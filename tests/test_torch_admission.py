"""The port's admission control plane (runtime/admission.py) against the
JAX package's on the same inputs, mirroring tests/test_admission.py. The
whole file runs with the port's lockdep checker on (controllers, queues
and pools made here take DebugLocks) and must record no cycle and nothing
acquired under a declared leaf.

- ``parse_quotas`` gives field-equal quotas, and raises alike, on good and
  bad strings.
- The same arrivals, signals and clock give the same sequence of
  decisions, rung by rung (action, cause, reason, level, waits); the
  ladder's order is pinned; ``heavy_cap_for`` is work-conserving.
- The same pushes and pops give the same ``FairQueue`` order.
- The pool: the fair sub-lane runs tenant work, the off knob never builds
  it, and the heavy lane's tenant branch picks the same groups as the JAX
  pool's and settles its slots.
- The proxy (device="cpu"): a rung-3 rejection raises CAPACITY_EXCEEDED
  and reaches no engine and no host fallback, and holds its caller after
  its accounting, one tenant's rejections spaced apart (a deviation: the
  JAX proxy raises at once); rung 2 gives a partial reply; the off knob
  touches nothing.
"""

import re

import numpy as np
import pytest
import torch

import chip_smoke
from wukong_tpu.config import Global as JGlobal
from wukong_tpu.obs import slo as jslo
from wukong_tpu.runtime import admission as jadm
from wukong_tpu.runtime import scheduler as jsched
from wukong_tpu_torch.analysis import lockdep
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.engine.cpu import CPUEngine
from wukong_tpu_torch.loader.lubm import VirtualLubmStrings, generate_lubm
from wukong_tpu_torch.obs import get_recorder
from wukong_tpu_torch.obs import slo
from wukong_tpu_torch.obs.events import EVENT_KINDS, get_journal
from wukong_tpu_torch.planner.heuristic import heuristic_plan
from wukong_tpu_torch.runtime import admission as padm
from wukong_tpu_torch.runtime import faults
from wukong_tpu_torch.runtime import scheduler as psched
from wukong_tpu_torch.runtime.proxy import Proxy
from wukong_tpu_torch.sparql.parser import Parser
from wukong_tpu_torch.store.gstore import build_partition
from wukong_tpu_torch.utils.errors import ErrorCode, WukongError

torch.set_num_threads(2)

Q_CHAIN = chip_smoke.PREFIX + """SELECT ?X ?Y WHERE {
    ?X ub:memberOf ?Y .
    ?Y ub:subOrganizationOf ?Z .
}"""
THREE_CLASSES = "gold:8:0:0:0;silver:4:0:0:0;bulk:1:0:0:0"
DRILL = "gold:8:0:0:0;silver:4:0:0:0;bulk:1:25:4:0"
KNOBS = ("enable_tracing", "enable_tenant_accounting", "slo_specs",
         "enable_admission", "admission_quotas", "admission_default_weight",
         "admission_max_inflight", "admission_defer_ms", "admission_burst_x",
         "admission_delay_budget_us", "admission_partial_deadline_ms",
         "admission_partial_budget_rows", "admission_retry_after_s",
         "admission_drr_quantum", "batch_window_us", "enable_batching",
         "heavy_lane_pct")


@pytest.fixture(autouse=True, scope="module")
def _lockdep():
    lockdep.install(True)
    yield
    try:
        assert lockdep.cycles() == [], lockdep.cycles()
        assert lockdep.leaf_violations() == [], lockdep.leaf_violations()
    finally:
        lockdep.install(False)


@pytest.fixture(scope="module")
def world(_lockdep):
    g = build_partition(generate_lubm(1, seed=42)[0], 0, 1)
    ss = VirtualLubmStrings(1, seed=42)
    return {"g": g, "ss": ss, "proxy": Proxy(g, ss, device="cpu")}


def _reset():
    for adm in (padm.get_admission(), jadm.get_admission()):
        adm.reset()
    for mod in (slo, jslo):
        mod.get_slo().reset()
        mod.get_overload().reset()
        mod.reset_labels()
    get_recorder().clear()
    get_journal().clear()
    faults.clear()


@pytest.fixture(autouse=True)
def _hygiene(monkeypatch):
    """Both packages' knobs at their defaults (the plane off), state
    clean."""
    for name in KNOBS:
        monkeypatch.setattr(Global, name, getattr(Global, name))
        monkeypatch.setattr(JGlobal, name, getattr(JGlobal, name))
    _reset()
    yield
    _reset()


def _both(monkeypatch, **knobs):
    for k, v in knobs.items():
        monkeypatch.setattr(Global, k, v)
        monkeypatch.setattr(JGlobal, k, v)


def _quota_fields(qs):
    return {t: (q.tenant, q.weight, q.qps, q.inflight, q.rows_per_s)
            for t, q in qs.items()}


# ---------------------------------------------------------------------------
# quotas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", [
    "gold:8:100:16:500000; bulk:1:10:2:0", DRILL, "", " ; ",
    "a:1:0.5:0:0", "gold:8:100", "gold:0:1:1:1", ":1:1:1:1",
    "gold:x:1:1:1", "gold:1:1:1.5:1"])
def test_parse_quotas_equal_on_good_and_bad_strings(text):
    try:
        want = _quota_fields(jadm.parse_quotas(text))
    except ValueError:
        with pytest.raises(ValueError):
            padm.parse_quotas(text)
        return
    assert _quota_fields(padm.parse_quotas(text)) == want


# ---------------------------------------------------------------------------
# the same arrivals give the same decisions, rung by rung
# ---------------------------------------------------------------------------

def _decision(d):
    return (d.action, d.tenant, d.cause, d.reason, d.level,
            round(d.wait_s, 9), round(d.retry_after_s, 9))


def _drive(monkeypatch, seed: int, quotas: str):
    """One seeded arrival schedule through both packages: per step, a
    clock advance, queue-delay notes on both buses, an arrival (noted,
    then admitted) and some completions. Returns both decision lists."""
    _both(monkeypatch, enable_admission=True, admission_quotas=quotas,
          admission_max_inflight=6, admission_defer_ms=0)
    now = {"t": 10**9}
    for mod in (slo, jslo):
        monkeypatch.setattr(mod, "get_usec", lambda: now["t"])
    ctrls = (padm.AdmissionController(clock=lambda: now["t"]),
             jadm.AdmissionController(clock=lambda: now["t"]))
    rng = np.random.default_rng(seed)
    tenants = ("gold", "silver", "bulk", "anon")
    out = ([], [])
    inflight = []
    for step in range(400):
        now["t"] += int(rng.integers(100, 9_000))
        if rng.random() < 0.3:
            lane = ("default", "batch", "heavy")[int(rng.integers(0, 3))]
            delay = int(rng.integers(0, 90_000))
            for mod in (slo, jslo):
                mod.get_overload().note_queue_delay(lane, delay)
        ten = tenants[int(rng.integers(0, len(tenants)))]
        for mod in (slo, jslo):
            mod.get_overload().note_admit(mod.tenant_label(ten))
        inflight.append(ten)
        cached = bool(rng.random() < 0.05)  # a result-cache hit
        for ctrl, o in zip(ctrls, out):
            o.append(_decision(ctrl.admit(ten, cached=cached)))
        if rng.random() < 0.2:
            rows = int(rng.integers(0, 400_000))
            for ctrl in ctrls:
                ctrl.note_reply(ten, rows)
        while inflight and rng.random() < 0.55:
            done = inflight.pop(int(rng.integers(0, len(inflight))))
            for mod in (slo, jslo):
                mod.get_overload().note_done(done)
    return out, ctrls


@pytest.mark.parametrize("quotas", [THREE_CLASSES, DRILL,
                                    "gold:8:0:3:0;bulk:1:40:0:90000"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_arrivals_same_decisions(monkeypatch, seed, quotas):
    (mine, theirs), ctrls = _drive(monkeypatch, seed, quotas)
    assert mine == theirs
    actions = {d[0] for d in mine}
    assert "admit" in actions and len(actions) > 1  # the ladder engaged
    a, b = ctrls[0].report(), ctrls[1].report()
    for k in ("level", "inflight_cap", "quotas", "tenants", "decisions"):
        assert a[k] == b[k], k


def test_degrade_ladder_ordering_is_pinned(monkeypatch):
    """Bulk is deferred at level 1 and partialed at level 2 before silver
    is first touched at level 3; gold (the top weight) never degrades."""
    _both(monkeypatch, admission_quotas=THREE_CLASSES)
    expect = {
        0: {"bulk": "admit", "silver": "admit", "gold": "admit"},
        1: {"bulk": "defer", "silver": "admit", "gold": "admit"},
        2: {"bulk": "partial", "silver": "admit", "gold": "admit"},
        3: {"bulk": "reject", "silver": "defer", "gold": "admit"},
    }
    for mod in (padm, jadm):
        adm = mod.AdmissionController(clock=lambda: 1_000_000)
        for level, want in expect.items():
            adm.overload_level = lambda lvl=level: lvl
            for tenant, action in want.items():
                d = adm.admit(tenant)
                assert (d.tenant, d.action) == (tenant, action), (mod, level)
        adm.overload_level = lambda: 3
        d = adm.admit("bulk")
        assert d.retry_after_s >= float(Global.admission_retry_after_s)
        assert not d.admitted


def test_token_bucket_rejects_defers_and_refills(monkeypatch):
    _both(monkeypatch, admission_quotas="t:1:10:0:0", admission_burst_x=1.0)
    t = [1_000_000]
    adm = padm.AdmissionController(clock=lambda: t[0])
    assert [adm.admit("t").action for _ in range(10)] == ["admit"] * 10
    d = adm.admit("t")
    assert (d.action, d.cause, d.reason) == ("reject", "admission_quota",
                                             "quota_qps")
    t[0] += 200_000  # 0.2 s at 10 q/s refills 2 tokens
    assert [adm.admit("t").action for _ in range(3)] == \
        ["admit", "admit", "reject"]
    _both(monkeypatch, admission_defer_ms=200)
    d = adm.admit("t")
    assert d.action == "defer" and 0.0 < d.wait_s <= 0.2 and d.admitted


def test_heavy_cap_weighted_share_is_work_conserving(monkeypatch):
    _both(monkeypatch, admission_quotas=THREE_CLASSES)
    cases = [("gold", 8, {}), ("bulk", 8, {}), ("gold", 8, {"bulk": 1}),
             ("bulk", 8, {"gold": 3}), ("silver", 12, {"gold": 2, "bulk": 1})]
    got = [padm.AdmissionController().heavy_cap_for(*c) for c in cases]
    assert got == [jadm.AdmissionController().heavy_cap_for(*c)
                   for c in cases] == [8, 8, 7, 1, 3]


# ---------------------------------------------------------------------------
# the fair queue
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantum", [1, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fair_queue_same_pushes_same_order(monkeypatch, seed, quantum):
    _both(monkeypatch, admission_drr_quantum=quantum)
    rng = np.random.default_rng(seed)
    queues = (padm.FairQueue(), jadm.FairQueue())
    weights = {"gold": 8, "silver": 4, "bulk": 1, "anon": 1}
    orders = ([], [])
    for step in range(600):
        if rng.random() < 0.55:
            ten = list(weights)[int(rng.integers(0, 4))]
            for fq in queues:
                fq.push(ten, (ten, step), weight=weights[ten])
        else:
            for fq, o in zip(queues, orders):
                o.append(fq.pop())
    for fq, o in zip(queues, orders):
        while len(fq):
            o.append(fq.pop())
    assert orders[0] == orders[1]
    assert queues[0].depths() == {} and queues[0].pop() is None


def test_fair_queue_drr_under_hostile_bulk_flood():
    fq = padm.FairQueue()
    for i in range(40):
        fq.push("bulk", ("b", i), weight=1)
    for i in range(16):
        fq.push("gold", ("g", i), weight=8)
    assert len(fq) == 56 and fq.depths() == {"bulk": 40, "gold": 16}
    order = [fq.pop() for _ in range(56)]
    gold_at = [i for i, it in enumerate(order) if it[0] == "g"]
    assert len(gold_at) == 16 and max(gold_at) < 20
    assert any(it[0] == "b" for it in order[:20])
    assert [it[1] for it in order if it[0] == "b"] == list(range(40))


def test_effective_tenant_precedence():
    from types import SimpleNamespace

    for mod in (padm, jadm):
        assert mod.effective_tenant(SimpleNamespace(
            owner_tenant="gold", tenant="bulk")) == "gold"
        assert mod.effective_tenant(SimpleNamespace(
            owner_tenant=None, tenant="bulk")) == "bulk"
        assert mod.effective_tenant(SimpleNamespace()) == "default"


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------

def _planned(world, tenant="default"):
    q = Parser(world["ss"]).parse(Q_CHAIN)
    heuristic_plan(q)
    q.result.blind = True
    q.tenant = tenant
    return q


def test_pool_fair_lane_executes_tenant_work(world, monkeypatch):
    _both(monkeypatch, enable_admission=True, admission_quotas=THREE_CLASSES)
    pool = psched.EnginePool(num_engines=2, make_engine=lambda tid: CPUEngine(
        world["g"], world["ss"]))
    pool.start()
    try:
        qids = [pool.submit(_planned(world, t))
                for t in ("bulk", "gold", "bulk", "silver")]
        outs = [pool.wait(qid, timeout=60) for qid in qids]
        assert all(o.result.status_code == 0 for o in outs)
        assert len({o.result.nrows for o in outs}) == 1
        assert pool._fair is not None and len(pool._fair) == 0
    finally:
        pool.stop()


def test_pool_off_knob_never_builds_the_fair_queue(world):
    pool = psched.EnginePool(num_engines=2, make_engine=lambda tid: CPUEngine(
        world["g"], world["ss"]))
    pool.start()
    try:
        out = pool.wait(pool.submit(_planned(world, "gold")), timeout=60)
        assert out.result.status_code == 0 and pool._fair is None
    finally:
        pool.stop()


class _Group:
    """A stand-in heavy-lane group: its tenant tag and lane."""

    lane = "heavy"

    def __init__(self, tenant, k):
        self.tenant, self.k = tenant, k


def _heavy_picks(sched, order):
    """Pop a pool's heavy lane (the engines not started) the way the
    engine loop does: a group per pop while under the caps, then release
    the oldest held slot; returns the (tenant, k) pop sequence."""
    pool = sched.EnginePool(num_engines=6, make_engine=None)
    for i, t in enumerate(order):
        pool.heavy_queue.append((None, _Group(t, i)))
    held, seq = [], []
    for _ in range(4 * len(order)):
        item = pool._pop_work(0)
        if item is None:
            if not held:
                break
            pool._heavy_done(held.pop(0))
            continue
        held.append(item[1])
        seq.append((item[1].tenant, item[1].k))
    for g in held:
        pool._heavy_done(g)
    return seq, pool


def test_heavy_lane_tenant_branch_matches_jax(monkeypatch):
    _both(monkeypatch, enable_admission=True, admission_quotas=THREE_CLASSES,
          heavy_lane_pct=50)
    order = ["gold", "bulk", "bulk", "silver", "bulk", "gold", "bulk"]
    seq, pool = _heavy_picks(psched, order)
    jseq, _jpool = _heavy_picks(jsched, order)
    assert seq == jseq and len(seq) == len(order)
    assert pool._heavy_by_tenant == {} and pool._heavy_inflight == 0
    # with gold and bulk each holding a slot of the 3, bulk is at its
    # weighted share (1): silver's group overtakes bulk's second
    assert seq.index(("silver", 3)) < seq.index(("bulk", 2))


# ---------------------------------------------------------------------------
# the proxy
# ---------------------------------------------------------------------------

def test_rejection_reaches_no_engine_and_no_fallback(world, monkeypatch):
    proxy = world["proxy"]
    _both(monkeypatch, enable_admission=True,
          admission_quotas="bulk:1:0.5:0:0")
    q = proxy.serve_query(Q_CHAIN, blind=True, tenant="bulk")
    assert q.result.status_code == ErrorCode.SUCCESS  # the burst admits one
    calls = []
    for eng in (proxy.gpu, proxy.cpu):
        monkeypatch.setattr(eng, "execute",
                            lambda q, *a, **k: calls.append(q))
    monkeypatch.setattr(proxy, "_run_repeats",
                        lambda *a, **k: calls.append("repeats"))
    with pytest.raises(WukongError) as ei:
        proxy.serve_query(Q_CHAIN, blind=True, tenant="bulk")
    assert ei.value.code == ErrorCode.CAPACITY_EXCEEDED
    assert "retry after" in str(ei.value)
    assert calls == []  # no engine, no host fallback, no execution loop
    assert slo.read_admission_input("shed_by_cause")["admission_quota"] >= 1
    assert slo.get_slo().compliance("bulk")["errors"] == 1
    assert any(e.kind == "admission.quota" and e.tenant == "bulk"
               for e in get_journal().last(kind="admission"))
    assert slo.read_admission_input("tenant_inflight").get("bulk", 0) == 0


def test_rejections_are_spaced_per_tenant(world, monkeypatch):
    """A rung-3 rejection holds its caller after its reply-side accounting
    (no in-flight slot held): for the yield at first, then until its
    tenant's next slot, each REJECT_SPACING_S after the one before, never
    past the retry-after; tenants are paced apart."""
    import time
    from types import SimpleNamespace

    from wukong_tpu_torch.runtime import proxy as proxy_mod

    proxy = Proxy(world["g"], world["ss"], device="cpu")
    y, sp = proxy_mod.REJECT_YIELD_S, proxy_mod.REJECT_SPACING_S
    _both(monkeypatch, enable_admission=True,
          admission_quotas="bulk:1:0.5:0:0")
    proxy.serve_query(Q_CHAIN, blind=True, tenant="bulk")  # the burst
    held = []
    monkeypatch.setattr(proxy_mod, "time", SimpleNamespace(
        monotonic=time.monotonic, sleep=lambda s: held.append(
            (s, slo.read_admission_input("tenant_inflight").get("bulk", 0)))))
    with pytest.raises(WukongError) as ei:
        proxy.serve_query(Q_CHAIN, blind=True, tenant="bulk")
    assert ei.value.code == ErrorCode.CAPACITY_EXCEEDED
    assert len(held) == 1 and held[0][1] == 0
    assert abs(held[0][0] - y) < 2e-3
    holds = [proxy._reject_hold_s("t", 1.0) for _ in range(4)]
    want = [y, y + sp, y + 2 * sp, y + 3 * sp]
    assert all(abs(h - w) < 2e-3 for h, w in zip(holds, want)), holds
    assert abs(proxy._reject_hold_s("u", 1.0) - y) < 2e-3
    cap = y + 3 * sp
    assert abs(proxy._reject_hold_s("t", cap) - cap) < 2e-3


def test_rejection_slots_under_threads(world, monkeypatch):
    """More threads than cores reserve one tenant's rejection slots at a
    short switch interval, the clock held still: every hold is distinct,
    the yield and then one REJECT_SPACING_S more each (a lost update would
    repeat one)."""
    import sys
    import threading
    from types import SimpleNamespace

    from wukong_tpu_torch.runtime import proxy as proxy_mod

    proxy = Proxy(world["g"], world["ss"], device="cpu")
    monkeypatch.setattr(proxy_mod, "time", SimpleNamespace(
        monotonic=lambda: 1000.0, sleep=None))
    holds, lock = [], threading.Lock()

    def reserve():
        for _ in range(20):
            h = proxy._reject_hold_s("t", 60.0)
            with lock:
                holds.append(h)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=reserve) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    want = (proxy_mod.REJECT_YIELD_S
            + proxy_mod.REJECT_SPACING_S * np.arange(320))
    np.testing.assert_allclose(sorted(holds), want, rtol=0, atol=1e-9)


def test_partial_reply_end_to_end(world, monkeypatch):
    """Rung 2: an over-row-budget tenant's reply degrades to a structured
    partial on the GPU engine (device="cpu"), with the rows it produced."""
    _both(monkeypatch, enable_admission=True,
          admission_quotas="bulk:1:0:0:50",
          admission_partial_deadline_ms=10_000,
          admission_partial_budget_rows=1)
    adm = padm.get_admission()
    adm.note_reply("bulk", 0)
    adm.note_reply("bulk", 1_000_000)
    q = world["proxy"].serve_query(Q_CHAIN, blind=True, tenant="bulk")
    assert q.result.complete is False and q.result.dropped_patterns
    assert q.result.status_code == ErrorCode.BUDGET_EXCEEDED
    assert slo.read_admission_input("shed_by_cause")[
        "admission_partial"] >= 1


def test_off_knob_zero_touch(world):
    assert padm.maybe_admission() is None
    q = world["proxy"].serve_query(Q_CHAIN, blind=True, tenant="bulk")
    assert q.result.status_code == ErrorCode.SUCCESS
    rep = padm.get_admission().report()
    assert rep["enabled"] is False and rep["decisions"] == {}


def test_report_and_render(monkeypatch, world, capsys):
    _both(monkeypatch, enable_admission=True, admission_quotas=THREE_CLASSES,
          admission_max_inflight=6)
    for mod in (padm, jadm):
        adm = mod.get_admission()
        assert adm.admit("gold").action == "admit"
    rep = padm.get_admission().report()
    jrep = jadm.get_admission().report()
    for k in ("enabled", "quotas", "decisions", "default_weight",
              "consumed_inputs", "inflight_cap"):
        assert rep[k] == jrep[k], k
    text, js = padm.render_admission(4)
    jtext, _ = jadm.render_admission(4)
    assert text.split("SIGNALS")[0] == jtext.split("SIGNALS")[0]
    from wukong_tpu_torch.runtime.console import Console

    Console(world["proxy"]).run_command("admission -k 4")
    assert "wukong-admission" in capsys.readouterr().out


def test_contracts_are_literal_and_closed():
    assert padm.CONSUMED_INPUTS == jadm.CONSUMED_INPUTS
    assert set(padm.CONSUMED_INPUTS) <= set(slo.ADMISSION_INPUTS)
    assert padm.SHED_CAUSES == jadm.SHED_CAUSES
    src = open(padm.__file__).read()
    noted = set(re.findall(r'maybe_note_shed\("([a-z_]+)"', src))
    read = set(re.findall(r'read_admission_input\("([a-z_]+)"\)', src))
    assert noted == set(padm.SHED_CAUSES)
    assert read <= set(padm.CONSUMED_INPUTS)
    assert {"admission.shed", "admission.quota"} <= set(EVENT_KINDS)
