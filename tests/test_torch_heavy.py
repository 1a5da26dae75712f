"""The port's heavy lane (runtime/batcher.py HeavyGroup and the pool's heavy
lane, device="cpu": every kernel's plain version) against its own
sequential path and the JAX package's heavy lane, on LUBM-1 (seed 42).

Mirrors tests/test_heavy.py: heavy recognition, keys and lane routing;
fused heavy counts equal the sequential count and the JAX heavy lane's,
with the split path forced and with it off; ``mt`` slices sum to the full
total; a member's deadline or budget degrades only that member; an
injected ``batch.heavy.dispatch`` fault is retried per slice; an engine
death mid-split strands no waiter; the weighted heavy cap leaves light
traffic an engine; ``heavy_lane`` off bypasses; ``heavy_index_batch`` is
memoised; the monitor's lane line. Then ``Emulator.run_serving`` once per
workload (light, and light with heavy), 0.5 s each.

Every wait carries its own timeout.
"""

import copy
import threading
import time

import numpy as np
import pytest
import torch

from wukong_tpu.config import Global as JGlobal
from wukong_tpu.engine.cpu import CPUEngine as JCPUEngine
from wukong_tpu.engine.tpu import TPUEngine
from wukong_tpu.loader import lubm as jlubm
from wukong_tpu.planner.optimizer import Planner as JPlanner
from wukong_tpu.planner.stats import Stats as JStats
from wukong_tpu.runtime import batcher as JB
from wukong_tpu.runtime.proxy import Proxy as JProxy
from wukong_tpu.store.gstore import build_partition as jbuild
from wukong_tpu_torch.analysis import lockdep
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.engine.cpu import CPUEngine
from wukong_tpu_torch.loader import lubm as plubm
from wukong_tpu_torch.obs import get_registry
from wukong_tpu_torch.planner.optimizer import Planner
from wukong_tpu_torch.planner.stats import Stats
from wukong_tpu_torch.runtime import batcher, faults
from wukong_tpu_torch.runtime.batcher import (
    HeavyGroup,
    _HeavySlice,
    _Pending,
    batchable,
    heavy_batchable,
    heavy_key,
)
from wukong_tpu_torch.runtime.emulator import Emulator
from wukong_tpu_torch.runtime.faults import FaultPlan, FaultSpec
from wukong_tpu_torch.runtime.proxy import Proxy
from wukong_tpu_torch.runtime.resilience import Deadline
from wukong_tpu_torch.runtime.scheduler import EnginePool
from wukong_tpu_torch.store.gstore import build_partition
from wukong_tpu_torch.types import OUT
from wukong_tpu_torch.utils.errors import ErrorCode

torch.set_num_threads(2)

UB = plubm.UB
RDF_TYPE = "<http://www.w3.org/1999/02/22-rdf-syntax-ns#type>"
WAIT_S = 60  # every join and future wait in this file is bounded by this


@pytest.fixture(autouse=True, scope="module")
def _lockdep_checked():
    """The gather barrier's slice locks, the pool's heavy-lane lock and the
    batcher condition feed the lockdep graph on every test."""
    lockdep.install(True)
    yield
    try:
        assert lockdep.cycles() == [], lockdep.cycles()
        assert lockdep.leaf_violations() == [], lockdep.leaf_violations()
    finally:
        lockdep.install(False)


@pytest.fixture(scope="module")
def world(_lockdep_checked):
    jt, _ = jlubm.generate_lubm(1, seed=42)
    jg = jbuild(jt, 0, 1)
    js = jlubm.VirtualLubmStrings(1, seed=42)
    jstats = JStats.generate(jt)
    jproxy = JProxy(jg, js, JCPUEngine(jg, js),
                    TPUEngine(jg, js, stats=jstats), planner=JPlanner(jstats))
    pt, _ = plubm.generate_lubm(1, seed=42)
    g = build_partition(pt, 0, 1)
    ss = plubm.VirtualLubmStrings(1, seed=42)
    proxy = Proxy(g, ss, device="cpu", planner=Planner(Stats.generate(pt)))
    yield {"g": g, "ss": ss, "proxy": proxy, "jproxy": jproxy}
    for p in (proxy, jproxy):
        if p._pool is not None:
            p._pool.stop()
        if p._batcher is not None:
            p._batcher.close()


@pytest.fixture(autouse=True)
def _knobs_reset(monkeypatch):
    """Every test starts and ends at the defaults, in both packages."""
    _set(monkeypatch, enable_batching=False, enable_tpu=True,
         heavy_lane=True, heavy_split_threshold=100000, heavy_split_max=4)
    yield


def _set(monkeypatch, **knobs):
    for G in (Global, JGlobal):
        for k, v in knobs.items():
            monkeypatch.setattr(G, k, v)


def _heavy_text(cls="GraduateStudent"):
    return (f"SELECT ?x ?y WHERE {{ ?x {RDF_TYPE} <{UB}{cls}> . "
            f"?x <{UB}takesCourse> ?y . }}")


def _light_text(world):
    """A const-start 1-hop (the light serving template)."""
    ss, g = world["ss"], world["g"]
    pid = ss.str2id(f"<{UB}memberOf>")
    dept = int(np.asarray(g.get_index(pid, OUT))[0])
    return f"SELECT ?s WHERE {{ ?s <{UB}memberOf> {ss.id2str(dept)} . }}"


def _planned(proxy, text, blind=True, deadline=None):
    q = proxy._parse_text(text)
    proxy._plan_prepared(q, blind, None)
    q.deadline = deadline
    return q


def _counter(name, **labels):
    m = get_registry()._metrics.get(name)
    if m is None:
        return 0.0
    return m.value(**labels) if labels else m.value()


def _concurrent(fn, n):
    """fn(i) on n threads at once; every thread joined within WAIT_S."""
    out = [None] * n

    def go(i):
        out[i] = fn(i)

    ths = [threading.Thread(target=go, args=(i,)) for i in range(n)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in ths), "a serving thread hung"
    return out


def _serve_heavy_concurrently(world, n, text=None):
    """n clients sending one heavy text to each package; returns (port
    replies, JAX replies)."""
    text = text or _heavy_text()
    ours = _concurrent(
        lambda i: world["proxy"].serve_query(text, blind=True), n)
    theirs = _concurrent(
        lambda i: world["jproxy"].serve_query(text, blind=True), n)
    return ours, theirs


# ---------------------------------------------------------------------------
# recognition + routing
# ---------------------------------------------------------------------------

def test_heavy_batchable_recognition(world):
    proxy = world["proxy"]
    q = _planned(proxy, _heavy_text())
    assert q.start_from_index()
    assert heavy_batchable(q) and not batchable(q)
    # non-blind: the sliced dispatch returns counts, not tables
    assert not heavy_batchable(_planned(proxy, _heavy_text(), blind=False))
    one_hop = _planned(proxy, f"SELECT ?s WHERE {{ ?s {RDF_TYPE} "
                              f"<{UB}FullProfessor> . }}")
    assert heavy_batchable(one_hop)  # a 1-hop index scan qualifies
    filt = _planned(proxy, f"SELECT ?x ?y WHERE {{ ?x {RDF_TYPE} "
                           f"<{UB}GraduateStudent> . ?x <{UB}takesCourse> "
                           f"?y . FILTER (?x != ?y) }}")
    assert not heavy_batchable(filt)  # filters need the table


def test_heavy_key_groups_identical_templates_only(world):
    proxy, jproxy = world["proxy"], world["jproxy"]
    a1 = _planned(proxy, _heavy_text("GraduateStudent"))
    a2 = _planned(proxy, _heavy_text("GraduateStudent"))
    b = _planned(proxy, _heavy_text("UndergraduateStudent"))
    assert heavy_key(a1) == heavy_key(a2) != heavy_key(b)
    ja = jproxy._parse_text(_heavy_text("GraduateStudent"))
    jproxy._plan_prepared(ja, True, None)
    assert heavy_key(a1) == JB.heavy_key(ja)


def test_classify_lane_routes_index_origin_heavy(world):
    proxy = world["proxy"]
    assert _planned(proxy, _heavy_text()).lane == "heavy"
    assert _planned(proxy, _light_text(world)).lane == "light"


def test_heavy_routed_const_template_bypasses_light_coalescer(
        world, monkeypatch):
    """A const-start template the optimizer estimates past
    heavy_rows_threshold is tagged heavy and never joins a light group."""
    proxy = world["proxy"]
    _set(monkeypatch, enable_batching=True, heavy_rows_threshold=1)
    q = _planned(proxy, _light_text(world))
    assert q.lane == "heavy" and batchable(q)
    before = _counter("wukong_batch_bypass_total", reason="heavy_route")
    assert proxy.batcher().offer(q) is None
    assert _counter("wukong_batch_bypass_total",
                    reason="heavy_route") == before + 1


# ---------------------------------------------------------------------------
# fused heavy dispatch: the sequential count, the JAX heavy lane's count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split", [False, True])
def test_fused_heavy_counts_match_sequential_and_jax(
        world, monkeypatch, split):
    proxy, jproxy = world["proxy"], world["jproxy"]
    want = proxy.serve_query(_heavy_text(), blind=True).result.nrows
    assert want > 0
    assert jproxy.serve_query(_heavy_text(), blind=True).result.nrows == want
    if split:
        proxy.engine_pool()
        jproxy.engine_pool()
        _set(monkeypatch, heavy_split_threshold=1, heavy_split_max=2)
    _set(monkeypatch, enable_batching=True, batch_window_us=100_000)
    # one group of five, formed deterministically: direct HeavyGroup run
    members = [_Pending(_planned(proxy, _heavy_text())) for _ in range(5)]
    fused0 = _counter("wukong_batch_heavy_fused_total")
    mode = "split" if split else "single"
    disp0 = _counter("wukong_batch_heavy_dispatch_total", mode=mode)
    HeavyGroup(members, proxy.batcher(), engine=proxy.gpu).run(None)
    assert _counter("wukong_batch_heavy_fused_total") == fused0 + 5
    assert _counter("wukong_batch_heavy_dispatch_total",
                    mode=mode) == disp0 + 1
    assert [m.q.result.nrows for m in members] == [want] * 5
    # and through serve_query from concurrent clients, in both packages
    ours, theirs = _serve_heavy_concurrently(world, 5)
    for q in ours + theirs:
        assert q.result.status_code == ErrorCode.SUCCESS
        assert q.result.nrows == want


def test_mt_sliced_parts_sum_to_full_total(world):
    """The split path's primitive: mt_factor carrier copies of an
    index-origin slice batch partition the index list exactly, part by part
    as in the JAX engine."""
    proxy, jproxy = world["proxy"], world["jproxy"]
    q = _planned(proxy, _heavy_text())
    jq = jproxy._parse_text(_heavy_text())
    jproxy._plan_prepared(jq, True, None)
    full = int(np.asarray(
        proxy.gpu.execute_batch_index(q, 8, slice_mode=True)).sum())
    parts, jparts = [], []
    for k in range(3):
        qk, jqk = copy.deepcopy(q), copy.deepcopy(jq)
        qk.mt_factor, qk.mt_tid = 3, k
        jqk.mt_factor, jqk.mt_tid = 3, k
        parts.append(int(np.asarray(
            proxy.gpu.execute_batch_index(qk, 8, slice_mode=True)).sum()))
        jparts.append(int(np.asarray(
            jproxy.tpu.execute_batch_index(jqk, 8, slice_mode=True)).sum()))
    assert sum(parts) == full and all(p > 0 for p in parts)
    assert parts == jparts


# ---------------------------------------------------------------------------
# member deadline/budget isolation inside a heavy group
# ---------------------------------------------------------------------------

def test_heavy_member_deadline_degrades_only_that_member(world):
    proxy = world["proxy"]
    t_frozen = [0.0]
    expired = Deadline(timeout_ms=1, clock=lambda: t_frozen[0])
    t_frozen[0] = 10.0  # expired before the flush
    members = [_Pending(_planned(proxy, _heavy_text())),
               _Pending(_planned(proxy, _heavy_text(), deadline=expired)),
               _Pending(_planned(proxy, _heavy_text()))]
    HeavyGroup(members, proxy.batcher(), engine=proxy.gpu).run(None)
    ok0, bad, ok2 = (m.q.result for m in members)
    assert ok0.status_code == ErrorCode.SUCCESS and ok0.nrows > 0
    assert ok2.status_code == ErrorCode.SUCCESS and ok2.nrows == ok0.nrows
    assert bad.status_code == ErrorCode.QUERY_TIMEOUT
    assert not bad.complete


def test_heavy_member_budget_charged_per_member(world):
    proxy = world["proxy"]
    members = [_Pending(_planned(proxy, _heavy_text())),
               _Pending(_planned(proxy, _heavy_text(),
                                 deadline=Deadline(budget_rows=1)))]
    HeavyGroup(members, proxy.batcher(), engine=proxy.gpu).run(None)
    ok, bad = (m.q.result for m in members)
    assert ok.status_code == ErrorCode.SUCCESS and ok.nrows > 0
    assert bad.status_code == ErrorCode.BUDGET_EXCEEDED
    assert not bad.complete


# ---------------------------------------------------------------------------
# split groups: the gather barrier, faults, engine death
# ---------------------------------------------------------------------------

def _force_split(world, monkeypatch):
    want = world["proxy"].serve_query(_heavy_text(), blind=True).result.nrows
    world["proxy"].engine_pool()  # a split needs live engines
    _set(monkeypatch, enable_batching=True, batch_window_us=100_000,
         heavy_split_threshold=1, heavy_split_max=2)
    return want


def test_split_gather_barrier_counts_identical(world, monkeypatch):
    proxy = world["proxy"]
    want = _force_split(world, monkeypatch)
    before = _counter("wukong_batch_heavy_dispatch_total", mode="split")
    slices0 = _counter("wukong_batch_heavy_slices_total")
    out = _concurrent(lambda i: proxy.serve_query(_heavy_text(), blind=True),
                      4)
    for q in out:
        assert q.result.status_code == ErrorCode.SUCCESS
        assert q.result.nrows == want
    ndisp = _counter("wukong_batch_heavy_dispatch_total", mode="split")
    assert ndisp > before
    assert _counter("wukong_batch_heavy_slices_total") \
        == slices0 + 2 * (ndisp - before)
    # a SINGLE heavy query also splits (a solo group still fuses)
    solo = proxy.serve_query(_heavy_text(), blind=True)
    assert solo.result.status_code == ErrorCode.SUCCESS
    assert solo.result.nrows == want
    assert _counter("wukong_batch_heavy_dispatch_total",
                    mode="split") == ndisp + 1


def test_injected_heavy_dispatch_fault_retries_per_slice(world, monkeypatch):
    """A transient fault at batch.heavy.dispatch fails ONE slice; the
    gather barrier re-runs it inline and every waiter gets the right
    count."""
    proxy = world["proxy"]
    want = _force_split(world, monkeypatch)
    before = _counter("wukong_batch_heavy_fallback_total",
                      reason="slice_retry")
    prev = faults.active()
    faults.install(FaultPlan([FaultSpec("batch.heavy.dispatch", "transient",
                                        count=1)]))
    try:
        out = _concurrent(
            lambda i: proxy.serve_query(_heavy_text(), blind=True), 3)
    finally:
        faults.install(prev)
    for q in out:
        assert q.result.status_code == ErrorCode.SUCCESS
        assert q.result.nrows == want
    assert _counter("wukong_batch_heavy_fallback_total",
                    reason="slice_retry") == before + 1


def test_engine_death_mid_split_strands_no_waiter(world, monkeypatch):
    """The engine running a pool slice dies (a thread-killing exception
    inside the slice): the death handler fails the slice, the gather
    barrier re-runs it inline, every waiter settles, and the pool
    respawns the engine."""
    proxy = world["proxy"]
    want = _force_split(world, monkeypatch)
    pool = proxy.engine_pool()
    killed = []
    orig_run = _HeavySlice.run

    def dying_run(self, engine=None):
        # the first pool slice (mt_tid > 0) kills its engine thread:
        # SystemExit escapes the engine loop's per-item guard
        if self.fq.mt_tid > 0 and not killed and self.claim():
            killed.append(True)
            raise SystemExit("engine killed mid-dispatch")
        return orig_run(self, engine)

    monkeypatch.setattr(_HeavySlice, "run", dying_run)
    # the gather thread waits for the pool's slice instead of claiming it
    # after the usual grace, so the dying engine always gets it
    monkeypatch.setattr(batcher, "SLICE_CLAIM_GRACE_S", WAIT_S)
    respawns0 = _counter("wukong_pool_engine_respawns_total")
    out = _concurrent(lambda i: proxy.serve_query(_heavy_text(), blind=True),
                      3)
    assert killed  # the scenario fired
    for q in out:
        assert q.result.status_code == ErrorCode.SUCCESS
        assert q.result.nrows == want
    assert _counter("wukong_pool_engine_respawns_total") > respawns0
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline and not all(
            h["alive"] for h in pool.health().values()):
        time.sleep(0.05)
    assert all(h["alive"] for h in pool.health().values())


# ---------------------------------------------------------------------------
# the pool's weighted heavy lane
# ---------------------------------------------------------------------------

class _Probe:
    """A fire-and-forget heavy-lane item recording run concurrency."""

    lane = "heavy"

    def __init__(self, state, hold_s=0.15):
        self.state = state
        self.hold_s = hold_s
        self.done = threading.Event()

    def run(self, engine=None):
        with self.state["lock"]:
            self.state["cur"] += 1
            self.state["max"] = max(self.state["max"], self.state["cur"])
        time.sleep(self.hold_s)
        with self.state["lock"]:
            self.state["cur"] -= 1
        self.done.set()

    def fail_all(self, exc):
        self.done.set()


def test_heavy_lane_weighted_cap_and_no_light_starvation(world, monkeypatch):
    _set(monkeypatch, heavy_lane_pct=50)
    pool = EnginePool(num_engines=2,
                      make_engine=lambda tid: CPUEngine(world["g"],
                                                        world["ss"]))
    pool.start()
    try:
        assert pool._heavy_cap() == 1  # 2 engines x 50%
        state = {"cur": 0, "max": 0, "lock": threading.Lock()}
        probes = [_Probe(state) for _ in range(4)]
        for p in probes:
            pool.submit(p, lane="heavy")
        # a heavy backlog holds its one engine; a light query is still
        # served by the other before the backlog drains
        q = _planned(world["proxy"], _light_text(world))
        pool.wait(pool.submit(q), timeout=WAIT_S)
        assert not probes[-1].done.is_set()
        for p in probes:
            assert p.done.wait(WAIT_S)
        assert state["max"] == 1  # the weighted cap held
    finally:
        pool.stop()


def test_heavy_lane_off_bypasses(world, monkeypatch):
    """heavy_lane off: index-origin queries bypass the batcher and still
    answer."""
    proxy = world["proxy"]
    _set(monkeypatch, enable_batching=True, heavy_lane=False)
    q = _planned(proxy, _heavy_text())
    before = _counter("wukong_batch_bypass_total", reason="shape")
    assert proxy.batcher().offer(q) is None
    assert _counter("wukong_batch_bypass_total", reason="shape") == before + 1
    out = proxy.serve_query(_heavy_text(), blind=True)
    assert out.result.status_code == ErrorCode.SUCCESS
    assert out.result.nrows > 0


def test_heavy_index_batch_memoised(world, monkeypatch):
    proxy, jproxy = world["proxy"], world["jproxy"]
    q = _planned(proxy, _heavy_text())
    calls = []
    orig = type(proxy.gpu).suggest_index_batch

    def spy(self, qq, cap=1024):
        calls.append(cap)
        return orig(self, qq, cap=cap)

    monkeypatch.setattr(type(proxy.gpu), "suggest_index_batch", spy)
    proxy._plan_cache.clear()
    b1, b2 = proxy.heavy_index_batch(q), proxy.heavy_index_batch(q)
    jq = jproxy._parse_text(_heavy_text())
    jproxy._plan_prepared(jq, True, None)
    assert b1 == b2 == jproxy.heavy_index_batch(jq)
    assert 1 <= b1 <= Global.heavy_batch_max
    assert len(calls) == 1  # the second lookup hit the plan cache


def test_monitor_lane_line(world, monkeypatch):
    proxy = world["proxy"]
    proxy.engine_pool()
    _set(monkeypatch, enable_batching=True, heavy_split_threshold=1,
         heavy_split_max=2)
    out = _concurrent(lambda i: proxy.serve_query(_heavy_text(), blind=True),
                      3)
    assert all(q.result.status_code == ErrorCode.SUCCESS for q in out)
    lines = proxy.monitor.lane_lines()
    assert lines and lines[0].startswith("HeavyLane: depth ")


# ---------------------------------------------------------------------------
# run_serving: one short run per workload
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workload", ["light", "mixed"])
def test_run_serving_smoke(world, monkeypatch, workload):
    proxy = world["proxy"]
    _set(monkeypatch, enable_batching=True)
    ss, g = world["ss"], world["g"]
    pid = ss.str2id(f"<{UB}advisor>")
    texts = [f"SELECT ?s WHERE {{ ?s <{UB}advisor> {ss.id2str(int(a))} . }}"
             for a in np.asarray(g.get_index(pid, OUT))[:16]]
    weights, classes = [1.0] * len(texts), [0] * len(texts)
    if workload == "mixed":
        proxy.engine_pool()
        texts.append(_heavy_text())
        weights.append(len(texts) * 0.3 / 0.7)  # 30% of arrivals
        classes.append(1)
    rep = Emulator(proxy).run_serving(texts, duration_s=0.5, warmup_s=0.1,
                                      clients=4, seed=1, weights=weights,
                                      classes=classes)
    assert rep["served"] > 0 and rep["errors"] == 0
    assert rep["batching"] is True
    assert 0 in rep["by_class"]
    if workload == "mixed":
        assert 1 in rep["by_class"]
