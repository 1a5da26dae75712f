"""The port's tenant SLO plane (obs/slo.py) against the JAX package's on the
same inputs, mirroring tests/test_slo.py.

- ``parse_specs`` gives field-equal specs, and raises alike, on good and
  bad strings; ``tenant_label`` bounds cardinality alike.
- The same sequence of observations under the same injected clock gives
  equal compliance, error budget, burn rates, alerts and verdicts, and the
  same rendered SLO table and Monitor line; the overload bus gives equal
  in-flight and arrival EWMAs.
- Through the port's proxy (device="cpu"): the tenant threads query,
  trace and metrics; a parse error still reaches the accounting; the
  engine pool charges queue delay and sheds by cause and tenant; the off
  knob touches nothing; the console's ``slo`` verb and ``sparql -t``.
- The burn sentinel dumps one trace per cooldown, the tenant's newest
  failed reply's.
"""

import time

import pytest
import torch

import chip_smoke
from wukong_tpu.config import Global as JGlobal
from wukong_tpu.obs import slo as jslo
from wukong_tpu.runtime import monitor as jmonitor
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.engine.cpu import CPUEngine
from wukong_tpu_torch.loader.lubm import VirtualLubmStrings, generate_lubm
from wukong_tpu_torch.obs import get_recorder, get_registry
from wukong_tpu_torch.obs import slo
from wukong_tpu_torch.obs.trace import QueryTrace
from wukong_tpu_torch.planner.heuristic import heuristic_plan
from wukong_tpu_torch.runtime import faults
from wukong_tpu_torch.runtime.monitor import Monitor
from wukong_tpu_torch.runtime.proxy import Proxy
from wukong_tpu_torch.runtime.resilience import Deadline
from wukong_tpu_torch.runtime.scheduler import EnginePool
from wukong_tpu_torch.sparql.parser import Parser
from wukong_tpu_torch.store.gstore import build_partition
from wukong_tpu_torch.utils.errors import ErrorCode, QueryTimeout, WukongError

torch.set_num_threads(2)

Q_CHAIN = chip_smoke.PREFIX + """SELECT ?X ?Y WHERE {
    ?X ub:memberOf ?Y .
    ?Y ub:subOrganizationOf ?Z .
}"""
KNOBS = ("enable_tenant_accounting", "max_tenants", "slo_specs",
         "slo_window", "slo_fast_window_s", "slo_slow_window_s",
         "slo_burn_fast_x", "slo_burn_slow_x", "slo_dump_cooldown_s",
         "enable_tracing", "trace_sample_every")


@pytest.fixture(scope="module")
def world():
    g = build_partition(generate_lubm(1, seed=42)[0], 0, 1)
    ss = VirtualLubmStrings(1, seed=42)
    return {"g": g, "ss": ss, "proxy": Proxy(g, ss, device="cpu")}


@pytest.fixture(autouse=True)
def _hygiene(monkeypatch):
    """The knobs at their defaults in both packages; trackers, signals,
    labels and recorders clean; no fault plan leaks."""
    for name in KNOBS:
        monkeypatch.setattr(Global, name, getattr(Global, name))
        monkeypatch.setattr(JGlobal, name, getattr(JGlobal, name))
    for mod in (slo, jslo):
        mod.get_slo().reset()
        mod.get_overload().reset()
        mod.reset_labels()
    get_recorder().clear()
    faults.clear()
    yield
    for mod in (slo, jslo):
        mod.get_slo().reset()
        mod.get_overload().reset()
        mod.reset_labels()
    faults.clear()


def _clock(monkeypatch, step_us=1_000, start=10**12):
    """The same injected clock in both packages' slo modules: every read
    advances ``step_us``; ``jump(us)`` moves both on."""
    state = {"p": start, "j": start}

    def make(k):
        def now():
            state[k] += step_us
            return state[k]
        return now

    monkeypatch.setattr(slo, "get_usec", make("p"))
    monkeypatch.setattr(jslo, "get_usec", make("j"))

    def jump(us):
        state["p"] += us
        state["j"] += us
    return jump


def _spec_fields(sp):
    return (sp.tenant, sp.percentile, sp.latency_ms, sp.availability,
            sp.budget)


# ---------------------------------------------------------------------------
# specs and labels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", [
    "gold:95:50:0.999; bulk:99:0:0.9", "gold:95:50:99.9", "", " ; ",
    "a:0.5:1.5:0.5;b:50:0:50", "gold:95:50", "gold:95:50:0",
    "gold:95:50:150", "gold:x:50:0.9", "a:1:2:3:4"])
def test_parse_specs_equal_on_good_and_bad_strings(text):
    try:
        want = [_spec_fields(s) for s in jslo.parse_specs(text)]
    except ValueError as e:
        with pytest.raises(ValueError, match="bad|could not convert"):
            slo.parse_specs(text)
        assert type(e) is ValueError
        return
    assert [_spec_fields(s) for s in slo.parse_specs(text)] == want


def test_overflow_bucket_bounds_cardinality(monkeypatch):
    for G in (Global, JGlobal):
        monkeypatch.setattr(G, "max_tenants", 2)
    for mod in (slo, jslo):
        got = [mod.tenant_label(t) for t in ("a", "b", "c", "a", None)]
        assert got == ["a", "b", "__overflow__", "a", "__overflow__"]


# ---------------------------------------------------------------------------
# the same observations give the same SLO reports, alerts and verdicts
# ---------------------------------------------------------------------------

SPECS = [("strict", 0.95, 0.0, 0.999), ("loose", 0.95, 0.0, 0.5),
         ("lat", 0.9, 1.0, 0.9), ("mid", 0.99, 2.0, 0.99)]


def _scenario(name):
    """(tenant, dur_us, ok, jump_us) observations."""
    out = []
    if name == "quarter_bad":
        for i in range(120):
            for t in ("strict", "loose", "mid"):
                out.append((t, 700 + 37 * (i % 5), i % 4 != 0, 0))
    elif name == "latency":
        for i in range(80):
            out.append(("lat", 500 if i % 3 else 5_000, True, 0))
            out.append(("mid", 1_500 + 300 * (i % 4), True, 0))
    elif name == "burst_after_quiet":
        for i in range(200):
            out.append(("strict", 800, True, 10_000_000))  # 10 s apart
        for i in range(40):
            out.append(("strict", 800, i % 2 == 0, 0))
    elif name == "unspecd":
        for i in range(30):
            out.append(("anon", 1_000, False, 0))
    return out


@pytest.mark.parametrize("cooldown", [60, 0])
@pytest.mark.parametrize("name", ["quarter_bad", "latency",
                                  "burst_after_quiet", "unspecd"])
def test_same_observations_same_reports(monkeypatch, name, cooldown):
    jump = _clock(monkeypatch)
    for G in (Global, JGlobal):
        monkeypatch.setattr(G, "slo_dump_cooldown_s", cooldown)
    trackers = (slo.SLOTracker(window=128), jslo.SLOTracker(window=128))
    for t, mod in zip(trackers, (slo, jslo)):
        for sp in SPECS:
            t.register(mod.SLOSpec(*sp))
    verdicts = ([], [])
    for (ten, dur, ok, dt) in _scenario(name):
        jump(dt)
        for t, vs in zip(trackers, verdicts):
            v = t.observe(ten, dur, ok)
            vs.append(None if v is None else
                      {k: v[k] for k in ("tenant", "fast_burn",
                                         "slow_burn", "windows")})
    assert verdicts[0] == verdicts[1]
    assert trackers[0].report() == trackers[1].report()
    if name == "quarter_bad":  # the conflicting-SLO property
        alerts = {r["tenant"]: r["alerts"]
                  for r in trackers[0].report()["tenants"]}
        assert alerts["strict"] >= 1 and alerts["loose"] == 0
    if name == "unspecd":
        assert not any(verdicts[0])
        assert "burn" not in trackers[0].compliance("anon")


def test_compliance_budget_and_burn_math():
    t = slo.SLOTracker(window=128)
    t.register(slo.SLOSpec("a", percentile=0.95, latency_ms=0.0,
                           availability=0.9))
    for i in range(20):
        t.observe("a", 1000, ok=(i % 2 == 0))  # 50% bad, budget 10%
    c = t.compliance("a")
    assert c["compliance"] == 0.5
    assert c["burn"]["fast"] == pytest.approx(5.0)
    assert c["burn"]["slow"] == pytest.approx(5.0)
    assert c["error_budget_remaining"] == pytest.approx(-4.0)


def test_config_declared_specs_apply(monkeypatch):
    monkeypatch.setattr(Global, "slo_specs", "cfg:95:100:0.99")
    t = slo.SLOTracker(window=64)
    t.observe("cfg", 1000, ok=True)
    assert t.compliance("cfg")["spec"] == {
        "percentile": 0.95, "latency_ms": 100.0, "availability": 0.99}


def test_rendered_table_and_monitor_line_equal_jax(monkeypatch):
    _clock(monkeypatch)
    for mod in (slo, jslo):
        tr = mod.get_slo()
        for sp in SPECS[:3]:
            tr.register(mod.SLOSpec(*sp))
        for i in range(40):
            tr.observe("strict", 900, ok=i % 5 != 0)
            tr.observe("loose", 1200, ok=True)
            tr.observe("lat", 400 if i % 2 else 3000, ok=True)
    text, js = slo.render_slo(k=8)
    jtext, jjs = jslo.render_slo(k=8)
    assert text.split("SIGNALS")[0] == jtext.split("SIGNALS")[0]
    assert js["tenants"] == jjs["tenants"]
    assert Monitor().slo_lines() == jmonitor.Monitor().slo_lines()


def test_render_slo_empty_state():
    text, js = slo.render_slo()
    assert "no tenant replies observed" in text and js["tenants"] == []
    assert Monitor().slo_lines() == []


def test_overload_inflight_and_arrival_ewma_equal_jax(monkeypatch):
    jump = _clock(monkeypatch)
    for mod in (slo, jslo):
        sig = mod.get_overload()
        for i in range(6):
            jump(1_000 * (i + 1))
            sig.note_admit("t1")
        sig.note_done("t1")
        sig.note_queue_delay("default", 100)
        sig.note_queue_delay("default", 300)
        sig.note_shed("queue_deadline", "t1")
    a, b = slo.get_overload().report(), jslo.get_overload().report()
    for k in ("tenants", "shed_by_cause", "shed_by_tenant", "inputs"):
        assert a[k] == b[k], k
    assert a["tenants"]["t1"]["inflight"] == 5
    assert a["lanes"]["default"]["queue_delay_ewma_us"] == \
        b["lanes"]["default"]["queue_delay_ewma_us"]


def test_admission_inputs_backed_by_registered_metrics(world):
    assert slo.ADMISSION_INPUTS == jslo.ADMISSION_INPUTS
    world["proxy"].serve_query(Q_CHAIN, blind=True)
    snap = get_registry().snapshot()
    for signal, metric in slo.ADMISSION_INPUTS.items():
        assert metric in snap, (signal, metric)
    with pytest.raises(KeyError):
        slo.read_admission_input("made_up")


# ---------------------------------------------------------------------------
# the burn sentinel
# ---------------------------------------------------------------------------

def test_burn_sentinel_trips_once_and_dumps_the_failed_trace(monkeypatch):
    monkeypatch.setattr(Global, "slo_dump_cooldown_s", 3600)
    t = slo.SLOTracker(window=128)
    t.register(slo.SLOSpec("gold", 0.95, 0.0, 0.999))
    failed = QueryTrace(kind="query", tenant="gold")
    failed.finish("ERROR")
    verdicts = [t.observe("gold", 1000, ok=False, trace=failed)]
    for _ in range(39):  # good replies, each with its own trace
        good = QueryTrace(kind="query", tenant="gold")
        good.finish("SUCCESS")
        verdicts.append(t.observe("gold", 1000, ok=True, trace=good))
    trips = [v for v in verdicts if v is not None]
    assert len(trips) == 1 and trips[0]["windows"] == ("fast", "slow")
    m = get_registry().counter("wukong_slo_burn_alerts_total",
                               labels=("tenant", "window"))
    assert m.value(tenant="gold", window="fast") >= 1
    dumps = [(r, d) for (r, d) in get_recorder().dumps if r == "SLO_BURN"]
    assert len(dumps) == 1 and dumps[0][1] is failed


def test_burn_sentinel_alerts_on_a_host_up_for_less_than_the_cooldown(
        monkeypatch):
    """A clock (the host's uptime) below the cooldown: no alert has fired
    yet, so no cooldown holds the first one back; the second stays held."""
    monkeypatch.setattr(Global, "slo_dump_cooldown_s", 3600)
    now = {"us": 10_000_000}  # up for 10 s

    def clock():
        now["us"] += 1_000
        return now["us"]

    monkeypatch.setattr(slo, "get_usec", clock)
    t = slo.SLOTracker(window=128)
    t.register(slo.SLOSpec("gold", 0.95, 0.0, 0.999))
    before = len([1 for r, _d in get_recorder().dumps if r == "SLO_BURN"])
    failed = QueryTrace(kind="query", tenant="gold")
    failed.finish("ERROR")
    verdicts = [t.observe("gold", 1000, ok=False, trace=failed)]
    for _ in range(39):
        good = QueryTrace(kind="query", tenant="gold")
        good.finish("SUCCESS")
        verdicts.append(t.observe("gold", 1000, ok=True, trace=good))
    trips = [v for v in verdicts if v is not None]
    assert len(trips) == 1 and trips[0]["windows"] == ("fast", "slow")
    dumps = [(r, d) for (r, d) in get_recorder().dumps if r == "SLO_BURN"]
    assert len(dumps) == before + 1 and dumps[-1][1] is failed


def test_burn_sentinel_min_samples_floor():
    t = slo.SLOTracker(window=64)
    t.register(slo.SLOSpec("a", 0.95, 0.0, 0.999))
    for _ in range(8):
        assert t.observe("a", 1000, ok=False) is None


# ---------------------------------------------------------------------------
# through the port's proxy and pool
# ---------------------------------------------------------------------------

def test_tenant_threads_query_trace_and_metrics(world, monkeypatch):
    monkeypatch.setattr(Global, "enable_tracing", True)
    m = get_registry().counter("wukong_queries_total",
                               labels=("status", "tenant"))
    before = m.value(status="SUCCESS", tenant="gold")
    q = world["proxy"].serve_query(Q_CHAIN, blind=True, tenant="gold")
    assert q.result.status_code == ErrorCode.SUCCESS and q.tenant == "gold"
    [tr] = get_recorder().last(1)
    assert tr.tenant == "gold" and tr.to_dict()["tenant"] == "gold"
    assert m.value(status="SUCCESS", tenant="gold") == before + 1
    assert slo.get_slo().compliance("gold")["samples"] == 1


def test_default_tenant_path(world):
    q = world["proxy"].run_single_query(Q_CHAIN, device="cpu", blind=True)
    assert q.result.status_code == ErrorCode.SUCCESS
    assert q.tenant == "default"
    assert slo.get_slo().compliance("default")["samples"] >= 1


def test_parse_error_still_reaches_tenant_accounting(world):
    with pytest.raises(WukongError):
        world["proxy"].serve_query("SELECT ?x WHERE { broken",
                                   tenant="gold")
    c = slo.get_slo().compliance("gold")
    assert c is not None and c["errors"] == 1
    assert slo.get_overload().report()["tenants"]["gold"]["inflight"] == 0


def test_repeats_validation_does_not_leak_inflight(world):
    with pytest.raises(WukongError):
        world["proxy"].run_single_query(Q_CHAIN, repeats=0, tenant="leaky")
    assert "leaky" not in slo.get_overload().report()["tenants"]


def _planned(world):
    q = Parser(world["ss"]).parse(Q_CHAIN)
    heuristic_plan(q)
    q.result.blind = True
    return q


def test_pool_queue_delay_utilization_and_shed(world):
    from wukong_tpu_torch.runtime.scheduler import _pool_utilization

    m = get_registry().counter("wukong_shed_total",
                               labels=("cause", "tenant"))
    before = m.value(cause="queue_deadline", tenant="gold")
    pool = EnginePool(num_engines=2, make_engine=lambda tid: CPUEngine(
        world["g"], world["ss"]))
    pool.start()
    try:
        out = pool.wait(pool.submit(_planned(world)), timeout=60)
        assert out.result.status_code == ErrorCode.SUCCESS
        lanes = slo.get_overload().lane_delay_series()
        assert lanes[("default",)] > 0
        assert 0.0 <= _pool_utilization() <= 1.0
        assert slo.read_admission_input("lane_depth")["default"] == 0
        q = _planned(world)
        q.tenant = "gold"
        q.deadline = Deadline(timeout_ms=1)
        time.sleep(0.02)  # expire in the queue
        assert isinstance(pool.wait(pool.submit(q), timeout=60),
                          QueryTimeout)
        assert m.value(cause="queue_deadline", tenant="gold") == before + 1
    finally:
        pool.stop()


def test_off_knob_touches_nothing(world, monkeypatch):
    monkeypatch.setattr(Global, "enable_tenant_accounting", False)
    q = world["proxy"].serve_query(Q_CHAIN, blind=True, tenant="ghost")
    assert q.result.status_code == ErrorCode.SUCCESS and q.tenant == "ghost"
    assert slo.get_slo().compliance("ghost") is None
    assert "ghost" not in slo.get_overload().report()["tenants"]
    assert slo.get_overload().lane_delay_series() == {}


def test_console_slo_verb_and_tenant_flag(world, tmp_path, capsys):
    from wukong_tpu_torch.runtime.console import Console

    qf = tmp_path / "q.sparql"
    qf.write_text(Q_CHAIN)
    con = Console(world["proxy"])
    con.run_command(f"sparql -f {qf} -d cpu -t acme")
    assert slo.get_slo().compliance("acme")["samples"] == 1
    con.run_command("slo -k 4")
    out = capsys.readouterr().out
    assert "wukong-slo" in out and "acme" in out
    con.run_command("slo -j")
    assert '"tenants"' in capsys.readouterr().out

