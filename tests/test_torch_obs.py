"""The port's tracing, flight recorder, event journal and exporters
(device="cpu": every kernel's plain version) against the JAX package's
obs/ on the same inputs, mirroring tests/test_obs.py's trace, recorder and
event cases.

- Spans nest and summarize alike; ``chrome_trace_events`` of the same spans
  under a fixed clock is equal; ``maybe_start_trace`` follows its knobs.
- A traced query has the JAX span set with neutral names (``gpu.execute``,
  ``gpu.chain``, ``gpu.host_step``), and the host steps' ``rows_in`` and
  ``rows_out`` equal the JAX engine's; a query through the engine pool has
  a ``pool.queue`` span closed on every exit from the queue.
- The recorder's ring, its dumps on QUERY_TIMEOUT and past
  ``trace_slow_ms``, its dump-directory pruning; the journal's render under
  a fixed clock equals the JAX one; fault and breaker events reach the
  trace and the journal.
- Spans hold no tensor: every attribute of every span of a traced chain, a
  traced fused group and a traced heavy dispatch is a host scalar.
- ``device_trace`` writes a Chrome trace, refuses a nested capture and a
  capture with kernel launches but no kernel, and
  ``maybe_device_trace`` follows ``xprof_dir``.
"""

import itertools
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from wukong_tpu.config import Global as JGlobal
from wukong_tpu.engine.cpu import CPUEngine as JCPUEngine
from wukong_tpu.engine.tpu import TPUEngine
from wukong_tpu.loader.lubm import VirtualLubmStrings as JStrings
from wukong_tpu.loader.lubm import generate_lubm as jgen
from wukong_tpu.loader.lubm import generate_lubm_attrs as jgen_attrs
from wukong_tpu.obs import events as jevents
from wukong_tpu.obs import export as jexport
from wukong_tpu.obs import trace as jtrace
from wukong_tpu.obs.recorder import FlightRecorder as JFlightRecorder
from wukong_tpu.runtime.proxy import Proxy as JProxy
from wukong_tpu.runtime.resilience import CircuitBreaker as JBreaker
from wukong_tpu.store.gstore import build_partition as jbuild
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.engine.cpu import CPUEngine
from wukong_tpu_torch.loader.lubm import (
    VirtualLubmStrings,
    generate_lubm,
    generate_lubm_attrs,
)
from wukong_tpu_torch.obs import events, export, get_recorder, get_registry
from wukong_tpu_torch.obs import trace as ptrace
from wukong_tpu_torch.obs.recorder import FlightRecorder
from wukong_tpu_torch.runtime import faults
from wukong_tpu_torch.runtime.faults import FaultPlan, FaultSpec, TransientFault
from wukong_tpu_torch.runtime.proxy import Proxy
from wukong_tpu_torch.runtime.resilience import CircuitBreaker, Deadline
from wukong_tpu_torch.runtime.scheduler import EnginePool
from wukong_tpu_torch.sparql.parser import Parser
from wukong_tpu_torch.store.gstore import build_partition
from wukong_tpu_torch.utils.errors import ErrorCode, WukongError

torch.set_num_threads(2)

PREFIX = chip_smoke.PREFIX
Q_CHAIN = PREFIX + """SELECT ?X ?Y WHERE {
    ?X ub:memberOf ?Y .
    ?Y ub:subOrganizationOf ?Z .
}"""
# a device prefix, then an attribute step on the host
Q_HOST_STEP = chip_smoke.EXT_QUERIES["x_attr"]
HOST = (int, float, str, bool, type(None))


@pytest.fixture(scope="module")
def world():
    jt, _ = jgen(1, seed=42)
    jg = jbuild(jt, 0, 1, attr_triples=jgen_attrs(1, seed=42))
    jss = JStrings(1, seed=42)
    pt, _ = generate_lubm(1, seed=42)
    g = build_partition(pt, 0, 1, attr_triples=generate_lubm_attrs(1, seed=42))
    ss = VirtualLubmStrings(1, seed=42)
    jproxy = JProxy(jg, jss, cpu_engine=JCPUEngine(jg, jss),
                    tpu_engine=TPUEngine(jg, jss))
    return {"jproxy": jproxy, "proxy": Proxy(g, ss, device="cpu"),
            "g": g, "ss": ss}


@pytest.fixture(autouse=True)
def _hygiene(monkeypatch):
    """Each test opts into tracing; the recorders and journals start empty
    and no fault plan leaks (both packages)."""
    from wukong_tpu.obs import get_recorder as jget_recorder
    from wukong_tpu.runtime import faults as jfaults

    for G in (Global, JGlobal):
        monkeypatch.setattr(G, "enable_tracing", False)
        monkeypatch.setattr(G, "trace_sample_every", 1)
        monkeypatch.setattr(G, "trace_dump_dir", "")
        monkeypatch.setattr(G, "enable_planner", False)
    monkeypatch.setattr(JGlobal, "join_strategy", "walk")
    for rec in (get_recorder(), jget_recorder()):
        rec.clear()
    for j in (events.get_journal(), jevents.get_journal()):
        j.clear()
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def _fixed_clock(monkeypatch, *modules):
    """The same deterministic microsecond clock in every module given, and
    fresh trace-id sequences in both packages."""
    ticks = {}
    for m in modules:
        seq = itertools.count(1_000_000, 7)
        ticks[m] = seq
        monkeypatch.setattr(m, "get_usec", lambda s=seq: next(s))
    monkeypatch.setattr(ptrace, "_trace_seq", itertools.count(1))
    monkeypatch.setattr(jtrace, "_trace_seq", itertools.count(1))


def _build_spans(mod):
    tr = mod.QueryTrace(kind="query", text="q")
    with tr.span("a", n=1):
        with tr.span("b", step=1):
            tr.event("ev", k=2)
        tr.event("ev2")
    tr.event("orphan", x="y")  # no open span: a zero-length span
    tr.finish()
    return tr


# ---------------------------------------------------------------------------
# spans, sampling, Chrome export
# ---------------------------------------------------------------------------

def test_spans_nest_summarize_and_export_like_jax(monkeypatch):
    _fixed_clock(monkeypatch, ptrace, jtrace)
    tr, jtr = _build_spans(ptrace), _build_spans(jtrace)
    assert [(s.name, s.depth) for s in tr.spans] == \
        [(s.name, s.depth) for s in jtr.spans] == \
        [("a", 0), ("b", 1), ("orphan", 0)]
    assert tr.step_summary() == jtr.step_summary()
    assert tr.event_names() == jtr.event_names() == ["ev2", "ev"]
    assert tr.to_dict() == jtr.to_dict()
    pe = export.chrome_trace_events([tr])
    assert pe == jexport.chrome_trace_events([jtr])
    assert any(e["ph"] == "X" and e["name"] == "a" for e in pe)
    assert any(e["ph"] == "i" and e["name"] == "ev" for e in pe)


def test_write_chrome_trace_envelope(tmp_path, monkeypatch):
    _fixed_clock(monkeypatch, ptrace, jtrace)
    a = export.write_chrome_trace(str(tmp_path / "p.json"),
                                  [_build_spans(ptrace)])
    b = jexport.write_chrome_trace(str(tmp_path / "j.json"),
                                   [_build_spans(jtrace)])
    assert json.load(open(a)) == json.load(open(b))


@pytest.mark.parametrize("every", [1, 3, 4])
def test_maybe_start_trace_follows_its_knobs(monkeypatch, every):
    for mod in (ptrace, jtrace):
        monkeypatch.setattr(mod, "_sample_seqs", {})
    assert ptrace.maybe_start_trace() is None  # off: no trace
    for G in (Global, JGlobal):
        monkeypatch.setattr(G, "enable_tracing", True)
        monkeypatch.setattr(G, "trace_sample_every", every)
    got = [ptrace.maybe_start_trace() is not None for _ in range(24)]
    jgot = [jtrace.maybe_start_trace() is not None for _ in range(24)]
    assert got == jgot and sum(got) == 24 // every
    # one sampling sequence per kind: another kind starts its own
    assert ptrace.maybe_start_trace(kind="batch") is not None


# ---------------------------------------------------------------------------
# traced queries through the proxy and the pool
# ---------------------------------------------------------------------------

def _names(tr, rename=False):
    out = [s.name for s in tr.spans]
    return [n.replace("tpu.", "gpu.") for n in out] if rename else out


@pytest.mark.parametrize("text", [Q_CHAIN, Q_HOST_STEP])
def test_traced_query_has_the_jax_span_set(world, monkeypatch, text):
    for G in (Global, JGlobal):
        monkeypatch.setattr(G, "enable_tracing", True)
    q = world["proxy"].run_single_query(text, blind=True)
    jq = world["jproxy"].run_single_query(text, blind=True)
    assert q.result.status_code == jq.result.status_code == 0
    tr, jtr = get_recorder().last(1)[0], q.trace
    assert tr is jtr and tr.status == "SUCCESS"
    from wukong_tpu.obs import get_recorder as jget_recorder

    jtr = jget_recorder().last(1)[0]
    assert _names(tr) == _names(jtr, rename=True)
    assert {"proxy.parse", "proxy.plan", "gpu.execute", "gpu.chain"} \
        <= set(_names(tr))
    steps = [(s.attrs["step"], s.attrs["rows_in"], s.attrs["rows_out"])
             for s in tr.spans if s.name == "gpu.host_step"]
    jsteps = [(s.attrs["step"], s.attrs["rows_in"], s.attrs["rows_out"])
              for s in jtr.spans if s.name == "tpu.host_step"]
    assert steps == jsteps
    assert (len(steps) > 0) == (text == Q_HOST_STEP)
    chain = next(s for s in tr.spans if s.name == "gpu.chain")
    assert chain.attrs["attempts"] >= 1
    assert chain.attrs["dispatches"] == \
        chain.attrs["attempts"] * chain.attrs["steps"]
    assert get_registry().counter(
        "wukong_queries_total", labels=("status", "tenant")).value(
            status="SUCCESS", tenant="default") >= 1


def test_host_engine_steps_match_jax(world, monkeypatch):
    for G in (Global, JGlobal):
        monkeypatch.setattr(G, "enable_tracing", True)
    q = world["proxy"].run_single_query(Q_CHAIN, blind=True, device="cpu")
    jq = world["jproxy"].run_single_query(Q_CHAIN, blind=True, device="cpu")
    steps = [(s.attrs["step"], s.attrs["rows_in"], s.attrs["rows_out"])
             for s in q.trace.spans if s.name == "cpu.step"]
    jsteps = [(s.attrs["step"], s.attrs["rows_in"], s.attrs["rows_out"])
              for s in jq.trace.spans if s.name == "cpu.step"]
    assert steps == jsteps and len(steps) == 3  # one span a BGP step
    assert steps[-1][2] == q.result.nrows == jq.result.nrows


def _planned(world, text=Q_CHAIN):
    from wukong_tpu_torch.planner.heuristic import heuristic_plan

    q = Parser(world["ss"]).parse(text)
    heuristic_plan(q)
    q.result.blind = True
    q.trace = ptrace.QueryTrace(kind="query")
    return q


def test_pool_queue_span_closes_when_popped(world):
    pool = EnginePool(num_engines=2, make_engine=lambda tid: CPUEngine(
        world["g"], world["ss"]))
    pool.start()
    try:
        q = _planned(world)
        out = pool.wait(pool.submit(q), timeout=60)
        assert out.result.status_code == ErrorCode.SUCCESS
        qs = [s for s in q.trace.spans if s.name == "pool.queue"]
        assert len(qs) == 1 and qs[0].t1_us is not None
        assert "engine" in qs[0].attrs  # closed by the popping engine
        assert "cpu.execute" in _names(q.trace)
        assert getattr(q, "_obs_queue_span") is None
    finally:
        pool.stop()


def test_pool_queue_span_closes_on_shed_and_dead_pool(world):
    pool = EnginePool(num_engines=2, make_engine=lambda tid: CPUEngine(
        world["g"], world["ss"]))
    pool.start()
    try:  # shed: the deadline expired in the queue
        q = _planned(world)
        q.deadline = Deadline(timeout_ms=1, clock=lambda: 0.0)
        q.deadline._expires_at = -1.0
        out = pool.wait(pool.submit(q), timeout=60)
        assert isinstance(out, Exception)
        [qs] = [s for s in q.trace.spans if s.name == "pool.queue"]
        assert qs.t1_us is not None and "engine" in qs.attrs
    finally:
        pool.stop()
    dead = EnginePool(num_engines=2, make_engine=None)
    dead._dead = [True, True]
    q = _planned(world)
    out = dead.wait(dead.submit(q), timeout=10)
    assert isinstance(out, RuntimeError)
    [qs] = [s for s in q.trace.spans if s.name == "pool.queue"]
    assert qs.t1_us is not None and qs.attrs["dead_pool"] is True


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", ["port", "jax"])
def test_flight_recorder_ring_is_bounded_and_searchable(mod):
    FR, QT = ((FlightRecorder, ptrace.QueryTrace) if mod == "port"
              else (JFlightRecorder, jtrace.QueryTrace))
    rec = FR(capacity=4)
    for i in range(8):
        rec.on_complete(QT(kind="query", qid=100 + i))
    assert len(rec.last()) == 4
    assert rec.find(107) is not None
    assert rec.find(rec.last(1)[0].trace_id) is not None
    assert rec.find(100) is None


def test_flight_recorder_dumps_on_timeout(world, monkeypatch, tmp_path):
    """A deadline-expired query dumps its trace: in memory and as a JSON
    file in trace_dump_dir; the dump journals a trace.dump event."""
    import wukong_tpu_torch.runtime.proxy as proxy_mod

    monkeypatch.setattr(Global, "enable_tracing", True)
    monkeypatch.setattr(Global, "trace_dump_dir", str(tmp_path))

    class _Clock:  # expires after the first engine-side check
        def __init__(self):
            self.t = 0.0

        def __call__(self):
            self.t += 0.6
            return self.t

    monkeypatch.setattr(
        proxy_mod.Deadline, "from_config",
        classmethod(lambda cls: Deadline(timeout_ms=1, clock=_Clock())))
    q = world["proxy"].run_single_query(Q_CHAIN, device="cpu", blind=True)
    assert q.result.status_code == ErrorCode.QUERY_TIMEOUT
    assert [r for r, _t in get_recorder().dumps] == ["QUERY_TIMEOUT"]
    [name] = os.listdir(tmp_path)
    dump = json.load(open(tmp_path / name))
    assert name.startswith("trace_") and dump["reason"] == "QUERY_TIMEOUT"
    assert any(s["name"] == "cpu.execute" for s in dump["spans"])
    assert dump["event_id"] == get_recorder().dump_meta[-1]["event_id"]
    assert events.get_journal().counts() == {"trace.dump": 1}


@pytest.mark.parametrize("mod", ["port", "jax"])
def test_flight_recorder_slow_query_threshold(monkeypatch, mod):
    FR, QT, G = ((FlightRecorder, ptrace.QueryTrace, Global)
                 if mod == "port"
                 else (JFlightRecorder, jtrace.QueryTrace, JGlobal))
    monkeypatch.setattr(G, "trace_slow_ms", 0)  # threshold off
    rec = FR(capacity=8)
    rec.on_complete(QT(kind="query"), ErrorCode.SUCCESS)
    assert not rec.dumps
    monkeypatch.setattr(G, "trace_slow_ms", 1)
    slow = QT(kind="query")
    slow.t0_us -= 5_000  # pretend it ran 5 ms
    rec.on_complete(slow, ErrorCode.SUCCESS)
    assert [r for r, _t in rec.dumps] == ["SLOW_QUERY"]


def test_dump_dir_keeps_the_newest(monkeypatch, tmp_path):
    monkeypatch.setattr(Global, "trace_dump_dir", str(tmp_path))
    monkeypatch.setattr(Global, "trace_dump_max", 3)
    rec = FlightRecorder(capacity=8)
    for i in range(5):
        tr = ptrace.QueryTrace(kind="query", qid=i)
        rec.dump(tr, "SLOW_QUERY")
        os.utime(tmp_path / f"trace_{tr.trace_id}.json", (i, i))
    assert len(os.listdir(tmp_path)) == 3


def test_parse_failure_still_reaches_reply_observability(world, monkeypatch):
    monkeypatch.setattr(Global, "enable_tracing", True)
    with pytest.raises(WukongError):
        world["proxy"].run_single_query("SELECT ?x WHERE { broken")
    [tr] = get_recorder().last(1)
    assert tr.status == "SYNTAX_ERROR"
    assert get_registry().counter(
        "wukong_queries_total", labels=("status", "tenant")).value(
            status="SYNTAX_ERROR", tenant="default") >= 1


def test_tracing_off_leaves_query_untouched(world):
    q = world["proxy"].run_single_query(Q_CHAIN, blind=True)
    assert q.result.status_code == ErrorCode.SUCCESS
    assert getattr(q, "trace", None) is None
    assert get_recorder().last() == []


# ---------------------------------------------------------------------------
# fault and breaker events, the journal
# ---------------------------------------------------------------------------

def test_fault_event_appears_in_trace(world, monkeypatch):
    monkeypatch.setattr(Global, "enable_tracing", True)
    faults.install(FaultPlan([FaultSpec("proxy.serve", "transient",
                                        count=1)], seed=0))
    with pytest.raises(TransientFault):
        world["proxy"].serve_query(Q_CHAIN, blind=True)
    [tr] = get_recorder().last(1)
    assert tr.status == "ERROR"
    assert [s.name for s in tr.spans if s.name == "fault.injected"] == \
        ["fault.injected"]
    assert get_registry().counter(
        "wukong_faults_injected_total", labels=("site", "kind")).value(
            site="proxy.serve", kind="transient") >= 1


def _breaker_events(Breaker, mod, journal):
    clock = [0.0]
    br = Breaker(threshold=2, cooldown_ms=1000, clock=lambda: clock[0])
    tr = mod.QueryTrace(kind="query")
    with mod.activate(tr), tr.span("batch.dispatch"):
        br.record_failure(0)
        br.record_failure(0)  # trips
        clock[0] = 2.0  # past the cooldown: the half-open trial
        assert br.allow(0)
        br.record_success(0)  # closes
    return tr.event_names(), [(e.kind, e.shard) for e in journal.last()]


def test_breaker_trip_and_close_reach_trace_and_journal():
    got = _breaker_events(CircuitBreaker, ptrace, events.get_journal())
    want = _breaker_events(JBreaker, jtrace, jevents.get_journal())
    assert got == want
    assert got[0] == ["breaker.trip", "breaker.close"]
    assert got[1] == [("breaker.trip", 0), ("breaker.close", 0)]


def _journal_run(mod, tmp_path, tag):
    j = mod.EventJournal(capacity=16, log_path=str(tmp_path / f"{tag}.jsonl"))
    for i in range(20):
        j.emit("slo.burn" if i % 3 else "shard.migrate.start",
               shard=i % 2 if i % 4 else None, tenant=f"t{i % 3}", qid=i,
               n=i)
    j.close()
    return j


def test_event_journal_matches_jax(monkeypatch, tmp_path):
    _fixed_clock(monkeypatch, events, jevents)
    pj, jj = _journal_run(events, tmp_path, "p"), _journal_run(
        jevents, tmp_path, "j")
    assert [e.to_dict() for e in pj.last()] == \
        [e.to_dict() for e in jj.last()]
    assert len(pj.last()) == 16  # bounded ring
    assert pj.counts() == jj.counts()
    assert [e.event_id for e in pj.last(kind="migrate")] == \
        [e.event_id for e in jj.last(kind="migrate")]
    assert [e.event_id for e in pj.last(shard=1)] == \
        [e.event_id for e in jj.last(shard=1)]
    assert pj.find("ev00000020").qid == 19
    # the JSONL mirror holds every event, the ring's evicted ones too
    assert open(tmp_path / "p.jsonl").read() == \
        open(tmp_path / "j.jsonl").read()
    assert len(open(tmp_path / "p.jsonl").read().splitlines()) == 20


def test_render_events_matches_jax(monkeypatch):
    _fixed_clock(monkeypatch, events, jevents)
    for mod in (events, jevents):
        monkeypatch.setattr(mod.get_journal(), "_seq", itertools.count(1))
    for mod in (events, jevents):
        for i in range(6):
            mod.emit_event("breaker.trip" if i % 2 else "slo.burn",
                           shard=i if i % 2 else None, tenant="gold", x=i)
    for kw in ({}, {"kind": "breaker"}, {"shard": 3}, {"k": 2}):
        assert events.render_events(**kw) == jevents.render_events(**kw)
    monkeypatch.setattr(Global, "enable_events", False)
    assert events.emit_event("slo.burn") is None


# ---------------------------------------------------------------------------
# spans hold no tensor
# ---------------------------------------------------------------------------

def _assert_host_attrs(traces):
    n = 0
    for tr in traces:
        for sp in tr.spans:
            for k, v in sp.attrs.items():
                assert isinstance(v, HOST) and not isinstance(
                    v, np.generic), (sp.name, k, type(v))
                n += 1
            for (_t, _name, attrs) in sp.events:
                for k, v in attrs.items():
                    assert isinstance(v, HOST), (sp.name, k, type(v))
        json.dumps(tr.to_dict())
    return n


def test_spans_hold_no_tensor(world, monkeypatch):
    """A traced chain, a traced fused group and a traced heavy dispatch on
    device="cpu": every span and event attribute is an int, float, str,
    bool or None (no tensor, no numpy scalar), and every trace is JSON."""
    from wukong_tpu_torch.runtime.batcher import (
        FusedGroup,
        HeavyGroup,
        QueryBatcher,
        _Pending,
    )

    monkeypatch.setattr(Global, "enable_tracing", True)
    proxy = world["proxy"]
    q = proxy.serve_query(Q_HOST_STEP, blind=False)
    traces = [q.trace]
    light, heavy = chip_smoke.live_texts(proxy)

    def planned(text, blind):
        tr = ptrace.maybe_start_trace(kind="query", text=text)
        return proxy._prepare(text, blind, None, "default", tr, None)

    batcher = QueryBatcher(proxy.cpu, proxy.gpu,
                           suggest_heavy_b=proxy.heavy_index_batch)
    try:
        members = [_Pending(planned(t, False)) for t in light[:8]]
        FusedGroup(members, batcher, engine=proxy.gpu, reason="t").run(None)
        hmembers = [_Pending(planned(heavy[0], True)) for _ in range(3)]
        HeavyGroup(hmembers, batcher, engine=proxy.gpu, reason="t").run(None)
    finally:
        batcher.close()
    for m in members + hmembers:
        assert m.q.result.status_code == 0
        assert "batch.settled" in {n for s in m.trace.spans
                                   for n in [s.name] + [e[1]
                                                        for e in s.events]}
        traces.append(m.trace)
    groups = [t for t in get_recorder().last() if t.kind == "batch"]
    assert len(groups) == 2
    assert {"batch.dispatch", "gpu.execute", "gpu.chain"} <= \
        set(_names(groups[0]))
    assert _assert_host_attrs(traces + groups) > 20


# ---------------------------------------------------------------------------
# the device trace
# ---------------------------------------------------------------------------

def test_device_trace_writes_a_chrome_trace(world, tmp_path, monkeypatch):
    monkeypatch.setattr(Global, "xprof_dir", str(tmp_path))
    q = world["proxy"].run_single_query(Q_CHAIN, blind=True)
    assert q.result.status_code == 0
    path = export.last_capture
    assert path is not None and os.path.dirname(path) == str(tmp_path)
    evs = json.load(open(path))["traceEvents"]
    assert any(e.get("ph") == "X" for e in evs)
    # on the CPU no kernel runs: the summary is empty, not an error
    assert export.kernel_summary(path) == []
    with export.device_trace(str(tmp_path)):
        with pytest.raises(RuntimeError, match="already being captured"):
            with export.device_trace(str(tmp_path)):
                pass


def test_maybe_device_trace_follows_xprof_dir(monkeypatch, tmp_path):
    import contextlib

    monkeypatch.delenv("WUKONG_XPROF_DIR", raising=False)
    assert isinstance(export.maybe_device_trace(),
                      contextlib.nullcontext)
    monkeypatch.setenv("WUKONG_XPROF_DIR", str(tmp_path))
    assert not isinstance(export.maybe_device_trace(),
                          contextlib.nullcontext)


def test_kernel_summary_reads_kernel_events(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "probe_kernel", "dur": 3.0},
        {"ph": "X", "cat": "kernel", "name": "probe_kernel", "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": "sort", "dur": 9.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 99.0}]}))
    assert export.kernel_summary(str(path)) == [
        {"name": "sort", "calls": 1, "total_us": 9.0, "max_us": 9.0},
        {"name": "probe_kernel", "calls": 2, "total_us": 8.0,
         "max_us": 5.0}]


@pytest.mark.parametrize("events, hand, faulty", [
    ([], 0, False),  # a block on the CPU: no launch, no kernel
    ([], 3, True),  # hand-written kernels launched, none recorded
    ([{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel"}], 0,
     True),  # torch's kernels only (q6): launch calls, no kernel event
    ([{"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernelEx"}], 0,
     True),
    ([{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel"},
      {"ph": "X", "cat": "kernel", "name": "sort", "dur": 9.0}], 2, False),
    ([{"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync"}], 0,
     False),
])
def test_check_capture_refuses_a_capture_without_kernels(tmp_path, events,
                                                         hand, faulty):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    if faulty:
        with pytest.raises(RuntimeError, match="holds no CUDA kernel"):
            export.check_capture(str(path), hand)
    else:
        export.check_capture(str(path), hand)


@pytest.mark.parametrize("kv, ok", [
    ({"status": "SUCCESS", "tenant": "gold"}, True),
    ({"tenant": "gold", "status": "SUCCESS"}, True),  # any order
    ({"status": "SUCCESS"}, False),  # a label missing
    ({"status": "SUCCESS", "tenant": "gold", "x": "1"}, False),  # extra
    ({"status": "SUCCESS", "lane": "gold"}, False),  # a wrong name
])
def test_metric_labels_find_one_series_or_raise(kv, ok):
    from wukong_tpu_torch.obs.metrics import MetricsRegistry

    fam = MetricsRegistry().counter("wukong_t_total", "t",
                                    labels=("status", "tenant"))
    if not ok:
        with pytest.raises(ValueError, match="expected labels"):
            fam.labels(**kv)
        return
    ch = fam.labels(**kv)
    ch.inc()
    assert fam.labels(status="SUCCESS", tenant="gold") is ch
    assert fam.value(status="SUCCESS", tenant="gold") == 1.0
