"""The port's serving-path micro-batching (runtime/batcher.py, device="cpu":
every kernel's plain version) against its own sequential path and the JAX
package's batcher, on LUBM-1 (seed 42, with attributes).

Mirrors tests/test_batcher.py: fused replies equal sequential ones byte for
byte and the JAX batcher's replies; groups flush on size, window and idle;
a tight deadline, a row budget, a device pin and an incompatible shape
bypass; ``fused_key`` groups only one template; a member's deadline or
budget degrades only that member; a failed fused dispatch re-runs its
members one at a time on the same (GPU) engine; the breaker opens after
repeated fused failures; the pool's batch lane runs a group whole; and
``batchable``, ``fused_key``, ``heavy_batchable`` and ``classify_lane``
answer as the JAX ones on all 19 shapes of chip_smoke's suites; each
batching knob has the JAX default and loads through ``config -s`` as the
JAX reload does.

Every wait carries its own timeout; the window tests hold the batcher's
in-flight count, so groups form deterministically.
"""

import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
from wukong_tpu.config import Global as JGlobal
from wukong_tpu.config import reload_config as jreload
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
from wukong_tpu_torch.loader import lubm as plubm
from wukong_tpu_torch.obs import get_registry
from wukong_tpu_torch.planner.optimizer import Planner
from wukong_tpu_torch.planner.stats import Stats
from wukong_tpu_torch.runtime.batcher import (
    FusedGroup,
    QueryBatcher,
    _Pending,
    batchable,
    fused_key,
    heavy_batchable,
    heavy_key,
    template_signature,
)
from wukong_tpu_torch.runtime.console import Console
from wukong_tpu_torch.runtime.proxy import Proxy
from wukong_tpu_torch.runtime.resilience import Deadline
from wukong_tpu_torch.store.gstore import build_partition
from wukong_tpu_torch.types import OUT
from wukong_tpu_torch.utils.errors import ErrorCode

torch.set_num_threads(2)

UB = plubm.UB
WAIT_S = 60  # every join and future wait in this file is bounded by this
SHAPES = {**chip_smoke.QUERIES, **chip_smoke.EXT_QUERIES}


@pytest.fixture(autouse=True, scope="module")
def _lockdep_checked():
    """The port's batcher condition, group and pool-lane locks feed the
    lockdep graph on every test; teardown asserts no cycle and no leaf
    inversion."""
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
    jg = jbuild(jt, 0, 1, attr_triples=jlubm.generate_lubm_attrs(1, seed=42))
    js = jlubm.VirtualLubmStrings(1, seed=42)
    jstats = JStats.generate(jt)
    jproxy = JProxy(jg, js, JCPUEngine(jg, js),
                    TPUEngine(jg, js, stats=jstats), planner=JPlanner(jstats))
    pt, _ = plubm.generate_lubm(1, seed=42)
    g = build_partition(pt, 0, 1,
                        attr_triples=plubm.generate_lubm_attrs(1, seed=42))
    ss = plubm.VirtualLubmStrings(1, seed=42)
    proxy = Proxy(g, ss, device="cpu", planner=Planner(Stats.generate(pt)))
    yield {"g": g, "ss": ss, "proxy": proxy, "jproxy": jproxy}
    if proxy._pool is not None:
        proxy._pool.stop()
    proxy.batcher().close()
    if jproxy._pool is not None:
        jproxy._pool.stop()
    if jproxy._batcher is not None:
        jproxy._batcher.close()


@pytest.fixture(autouse=True)
def _batching_off(monkeypatch):
    """Every test starts and ends with batching off in both packages."""
    for G in (Global, JGlobal):
        monkeypatch.setattr(G, "enable_batching", False)
    yield


def _set(monkeypatch, **knobs):
    for G in (Global, JGlobal):
        for k, v in knobs.items():
            monkeypatch.setattr(G, k, v)


def _texts(world, n=6, shape="chain"):
    """Same-template texts differing only in the start constant."""
    ss, g = world["ss"], world["g"]
    pid = ss.str2id(f"<{UB}memberOf>")
    out = []
    for d in np.asarray(g.get_index(pid, OUT))[:n]:
        dept = ss.id2str(int(d))
        if shape == "const":
            out.append(f"SELECT ?s WHERE {{ ?s <{UB}memberOf> {dept} . }}")
        elif shape == "chain":
            out.append(f"SELECT ?s ?c WHERE {{ ?s <{UB}memberOf> {dept} . "
                       f"?s <{UB}takesCourse> ?c . }}")
        else:
            out.append(f"SELECT ?s ?c WHERE {{ ?s <{UB}memberOf> {dept} . "
                       f"?s <{UB}takesCourse> ?c . FILTER (?s != ?c) }}")
    return out


def _planned(proxy, text, blind=True, deadline=None):
    """A parsed and planned query, as the serving path prepares it."""
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


def _hold_inflight(bt):
    """Pretend a dispatch runs, so offers accumulate instead of
    idle-flushing — the deterministic stand-in for concurrent load."""
    with bt._lock:
        bt._inflight += 1


def _release_inflight(bt):
    with bt._lock:
        bt._inflight = max(bt._inflight - 1, 0)


def _quiesce(bt):
    """Wait (bounded) until no dispatch is in flight and no group is open:
    a dispatch settles its waiters before it leaves the in-flight count."""
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        with bt._lock:
            if bt._inflight == 0 and not bt._groups:
                return
        time.sleep(0.01)
    raise AssertionError("the batcher never went idle")


# ---------------------------------------------------------------------------
# result fidelity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["const", "chain", "filter"])
def test_batched_byte_identical_to_sequential_and_to_jax(
        world, monkeypatch, shape):
    proxy, jproxy = world["proxy"], world["jproxy"]
    texts = _texts(world, n=6, shape=shape)
    seq = [proxy.serve_query(t, blind=False) for t in texts]
    assert all(q.result.status_code == ErrorCode.SUCCESS for q in seq)
    assert any(q.result.nrows for q in seq)

    _set(monkeypatch, enable_batching=True, batch_window_us=30_000_000)
    fused0 = _counter("wukong_batch_fused_queries_total")
    # one group of all six, formed deterministically behind a held dispatch
    bt = proxy.batcher()
    _hold_inflight(bt)
    try:
        pends = [bt.offer(_planned(proxy, t, blind=False)) for t in texts]
        assert all(p is not None for p in pends)
        bt.flush()
        grouped = [p.wait(WAIT_S) for p in pends]
    finally:
        _release_inflight(bt)
    assert _counter("wukong_batch_fused_queries_total") == fused0 + 6
    # and through serve_query from concurrent clients, however they group
    _set(monkeypatch, batch_window_us=100_000)
    live = _concurrent(lambda i: proxy.serve_query(texts[i], blind=False),
                       len(texts))
    jlive = _concurrent(lambda i: jproxy.serve_query(texts[i], blind=False),
                        len(texts))
    for i, want in enumerate(seq):
        for got in (grouped[i], live[i]):
            assert got.result.status_code == ErrorCode.SUCCESS
            assert np.array_equal(np.asarray(got.result.table),
                                  np.asarray(want.result.table)), i
            assert got.result.v2c_map == want.result.v2c_map
        j = jlive[i].result
        assert j.status_code == ErrorCode.SUCCESS
        assert np.array_equal(np.asarray(j.table),
                              np.asarray(want.result.table)), i
        assert j.v2c_map == want.result.v2c_map


# ---------------------------------------------------------------------------
# coalescing mechanics: flush reasons, bypasses
# ---------------------------------------------------------------------------

def test_flush_on_size(world, monkeypatch):
    proxy = world["proxy"]
    _set(monkeypatch, enable_batching=True, batch_window_us=10_000_000,
         batch_max_size=4)
    bt = proxy.batcher()
    _hold_inflight(bt)
    try:
        before = _counter("wukong_batch_flush_total", reason="size")
        pends = [bt.offer(_planned(proxy, t))
                 for t in _texts(world, n=4, shape="chain")]
        assert all(p is not None for p in pends)
        for p in pends:  # the 4th offer flushed the group at once
            p.wait(WAIT_S)
        assert _counter("wukong_batch_flush_total",
                        reason="size") == before + 1
        assert all(p.q.result.status_code == ErrorCode.SUCCESS
                   for p in pends)
    finally:
        _release_inflight(bt)


def test_flush_on_window(world, monkeypatch):
    proxy = world["proxy"]
    _set(monkeypatch, enable_batching=True, batch_window_us=20_000,
         batch_max_size=64)
    bt = proxy.batcher()
    _hold_inflight(bt)
    try:
        before = _counter("wukong_batch_flush_total", reason="window")
        p = bt.offer(_planned(proxy, _texts(world, n=1)[0]))
        assert p is not None
        p.wait(WAIT_S)  # nobody joined: the window released it
        assert _counter("wukong_batch_flush_total",
                        reason="window") == before + 1
        assert p.q.result.status_code == ErrorCode.SUCCESS
    finally:
        _release_inflight(bt)


def test_idle_flush_skips_window(world, monkeypatch):
    """Nothing executing, nothing queued: a lone query dispatches at once
    (reason idle) instead of waiting out the window."""
    proxy = world["proxy"]
    _set(monkeypatch, enable_batching=True, batch_window_us=30_000_000)
    bt = proxy.batcher()
    _quiesce(bt)
    before = _counter("wukong_batch_flush_total", reason="idle")
    t0 = time.monotonic()
    p = bt.offer(_planned(proxy, _texts(world, n=1)[0]))
    assert p is not None
    p.wait(WAIT_S)
    assert time.monotonic() - t0 < 20  # never saw the 30 s window
    assert _counter("wukong_batch_flush_total", reason="idle") == before + 1
    assert p.q.result.status_code == ErrorCode.SUCCESS


def test_deadline_tight_bypasses(world, monkeypatch):
    proxy = world["proxy"]
    _set(monkeypatch, enable_batching=True, batch_window_us=50_000)
    q = _planned(proxy, _texts(world, n=1)[0],
                 deadline=Deadline(timeout_ms=50))  # < 4 windows left
    before = _counter("wukong_batch_bypass_total", reason="deadline")
    assert proxy.batcher().offer(q) is None
    assert _counter("wukong_batch_bypass_total",
                    reason="deadline") == before + 1


def test_row_budget_bypasses(world, monkeypatch):
    """Per-step row budgets cannot be attributed inside a fused chain."""
    proxy = world["proxy"]
    _set(monkeypatch, enable_batching=True)
    q = _planned(proxy, _texts(world, n=1)[0],
                 deadline=Deadline(budget_rows=100))
    before = _counter("wukong_batch_bypass_total", reason="budget")
    assert proxy.batcher().offer(q) is None
    assert _counter("wukong_batch_bypass_total",
                    reason="budget") == before + 1


def test_device_pin_bypasses_batcher(world, monkeypatch):
    """An explicit device= request is never rerouted onto the batcher's
    engine choice."""
    proxy = world["proxy"]
    _set(monkeypatch, enable_batching=True)
    offered = []
    orig = QueryBatcher.offer

    def spy(self, q):
        offered.append(q)
        return orig(self, q)

    monkeypatch.setattr(QueryBatcher, "offer", spy)
    for device in ("cpu", "gpu"):
        q = proxy.run_single_query(_texts(world, n=1)[0], device=device,
                                   blind=True)
        assert q.result.status_code == ErrorCode.SUCCESS
    assert offered == []  # pinned: never entered the batcher
    proxy.serve_query(_texts(world, n=1)[0], blind=True)
    assert len(offered) == 1  # unpinned: it did


def test_incompatible_shapes_bypass(world, monkeypatch):
    """A non-blind index-origin query fuses in neither lane; through the
    proxy it still answers directly."""
    proxy = world["proxy"]
    _set(monkeypatch, enable_batching=True)
    text = (f"SELECT ?x WHERE {{ ?x <http://www.w3.org/1999/02/"
            f"22-rdf-syntax-ns#type> <{UB}FullProfessor> . }}")
    q = _planned(proxy, text, blind=False)
    assert not batchable(q) and not heavy_batchable(q)
    before = _counter("wukong_batch_bypass_total", reason="shape")
    assert proxy.batcher().offer(q) is None
    assert _counter("wukong_batch_bypass_total", reason="shape") == before + 1
    out = proxy.serve_query(text, blind=False)
    assert out.result.status_code == ErrorCode.SUCCESS
    assert out.result.nrows > 0


def test_fused_key_groups_only_same_template(world):
    proxy = world["proxy"]
    chain = [_planned(proxy, t) for t in _texts(world, n=2, shape="chain")]
    const = [_planned(proxy, t) for t in _texts(world, n=2, shape="const")]
    filt = [_planned(proxy, t) for t in _texts(world, n=2, shape="filter")]
    assert fused_key(chain[0]) == fused_key(chain[1])
    assert fused_key(const[0]) == fused_key(const[1])
    assert fused_key(chain[0]) != fused_key(const[0])
    assert fused_key(chain[0]) != fused_key(filt[0])  # filters differ
    assert template_signature(chain[0]) == template_signature(chain[1])


# ---------------------------------------------------------------------------
# per-member resilience inside a fused dispatch
# ---------------------------------------------------------------------------

def test_member_deadline_degrades_only_that_member(world):
    proxy = world["proxy"]
    texts = _texts(world, n=3, shape="chain")
    t_frozen = [0.0]
    expired = Deadline(timeout_ms=1, clock=lambda: t_frozen[0])
    t_frozen[0] = 10.0  # expired before the flush
    members = [
        _Pending(_planned(proxy, texts[0], blind=False)),
        _Pending(_planned(proxy, texts[1], blind=False, deadline=expired)),
        _Pending(_planned(proxy, texts[2], blind=False)),
    ]
    FusedGroup(members, proxy.batcher(), engine=proxy.gpu).run(None)
    ok0, bad, ok2 = (m.q.result for m in members)
    assert ok0.status_code == ErrorCode.SUCCESS and ok0.nrows > 0
    assert ok2.status_code == ErrorCode.SUCCESS and ok2.nrows > 0
    assert bad.status_code == ErrorCode.QUERY_TIMEOUT
    assert not bad.complete


def test_member_budget_charged_per_member(world):
    """Each member is charged its own rows: the tiny-budget member degrades
    to a partial result, its co-member is untouched."""
    proxy = world["proxy"]
    texts = _texts(world, n=2, shape="chain")
    members = [
        _Pending(_planned(proxy, texts[0], blind=False)),
        _Pending(_planned(proxy, texts[1], blind=False,
                          deadline=Deadline(budget_rows=1))),
    ]
    FusedGroup(members, proxy.batcher(), engine=proxy.gpu).run(None)
    ok, bad = (m.q.result for m in members)
    assert ok.status_code == ErrorCode.SUCCESS and ok.nrows > 0
    assert bad.status_code == ErrorCode.BUDGET_EXCEEDED
    assert not bad.complete


def _exploding(calls):
    def boom(self, live, engine):
        calls.append(len(live))
        raise RuntimeError("chain exploded")
    return boom


def test_fused_failure_falls_back_per_query_on_the_same_engine(
        world, monkeypatch):
    """A failed fused dispatch re-runs its members one at a time on the
    group's engine — the GPU engine, never the host engine — and every
    member gets its own rows."""
    proxy = world["proxy"]
    texts = _texts(world, n=3, shape="chain")
    want = [proxy.serve_query(t, blind=True).result.nrows for t in texts]
    bt = QueryBatcher(proxy.cpu, proxy.gpu)
    ran = []
    gpu_execute = type(proxy.gpu).execute

    def on_gpu(self, q, from_proxy=True):
        ran.append(self)
        return gpu_execute(self, q, from_proxy)

    def on_host(self, q, from_proxy=True):
        raise AssertionError("a member fell back to the host engine")

    try:
        monkeypatch.setattr(FusedGroup, "_run_fused", _exploding([]))
        monkeypatch.setattr(type(proxy.gpu), "execute", on_gpu)
        monkeypatch.setattr(type(proxy.cpu), "execute", on_host)
        before = _counter("wukong_batch_fallback_total",
                          reason="dispatch_error")
        members = [_Pending(_planned(proxy, t)) for t in texts]
        FusedGroup(members, bt, engine=proxy.gpu).run(None)
        assert _counter("wukong_batch_fallback_total",
                        reason="dispatch_error") == before + 1
        assert ran == [proxy.gpu] * 3
        for m, n in zip(members, want):
            assert m.q.result.status_code == ErrorCode.SUCCESS
            assert m.q.result.nrows == n
    finally:
        bt.close()


def test_breaker_opens_after_repeated_fused_failures(world, monkeypatch):
    """Consecutive fused failures open the batch breaker; while open,
    groups go straight to per-query execution."""
    proxy = world["proxy"]
    texts = _texts(world, n=2, shape="chain")
    bt = QueryBatcher(proxy.cpu, proxy.gpu)
    try:
        calls = []
        monkeypatch.setattr(FusedGroup, "_run_fused", _exploding(calls))
        for _ in range(Global.breaker_threshold):
            members = [_Pending(_planned(proxy, t)) for t in texts]
            FusedGroup(members, bt, engine=proxy.gpu).run(None)
        assert len(calls) == Global.breaker_threshold
        assert bt.breaker.state("batch.dispatch") == "open"
        before = _counter("wukong_batch_fallback_total",
                          reason="breaker_open")
        members = [_Pending(_planned(proxy, t)) for t in texts]
        FusedGroup(members, bt, engine=proxy.gpu).run(None)
        assert len(calls) == Global.breaker_threshold  # not attempted
        assert _counter("wukong_batch_fallback_total",
                        reason="breaker_open") == before + 1
        for m in members:  # still served, one at a time
            assert m.q.result.status_code == ErrorCode.SUCCESS
    finally:
        bt.close()


# ---------------------------------------------------------------------------
# the pool's batch lane
# ---------------------------------------------------------------------------

def test_batch_lane_executes_group_as_unit(world):
    proxy = world["proxy"]
    pool = proxy.engine_pool()
    members = [_Pending(_planned(proxy, t))
               for t in _texts(world, n=4, shape="chain")]
    fused0 = _counter("wukong_batch_fused_queries_total")
    lane0 = _counter("wukong_pool_submitted_total", lane="batch")
    group = FusedGroup(members, proxy.batcher(), engine=proxy.gpu)
    assert pool.submit(group, lane="batch") == -1
    for m in members:
        m.wait(WAIT_S)
        assert m.q.result.status_code == ErrorCode.SUCCESS
    assert _counter("wukong_batch_fused_queries_total") == fused0 + 4
    assert _counter("wukong_pool_submitted_total", lane="batch") == lane0 + 1
    # fire-and-forget: no pool completion left for poll() consumers
    assert pool.poll() == []


# ---------------------------------------------------------------------------
# the same answers as the JAX functions on every shape
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SHAPES))
def test_batchable_fused_key_and_lane_match_jax(world, name):
    """``batchable``, ``heavy_batchable``, their group keys and
    ``classify_lane`` answer as the JAX ones on each planned shape (blind
    and not), both packages under their planner."""
    proxy, jproxy = world["proxy"], world["jproxy"]
    for blind in (True, False):
        q = _planned(proxy, SHAPES[name], blind=blind)
        jq = jproxy._parse_text(SHAPES[name])
        jproxy._plan_prepared(jq, blind, None)
        assert batchable(q) == JB.batchable(jq)
        assert heavy_batchable(q) == JB.heavy_batchable(jq)
        assert q.lane == jq.lane == jproxy.classify_lane(jq)
        if q.pattern_group.patterns:
            assert fused_key(q) == JB.fused_key(jq)
            assert heavy_key(q) == JB.heavy_key(jq)


# ---------------------------------------------------------------------------
# the knobs: JAX names, defaults and mutability
# ---------------------------------------------------------------------------

KNOBS = {"enable_batching": "true", "batch_window_us": "750",
         "batch_max_size": "16", "batch_deadline_bypass_factor": "2",
         "heavy_lane": "false", "heavy_split_threshold": "10",
         "heavy_split_max": "3", "heavy_lane_pct": "25",
         "heavy_rows_threshold": "500", "breaker_threshold": "5",
         "breaker_cooldown_ms": "250"}


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_batching_knob_loads_like_jax(world, monkeypatch, knob):
    """Each knob has the JAX default, and the console's ``config -s
    global_<knob>=<v>`` sets it at runtime as the JAX reload does."""
    for G in (Global, JGlobal):
        monkeypatch.setattr(G, knob, getattr(G, knob))
    assert getattr(Global, knob) == getattr(JGlobal, knob)
    Console(world["proxy"]).run_command(f"config -s global_{knob}="
                                        f"{KNOBS[knob]}")
    jreload(f"global_{knob} {KNOBS[knob]}")
    assert getattr(Global, knob) == getattr(JGlobal, knob)
    assert str(getattr(Global, knob)).lower() == KNOBS[knob]
