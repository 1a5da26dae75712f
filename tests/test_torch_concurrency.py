"""The port's device code under concurrent serving threads, without a card
(device="cpu").

- ``DeviceStore`` stages a key once: threads that miss the same segment,
  combined segment, merge segment, index list or const list at the same
  moment wait for one staging, and all get the same entry; stagings of
  different keys overlap (the per-key lock serializes no chain on another
  key); a key two chains pinned stays pinned until both unpin.
- ``cuda_lib.count_launch`` counts exactly under threads, per kernel and
  per thread, and a ``FaultPlan`` spec with ``count=N`` fires N times.
- The planner gives each query its own plan when threads plan at once.
- A multi-tenant scenario (``Emulator.run_tenants``: chaos with tracing
  on, then the overload drill with admission armed and the fair sub-lane,
  through the batcher and the engine pool) runs under the port's lockdep
  checker with no cycle and nothing acquired under a declared leaf: the
  SLO, overload-signal, admission, fair-queue, trace, recorder and journal
  locks stay innermost, and ``FairQueue`` and the heavy pick never call out
  under theirs.

Each test runs more threads than this machine's cores with a shortened
switch interval, so a lost update would show; every wait is bounded.
"""

import sys
import threading
import time

import numpy as np
import pytest

import chip_smoke
from wukong_tpu_torch.engine import cuda_lib
from wukong_tpu_torch.engine.device_store import DeviceStore
from wukong_tpu_torch.loader.lubm import UB, VirtualLubmStrings, generate_lubm
from wukong_tpu_torch.planner.optimizer import Planner
from wukong_tpu_torch.planner.stats import Stats
from wukong_tpu_torch.runtime.faults import FaultPlan, FaultSpec, TransientFault
from wukong_tpu_torch.sparql.parser import Parser
from wukong_tpu_torch.store.gstore import build_partition
from wukong_tpu_torch.types import IN, OUT, TYPE_ID

THREADS = 16
WAIT_S = 60


@pytest.fixture(scope="module")
def world():
    g = build_partition(generate_lubm(1, seed=0)[0], 0, 1)
    return g, VirtualLubmStrings(1, seed=0)


@pytest.fixture
def fast_switch():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def _together(fn, n=THREADS):
    """fn(i) on n threads released at once by a barrier; all joined."""
    go = threading.Barrier(n)
    out, errs = [None] * n, []

    def run(i):
        try:
            go.wait(WAIT_S)
            out[i] = fn(i)
        except BaseException as e:  # reported by the caller's assert
            errs.append(e)

    ths = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in ths), "a thread hung"
    assert not errs, errs
    return out


def _counting(monkeypatch, stager: str):
    """Count (and slow) DeviceStore.<stager> so racing misses overlap."""
    calls = []
    orig = getattr(DeviceStore, stager)

    def slow(self, *a):
        calls.append(threading.get_ident())
        time.sleep(0.05)
        return orig(self, *a)

    monkeypatch.setattr(DeviceStore, stager, slow)
    return calls


def _kinds(g, ss):
    pid = ss.str2id(f"<{UB}memberOf>")
    dept = int(np.asarray(g.get_index(pid, OUT))[0])
    grad = ss.str2id(f"<{UB}GraduateStudent>")
    return {
        "segment": ("_stage", lambda ds: ds.segment(pid, OUT)),
        "combined segment": ("_stage", lambda ds: ds.versatile_segment(OUT)),
        "merge segment": ("_stage_merge",
                          lambda ds: ds.merge_segment(pid, IN)),
        "index list": ("_stage_list", lambda ds: ds.index_list(grad, IN)),
        "const list": ("_stage_list",
                       lambda ds: ds.const_list(pid, OUT, dept)),
        "type index": ("_stage", lambda ds: ds.segment(TYPE_ID, IN)),
    }


@pytest.mark.parametrize("kind", ["segment", "combined segment",
                                  "merge segment", "index list",
                                  "const list", "type index"])
def test_racing_misses_stage_a_key_once(world, monkeypatch, fast_switch,
                                        kind):
    g, ss = world
    stager, stage = _kinds(g, ss)[kind]
    ds = DeviceStore(g, device="cpu")
    calls = _counting(monkeypatch, stager)
    got = _together(lambda i: stage(ds))
    assert len(calls) == 1, f"{kind} staged {len(calls)} times"
    first = got[0]
    assert first is not None
    assert all(x is first for x in got)  # every thread got the one entry
    entry = first[0] if isinstance(first, tuple) else first
    assert ds.bytes_used == (entry.numel() * 4 if isinstance(first, tuple)
                             else first.nbytes)
    assert len(ds._lru) == 1 and not ds._staging


def test_stagings_of_different_keys_overlap(world, monkeypatch):
    """Two keys' stagings run at once: each build waits for the other to
    start, which a store-wide staging lock would deadlock (and time out)."""
    g, ss = world
    both = threading.Barrier(2)
    orig = DeviceStore._stage

    def meeting(self, *a):
        both.wait(WAIT_S)  # BrokenBarrierError if stagings serialize
        return orig(self, *a)

    monkeypatch.setattr(DeviceStore, "_stage", meeting)
    ds = DeviceStore(g, device="cpu")
    pids = [ss.str2id(f"<{UB}memberOf>"), ss.str2id(f"<{UB}takesCourse>")]
    segs = _together(lambda i: ds.segment(pids[i], OUT), n=2)
    assert all(s is not None for s in segs) and segs[0] is not segs[1]


def test_a_key_stays_pinned_while_any_chain_holds_it(world):
    g, ss = world
    pid = ss.str2id(f"<{UB}memberOf>")
    ds = DeviceStore(g, device="cpu")
    seg = ds.segment(pid, OUT)
    ds.pin([(pid, OUT)])
    ds.pin([(pid, OUT)])
    ds.unpin([(pid, OUT)])
    ds.budget = 0  # everything unpinned must go
    ds._enforce_budget()
    assert ds.segment(pid, OUT) is seg  # still pinned by the other chain
    ds.unpin([(pid, OUT)])
    assert not ds._cache and ds.bytes_used == 0


def test_launch_counts_are_exact_under_threads(fast_switch):
    def kernel():
        pass

    kernel.launches = 0
    per = 2000

    def launch(_i):
        before = cuda_lib.thread_launches()
        for _ in range(per):
            cuda_lib.count_launch(kernel)
        return cuda_lib.thread_launches() - before

    own = _together(launch)
    assert kernel.launches == THREADS * per
    assert own == [per] * THREADS  # each thread sees only its own


def test_fault_plan_count_is_exact_under_threads(fast_switch):
    plan = FaultPlan([FaultSpec("batch.heavy.dispatch", "transient",
                                count=3)])

    def hit(_i):
        fired = 0
        for _ in range(50):
            try:
                plan.fire("batch.heavy.dispatch")
            except TransientFault:
                fired += 1
        return fired

    assert sum(_together(hit)) == 3
    assert plan.specs[0].seen == THREADS * 50


def test_concurrent_planning_gives_each_query_its_own_plan(fast_switch):
    """Serving threads plan at once: each query gets the plan it gets
    alone (the planner's search keeps its best plan on the planner)."""
    triples, _ = generate_lubm(1, seed=0)
    planner = Planner(Stats.generate(triples))
    ss = VirtualLubmStrings(1, seed=0)
    texts = list(chip_smoke.QUERIES.values())

    def plan(text):
        q = Parser(ss).parse(text)
        planner.generate_plan(q)
        return repr(q.pattern_group.patterns), q.planner_empty

    want = [plan(t) for t in texts]
    got = _together(lambda i: [plan(texts[(i + k) % len(texts)])
                               for k in range(len(texts))])
    for i, plans in enumerate(got):
        assert plans == [want[(i + k) % len(texts)]
                         for k in range(len(texts))], i


def test_tenant_scenario_under_lockdep(monkeypatch):
    """Checked locks for every lock this scenario takes: the module-level
    singletons (tracker, signals, labels, controller, recorder, journal)
    are swapped for ones made after ``install(True)``, as are the proxy,
    its pool and its batcher."""
    from wukong_tpu_torch.analysis import lockdep
    from wukong_tpu_torch.config import Global
    from wukong_tpu_torch.obs import events, recorder, slo
    from wukong_tpu_torch.runtime import admission
    from wukong_tpu_torch.runtime.emulator import Emulator
    from wukong_tpu_torch.runtime.proxy import Proxy

    for name in ("enable_batching", "enable_admission", "admission_quotas",
                 "admission_max_inflight", "enable_tracing"):
        monkeypatch.setattr(Global, name, getattr(Global, name))
    lockdep.install(True)
    proxy = None
    try:
        monkeypatch.setattr(slo, "_label_lock", lockdep.make_lock(
            "slo.labels"))
        monkeypatch.setattr(slo, "_tracker", slo.SLOTracker())
        monkeypatch.setattr(slo, "_signals", slo.OverloadSignals())
        monkeypatch.setattr(admission, "_controller",
                            admission.AdmissionController())
        monkeypatch.setattr(recorder, "_recorder", recorder.FlightRecorder())
        monkeypatch.setattr(events, "_journal", events.EventJournal())
        triples, _ = generate_lubm(1, seed=0)
        proxy = Proxy(build_partition(triples, 0, 1),
                      VirtualLubmStrings(1, seed=0), device="cpu",
                      planner=Planner(Stats.generate(triples)))
        light, _heavy = chip_smoke.live_texts(proxy)
        Global.enable_batching = True
        proxy.engine_pool()
        emu = Emulator(proxy)
        out = emu.run_tenants(light[:16], duration_s=0.4, warmup_s=0.0,
                              chaos=True, seed=1)
        assert out["tenants"]["gold"]["served"] > 0
        Global.enable_admission = True
        Global.admission_quotas = chip_smoke.TENANT_QUOTAS
        Global.admission_max_inflight = chip_smoke.TENANT_MAX_INFLIGHT
        out = emu.run_tenants(light[:16], duration_s=0.4, warmup_s=0.0,
                              overload_x=2.0, seed=1)
        assert out["tenants"]["gold"]["rejected"] == 0
        pool = proxy._pool
        # the fair sub-lane carried no default-lane work here (the batch
        # lane did), but it stays a checked leaf when it exists
        q = Parser(proxy.str_server).parse(light[0])
        proxy._plan_prepared(q, True, None, tenant="gold")
        assert pool.wait(pool.submit(q), timeout=WAIT_S).result.nrows >= 0
        assert pool._fair is not None
        rep = lockdep.report()
        names = {n for e in rep["edges"] for n in (e["from"], e["to"])}
        assert rep["cycles"] == [], rep["cycles"]
        assert rep["leaf_violations"] == [], rep["leaf_violations"]
        # every lock of the plane was a checked one, and the fair queue's
        # was taken under the pool's routing lock (the recorded edge)
        for lk in (slo._tracker._lock, slo._signals._lock,
                   admission._controller._lock, pool._fair._lock,
                   recorder._recorder._lock, events._journal._lock):
            assert isinstance(lk, lockdep.DebugLock), lk
        assert {"pool.route", "admission.queue"} <= names
    finally:
        if proxy is not None and proxy._pool is not None:
            proxy._pool.stop()
        if proxy is not None and proxy._batcher is not None:
            proxy._batcher.close()
        lockdep.install(False)

