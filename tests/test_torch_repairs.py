"""The port's concurrency and fault repairs, each held against the JAX
package where it has the behaviour:

- ``stream.ingest`` is a declared fault site of the port: a FaultSpec there
  makes ``StreamIngestor.commit_epoch`` retry exactly as the JAX one does
  (same firings, same epochs and inserted counts, same standing results;
  exhaustion and the non-dedup refusal raise the same exceptions);
- lockdep exports ``wukong_lock_*`` / ``wukong_lockdep_*``: one checked
  workload gives the same counts in both packages;
- ``DeltaCSRSegment.num_edges`` / ``memory_bytes`` read under the segment
  lock: a reader between a merge's swap of the base and its reset of the
  pending count counted the pending edges twice;
- ``dead_engine_count`` (the /healthz input) equals the JAX function's on
  pools with dead engines.
"""

import threading
import time

import numpy as np
import pytest

from wukong_tpu.analysis import lockdep as jlockdep
from wukong_tpu.obs.metrics import get_registry as jregistry
from wukong_tpu.runtime import faults as jfaults
from wukong_tpu.store.gstore import build_partition as jbuild
from wukong_tpu.stream import StreamContext as JStreamContext
from wukong_tpu_torch.analysis import lockdep
from wukong_tpu_torch.loader import lubm as plubm
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.runtime import faults
from wukong_tpu_torch.store.gstore import build_partition
from wukong_tpu_torch.stream import StreamContext

PREFIX = """
PREFIX ub: <http://swat.cse.lehigh.edu/onto/univ-bench.owl#>
"""
Q_CHAIN = PREFIX + """SELECT ?X ?Y ?Z WHERE {
    ?X ub:memberOf ?Y . ?Y ub:subOrganizationOf ?Z . }"""


@pytest.fixture(scope="module")
def world():
    triples, _ = plubm.generate_lubm(1, seed=42)
    perm = np.random.default_rng(0).permutation(len(triples))
    n = int(len(triples) * 0.7)
    return triples[perm[:n]], triples[perm[n:]]


@pytest.fixture(autouse=True)
def _no_plans():
    faults.install(None)
    jfaults.install(None)
    yield
    faults.install(None)
    jfaults.install(None)


def _contexts(base, dedup=True):
    from wukong_tpu.loader import lubm as jlubm

    ctx = StreamContext([build_partition(base, 0, 1)],
                        plubm.VirtualLubmStrings(1, seed=42), device="cpu",
                        dedup=dedup)
    jctx = JStreamContext([jbuild(base, 0, 1)],
                          jlubm.VirtualLubmStrings(1, seed=42), dedup=dedup)
    return ctx, jctx


def _install(spec_kw: dict) -> None:
    faults.install(faults.FaultPlan([faults.FaultSpec(**spec_kw)], seed=7))
    jfaults.install(jfaults.FaultPlan([jfaults.FaultSpec(**spec_kw)],
                                      seed=7))


@pytest.mark.parametrize("count", [1, 2])
def test_stream_ingest_fault_retries_as_jax(world, count):
    base, live = world
    ctx, jctx = _contexts(base)
    qid, jqid = ctx.register(Q_CHAIN), jctx.register(Q_CHAIN)
    _install({"site": "stream.ingest", "kind": "transient", "count": count})
    recs, jrecs = [], []
    for lo in range(0, 3 * 2000, 2000):
        recs.append(ctx.feed(live[lo:lo + 2000]))
        jrecs.append(jctx.feed(live[lo:lo + 2000]))
    assert faults.active().specs[0].fired == count
    assert jfaults.active().specs[0].fired == count
    assert [(r.epoch, r.n_inserted) for r in recs] \
        == [(r.epoch, r.n_inserted) for r in jrecs]
    assert np.array_equal(ctx.result_set(qid), jctx.result_set(jqid))


def test_stream_ingest_fault_exhausts_and_refuses_as_jax(world):
    from wukong_tpu.utils.errors import RetryExhausted as JRetryExhausted
    from wukong_tpu_torch.utils.errors import RetryExhausted

    base, live = world
    ctx, jctx = _contexts(base)
    _install({"site": "stream.ingest", "kind": "transient"})
    with pytest.raises(RetryExhausted):
        ctx.feed(live[:100])
    with pytest.raises(JRetryExhausted):
        jctx.feed(live[:100])
    assert ctx.epoch == jctx.epoch == 0
    assert faults.active().specs[0].fired == jfaults.active().specs[0].fired
    # without dedup a replay would double-append: the transient surfaces
    ctx, jctx = _contexts(base, dedup=False)
    _install({"site": "stream.ingest", "kind": "transient", "count": 1})
    with pytest.raises(faults.TransientFault):
        ctx.feed(live[:100])
    with pytest.raises(jfaults.TransientFault):
        jctx.feed(live[:100])
    assert ctx.feed(live[:100]).epoch == jctx.feed(live[:100]).epoch == 1


# ---------------------------------------------------------------------------
# lockdep's metric export
# ---------------------------------------------------------------------------

_LOCK_METRICS = ("wukong_lock_hold_us", "wukong_lock_wait_us",
                 "wukong_lock_contended_total", "wukong_lockdep_cycles_total",
                 "wukong_lockdep_leaf_violations_total")


def _lock_counts(reg, prefix: str) -> dict:
    """{(metric, name label): count or value} of the test's own locks."""
    snap = reg.snapshot()
    out = {}
    for m in _LOCK_METRICS:
        for s in snap.get(m, {}).get("series", []):
            name = s.get("labels", {}).get("name", "")
            if name and not name.startswith(prefix):
                continue
            out[(m, name)] = s.get("count", s.get("value"))
    return out


def _checked_workload(ld, prefix: str) -> None:
    """An ABBA cycle, a leaf inversion and one contended acquisition."""
    a, b = ld.make_lock(f"{prefix}.A"), ld.make_lock(f"{prefix}.B")
    ld.declare_leaf(f"{prefix}.leaf")
    leaf = ld.make_lock(f"{prefix}.leaf")
    with a:
        with b:
            pass
    with b:
        with a:  # closes the cycle
            pass
    with leaf:
        with a:  # acquisition under a declared leaf
            pass
    held, release = threading.Event(), threading.Event()

    def holder():
        with b:
            held.set()
            release.wait(5)

    t = threading.Thread(target=holder)
    t.start()
    held.wait(5)
    waiter = threading.Thread(target=lambda: b.acquire() and b.release())
    waiter.start()
    time.sleep(0.05)  # let the waiter block on b
    release.set()
    t.join(5)
    waiter.join(5)


def test_lockdep_metrics_equal_jax():
    before = _lock_counts(get_registry(), "rp."), _lock_counts(jregistry(),
                                                               "rp.")
    lockdep.install(True)
    jlockdep.install(True)
    try:
        _checked_workload(lockdep, "rp")
        _checked_workload(jlockdep, "rp")
        assert len(lockdep.cycles()) == len(jlockdep.cycles()) == 1
        assert len(lockdep.leaf_violations()) \
            == len(jlockdep.leaf_violations()) == 1
    finally:
        lockdep.install(False)
        jlockdep.install(False)
    after = _lock_counts(get_registry(), "rp."), _lock_counts(jregistry(),
                                                              "rp.")

    def delta(i):
        return {k: v - before[i].get(k, 0) for k, v in after[i].items()
                if v - before[i].get(k, 0)}

    port, jax = delta(0), delta(1)
    assert port == jax
    assert port[("wukong_lockdep_cycles_total", "")] == 1
    assert port[("wukong_lockdep_leaf_violations_total", "")] == 1
    assert port[("wukong_lock_contended_total", "rp.B")] == 1
    # hold-time samples: A three times, B three times (one by the waiter)
    # plus the holder's, the leaf once
    assert port[("wukong_lock_hold_us", "rp.A")] == 3
    assert port[("wukong_lock_hold_us", "rp.leaf")] == 1


# ---------------------------------------------------------------------------
# DeltaCSRSegment: counts read under the segment lock
# ---------------------------------------------------------------------------

class _ReadDuringClear(list):
    """A pending-batch list whose clear() — the merge's step after it
    swapped in the merged base — lets another thread read the segment and
    records what it saw."""

    def __init__(self, items, seg, read):
        super().__init__(items)
        self.seg, self.read, self.seen = seg, read, []
        self.reader = None

    def clear(self):
        self.reader = threading.Thread(
            target=lambda: self.seen.append(self.read(self.seg)))
        self.reader.start()
        self.reader.join(0.2)  # a reader under the lock waits for the merge
        super().clear()


@pytest.mark.parametrize("read", ["num_edges", "memory_bytes"])
def test_segment_count_never_sees_a_half_merge(read):
    from wukong_tpu_torch.store.dynamic import DeltaCSRSegment
    from wukong_tpu_torch.store.segment import CSRSegment

    ks = np.array([1, 1, 2], dtype=np.int64)
    vs = np.array([10, 11, 20], dtype=np.int64)
    seg = DeltaCSRSegment(CSRSegment.empty())
    seg.append(ks, vs, dedup=True)
    seg.append(np.array([3], np.int64), np.array([30], np.int64), dedup=True)
    getter = {"num_edges": lambda s: s.num_edges,
              "memory_bytes": lambda s: s.memory_bytes()}[read]
    spy = _ReadDuringClear(seg._pending, seg, getter)
    seg._pending = spy
    seg.keys  # a read merges the deltas
    spy.reader.join(5)
    after = getter(seg)
    assert seg.num_edges == 4
    assert spy.seen == [after]


# ---------------------------------------------------------------------------
# /healthz's dead-engine input
# ---------------------------------------------------------------------------

def test_dead_engine_count_equals_jax():
    from wukong_tpu.runtime import scheduler as jsched
    from wukong_tpu_torch.runtime import scheduler

    class Echo:
        def execute(self, q):
            return q

    pool = scheduler.EnginePool(num_engines=3, make_engine=lambda t: Echo())
    jpool = jsched.EnginePool(num_engines=3, make_engine=lambda t: Echo())
    base, jbase = scheduler.dead_engine_count(), jsched.dead_engine_count()
    with pool._route_lock:
        pool._dead[1] = True
    with jpool._route_lock:
        jpool._dead[1] = True
    assert scheduler.dead_engine_count() - base \
        == jsched.dead_engine_count() - jbase == 1
    with pool._route_lock:
        pool._dead[2] = True
    assert scheduler.dead_engine_count() - base == 2
