"""The port's recovery manager (wukong_tpu_torch/runtime/recovery.py, one
partition) against the JAX package's:

- a checkpoint and WAL directory written by the JAX manager (and by the
  JAX proxy, whose checkpoints carry stream state) recovers in the port to
  the JAX store's ``gstore_digest``, and the reverse;
- retention keeps two bundles and truncates the WAL behind the older; a
  corrupt newest bundle falls back to the older one and its longer WAL
  tail; a WAL gap is refused, and vector records replay (counted in
  ``replayed["vector"]``) to the JAX store's vector digest; the
  ``checkpoint.write`` fault site writes nothing; the periodic checkpointer
  starts and stops;
- ``RebuildJob`` rides the engine pool's rebuild lane, after every other
  lane, and a dead pool settles it."""

import os
import shutil
import threading
import time

import numpy as np
import pytest

from wukong_tpu.config import Global as JGlobal
from wukong_tpu.loader.lubm import generate_lubm
from wukong_tpu.runtime import recovery as jrec
from wukong_tpu.store import dynamic as jdyn
from wukong_tpu.store import persist as jp
from wukong_tpu.store import wal as jwal
from wukong_tpu.store.gstore import build_partition as jbuild
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.runtime import faults, recovery
from wukong_tpu_torch.runtime.scheduler import EnginePool
from wukong_tpu_torch.store import dynamic, persist, wal
from wukong_tpu_torch.store.gstore import build_partition
from wukong_tpu_torch.utils.errors import CheckpointCorrupt, WukongError


@pytest.fixture(scope="module")
def world():
    triples, _ = generate_lubm(1, seed=3)
    rng = np.random.default_rng(1)
    perm = rng.permutation(len(triples))
    n = int(len(triples) * 0.7)
    return triples[perm[:n]], np.array_split(triples[perm[n:]], 4)


@pytest.fixture
def dirs(tmp_path, monkeypatch):
    """Both packages' WAL and checkpoint knobs on one pair of directories;
    both process logs dropped after the test."""
    w, c = str(tmp_path / "wal"), str(tmp_path / "ckpt")
    for G in (Global, JGlobal):
        monkeypatch.setattr(G, "wal_dir", w)
        monkeypatch.setattr(G, "checkpoint_dir", c)
    yield w, c
    wal.reset_wal()
    jwal.reset_wal()


def _jax_history(base, batches, ckpt_after=2):
    """The JAX side's life: a store, inserts logged, a checkpoint after
    ``ckpt_after`` batches, more inserts; returns its live store."""
    jg = jbuild(base, 0, 1)
    mgr = jrec.RecoveryManager([jg], stream=None)
    for k, b in enumerate(batches):
        if k == ckpt_after:
            mgr.checkpoint()
        jdyn.insert_batch_into([jg], b, dedup=bool(k % 2))
    jwal.reset_wal()  # the process ends: its log file is closed
    return jg


def test_jax_checkpoint_and_wal_recover_in_the_port(world, dirs):
    base, batches = world
    jg = _jax_history(base, batches)
    g = build_partition(base, 0, 1)
    stats = recovery.RecoveryManager([g]).recover()
    assert stats["checkpoint"].endswith("ckpt-000001")
    assert stats["replayed"] == {"insert": 2, "epoch": 0, "vector": 0}
    assert persist.gstore_digest(g) == jp.gstore_digest(jg)
    # with no checkpoint at all the whole log replays onto the base
    shutil.rmtree(dirs[1])
    wal.reset_wal()
    g2 = build_partition(base, 0, 1)
    assert recovery.RecoveryManager([g2]).recover()["replayed"]["insert"] == 4
    assert persist.gstore_digest(g2) == jp.gstore_digest(jg)


def test_port_checkpoint_and_wal_recover_in_jax(world, dirs):
    base, batches = world
    g = build_partition(base, 0, 1)
    mgr = recovery.RecoveryManager([g])
    for k, b in enumerate(batches):
        if k == 2:
            path = mgr.checkpoint()
        dynamic.insert_batch_into([g], b, dedup=bool(k % 2))
    wal.reset_wal()
    jg = jbuild(base, 0, 1)
    stats = jrec.RecoveryManager([jg], stream=None).recover()
    assert stats["checkpoint"] == path
    assert jp.gstore_digest(jg) == persist.gstore_digest(g)
    with open(os.path.join(path, "MANIFEST.json")) as f:
        assert f.read().startswith('{"format": [1, 0], "wal_seq": 1,')


def test_a_jax_proxy_checkpoint_with_stream_state(world, dirs):
    """The JAX proxy's manager checkpoints its stream context too; the
    port restores the partitions and replays the tail."""
    from wukong_tpu.loader.lubm import VirtualLubmStrings
    from wukong_tpu.runtime.proxy import Proxy as JProxy

    base, batches = world
    jg = jbuild(base, 0, 1)
    jproxy = JProxy(jg, VirtualLubmStrings(1, seed=3))
    jdyn.insert_batch_into([jg], batches[0])
    path = jproxy.checkpoint()
    assert os.path.exists(os.path.join(path, "stream.pkl"))
    jdyn.insert_batch_into([jg], batches[1])
    jwal.reset_wal()
    g = build_partition(base, 0, 1)
    stats = recovery.RecoveryManager([g]).recover()
    assert stats["checkpoint"] == path and stats["replayed"]["insert"] == 1
    assert persist.gstore_digest(g) == jp.gstore_digest(jg)


def test_retention_truncation_and_fallback(world, dirs):
    base, batches = world
    g = build_partition(base, 0, 1)
    mgr = recovery.RecoveryManager([g])
    paths = []
    for b in batches:
        dynamic.insert_batch_into([g], b)
        wal.active_wal().segment_bytes = 1  # one segment per record
        paths.append(mgr.checkpoint())
    kept = sorted(os.listdir(dirs[1]))
    assert kept == ["ckpt-000003", "ckpt-000004"]
    # segments every retained bundle covers are gone: the older keeps
    # records up to 2, so only record 3's segment (the newest) stays
    assert [r.seq for r in wal.replay_dir(dirs[0])] == [3]
    assert mgr.newest_checkpoint()[0] == paths[-1]
    digest = persist.gstore_digest(g)
    # corrupt the newest bundle: recovery falls back to the older one and
    # replays its tail
    part = persist.checkpoint_part_path(paths[-1], 0)
    raw = bytearray(open(part, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(part, "wb").write(bytes(raw))
    wal.reset_wal()
    g2 = build_partition(base, 0, 1)
    stats = recovery.RecoveryManager([g2]).recover()
    assert stats["checkpoint"] == paths[-2]
    assert stats["replayed"]["insert"] == 1
    assert persist.gstore_digest(g2) == digest


def test_wal_gap_and_vector_records_are_refused(world, dirs):
    base, batches = world
    log = jwal.WriteAheadLog(dirs[0], sync="none", segment_bytes=1)
    for b in batches[:3]:
        log.append("insert", triples=b, dedup=True, ts=None)
    log.close()
    os.remove(os.path.join(dirs[0], sorted(os.listdir(dirs[0]))[1]))
    with pytest.raises(CheckpointCorrupt, match="WAL gap"):
        recovery.RecoveryManager([build_partition(base, 0, 1)]).recover()
    shutil.rmtree(dirs[0])
    wal.reset_wal()
    # a vector record is no longer refused: it replays into the vector
    # store, as in JAX
    log = jwal.WriteAheadLog(dirs[0], sync="none")
    log.append("vector", triples=np.asarray([1 << 17], np.int64),
               dedup=True, ts=None, vecs=np.ones((1, 3), np.float32),
               tombstone=False, dim=3)
    log.close()
    g = build_partition(base, 0, 1)
    stats = recovery.RecoveryManager([g]).recover()
    assert stats["replayed"] == {"insert": 0, "epoch": 0, "vector": 1}
    assert g.vstore.get(1 << 17).tolist() == [1.0, 1.0, 1.0]


def test_checkpoint_fault_writes_nothing(world, dirs):
    base, _batches = world
    mgr = recovery.RecoveryManager([build_partition(base, 0, 1)])
    faults.install(faults.parse_plan("seed=0;checkpoint.write:transient,"
                                     "count=1"))
    try:
        with pytest.raises(faults.TransientFault):
            mgr.checkpoint()
        assert not os.path.exists(dirs[1])
        assert mgr.checkpoint().endswith("ckpt-000001")
    finally:
        faults.install(None)
    with pytest.raises(WukongError, match="checkpoint_dir"):
        recovery.RecoveryManager([], ckpt_dir="").checkpoint()
    # a sharded store is taken: its replicas join the mutation fan-out
    class _SStore:
        def replica_stores(self):
            return ["replica"]

    assert recovery.RecoveryManager(
        ["primary"], sstore=_SStore())._mutation_targets() == \
        ["primary", "replica"]


def test_periodic_checkpointer(world, dirs, monkeypatch):
    base, _batches = world
    monkeypatch.setattr(Global, "checkpoint_interval_s", 1)
    mgr = recovery.RecoveryManager([build_partition(base, 0, 1)])
    mgr.start()
    mgr.start()  # idempotent
    try:
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and mgr.newest_checkpoint() is None:
            time.sleep(0.1)
    finally:
        mgr.stop()
    assert mgr.newest_checkpoint() is not None
    assert mgr._threads == []


def test_proxy_starts_the_periodic_checkpointer(world, dirs, monkeypatch):
    """A proxy built with ``checkpoint_interval_s`` and ``checkpoint_dir``
    set checkpoints on its own, as the JAX proxy does; with the interval
    at 0 it starts no thread."""
    from wukong_tpu_torch.loader.lubm import VirtualLubmStrings
    from wukong_tpu_torch.runtime.proxy import Proxy

    base, _batches = world
    monkeypatch.setattr(Global, "checkpoint_interval_s", 0)
    idle = Proxy(build_partition(base, 0, 1), VirtualLubmStrings(1, seed=0),
                 device="cpu")
    assert idle._recovery is None
    monkeypatch.setattr(Global, "checkpoint_interval_s", 1)
    proxy = Proxy(build_partition(base, 0, 1), VirtualLubmStrings(1, seed=0),
                  device="cpu")
    mgr = proxy._recovery
    try:
        assert mgr is not None and len(mgr._threads) == 1
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and mgr.newest_checkpoint() is None:
            time.sleep(0.1)
    finally:
        mgr.stop()
    path, man = mgr.newest_checkpoint()
    assert os.path.isdir(path) and len(man["parts"]) == 1


class _Recorder:
    def __init__(self, order, gate):
        self.order, self.gate = order, gate

    def execute(self, q):
        if q == "block":
            self.gate.wait(30)
        self.order.append(q)
        return q


def test_rebuild_job_rides_the_last_lane():
    order, gate = [], threading.Event()
    pool = EnginePool(num_engines=1,
                      make_engine=lambda tid: _Recorder(order, gate))
    pool.start()
    try:
        pool.submit("block")
        time.sleep(0.2)  # the engine holds the blocker
        job = recovery.RebuildJob(lambda: order.append("rebuild"), "t")
        assert pool.submit(job, lane="rebuild") == -1
        qids = [pool.submit(f"q{k}") for k in range(3)]
        assert len(pool.rebuild_queue) == 1
        gate.set()
        assert job.done.wait(30)
        for q in qids:
            pool.wait(q, timeout=30)
    finally:
        pool.stop()
    assert order == ["block", "q0", "q1", "q2", "rebuild"]
    dead = EnginePool(num_engines=1, make_engine=lambda tid: None)
    dead._dead = [True]
    job = recovery.RebuildJob(lambda: None, "dead")
    assert dead.submit(job, lane="rebuild") == -1 and job.done.is_set()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_vectors_ride_checkpoints_and_the_wal_across_packages(world, dirs,
                                                              writer):
    """A store with vectors, checkpointed, then more vector and triple
    batches logged: the other package recovers it to the same
    ``gstore_digest`` and vector digest, with the vector records counted."""
    from wukong_tpu.vector import vstore as jvs
    from wukong_tpu_torch.vector import vstore as pvs

    base, batches = world
    rng = np.random.default_rng(5)
    vids = np.unique(base[:, 0])[:300]
    vecs = rng.standard_normal((len(vids), 4)).astype(np.float32)
    if writer == "jax":
        live = jbuild(base, 0, 1)
        mgr, vs, dyn = jrec.RecoveryManager([live], stream=None), jvs, jdyn
    else:
        live = build_partition(base, 0, 1)
        mgr, vs, dyn = recovery.RecoveryManager([live]), pvs, dynamic
    vs.upsert_batch_into([live], vids[:200], vecs[:200])
    mgr.checkpoint()
    vs.upsert_batch_into([live], vids[150:], vecs[150:] * 2)
    dyn.insert_batch_into([live], batches[0], dedup=True)
    vs.upsert_batch_into([live], vids[::5], tombstone=True)
    (jwal if writer == "jax" else wal).reset_wal()
    if writer == "jax":
        g = build_partition(base, 0, 1)
        stats = recovery.RecoveryManager([g]).recover()
        assert persist.gstore_digest(g) == jp.gstore_digest(live)
    else:
        g = jbuild(base, 0, 1)
        stats = jrec.RecoveryManager([g], stream=None).recover()
        assert jp.gstore_digest(g) == persist.gstore_digest(live)
    assert stats["replayed"]["vector"] == 2
    assert stats["replayed"]["insert"] == 1
    assert g.vstore.digest() == live.vstore.digest()
