"""The port's vector store (wukong_tpu_torch/vector/vstore.py) against the JAX
package's on the same seeded batches.

- ``VectorStore`` upsert (last occurrence wins, sorted fresh slots),
  tombstone and revive, ownership, write-protected snapshots, ``digest``,
  ``export_arrays``, ``from_arrays`` and ``clone`` give equal arrays and
  equal digests in both packages.
- ``upsert_batch_into`` writes its WAL record before any store mutates (a
  WAL failure leaves the store untouched), and an injected fault at
  ``vector.upsert`` leaves the WAL and the store untouched; a retry commits.
- ``apply_vector_record`` replays WAL records, including records written by
  the JAX package, to a store with the live store's digest.
- ``make_vectors`` equals the JAX function bit for bit.
"""

import numpy as np
import pytest

from wukong_tpu.config import Global as JGlobal
from wukong_tpu.loader import datagen as jdatagen
from wukong_tpu.store import wal as jwal
from wukong_tpu.vector import vstore as jvstore
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.loader import datagen
from wukong_tpu_torch.runtime import faults
from wukong_tpu_torch.store import wal
from wukong_tpu_torch.store.gstore import build_partition
from wukong_tpu_torch.types import NORMAL_ID_START
from wukong_tpu_torch.utils.errors import ErrorCode, WukongError
from wukong_tpu_torch.vector import VECTOR_METRICS
from wukong_tpu_torch.vector import vstore

DIM = 8


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for G in (Global, JGlobal):
        monkeypatch.setattr(G, "wal_dir", "")
        monkeypatch.setattr(G, "vector_dim", 64)
    faults.clear()
    wal.reset_wal()
    jwal.reset_wal()
    yield
    faults.clear()
    wal.reset_wal()
    jwal.reset_wal()


def _batches(seed=0, n=60, dim=DIM):
    """(kind, vids, vecs) mutations: upserts with in-batch duplicates,
    overwrites, tombstones and revivals."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(6):
        vids = rng.integers(0, n, size=25).astype(np.int64)
        if step % 3 == 2:
            out.append(("tomb", vids[:8], None))
        else:
            out.append(("up", vids,
                        rng.standard_normal((25, dim)).astype(np.float32)))
    return out


def _apply(store, batches):
    for kind, vids, vecs in batches:
        if kind == "tomb":
            store.tombstone(vids)
        else:
            store.upsert(vids, vecs)


def _same(port, jax_):
    a, b = port.export_arrays(), jax_.export_arrays()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert port.digest() == jax_.digest()
    assert port.slot_of == jax_.slot_of
    assert port.version == jax_.version
    assert port.live_count() == jax_.live_count()


@pytest.mark.parametrize("workers,sid", [(1, 0), (3, 1)])
def test_store_mutations_equal_jax(workers, sid):
    port = vstore.VectorStore(sid, workers, DIM)
    jax_ = jvstore.VectorStore(sid, workers, DIM)
    for step in _batches(seed=workers):
        _apply(port, [step])
        _apply(jax_, [step])
        _same(port, jax_)
    assert port.n_slots() > 0 and port.memory_bytes() == jax_.memory_bytes()
    for vid in range(60):
        a, b = port.get(vid), jax_.get(vid)
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a, b)


def test_last_duplicate_wins_and_fresh_slots_are_sorted():
    vs = vstore.VectorStore(0, 1, 2)
    vs.upsert(np.asarray([9, 3, 9, 5]),
              np.asarray([[1, 1], [2, 2], [3, 3], [4, 4]], np.float32))
    assert vs.vids.tolist() == [3, 5, 9]
    assert vs.get(9).tolist() == [3.0, 3.0]
    vs.tombstone([5])
    assert vs.get(5) is None and vs.live_count() == 2
    vs.upsert([5], np.asarray([[7, 7]], np.float32))  # revives in place
    assert vs.vids.tolist() == [3, 5, 9] and vs.get(5).tolist() == [7, 7]


def test_snapshots_are_write_protected_and_stable():
    vs = vstore.VectorStore(0, 1, DIM)
    _apply(vs, _batches(seed=4)[:1])
    vids, vecs, alive, ver = vs.snapshot()
    for a in (vids, vecs, alive):
        with pytest.raises(ValueError):
            a[...] = 0
    before = vecs.copy()
    _apply(vs, _batches(seed=5)[:2])
    assert np.array_equal(vecs, before) and vs.version > ver


def test_export_from_arrays_and_clone_round_trip_both_ways():
    port = vstore.VectorStore(0, 1, DIM)
    jax_ = jvstore.VectorStore(0, 1, DIM)
    _apply(port, _batches(seed=7))
    _apply(jax_, _batches(seed=7))
    a = port.export_arrays()
    b = jax_.export_arrays()
    p2 = vstore.VectorStore.from_arrays(0, 1, b["vstore_vids"],
                                        b["vstore_vecs"], b["vstore_alive"],
                                        version=jax_.version)
    j2 = jvstore.VectorStore.from_arrays(0, 1, a["vstore_vids"],
                                         a["vstore_vecs"], a["vstore_alive"],
                                         version=port.version)
    _same(p2, j2)
    _same(port.clone(), jax_.clone())
    assert port.clone().digest() == port.digest()


def test_shape_and_id_refusals():
    vs = vstore.VectorStore(0, 1, DIM)
    with pytest.raises(WukongError) as e:
        vs.upsert([1], np.ones((1, DIM + 1), np.float32))
    assert e.value.code == ErrorCode.UNSUPPORTED_SHAPE
    with pytest.raises(WukongError):
        vstore.VectorStore(0, 1, 0)
    g = build_partition(np.asarray([[NORMAL_ID_START, 2,
                                     NORMAL_ID_START + 1]]), 0, 1)
    with pytest.raises(WukongError) as e:
        vstore.upsert_batch_into([g], [-1], np.ones((1, DIM), np.float32))
    assert e.value.code == ErrorCode.UNKNOWN_PATTERN
    vstore.upsert_batch_into([g], [1], np.ones((1, DIM), np.float32))
    with pytest.raises(WukongError) as e:
        vstore.upsert_batch_into([g], [1], np.ones((1, 3), np.float32))
    assert e.value.code == ErrorCode.UNSUPPORTED_SHAPE


def _world():
    return build_partition(np.asarray([[NORMAL_ID_START, 2,
                                        NORMAL_ID_START + 1]],
                                      dtype=np.int64), 0, 1)


def test_upsert_batch_logs_before_it_mutates(tmp_path, monkeypatch):
    Global.wal_dir = str(tmp_path)
    g = _world()
    vids = np.arange(NORMAL_ID_START, NORMAL_ID_START + 30, dtype=np.int64)
    vecs = datagen.make_vectors(vids, DIM)
    seen = []
    orig = wal.WriteAheadLog.append

    def spy(self, kind, **payload):
        seen.append((kind, getattr(g, "vstore", None) is None,
                     getattr(g, "version", 0)))
        return orig(self, kind, **payload)

    monkeypatch.setattr(wal.WriteAheadLog, "append", spy)
    assert vstore.upsert_batch_into([g], vids, vecs) == 30
    assert seen == [("vector", True, 0)]  # logged before the store changed
    assert g.version == 1 and g.vstore.version == 1

    def broken(self, kind, **payload):
        raise OSError("disk full")

    monkeypatch.setattr(wal.WriteAheadLog, "append", broken)
    digest = g.vstore.digest()
    with pytest.raises(OSError):
        vstore.upsert_batch_into([g], vids, vecs * 2)
    assert g.vstore.digest() == digest and g.version == 1


def test_fault_at_vector_upsert_leaves_wal_and_store_untouched(tmp_path):
    Global.wal_dir = str(tmp_path)
    g = _world()
    vids = np.arange(NORMAL_ID_START, NORMAL_ID_START + 20, dtype=np.int64)
    vstore.upsert_batch_into([g], vids, datagen.make_vectors(vids, DIM))
    digest0, vver0, gver0 = g.vstore.digest(), g.vstore.version, g.version
    wal_count0 = len(list(wal.active_wal().replay()))
    assert "vector.upsert" in faults.KNOWN_FAULT_SITES
    faults.install(faults.parse_plan("seed=0;vector.upsert:transient,"
                                     "count=1"))
    with pytest.raises(faults.TransientFault):
        vstore.upsert_batch_into([g], vids,
                                 datagen.make_vectors(vids, DIM, seed=9))
    assert len(list(wal.active_wal().replay())) == wal_count0
    assert g.vstore.digest() == digest0
    assert g.vstore.version == vver0 and g.version == gver0
    # the plan's one firing is spent: the same batch now commits durably
    assert vstore.upsert_batch_into(
        [g], vids, datagen.make_vectors(vids, DIM, seed=9)) == 20
    assert len(list(wal.active_wal().replay())) == wal_count0 + 1


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_vector_records_replay_to_the_same_digest(tmp_path, writer):
    vids = np.arange(NORMAL_ID_START, NORMAL_ID_START + 40, dtype=np.int64)
    vecs = datagen.make_vectors(vids, DIM)
    if writer == "port":
        Global.wal_dir = str(tmp_path)
        g = _world()
        vstore.attach_vstore(g, DIM)
        vstore.upsert_batch_into([g], vids, vecs)
        vstore.upsert_batch_into([g], vids[::3], tombstone=True)
        live = g.vstore
        wal.reset_wal()
    else:
        JGlobal.wal_dir = str(tmp_path)
        from wukong_tpu.store.gstore import build_partition as jbuild

        jg = jbuild(np.asarray([[NORMAL_ID_START, 2, NORMAL_ID_START + 1]],
                               dtype=np.int64), 0, 1)
        jvstore.attach_vstore(jg, DIM)
        jvstore.upsert_batch_into([jg], vids, vecs)
        jvstore.upsert_batch_into([jg], vids[::3], tombstone=True)
        live = jg.vstore
        jwal.reset_wal()
    recs = [r for r in wal.replay_dir(str(tmp_path)) if r.kind == "vector"]
    assert len(recs) == 2
    g2 = _world()
    for r in recs:  # replay attaches on demand (fresh-world contract)
        vstore.apply_vector_record(g2, r.payload)
    assert g2.vstore.digest() == live.digest()
    assert g2.vstore.live_count() == live.live_count()
    assert g2.version == 2


def test_attach_and_version_protocol():
    g = _world()
    Global.vector_dim = 5
    vs = vstore.attach_vstore(g)
    assert vs.dim == 5 and vstore.attach_vstore(g) is vs
    assert vstore.bump_store_version(g) == 1
    vstore.upsert_batch_into([g], [7], np.ones((1, 5), np.float32))
    assert g.version == 2
    assert vstore.upsert_batch_into([g], [7], tombstone=True) == 1
    assert g.version == 3 and g.vstore.live_count() == 0


@pytest.mark.parametrize("dim,seed,clusters", [(8, 0, 16), (64, 3, 4),
                                               (5, 11, 1)])
def test_make_vectors_equals_jax(dim, seed, clusters):
    vids = np.concatenate([np.arange(NORMAL_ID_START, NORMAL_ID_START + 50),
                           [7, NORMAL_ID_START + 1000, 3]]).astype(np.int64)
    got = datagen.make_vectors(vids, dim, seed=seed, clusters=clusters)
    want = jdatagen.make_vectors(vids, dim, seed=seed, clusters=clusters)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


def test_write_vectors_and_cli_flag_equal_jax(tmp_path):
    (tmp_path / "nt").mkdir()
    (tmp_path / "nt" / "a.nt").write_text(
        "<http://x/a> <http://x/p> <http://x/b> .\n"
        "<http://x/b> <http://x/p> <http://x/c> .\n")
    out = {}
    for name, mod in (("port", datagen), ("jax", jdatagen)):
        dst = tmp_path / name
        mod.main([str(tmp_path / "nt"), str(dst), "--vectors", "6",
                  "--vec-seed", "2"])
        z = np.load(dst / "vectors.npz")
        out[name] = (z["vids"], z["vecs"])
    assert np.array_equal(out["port"][0], out["jax"][0])
    assert np.array_equal(out["port"][1], out["jax"][1])
    assert out["port"][1].shape == (3, 6)


def test_vector_metrics_are_registered():
    from wukong_tpu_torch.obs.metrics import get_registry
    from wukong_tpu_torch.runtime.proxy import Proxy  # noqa: F401 (registers)
    from wukong_tpu_torch.vector import knn  # noqa: F401 (registers)

    names = set(get_registry().snapshot())
    g = _world()
    vstore.attach_vstore(g, 2)  # the store registers its two counters
    names |= set(get_registry().snapshot())
    proxy_names = {"wukong_vector_queries_total", "wukong_vector_route_total",
                   "wukong_vector_route_demotions_total"}
    assert set(VECTOR_METRICS.values()) - proxy_names <= names
