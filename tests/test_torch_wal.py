"""The port's write-ahead log (wukong_tpu_torch/store/wal.py) against the JAX
package's: the same appends write the same segment bytes; a WAL directory
written by either package replays in the other; a torn tail is dropped (and
repaired in place when the log reopens) and a mid-segment CRC error raises
CheckpointCorrupt, as in JAX; segments rotate with a ``wal.rotate`` event and
are truncated behind a checkpoint the same way; the three sync modes fsync
as documented; and the hooks (``maybe_wal_append``, ``suppress``, the
``wal.append`` fault site, the reentrant mutation lock) behave alike."""

import os

import numpy as np
import pytest

from wukong_tpu.config import Global as JGlobal
from wukong_tpu.store import wal as jwal
from wukong_tpu.utils.errors import CheckpointCorrupt as JCorrupt
from wukong_tpu_torch.analysis import lockdep
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.obs import get_journal, get_registry
from wukong_tpu_torch.runtime import faults
from wukong_tpu_torch.store import dynamic, wal
from wukong_tpu_torch.store.gstore import build_partition
from wukong_tpu_torch.utils.errors import CheckpointCorrupt


def _batch(seed, n=50):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(1 << 17, 1 << 18, n),
                     rng.integers(2, 9, n),
                     rng.integers(1 << 17, 1 << 18, n)], 1).astype(np.int64)


def _write(mod, d, n=6, **kw):
    log = mod.WriteAheadLog(str(d), sync="none", **kw)
    for k in range(n):
        log.append("insert", triples=_batch(k), dedup=bool(k % 2), ts=None)
    log.close()
    return log


def _records(it):
    return [(r.seq, r.kind, r.payload["triples"].tolist(),
             r.payload["dedup"], r.payload["ts"]) for r in it]


def _count(series: str, **labels) -> float:
    snap = get_registry().snapshot().get(series) or {}
    return sum(s.get("value", 0) for s in snap.get("series", [])
               if all(s["labels"].get(k) == v for k, v in labels.items()))


def _fsyncs() -> float:
    return _count("wukong_wal_fsyncs_total")


def test_same_appends_same_bytes(tmp_path):
    _write(wal, tmp_path / "port", segment_bytes=4096)
    _write(jwal, tmp_path / "jax", segment_bytes=4096)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) > 1  # rotated
    assert sorted(os.listdir(tmp_path / "port")) == names
    for n in names:
        assert ((tmp_path / "port" / n).read_bytes()
                == (tmp_path / "jax" / n).read_bytes())


@pytest.mark.parametrize("writer,reader", [(wal, jwal), (jwal, wal)])
def test_a_directory_replays_in_the_other_package(tmp_path, writer, reader):
    _write(writer, tmp_path, segment_bytes=4096)
    want = _records(writer.replay_dir(str(tmp_path)))
    assert [r[0] for r in want] == list(range(6))
    assert _records(reader.replay_dir(str(tmp_path))) == want
    assert _records(reader.replay_dir(str(tmp_path), after_seq=3)) == want[4:]
    log = reader.WriteAheadLog(str(tmp_path), sync="none")
    assert log.next_seq == 6
    assert _records(log.replay(after_seq=-1)) == want
    log.close()


def _tear(d, cut):
    last = sorted(os.listdir(d))[-1]
    p = os.path.join(d, last)
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) - cut)
    return p


@pytest.mark.parametrize("cut", [1, 9, 40])
def test_torn_tail_dropped_and_repaired_as_in_jax(tmp_path, cut):
    for mod, d in ((wal, tmp_path / "port"), (jwal, tmp_path / "jax")):
        _write(mod, d)
        _tear(str(d), cut)
    got = _records(wal.replay_dir(str(tmp_path / "port")))
    assert got == _records(jwal.replay_dir(str(tmp_path / "jax")))
    assert [r[0] for r in got] == list(range(5))
    # reopening repairs the tail in place, to the same size as JAX's repair
    a = wal.WriteAheadLog(str(tmp_path / "port"), sync="none")
    b = jwal.WriteAheadLog(str(tmp_path / "jax"), sync="none")
    assert a.next_seq == b.next_seq == 5
    for d in ("port", "jax"):
        (name,) = os.listdir(tmp_path / d)
    assert (os.path.getsize(tmp_path / "port" / name)
            == os.path.getsize(tmp_path / "jax" / name))
    assert a.append("insert", triples=_batch(9), dedup=True, ts=None) == 5
    a.close()
    b.close()
    assert [r[0] for r in _records(jwal.replay_dir(str(tmp_path / "port")))
            ] == list(range(6))


def test_mid_segment_crc_error_raises(tmp_path):
    for mod, d in ((wal, tmp_path / "port"), (jwal, tmp_path / "jax")):
        _write(mod, d)
        (name,) = os.listdir(d)
        p = d / name
        raw = bytearray(p.read_bytes())
        raw[len(wal.MAGIC) + wal._HDR.size + 5] ^= 0xFF  # record 0's body
        p.write_bytes(bytes(raw))
    with pytest.raises(CheckpointCorrupt, match="crc mismatch"):
        list(wal.replay_dir(str(tmp_path / "port")))
    with pytest.raises(JCorrupt, match="crc mismatch"):
        list(jwal.replay_dir(str(tmp_path / "jax")))
    with pytest.raises(CheckpointCorrupt):
        wal.WriteAheadLog(str(tmp_path / "port"))
    bad = tmp_path / "nomagic"
    bad.mkdir()
    (bad / "wal-0000000000000000.log").write_bytes(b"junk")
    with pytest.raises(CheckpointCorrupt, match="magic"):
        list(wal.replay_dir(str(bad)))


def test_rotation_event_and_truncation_match_jax(tmp_path):
    before = _count("wukong_cluster_events_total", kind="wal.rotate")
    a = _write(wal, tmp_path / "port", n=12, segment_bytes=4096)
    b = _write(jwal, tmp_path / "jax", n=12, segment_bytes=4096)
    rotations = _count("wukong_cluster_events_total",
                       kind="wal.rotate") - before
    assert get_journal().last(1, kind="wal.rotate")[0].attrs["first_seq"] > 0
    assert rotations == len(os.listdir(tmp_path / "port")) - 1 > 0
    for seq in (-1, 3, 7, 11, 40):
        assert a.truncate_upto(seq) == b.truncate_upto(seq)
        assert sorted(os.listdir(tmp_path / "port")) == sorted(
            os.listdir(tmp_path / "jax"))
    assert len(os.listdir(tmp_path / "port")) == 1  # the newest stays


@pytest.mark.parametrize("mode,expect", [("none", 0), ("always", 4),
                                         ("interval", 1)])
def test_sync_modes(tmp_path, monkeypatch, mode, expect):
    """interval: at most one fsync per wal_sync_interval_s (an hour here,
    the first append's due at once)."""
    monkeypatch.setattr(Global, "wal_sync_interval_s", 3600)
    log = wal.WriteAheadLog(str(tmp_path), sync=mode)
    log._last_fsync = -1e18
    f0 = _fsyncs()
    for k in range(4):
        log.append("insert", triples=_batch(k), dedup=True, ts=None)
    log.close()
    assert _fsyncs() - f0 == expect
    with pytest.raises(ValueError):
        wal.WriteAheadLog(str(tmp_path), sync="sometimes")
    # with no override the live knob decides, per append
    monkeypatch.setattr(Global, "wal_sync", "always")
    live = wal.WriteAheadLog(str(tmp_path))
    assert live.sync == "always"
    live.close()


def test_hooks_suppress_and_the_process_log(tmp_path, monkeypatch):
    monkeypatch.setattr(Global, "wal_dir", "")
    assert wal.active_wal() is None
    assert wal.maybe_wal_append("insert", _batch(0), True) is None
    monkeypatch.setattr(Global, "wal_dir", str(tmp_path / "a"))
    try:
        log = wal.active_wal()
        assert log is wal.active_wal()  # one log per directory
        assert wal.maybe_wal_append("insert", _batch(0), True) == 0
        with log.suppress():
            assert log.suppressed
            assert wal.maybe_wal_append("insert", _batch(1), True) is None
        assert wal.maybe_wal_append("insert", _batch(2), False) == 1
        monkeypatch.setattr(Global, "wal_dir", str(tmp_path / "b"))
        assert wal.active_wal() is not log and log._fh is None
    finally:
        wal.reset_wal()
    got = _records(jwal.replay_dir(str(tmp_path / "a")))
    assert [(r[0], r[3]) for r in got] == [(0, True), (1, False)]
    assert got[1][2] == _batch(2).tolist()


def test_append_fault_leaves_log_and_store_untouched(tmp_path, monkeypatch):
    from wukong_tpu_torch.loader.lubm import generate_lubm
    from wukong_tpu_torch.store.persist import gstore_digest

    triples, _ = generate_lubm(1, seed=0)
    g = build_partition(triples[:20000], 0, 1)
    before = gstore_digest(g)
    monkeypatch.setattr(Global, "wal_dir", str(tmp_path))
    faults.install(faults.parse_plan("seed=0;wal.append:transient,count=1"))
    try:
        with pytest.raises(faults.TransientFault):
            dynamic.insert_batch_into([g], triples[20000:21000])
        assert gstore_digest(g) == before and g.__dict__.get("version") is None
        assert list(wal.replay_dir(str(tmp_path))) == []
        dynamic.insert_batch_into([g], triples[20000:21000])  # retried
    finally:
        faults.install(None)
        wal.reset_wal()
    (rec,) = list(jwal.replay_dir(str(tmp_path)))
    assert rec.seq == 0 and np.array_equal(rec.payload["triples"],
                                           triples[20000:21000])
    assert g.version == 1


def test_mutation_lock_is_reentrant_and_rebound_by_lockdep():
    with wal.mutation_lock():
        with wal.mutation_lock():  # a nested insert on the same thread
            pass
    lockdep.install(True)
    try:
        lk = wal.mutation_lock()
        assert type(lk).__name__ == "DebugRLock"
        with lk:
            with wal._state_lock:
                pass
        assert ("wal.mutation_lock", "wal.state") in {
            (e["from"], e["to"]) for e in lockdep.report()["edges"]}
        assert lockdep.cycles() == []
    finally:
        lockdep.install(False)
    assert not isinstance(wal.mutation_lock(), lockdep.DebugLock)
    assert JGlobal.wal_dir == ""  # the JAX package's knob is its own
