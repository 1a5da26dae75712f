"""The port's checkpoint bundles (wukong_tpu_torch/store/persist.py) against
the JAX package's: a partition (with dynamic deltas) saved by either package
loads in the other with the same arrays, version and ``gstore_digest``, and
the two packages write the same bytes; the byte codec round-trips; a
truncated, bit-flipped, foreign or newer-major bundle is refused with the
JAX error; a bundle that carries vectors (format 2.1) written by either
package loads in the other with the same vector store and digest; and clone
/ adopt / restore behave as in JAX, the vector store included."""

import io
import json
import zipfile

import numpy as np
import pytest

from wukong_tpu.loader.lubm import generate_lubm, generate_lubm_attrs
from wukong_tpu.store import dynamic as jdyn
from wukong_tpu.store import persist as jp
from wukong_tpu.store.gstore import build_partition as jbuild
from wukong_tpu.utils.errors import CheckpointCorrupt as JCorrupt
from wukong_tpu_torch.store import dynamic, persist
from wukong_tpu_torch.store.gstore import build_partition
from wukong_tpu_torch.utils.errors import CheckpointCorrupt, ErrorCode


@pytest.fixture(scope="module")
def stores():
    """(port, JAX) partitions 1 of 2 of LUBM-1 with attributes, 80% built
    in bulk and 20% inserted in two batches (pending deltas included)."""
    triples, _ = generate_lubm(1, seed=7)
    attrs = generate_lubm_attrs(1, seed=7)
    rng = np.random.default_rng(0)
    perm = rng.permutation(len(triples))
    n = int(len(triples) * 0.8)
    base, rest = triples[perm[:n]], np.array_split(triples[perm[n:]], 2)
    # the JAX attributes are rows, the port's the columns of the same rows
    cols = tuple(np.asarray(c) for c in zip(*attrs))
    cols = cols[:3] + (cols[3].astype(np.int64),)
    pg = build_partition(base, 1, 2, attr_triples=cols)
    jg = jbuild(base, 1, 2, attr_triples=attrs)
    for k, b in enumerate(rest):
        dynamic.insert_triples(pg, b, dedup=bool(k))
        jdyn.insert_triples(jg, b, dedup=bool(k))
    return pg, jg


def _same_store(a, b):
    am, aa = persist._collect_arrays(a)
    bm, ba = jp._collect_arrays(b)
    assert am == bm
    assert sorted(aa) == sorted(ba)
    for k in aa:
        assert aa[k].dtype == ba[k].dtype and np.array_equal(aa[k], ba[k]), k
    assert getattr(a, "version", 0) == getattr(b, "version", 0)
    assert a.type_ids == b.type_ids


def test_bundles_cross_load_with_the_same_digest(stores, tmp_path):
    pg, jg = stores
    assert persist.gstore_digest(pg) == jp.gstore_digest(jg)
    persist.save_gstore(pg, str(tmp_path / "port.npz"))
    jp.save_gstore(jg, str(tmp_path / "jax.npz"))
    assert ((tmp_path / "port.npz").read_bytes()
            == (tmp_path / "jax.npz").read_bytes())
    from_port = jp.load_gstore(str(tmp_path / "port"))  # .npz appended
    from_jax = persist.load_gstore(str(tmp_path / "jax.npz"))
    _same_store(from_jax, from_port)
    assert persist.gstore_digest(from_jax) == jp.gstore_digest(jg)
    assert from_jax.version == 2 and from_jax.attrs.keys() == pg.attrs.keys()
    # a loaded store takes inserts again (its segments re-wrap lazily)
    extra = np.asarray([[1 << 22, 5, 1 << 21]], dtype=np.int64)
    dynamic.insert_triples(from_jax, extra)
    jdyn.insert_triples(from_port, extra)
    assert persist.gstore_digest(from_jax) == jp.gstore_digest(from_port)


def test_byte_codec_round_trips(stores):
    pg, jg = stores
    blob = persist.gstore_to_bytes(pg)
    assert blob == jp.gstore_to_bytes(jg)
    g2 = persist.gstore_from_bytes(blob)
    assert persist.gstore_digest(g2) == persist.gstore_digest(pg)
    with pytest.raises(CheckpointCorrupt, match="<wire>"):
        persist.gstore_from_bytes(blob[:100])


def _rewrite(path, mutate):
    """Rewrite a bundle with mutate(arrays, meta) applied."""
    z = np.load(path)
    arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays["_meta"]).decode())
    mutate(arrays, meta)
    arrays["_meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **arrays)


def _both_refuse(stores, tmp_path, mutate, match):
    """Each package refuses its own bundle, rewritten by mutate, with the
    same message: (port error, JAX error)."""
    persist.save_gstore(stores[0], str(tmp_path / "port.npz"))
    jp.save_gstore(stores[1], str(tmp_path / "jax.npz"))
    for mod, name, err in ((persist, "port.npz", CheckpointCorrupt),
                           (jp, "jax.npz", JCorrupt)):
        _rewrite(str(tmp_path / name), mutate)
        with pytest.raises(err, match=match) as e:
            mod.load_gstore(str(tmp_path / name))
        yield e.value


@pytest.fixture
def bundles(stores, tmp_path):
    pg, jg = stores
    persist.save_gstore(pg, str(tmp_path / "port.npz"))
    jp.save_gstore(jg, str(tmp_path / "jax.npz"))
    return tmp_path


def test_bit_flip_is_a_checksum_error(stores, bundles):
    def flip(arrays, meta):
        a = arrays["seg0_e"].copy()
        a[0] ^= 1
        arrays["seg0_e"] = a

    got, want = _both_refuse(stores, bundles, flip, "checksum mismatch")
    assert got.code == ErrorCode.CHECKPOINT_CORRUPT
    assert str(got).replace("port.npz", "jax.npz") == str(want)


@pytest.mark.parametrize("what,match", [
    ("array", "missing array 'idx0'"), ("format", "not a gstore bundle"),
    ("version", "newer than this build"), ("manifest", "malformed manifest")])
def test_missing_array_and_foreign_and_newer_formats(stores, bundles, what,
                                                     match):
    mutate = {"array": lambda a, m: a.pop("idx0"),
              "format": lambda a, m: m.update(format="other"),
              "version": lambda a, m: m.update(version=[3, 0]),
              "manifest": lambda a, m: m.pop("segments")}[what]
    got, want = _both_refuse(stores, bundles, mutate, match)
    assert str(got).replace("port.npz", "jax.npz") == str(want)


def test_truncated_and_absent_bundles(bundles):
    p = bundles / "port.npz"
    raw = p.read_bytes()
    p.write_bytes(raw[: len(raw) // 2])
    with pytest.raises(CheckpointCorrupt, match="unreadable"):
        persist.load_gstore(str(p))
    with pytest.raises(FileNotFoundError):
        persist.load_gstore(str(bundles / "nothing.npz"))


def test_legacy_bundle_without_header_loads(bundles):
    def strip(arrays, meta):
        for k in ("format", "version", "checksums"):
            meta.pop(k)

    _rewrite(str(bundles / "port.npz"), strip)
    g = persist.load_gstore(str(bundles / "port.npz"))
    assert g.sid == 1 and g.num_workers == 2


def test_a_bundle_with_vectors_is_refused(bundles, stores):
    """Format 2.1 since the vector plane landed: a bundle with vectors is
    no longer refused; either package's loads in the other, byte for byte,
    with the vector store's arrays, version and digest."""
    from wukong_tpu.vector.vstore import attach_vstore
    from wukong_tpu_torch.vector.vstore import attach_vstore as pattach

    g = jp.load_gstore(str(bundles / "jax.npz"))
    pgl = persist.load_gstore(str(bundles / "jax.npz"))
    vids = np.asarray([200000, 200003, 200001], dtype=np.int64)
    vecs = np.arange(12, dtype=np.float32).reshape(3, 4)
    vs, pvs = attach_vstore(g, dim=4), pattach(pgl, dim=4)
    for store in (vs, pvs):
        store.upsert(vids, vecs)
        store.tombstone(vids[:1])
    buf = io.BytesIO()
    jp.save_gstore(g, buf)
    assert zipfile.is_zipfile(io.BytesIO(buf.getvalue()))
    assert persist.gstore_to_bytes(pgl) == buf.getvalue()
    got = persist.gstore_from_bytes(buf.getvalue())
    back = jp.gstore_from_bytes(persist.gstore_to_bytes(pgl))
    assert got.vstore.digest() == vs.digest() == back.vstore.digest()
    assert got.vstore.version == vs.version == pvs.version >= 1
    assert got.vstore.live_count() == vs.live_count() >= 1
    assert got.vstore.dim == 4
    assert persist.gstore_digest(got) == jp.gstore_digest(g) \
        == jp.gstore_digest(back)
    _same_store(got, back)
    # clone shares the vector store's arrays; adopt swaps it in (or out)
    c = persist.clone_gstore(got)
    assert c.vstore is not got.vstore
    assert c.vstore.digest() == got.vstore.digest()
    target = persist.load_gstore(str(bundles / "jax.npz"))
    persist.adopt_gstore(target, got)
    assert target.vstore is got.vstore
    persist.adopt_gstore(target, persist.load_gstore(str(bundles
                                                         / "jax.npz")))
    assert target.vstore is None


def test_clone_adopt_and_restore(stores, tmp_path):
    pg, jg = stores
    c = persist.clone_gstore(pg)
    jc = jp.clone_gstore(jg)
    assert persist.gstore_digest(c) == persist.gstore_digest(pg)
    # an edge this partition (1 of 2) owns on both sides
    from wukong_tpu_torch.utils.mathutil import hash_mod

    ids = np.arange(1 << 23, (1 << 23) + 64, dtype=np.int64)
    s, o = ids[hash_mod(ids, 2) == 1][:2]
    edge = np.asarray([[s, 5, o]], np.int64)
    dynamic.insert_triples(c, edge)
    jdyn.insert_triples(jc, edge)
    assert persist.gstore_digest(c) != persist.gstore_digest(pg)  # private
    assert persist.gstore_digest(c) == jp.gstore_digest(jc)
    target = build_partition(np.empty((0, 3), np.int64), 1, 2)
    target.version = 5
    persist.save_gstore(c, str(tmp_path / "c.npz"))
    persist.restore_gstore_into(target, str(tmp_path / "c.npz"))
    assert persist.gstore_digest(target) == persist.gstore_digest(c)
    assert target.version == max(5, c.version) + 1  # force-bumped
    wrong = build_partition(np.empty((0, 3), np.int64), 0, 2)
    with pytest.raises(CheckpointCorrupt, match="partition mismatch"):
        persist.restore_gstore_into(wrong, str(tmp_path / "c.npz"))
    assert persist.checkpoint_part_path("d", 3) == jp.checkpoint_part_path(
        "d", 3)
