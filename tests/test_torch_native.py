"""The port's host fast paths (wukong_tpu_torch/native/) against their numpy
paths and the JAX package's native/, on the same seeded inputs.

- The library builds from the port's own copy of the C++ source into
  wukong_tpu_torch/build/, keyed by the source's hash, never beside it.
- ``parse_id_triples``, ``sort_triples_perm`` and
  ``build_bucket_table_native`` equal their numpy paths and the JAX
  package's results bit for bit.
- ``build_partition`` and ``DeviceStore`` staging give equal arrays with the
  native paths on and off.
- The path counters count each call's path.
"""

import os

import numpy as np
import pytest

from wukong_tpu import native as jnative
from wukong_tpu.engine import device_store as jds
from wukong_tpu_torch import native
from wukong_tpu_torch.engine import device_store as ds
from wukong_tpu_torch.engine.device_store import DeviceStore
from wukong_tpu_torch.loader.base import load_triples
from wukong_tpu_torch.loader.lubm import generate_lubm
from wukong_tpu_torch.store.gstore import build_partition


def _triples(n, seed, hi=1 << 20):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, hi, size=(n, 3), dtype=np.int64)
    t[:, 1] = rng.integers(0, 40, size=n)
    return t


def _write_ids(path, t):
    with open(path, "w") as f:
        for s, p, o in t.tolist():
            f.write(f"{s}\t{p}\t{o}\n")
    return str(path)


def test_library_builds_into_the_build_directory():
    lib = native.get_lib()
    assert lib is not None  # the test host has a C++ compiler
    so = native.library_path()
    assert so.exists() and so.parent == native.BUILD
    assert so.parent.name == "build" and so.parent.parent.name == \
        "wukong_tpu_torch"
    here = os.path.dirname(native.__file__)
    assert not [f for f in os.listdir(here) if f.endswith(".so")]


@pytest.mark.parametrize("n", [0, 1, 5000])
def test_parse_id_triples_equals_numpy_and_jax(tmp_path, monkeypatch, n):
    path = _write_ids(tmp_path / "id_a.nt", _triples(n, seed=n))
    got = native.parse_id_triples(path)
    want_j = jnative.parse_id_triples(path)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    plain = native.parse_id_triples(path)
    assert got.dtype == plain.dtype == np.int64
    assert got.shape == plain.shape == (n, 3)
    assert np.array_equal(got, plain) and np.array_equal(got, want_j)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_sort_triples_perm_equals_lexsort_and_jax(dtype):
    t = _triples(20000, seed=3, hi=1 << 12).astype(dtype)
    p, s, o = t[:, 1], t[:, 0], t[:, 2]
    perm = native.sort_triples_perm(p, s, o)
    assert perm is not None and perm.dtype == dtype
    assert np.array_equal(perm, np.lexsort((o, s, p)))
    assert np.array_equal(perm, jnative.sort_triples_perm(p, s, o))


@pytest.mark.parametrize("nkeys", [1, 7, 3000, 20000])
def test_bucket_table_equals_numpy_rounds_and_jax(monkeypatch, nkeys):
    rng = np.random.default_rng(nkeys)
    keys = np.unique(rng.integers(0, 1 << 24, size=nkeys))
    degs = rng.integers(1, 9, size=len(keys))
    offsets = np.concatenate([[0], np.cumsum(degs)]).astype(np.int64)
    got = ds.build_hash_table(keys, offsets)
    want_j = jds.build_hash_table(keys, offsets)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    plain = ds.build_hash_table(keys, offsets)
    for a, b, c in zip(got[:3], plain[:3], want_j[:3]):
        assert a.dtype == b.dtype == np.int32
        assert np.array_equal(a, b) and np.array_equal(a, c)
    assert got[3] == plain[3] == want_j[3]


def _partition_arrays(g):
    out = {}
    for k, seg in sorted(g.segments.items()):
        out[("seg",) + k] = (seg.keys, seg.offsets, seg.edges)
    for k, arr in sorted(g.index.items()):
        out[("idx",) + k] = (arr,)
    for d, seg in sorted(g.vp.items()):
        out[("vp", d)] = (seg.keys, seg.offsets, seg.edges)
    out["sets"] = (g.v_set, g.t_set, g.p_set)
    return out


def _staged(g):
    store = DeviceStore(g, device="cpu")
    out = {}
    for pid, d in sorted(g.segments):
        seg = store.segment(pid, d)
        out[(pid, d)] = (seg.bline.numpy().copy(), seg.bhi.numpy().copy(),
                         seg.edges.numpy().copy(), seg.max_probe)
    return out


def test_partition_and_staging_equal_with_native_on_and_off(monkeypatch):
    triples, _ = generate_lubm(1, seed=5)
    native.reset_counts()
    g_on = build_partition(triples, 0, 1)
    staged_on = _staged(g_on)
    assert native.counts["sort_triples_perm"]["native"] >= 2
    assert native.counts["build_bucket_table_native"]["native"] >= 1
    monkeypatch.setattr(native, "get_lib", lambda: None)
    g_off = build_partition(triples, 0, 1)
    staged_off = _staged(g_off)
    a, b = _partition_arrays(g_on), _partition_arrays(g_off)
    assert a.keys() == b.keys()
    for k in a:
        for x, y in zip(a[k], b[k]):
            assert np.array_equal(x, y), k
    assert staged_on.keys() == staged_off.keys()
    for k in staged_on:
        for x, y in zip(staged_on[k], staged_off[k]):
            assert np.array_equal(x, y), k


def test_path_counters_count(tmp_path, monkeypatch):
    t = _triples(100, seed=9)
    d = tmp_path / "ids"
    d.mkdir()
    _write_ids(d / "id_0.nt", t[:50])
    _write_ids(d / "id_1.nt", t[50:])
    native.reset_counts()
    assert np.array_equal(load_triples(str(d)), t)
    assert native.counts["parse_id_triples"] == {"native": 2, "numpy": 0}
    keys = np.arange(10, dtype=np.int64)
    offsets = np.arange(11, dtype=np.int64)
    ds.build_hash_table(keys, offsets)
    native.sort_triples_perm(t[:, 0], t[:, 1], t[:, 2])
    assert native.counts["build_bucket_table_native"]["native"] == 1
    assert native.counts["sort_triples_perm"]["native"] == 1
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert np.array_equal(load_triples(str(d)), t)
    ds.build_hash_table(keys, offsets)
    assert native.sort_triples_perm(t[:, 0], t[:, 1], t[:, 2]) is None
    assert native.counts == {
        "parse_id_triples": {"native": 2, "numpy": 2},
        "sort_triples_perm": {"native": 1, "numpy": 1},
        "build_bucket_table_native": {"native": 1, "numpy": 1}}
