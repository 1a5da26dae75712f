"""The port's store against the JAX package's: the JAX partition carried over
with gstore_from_numpy stages element-for-element the same device arrays,
the port's own synthesis and build give the same partition, attribute
segments and combined (versatile) adjacency."""

import numpy as np
import pytest
import torch

from wukong_tpu.engine.device_store import DeviceStore as JDeviceStore
from wukong_tpu.engine.device_store import combined_adjacency as j_combined
from wukong_tpu.loader.lubm import generate_lubm, generate_lubm_attrs
from wukong_tpu.store.gstore import build_partition
from wukong_tpu.types import IN, OUT, TYPE_ID
from wukong_tpu_torch.engine.device_store import DeviceStore
from wukong_tpu_torch.engine.device_store import combined_adjacency
from wukong_tpu_torch.loader import lubm as port_lubm
from wukong_tpu_torch.store import gstore as port_gstore

# the suite runs several test processes side by side: keep torch's own
# thread pool small so it does not starve their timing-sensitive tests
torch.set_num_threads(2)


def _carry(g):
    return port_gstore.gstore_from_numpy(
        {k: (s.keys, s.offsets, s.edges) for k, s in g.segments.items()},
        dict(g.index), type_ids=g.type_ids, v_set=g.v_set, t_set=g.t_set,
        p_set=g.p_set)


@pytest.fixture(scope="module")
def stores():
    triples, _ = generate_lubm(1, seed=42)
    g = build_partition(triples, 0, 1)
    return g, _carry(g)


def _same(jarr, tarr):
    assert isinstance(tarr, torch.Tensor) and tarr.dtype == torch.int32
    assert np.array_equal(np.asarray(jarr), tarr.numpy())


def _same_bucket_segment(js, ts):
    """A staged bucket segment equals the JAX one: the edge arrays element
    for element; bline the JAX bucket keys, then the (bstart, bdeg) pairs
    of lanes 0-3, and bhi the pairs of lanes 4-7; nbytes the bytes of every
    staged array, the same as the JAX segment's."""
    names = ["edges"] + (["edges2"] if ts.edges2 is not None else [])
    for name in names:
        _same(getattr(js, name), getattr(ts, name))
    k = np.asarray(js.bkey).reshape(-1, 8)
    sd = np.stack([np.asarray(js.bstart).reshape(-1, 8),
                   np.asarray(js.bdeg).reshape(-1, 8)], -1)
    _same(np.concatenate([k, sd[:, :4].reshape(-1, 8)], 1), ts.bline)
    _same(sd[:, 4:].reshape(-1, 2), ts.bhi)
    assert (js.num_keys, js.num_edges, js.max_probe, js.max_deg_log2) == \
        (ts.num_keys, ts.num_edges, ts.max_probe, ts.max_deg_log2)
    assert ts.nbytes == 4 * sum(np.asarray(getattr(js, name)).size for name in
                                names + ["bkey", "bstart", "bdeg"])


def test_staged_segments_equal(stores):
    g, pg = stores
    jds, tds = JDeviceStore(g), DeviceStore(pg, device="cpu")
    keys = sorted(g.segments) + [(TYPE_ID, IN)]
    for pid, d in keys:
        _same_bucket_segment(jds.segment(pid, d), tds.segment(pid, d))
        jm, tm = jds.merge_segment(pid, d), tds.merge_segment(pid, d)
        for name in ("skey", "sstart", "sdeg", "edges", "ekey"):
            _same(getattr(jm, name), getattr(tm, name))


def test_staged_lists_equal(stores):
    from wukong_tpu.loader.lubm import P, T

    g, pg = stores
    jds, tds = JDeviceStore(g), DeviceStore(pg, device="cpu")
    for key in list(g.index)[:40]:
        ja, jn = jds.index_list(*key)
        ta, tn = tds.index_list(*key)
        assert jn == tn
        _same(ja, ta)
    for (pid, d, c) in ((TYPE_ID, OUT, T["GraduateStudent"]),
                        (P["memberOf"], OUT, int(g.segments[(P["memberOf"],
                                                              IN)].keys[0]))):
        ja, jn = jds.const_list(pid, d, c)
        ta, tn = tds.const_list(pid, d, c)
        assert jn == tn > 0
        _same(ja, ta)
    f = [(TYPE_ID, OUT, T["Department"])]
    jf = jds.filtered_merge_segment(P["memberOf"], OUT, f)
    tf = tds.filtered_merge_segment(P["memberOf"], OUT, f)
    for name in ("skey", "sstart", "sdeg", "edges", "ekey"):
        _same(getattr(jf, name), getattr(tf, name))


def test_port_synthesis_and_build_match(stores):
    g, _ = stores
    triples, _ = port_lubm.generate_lubm(1, seed=42)
    jt, _ = generate_lubm(1, seed=42)
    assert np.array_equal(triples, jt)
    pg = port_gstore.build_partition(triples, 0, 1)
    assert set(pg.segments) == set(g.segments)
    for k, s in g.segments.items():
        ps = pg.segments[k]
        for name in ("keys", "offsets", "edges"):
            assert np.array_equal(getattr(s, name), getattr(ps, name)), k
    assert set(pg.index) == set(g.index) and pg.type_ids == g.type_ids
    for k, v in g.index.items():
        assert np.array_equal(v, pg.index[k]), k
    for name in ("v_set", "t_set", "p_set"):
        assert np.array_equal(getattr(g, name), getattr(pg, name))


@pytest.mark.parametrize("workers", [1, 3])
def test_attr_segments_equal(workers):
    """generate_lubm_attrs gives the JAX rows as columns, and every
    partition's AttrSegments equal the JAX ones key for key and value for
    value (int64 values, so equality is exact)."""
    triples, _ = generate_lubm(1, seed=42)
    jattrs = generate_lubm_attrs(1, seed=42)
    cols = port_lubm.generate_lubm_attrs(1, seed=42)
    assert np.array_equal(np.asarray(jattrs, dtype=np.int64),
                          np.stack(cols, axis=1))
    for sid in range(workers):
        jg = build_partition(triples, sid, workers, attr_triples=jattrs)
        pg = port_gstore.build_partition(triples, sid, workers,
                                         attr_triples=cols)
        assert set(pg.attrs) == set(jg.attrs) and jg.attrs
        for aid, ja in jg.attrs.items():
            pa = pg.attrs[aid]
            assert pa.type == ja.type
            for name in ("keys", "values"):
                a, b = getattr(ja, name), getattr(pa, name)
                assert a.dtype == b.dtype and np.array_equal(a, b), name
        vid = int(jg.attrs[next(iter(jg.attrs))].keys[0])
        assert pg.get_attr(vid, next(iter(jg.attrs))) == \
            jg.get_attr(vid, next(iter(jg.attrs)))


@pytest.mark.parametrize("d", [IN, OUT])
def test_combined_adjacency_and_versatile_segment_equal(stores, d):
    g, pg = stores
    for ja, ta in zip(j_combined(g, d), combined_adjacency(pg, d)):
        assert ja.dtype == ta.dtype and np.array_equal(ja, ta)
    _same_bucket_segment(JDeviceStore(g).versatile_segment(d),
                         DeviceStore(pg, device="cpu").versatile_segment(d))


def test_budget_eviction_respects_pins(stores):
    from wukong_tpu.loader.lubm import P

    _, pg = stores
    ds = DeviceStore(pg, budget_bytes=1 << 16, device="cpu")
    key = (P["memberOf"], OUT)
    ds.pin([key])
    ds.segment(*key)
    ds.merge_segment(P["takesCourse"], OUT)
    assert key in ds._cache  # pinned: kept over budget
    ds.unpin([key])
    assert ds.bytes_used <= 1 << 16 or not ds._lru
