"""The port's kernels (plain PyTorch versions on the CPU) against the JAX
package's, on the same numpy-seeded inputs. Every comparison is exact: the
data is integer.

- K1: probe_kernel's plain version vs K._hash_find and pallas_probe
  (interpret mode);
- K2/K3: the port's stream_expand (plain emit versions) vs
  tpu_stream.stream_expand (interpret mode), on the cases of
  test_stream_expand.py, and the plain emits against their definition;
- the plain pattern and merge kernels vs their jitted JAX counterparts.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wukong_tpu.engine import tpu_kernels as JK
from wukong_tpu.engine import tpu_stream as JS
from wukong_tpu.engine.device_store import DeviceStore as JDeviceStore
from wukong_tpu.loader.lubm import P, generate_lubm
from wukong_tpu.store.gstore import build_partition
from wukong_tpu.types import OUT
from wukong_tpu_torch.engine import tpu_kernels as K
from wukong_tpu_torch.engine import tpu_stream as S
from wukong_tpu_torch.engine.device_store import line_table

# the suite runs several test processes side by side: keep torch's own
# thread pool small so it does not starve their timing-sensitive tests
torch.set_num_threads(2)

INT32_MAX = 2**31 - 1


def _t(a):
    return torch.from_numpy(np.array(a))


def _lines(bkey, bstart, bdeg):
    """The JAX package's flat bucket arrays as the port stages them
    (line_table: bline [NB, 16], bhi [NB*4, 2]), as torch tensors."""
    return tuple(_t(a) for a in line_table(
        *(np.asarray(x).reshape(-1, 8) for x in (bkey, bstart, bdeg))))


def _eq(jax_out, torch_out):
    a = np.asarray(jax_out)
    b = torch_out.numpy() if isinstance(torch_out, torch.Tensor) \
        else np.asarray(torch_out)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a.astype(np.int64), b.astype(np.int64))


@pytest.fixture(scope="module")
def seg():
    triples, _ = generate_lubm(1, seed=42)
    g = build_partition(triples, 0, 1)
    s = JDeviceStore(g).segment(P["memberOf"], OUT)
    keys = np.asarray(g.segments[(P["memberOf"], OUT)].keys)
    return s, keys


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["mixed", "all_miss", "empty", "dead_tail"])
def test_probe_plain_matches_hash_find_and_pallas(seg, case):
    s, keys = seg
    rng = np.random.default_rng(3)
    C = 2048
    if case == "all_miss":
        cur = rng.integers(1 << 22, 1 << 23, C).astype(np.int32)
    else:
        cur = np.concatenate([rng.choice(keys, C // 2),
                              rng.integers(1 << 22, 1 << 23, C // 2)]
                             ).astype(np.int32)
        rng.shuffle(cur)
    n = {"empty": 0, "dead_tail": C - 17}.get(case, C)
    fx, sx, dx = JK._hash_find(s.bkey, s.bstart, s.bdeg, jnp.asarray(cur),
                               jnp.arange(C) < n, s.max_probe)
    fp, sp, dp = JK.pallas_probe(s.bkey, s.bstart, s.bdeg, jnp.asarray(cur),
                                 jnp.int32(n), s.max_probe, interpret=True)
    ft, st, dt = K.probe_kernel(*_lines(s.bkey, s.bstart, s.bdeg), _t(cur), n,
                                s.max_probe)
    for j, p, t in ((fx, fp, ft), (sx, sp, st), (dx, dp, dt)):
        _eq(j, t)
        _eq(p, t)
    if case == "mixed":
        assert int(ft.sum()) > 0


def test_probe_multi_round_buckets():
    """Keys forced into one home bucket overflow into later probe rounds."""
    from wukong_tpu.engine.device_store import build_hash_table

    NB = 8
    # keys whose home bucket is 0 in an 8-bucket table
    cand = np.arange(1 << 17, (1 << 17) + 20000, dtype=np.int64)
    home = (cand.astype(np.uint32) * np.uint32(2654435761)) & np.uint32(NB - 1)
    keys = np.sort(cand[home == 0][:20])
    offs = np.arange(len(keys) + 1, dtype=np.int64) * 3
    bkey, bstart, bdeg, max_probe = build_hash_table(keys, offs, NB)
    assert max_probe >= 3
    cur = np.concatenate([keys, keys[::-1] + 1]).astype(np.int32)
    C = len(cur)
    args = [a.reshape(-1) for a in (bkey, bstart, bdeg)]
    fj, sj, dj = JK._hash_find(*(jnp.asarray(a) for a in args),
                               jnp.asarray(cur), jnp.ones(C, bool), max_probe)
    ft, st, dt = K.probe_kernel(*_lines(*args), _t(cur), C, max_probe)
    for j, t in ((fj, ft), (sj, st), (dj, dt)):
        _eq(j, t)
    assert int(ft[:len(keys)].sum()) == len(keys)


def test_build_hash_table_bit_identical(seg):
    from wukong_tpu.engine.device_store import build_hash_table as jbuild
    from wukong_tpu_torch.engine.device_store import build_hash_table as tbuild

    rng = np.random.default_rng(5)
    keys = np.sort(rng.choice(1 << 24, 5000, replace=False)).astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(rng.integers(1, 4, 5000))])
    for a, b in zip(jbuild(keys, offs), tbuild(keys, offs)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# K2 / K3 through stream_expand (cases of test_stream_expand.py)
# ---------------------------------------------------------------------------


def _mk_segment(rng, nkeys, max_deg):
    keys = np.sort(rng.choice(200_000, size=nkeys, replace=False)).astype(
        np.int32)
    degs = rng.integers(0, max_deg + 1, size=nkeys)
    offs = np.concatenate([[0], np.cumsum(degs)]).astype(np.int64)
    edges = rng.integers(0, 2**31 - 1, size=int(offs[-1]), dtype=np.int64)
    Kp = 1 << max(int(nkeys - 1).bit_length(), 1)
    Ep = 1 << max(int(len(edges) - 1).bit_length(), 8)
    sk = np.full(Kp, INT32_MAX, np.int32)
    sk[:nkeys] = keys
    ss = np.zeros(Kp, np.int32)
    ss[:nkeys] = offs[:-1]
    sd = np.zeros(Kp, np.int32)
    sd[:nkeys] = degs
    e = np.full(Ep, INT32_MAX, np.int32)
    e[:len(edges)] = edges
    return sk, ss, sd, e, keys


def _run_mult(sk, sd, cur, n, live) -> int:
    """The port's stream-arm bound, exact here: the largest number of live
    frontier rows (i < n) sharing one key that has edges in the segment."""
    keys = cur[:n][live[:n]]
    deg = dict(zip(sk.tolist(), sd.tolist()))
    keys = keys[np.array([deg.get(int(k), 0) > 0 for k in keys], bool)]
    return int(np.unique(keys, return_counts=True)[1].max()) if len(keys) \
        else 0


def _stream_both(sk, ss, sd, e, cur, n, live, cap, mhot=True, mdup=JS.MDUP):
    a = JS.stream_expand(jnp.asarray(sk), jnp.asarray(ss), jnp.asarray(sd),
                         jnp.asarray(e), jnp.asarray(cur), jnp.int32(n),
                         jnp.asarray(live), cap_out=cap, interpret=True,
                         mhot=mhot, mdup=mdup)
    b = S.stream_expand(_t(sk), _t(ss), _t(sd), _t(e), _t(cur),
                        K.as_count(n, "cpu"), _t(live), cap_out=cap,
                        mult=_run_mult(sk, sd, cur, n, live),
                        mhot=mhot, mdup=mdup)
    return [np.asarray(x) for x in a], [x.numpy() for x in b]


def _frontier(rng, keys, case, C):
    cur = np.full(C, INT32_MAX, np.int32)
    live = np.ones(C, bool)
    if case == "distinct":
        n = min(300, len(keys))
        cur[:n] = rng.choice(keys, size=n, replace=False)
        live[rng.integers(0, n, 20)] = False
    elif case == "mhot":
        picks = rng.choice(keys, size=30, replace=False)
        anchors = np.repeat(picks, rng.integers(1, 5, size=30))
        rng.shuffle(anchors)
        n = len(anchors)
        cur[:n] = anchors
    elif case == "high_mult":
        n = JS.MDUP + 8
        cur[:n] = keys[0]
    elif case == "all_miss":
        n = 40
        cur[:n] = np.arange(40, dtype=np.int32) + 500_000
    else:  # empty
        n = 0
    return cur, n, live


def _bag(v, p, n):
    return sorted(zip(v[:n].tolist(), p[:n].tolist()))


@pytest.mark.parametrize("case", ["distinct", "mhot", "mhot_off",
                                  "high_mult", "all_miss", "empty"])
def test_stream_expand_matches_jax(case):
    rng = np.random.default_rng(7)
    sk, ss, sd, e, keys = _mk_segment(rng, nkeys=400, max_deg=9)
    mhot = case != "mhot_off"
    cur, n, live = _frontier(rng, keys, "mhot" if case == "mhot_off"
                             else case, 1024)
    (av, ap, an, at), (bv, bp, bn, bt) = _stream_both(
        sk, ss, sd, e, cur, n, live, 1 << 13, mhot=mhot)
    assert int(at) == int(bt) and int(an) == int(bn)
    if case == "mhot":
        # the m-hot arm emits edge-repeat order: the same bag
        assert int(at) > 0
        assert _bag(av, ap, int(an)) == _bag(bv, bp, int(bn))
        assert not np.any(bv[int(bn):]) and not np.any(bp[int(bn):])
    else:
        _eq(av, bv)
        _eq(ap, bp)


@pytest.mark.parametrize("case", ["distinct", "mhot", "mhot_off",
                                  "high_mult", "all_miss", "empty"])
@pytest.mark.parametrize("bound", ["mdup", "above_mdup", "none",
                                   "lower_past_mdup"])
def test_stream_expand_loose_bound_same_bits(case, bound):
    """A bound above the frontier's true multiplicity gives the exact
    bound's bits: K3 stands in for K2 over distinct keys, past mdup (or
    with no bound) the device picks K3's rows or the gather arm's, and a
    lower bound past mdup takes the gather arm."""
    rng = np.random.default_rng(7)
    sk, ss, sd, e, keys = _mk_segment(rng, nkeys=400, max_deg=9)
    mhot = case != "mhot_off"
    cur, n, live = _frontier(rng, keys, "mhot" if case == "mhot_off"
                             else case, 1024)
    true = _run_mult(sk, sd, cur, n, live)
    loose = {"mdup": max(true, 2) if true <= JS.MDUP else true,
             "above_mdup": max(true, JS.MDUP + 1), "none": None,
             "lower_past_mdup": None}[bound]
    # a lower bound holds only where every matched key has that many rows
    lo = true if bound == "lower_past_mdup" and case == "high_mult" else 1
    args = (_t(sk), _t(ss), _t(sd), _t(e), _t(cur), K.as_count(n, "cpu"),
            _t(live))
    want = S.stream_expand(*args, cap_out=1 << 13, mult=true, mhot=mhot)
    got = S.stream_expand(*args, cap_out=1 << 13, mult=loose, mhot=mhot,
                          mult_lo=lo)
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_stream_overflow_totals_agree():
    rng = np.random.default_rng(11)
    sk, ss, sd, e, keys = _mk_segment(rng, nkeys=128, max_deg=40)
    cur = np.full(256, INT32_MAX, np.int32)
    cur[:128] = keys
    (av, ap, an, at), (bv, bp, bn, bt) = _stream_both(
        sk, ss, sd, e, cur, 128, np.ones(256, bool), JS.TILE)
    assert int(at) == int(bt) > JS.TILE
    assert int(an) == int(bn) == JS.TILE
    _eq(av, bv)
    _eq(ap, bp)


def test_stream_multi_tile_carries():
    """Runs spanning many tiles, one of them longer than three tiles."""
    rng = np.random.default_rng(13)
    nkeys = 500
    keys = np.sort(rng.choice(100_000, nkeys, replace=False)).astype(np.int32)
    degs = rng.integers(1, 8, nkeys)
    degs[100] = 3 * JS.TILE + 17
    offs = np.concatenate([[0], np.cumsum(degs)])
    E = int(offs[-1])
    Ep = 1 << int(E - 1).bit_length()
    sk = np.full(512, INT32_MAX, np.int32)
    sk[:nkeys] = keys
    ss = np.zeros(512, np.int32)
    ss[:nkeys] = offs[:-1]
    sd = np.zeros(512, np.int32)
    sd[:nkeys] = degs
    e = np.full(Ep, INT32_MAX, np.int32)
    e[:E] = rng.integers(0, 2**31 - 1, E, dtype=np.int64)
    cur = np.full(1024, INT32_MAX, np.int32)
    cur[:400] = rng.choice(keys, size=400, replace=False)
    (av, ap, an, at), (bv, bp, bn, bt) = _stream_both(
        sk, ss, sd, e, cur, 400, np.ones(1024, bool), 1 << 13)
    assert int(at) == int(bt) > 3 * JS.TILE
    _eq(av, bv)
    _eq(ap, bp)


@pytest.mark.parametrize("mdup", [2, 8])
def test_stream_mdup_cap(mdup):
    """At the cap the m-hot arm runs (same bag); one past it the gather arm
    (bitwise)."""
    rng = np.random.default_rng(21)
    sk, ss, sd, e, keys = _mk_segment(rng, nkeys=80, max_deg=6)
    picks = rng.choice(keys, size=40, replace=False)
    live = np.ones(512, bool)
    for mult, bitwise in ((mdup, False), (mdup + 1, True)):
        anchors = np.repeat(picks[:30], mult)
        cur = np.full(512, INT32_MAX, np.int32)
        cur[:len(anchors)] = anchors
        (av, ap, an, at), (bv, bp, bn, bt) = _stream_both(
            sk, ss, sd, e, cur, len(anchors), live, 1 << 13, mdup=mdup)
        assert int(at) == int(bt) > 0 and int(an) == int(bn)
        if bitwise:
            _eq(av, bv)
            _eq(ap, bp)
        else:
            assert _bag(av, ap, int(an)) == _bag(bv, bp, int(bn))


def _emit_reference(edges, dsel, dpar, cap, mhot):
    """The emit contract written as a loop over edges."""
    val = np.zeros(cap, np.int64)
    par = np.zeros(cap, np.int64)
    csel = cpar = pos = 0
    for e, ds, dp in zip(edges.tolist(), dsel.tolist(), dpar.tolist()):
        csel += ds
        cpar += dp
        m = max(csel, 0) if mhot else int(csel > 0)
        for c in range(m):
            if pos + c < cap:
                val[pos + c] = e
                par[pos + c] = np.int64(cpar + c).astype(np.int32)
        pos += m
    return val, par, pos


@pytest.mark.parametrize("mhot", [False, True])
def test_emit_plain_matches_definition(mhot):
    """Adversarial deltas (runs, negative dips, wraparound parents): the
    plain emit the kernels are held against equals the loop definition."""
    rng = np.random.default_rng(31 + mhot)
    E = 3000
    edges = rng.integers(0, 2**31 - 1, E).astype(np.int32)
    dsel = rng.choice([-1, 0, 0, 0, 1], E).astype(np.int32)
    dpar = rng.integers(-2**31, 2**31 - 1, E).astype(np.int32)
    cap = 1500
    fn = S.stream_emit_m if mhot else S.stream_emit
    v, p, tot = fn(_t(edges), _t(dsel), _t(dpar), cap)
    rv, rp, rt = _emit_reference(edges, dsel, dpar, cap, mhot)
    assert int(tot) == rt
    assert np.array_equal(v.numpy(), rv) and np.array_equal(p.numpy(), rp)


def _tile_edge_deltas(kind, E, rng):
    """(dsel, dpar) for the CUDA emit's cross-tile cases."""
    if kind == "runs":  # disjoint runs with ascending parents (the K2 path)
        starts = np.sort(rng.choice(E, max(E // 16, 1), replace=False))
        ends = np.minimum(starts + rng.integers(1, 40, len(starts)),
                          np.append(starts[1:], E))
        dsel = np.zeros(E + 1, np.int32)
        np.add.at(dsel, starts, 1)
        np.add.at(dsel, ends, -1)
        dpar = np.zeros(E + 1, np.int32)
        dpar[starts] = np.diff(np.concatenate(
            [[0], rng.integers(0, 1 << 20, len(starts))]))
        return dsel[:E], dpar[:E]
    dpar = rng.integers(-2**31, 2**31 - 1, E).astype(np.int32)  # wraps
    if kind == "one_run":  # one run spanning every tile
        dsel = np.zeros(E, np.int32)
        dsel[0] = 1
    elif kind == "negative":  # a random walk with negative carries
        dsel = rng.choice([-1, 0, 0, 1], E).astype(np.int32)
        dsel[0] = -3
    else:  # "mhot16": piecewise-constant multiplicities 0..16
        cuts = np.sort(rng.choice(np.arange(1, E), E // 50, replace=False))
        levels = rng.integers(0, 17, len(cuts) + 1).astype(np.int32)
        dsel = np.zeros(E, np.int32)
        dsel[0] = levels[0]
        dsel[cuts] = np.diff(levels)
    return dsel, dpar


@pytest.mark.parametrize("E", [S.EMIT_TILE - 1, S.EMIT_TILE, S.EMIT_TILE + 1,
                               3 * S.EMIT_TILE, 3 * S.EMIT_TILE + 5])
@pytest.mark.parametrize("kind", ["runs", "one_run", "negative", "mhot16"])
def test_emit_tile_edges(kind, E):
    """K2 and K3 around the CUDA kernel's tile (EMIT_TILE edges): runs
    across tiles, a run over all of them, negative carries and K3
    multiplicities up to 16, with cap_out cutting inside a tile and inside
    one edge's copies, held against the loop definition. Where the JAX
    kernels take the shape (E a multiple of 256, cap_out of 128, K3
    multiplicity <= 16), also against _stream_emit / _stream_emit_m in
    interpret mode, over the rows below min(total, cap_out)."""
    rng = np.random.default_rng(E + len(kind))
    edges = rng.integers(0, 2**31 - 1, E).astype(np.int32)
    dsel, dpar = _tile_edge_deltas(kind, E, rng)
    csel = np.cumsum(dsel, dtype=np.int64)
    for mhot in (False, True):
        m = np.maximum(csel, 0) if mhot else (csel > 0).astype(np.int64)
        total = int(m.sum())
        past = (total // 128 + 1) * 128
        rv, rp, rt = _emit_reference(edges, dsel, dpar, past, mhot)
        assert rt == total
        caps = [past, total // 2 + 1, max(total // 256 * 128, 128)]
        multi = np.flatnonzero(m >= 2)
        if len(multi):  # just after the first copy of a middle edge
            e = int(multi[len(multi) // 2])
            caps.append(int(m[:e].sum()) + 1)
        fn = S.stream_emit_m if mhot else S.stream_emit
        for cap in caps:
            v, p, tot = fn(_t(edges), _t(dsel), _t(dpar), cap)
            assert int(tot) == total
            assert np.array_equal(v.numpy(), rv[:cap])
            assert np.array_equal(p.numpy(), rp[:cap])
        cap = caps[2]
        if E % 256 or (mhot and m.max() > 16):
            continue
        G = E // 256
        ins = [jnp.asarray(a).reshape(G, 256) for a in (edges, dsel, dpar)]
        if mhot:
            jv, jp, jt = JS._stream_emit_m(*ins, cap_out=cap, interpret=True,
                                           mdup=16)
        else:
            jv, jp, jt = JS._stream_emit(*ins, cap_out=cap, interpret=True)
        n = min(total, cap)
        assert int(np.asarray(jt).reshape(-1)[0]) == total
        assert np.array_equal(np.asarray(jv)[:n, 0], rv[:n])
        assert np.array_equal(np.asarray(jp)[:n, 0], rp[:n])


# ---------------------------------------------------------------------------
# plain pattern / merge kernels vs the jitted JAX functions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def table(seg):
    s, keys = seg
    rng = np.random.default_rng(9)
    C = 1024
    t = np.zeros((2, C), np.int32)
    t[0] = rng.integers(0, 1000, C)
    t[1, :700] = rng.choice(keys, 700)
    t[1, 700:] = rng.integers(1 << 22, 1 << 23, C - 700)
    return t


def test_expand_and_member_mask_known(seg, table):
    s, _ = seg
    C = table.shape[1]
    n = C - 30
    js = (s.bkey, s.bstart, s.bdeg, s.edges)
    ts = (*_lines(s.bkey, s.bstart, s.bdeg), _t(np.asarray(s.edges)))
    for cap in (1024, 4096):  # overflow, then exact
        a = JK.expand(jnp.asarray(table), jnp.int32(n), *js, col=1,
                      cap_out=cap, max_probe=s.max_probe)
        b = K.expand(_t(table), K.as_count(n, "cpu"), *ts, col=1,
                     cap_out=cap, max_probe=s.max_probe)
        for x, y in zip(a, b):
            _eq(x, y)
    out = np.asarray(a[0])
    vals = out[2].copy()
    vals[::3] += 1  # some non-members
    a = JK.member_mask_known(jnp.asarray(out), a[1], jnp.asarray(vals), *js,
                             col=1, max_probe=s.max_probe,
                             depth=s.max_deg_log2)
    b = K.member_mask_known(_t(out), b[1], _t(vals), *ts, col=1,
                            max_probe=s.max_probe, depth=s.max_deg_log2)
    _eq(a, b)
    assert 0 < int(b.sum()) < len(vals)


def test_expand2_matches_jax(table):
    """expand2 over the staged OUT combined segment: a cap_out that cuts
    the expansion, then one that holds it, bit for bit with the JAX
    function; rows past n and anchors with no edges expand to nothing."""
    triples, _ = generate_lubm(1, seed=42)
    v = JDeviceStore(build_partition(triples, 0, 1)).versatile_segment(OUT)
    js = (v.bkey, v.bstart, v.bdeg, v.edges2, v.edges)
    ts = (*_lines(v.bkey, v.bstart, v.bdeg), _t(np.asarray(v.edges2)),
          _t(np.asarray(v.edges)))
    C = table.shape[1]
    n = C - 30
    total = None
    for cap in (1024, 8192):
        a = JK.expand2(jnp.asarray(table), jnp.int32(n), *js, col=1,
                       cap_out=cap, max_probe=v.max_probe)
        b = K.expand2(_t(table), K.as_count(n, "cpu"), *ts, col=1,
                      cap_out=cap, max_probe=v.max_probe)
        for x, y in zip(a, b):
            _eq(x, y)
        total = int(b[2])
    assert 1024 < total <= 8192  # the first capacity cut the expansion


def test_compact_init_and_list_kernels(table):
    rng = np.random.default_rng(4)
    C = table.shape[1]
    keep = rng.random(C) < 0.3
    for cap in (256, 1024):
        for x, y in zip(JK.compact_to(jnp.asarray(table), jnp.asarray(keep),
                                      cap_out=cap),
                        K.compact_to(_t(table), _t(keep), cap)):
            _eq(x, y)
    for x, y in zip(JK.compact(jnp.asarray(table), jnp.asarray(keep)),
                    K.compact(_t(table), _t(keep))):
        _eq(x, y)
    lst = np.full(512, INT32_MAX, np.int32)
    lst[:300] = np.sort(rng.choice(1 << 20, 300, replace=False))
    for x, y in zip(JK.init_from_list(jnp.asarray(lst), jnp.int32(300), 1024),
                    K.init_from_list(_t(lst), 300, 1024)):
        _eq(x, y)
    for x, y in zip(JK.init_batch_index(jnp.asarray(lst), jnp.int32(300), B=3,
                                        cap=1024, slice_mode=False),
                    K.init_batch_index(_t(lst), 300, B=3, cap=1024)):
        _eq(x, y)
    tab = table.copy()
    tab[1, ::2] = lst[rng.integers(0, 300, C // 2)]
    _eq(JK.member_mask_list(jnp.asarray(tab), jnp.int32(900), 1,
                            jnp.asarray(lst), jnp.int32(300)),
        K.member_mask_list(_t(tab), K.as_count(900, "cpu"), 1, _t(lst), 300))
    live = rng.random(C) < 0.9
    for jf, tf in ((JK.merge_member_list, K.merge_member_list),
                   (JK.member_list_binsearch, K.member_list_binsearch)):
        _eq(jf(jnp.asarray(lst), jnp.int32(300), jnp.asarray(tab[1]),
               jnp.int32(900), jnp.asarray(live)),
            tf(_t(lst), 300, _t(tab[1]), K.as_count(900, "cpu"), _t(live)))


def test_merge_kernels(seg):
    """merge_expand, probe_expand, merge_member_pairs, gather_col,
    merge_compact and qid_counts_pos0 on a staged LUBM segment."""
    from wukong_tpu.engine.device_store import DeviceStore

    s, keys = seg
    triples, _ = generate_lubm(1, seed=42)
    g = build_partition(triples, 0, 1)
    m = DeviceStore(g).merge_segment(P["memberOf"], OUT)
    rng = np.random.default_rng(12)
    C = 2048
    cur = np.full(C, INT32_MAX, np.int32)
    n = 1500
    cur[:n] = rng.choice(keys, n)  # duplicates included
    live = rng.random(C) < 0.9
    jm = (m.skey, m.sstart, m.sdeg, m.edges)
    tm = tuple(_t(np.asarray(a)) for a in jm)
    nn = K.as_count(n, "cpu")
    for cap in (1024, 2048):
        a = JK.merge_expand(*jm, jnp.asarray(cur), jnp.int32(n),
                            jnp.asarray(live), cap_out=cap)
        b = K.merge_expand(*tm, _t(cur), nn, _t(live), cap)
        for x, y in zip(a, b):
            _eq(x, y)
        a = JK.probe_expand(s.bkey, s.bstart, s.bdeg, s.edges,
                            jnp.asarray(cur), jnp.int32(n), jnp.asarray(live),
                            cap_out=cap, max_probe=s.max_probe)
        b = K.probe_expand(*_lines(s.bkey, s.bstart, s.bdeg),
                           _t(np.asarray(s.edges)), _t(cur), nn, _t(live),
                           cap, s.max_probe)
        for x, y in zip(a, b):
            _eq(x, y)
    vals = np.asarray(a[0]).copy()
    par = np.asarray(a[1])
    anchor = cur[par]
    vals[::4] += 1
    _eq(JK.merge_member_pairs(m.ekey, m.edges, jnp.int32(m.num_edges),
                              jnp.asarray(anchor), jnp.asarray(vals),
                              a[2], jnp.asarray(live)),
        K.merge_member_pairs(_t(np.asarray(m.ekey)), _t(np.asarray(m.edges)),
                             m.num_edges, _t(anchor), _t(vals), b[2],
                             _t(live)))
    _eq(JK.gather_col(jnp.asarray(cur), a[1]), K.gather_col(_t(cur), b[1]))
    keep = rng.random(2048) < 0.5
    for x, y in zip(JK.merge_compact(a[0], a[1], jnp.asarray(keep), a[2],
                                     cap_out=1024),
                    K.merge_compact(b[0], b[1], _t(keep), b[2], 1024)):
        _eq(x, y)
    pos0 = rng.integers(0, 3 * 500, C).astype(np.int32)
    _eq(JK.qid_counts_pos0(jnp.asarray(pos0), jnp.int32(n), jnp.asarray(live),
                           B=3, r=500, slice_mode=False),
        K.qid_counts_pos0(_t(pos0), nn, _t(live), B=3, r=500))


def test_saturate_total_int32():
    """An exact degree total past 2^31 - 1 saturates to INT32_MAX in both
    packages; below it both give the exact total."""
    big = np.full(4, 2**30, np.int32)  # exact total 2^32: wraps to 0 in int32
    for deg, want in ((big, INT32_MAX), (big[:1], 2**30),
                      (np.asarray([2**31 - 2, 1], np.int32), INT32_MAX)):
        j = JK._saturate_total(jnp.cumsum(jnp.asarray(deg)))
        t = K._saturate_total(torch.cumsum(_t(deg), 0, dtype=torch.int64))
        assert int(j) == int(t) == want
        assert t.dtype == torch.int32
