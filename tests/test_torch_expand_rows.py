"""expand_rows (csrc/expand_rows.cu): expand's row plan and gathers after
its K1 probe, one launch for a table of up to a tile of rows and three past
it. The CUDA kernel runs on the card only (chip_smoke phase 2 holds it
against its plain version on ``chip_smoke.expand_rows_cases()`` and on the
main path's inputs); here:

- a numpy model of the kernel's algorithm (the tile scans, the tile totals'
  scan, the two binary searches a slot makes) equals the plain version bit
  for bit on every adversarial case, with the tile the source declares and
  with a small tile that sends every case down the three-launch form;
- on a CPU tensor the wrapper runs the plain version and counts no launch;
- the JAX expand equals the port's (K1's plain version, then expand_rows)
  on a staged segment, rows past n and a cap_out cut included.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from wukong_tpu_torch.engine import tpu_kernels as K

SRC = Path(K.__file__).resolve().parents[1] / "csrc" / "expand_rows.cu"
TILE = int(re.search(r"constexpr int kTile = (\d+);", SRC.read_text())[1])
CASES = chip_smoke.expand_rows_cases()
INT32_MAX = 2**31 - 1


def kernel_model(table, start, deg, edges, cap_out: int, tile: int):
    """What csrc/expand_rows.cu computes, in the kernel's own steps: each
    tile's inclusive scan of deg, the running total over tiles, and for
    each slot below the total the first tile, then the first row of that
    tile, whose running sum passes the slot."""
    table, start, deg, edges = (x.numpy() for x in (table, start, deg,
                                                    edges))
    W, C = table.shape
    E = edges.shape[0]
    T = -(-C // tile)
    deg64 = deg.astype(np.int64)
    incl = np.concatenate([np.cumsum(deg64[t * tile:(t + 1) * tile])
                           for t in range(T)])
    tile_tot = np.array([incl[min((t + 1) * tile, C) - 1]
                         for t in range(T)], dtype=np.int64)
    tile_incl = np.cumsum(tile_tot)
    total = int(tile_incl[-1])
    j = np.arange(cap_out, dtype=np.int64)
    live = j < total
    jl = j[live]
    t = np.searchsorted(tile_incl, jl, side="right")
    off = np.where(t > 0, tile_incl[np.maximum(t - 1, 0)], 0)
    r = np.empty_like(jl)
    for k in np.unique(t):
        sel = t == k
        seg = incl[k * tile:min((k + 1) * tile, C)]
        r[sel] = k * tile + np.searchsorted(seg, jl[sel] - off[sel],
                                            side="right")
    first = (r // tile) * tile
    excl = off + np.where(r > first, incl[np.maximum(r - 1, 0)], 0)
    e = start.astype(np.int64)[r] + (jl - excl)
    e = np.maximum(np.minimum(e, E - 1), 0)
    out = np.zeros((W + 1, cap_out), dtype=np.int32)
    out[:W, live] = table[:, r]
    if E:
        out[W, live] = edges[e]
    sat = min(total, INT32_MAX)
    return out, min(sat, cap_out), sat


@pytest.mark.parametrize("tile", [TILE, 1000])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_model_equals_plain(case, tile):
    _label, table, start, deg, edges, cap_out = case
    out, out_n, total = K.expand_rows_plain(table, start, deg, edges,
                                            cap_out)
    m_out, m_n, m_total = kernel_model(table, start, deg, edges, cap_out,
                                       tile)
    assert out.dtype == torch.int32 and tuple(out.shape) == m_out.shape
    np.testing.assert_array_equal(out.numpy(), m_out)
    assert (int(out_n), int(total)) == (m_n, m_total)
    assert out_n.dtype == total.dtype == torch.int32
    assert out_n.dim() == total.dim() == 0


def test_cpu_tensors_run_the_plain_version():
    _label, table, start, deg, edges, cap_out = CASES[1]
    before = K.expand_rows.launches
    got = K.expand_rows(table, start, deg, edges, cap_out)
    want = K.expand_rows_plain(table, start, deg, edges, cap_out)
    assert K.expand_rows.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_expand_on_a_staged_segment_equals_jax_and_the_model():
    """On a staged LUBM segment (takesCourse, OUT) and a 5,000-row frontier
    with rows past n (past one tile, so the model takes the three-launch
    form): the JAX expand (its probe and XLA plan) equals the port's (K1's
    plain version, then expand_rows), and the kernel model on K1's
    (start, deg) equals expand_rows' plain version, for a cap_out that cuts
    the total and one that holds it."""
    import jax.numpy as jnp

    from wukong_tpu.engine import tpu_kernels as JK
    from wukong_tpu.engine.device_store import DeviceStore as JDeviceStore
    from wukong_tpu.loader.lubm import P, generate_lubm
    from wukong_tpu.store.gstore import build_partition
    from wukong_tpu.types import OUT
    from wukong_tpu_torch.engine.device_store import line_table

    triples, _ = generate_lubm(1, seed=7)
    g = build_partition(triples, 0, 1)
    s = JDeviceStore(g).segment(P["takesCourse"], OUT)
    keys = np.asarray(g.segments[(P["takesCourse"], OUT)].keys)
    rng = np.random.default_rng(4)
    C, n = 5000, 4700
    table = np.zeros((2, C), np.int32)
    table[0] = rng.integers(0, 1000, C)
    table[1, :n] = rng.choice(keys, n)
    table[1, n:] = rng.choice(keys, C - n)  # past n: no rows
    js = (s.bkey, s.bstart, s.bdeg, s.edges)
    bline, bhi = (torch.from_numpy(np.array(a)) for a in line_table(
        *(np.asarray(x).reshape(-1, 8) for x in (s.bkey, s.bstart,
                                                  s.bdeg))))
    edges = torch.from_numpy(np.array(s.edges))
    tt = torch.from_numpy(table)
    nn = K.as_count(n, "cpu")
    _f, start, deg = K.probe_plain(bline, bhi, tt[1], nn, s.max_probe)
    for cap in (1 << 13, 1 << 15):
        a = JK.expand(jnp.asarray(table), jnp.int32(n), *js, col=1,
                      cap_out=cap, max_probe=s.max_probe)
        b = K.expand(tt, nn, bline, bhi, edges, col=1, cap_out=cap,
                     max_probe=s.max_probe)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
        m_out, m_n, m_total = kernel_model(tt, start, deg, edges, cap, TILE)
        np.testing.assert_array_equal(b[0].numpy(), m_out)
        assert (int(b[1]), int(b[2])) == (m_n, m_total)
    assert int(b[2]) > 1 << 13  # the first cap_out cut the total
