"""Streaming merge-expand: the bandwidth-bound emitter for dense expansions.

The port of the JAX package's engine/tpu_stream.py. The host side scatters
the O(R) run boundaries of the matched frontier rows (R runs) into delta
arrays aligned with the segment's edge array: dsel (+1 at a run start, -1
at its end) and dpar (parent-id deltas at run starts). A kernel then streams
(edges, dsel, dpar), integrates the deltas and compacts the selected
(edge, parent) pairs in edge order — per streamed edge a few bytes instead
of a scatter, a running max and a random gather per output row.

Two hand-written kernels (csrc/stream_emit.cu) replace the Pallas ones:
- K2 ``stream_emit`` (was ``_stream_emit``): distinct anchors; bit-identical
  to ``tpu_kernels.merge_expand``.
- K3 ``stream_emit_m`` (was ``_stream_emit_m``): duplicate anchors with
  per-key multiplicity <= mdup. dsel integrates to a multiplicity m(e); edge
  e fills m(e) consecutive rows (edge-repeat order, a permutation of the
  merge emit's bag) with row positions dupstart + copy that one gather
  resolves to parents.
Above mdup, ``stream_expand`` takes the plain scatter/gather emit. The JAX
package chooses among the three arms with ``lax.cond`` on the device, from
the frontier's duplicates. The port reads nothing to the host for it. The
caller passes ``mult``, a bound it already holds on how many live frontier
rows share one key (the merge executor derives it from the start constants
and the host CSRs' degrees). A bound of 1 launches K2; a bound of at most
mdup launches K3, which over distinct matched keys emits K2's bits (each
edge once, in edge order, with its run's parent). A lower bound past mdup
(``mult_lo``: B in a replicate batch) takes the gather arm. Any other
bound, or none, leaves the choice to the device: K3 and the gather arm
both run, and the frontier's true multiplicity selects K3's rows (at most
mdup) or the gather's, element by element, so every arm gives the JAX
arm's bits. On CPU tensors each kernel wrapper runs its plain version.
"""

from __future__ import annotations

import os

import torch

from wukong_tpu_torch.engine import cuda_lib
from wukong_tpu_torch.engine.tpu_kernels import (
    DUMP,
    I32,
    INT32_MAX,
    _arange,
    _cummax,
    _cumsum,
    _emit_gather,
    _merge_lookup,
    _saturate_total,
    _scatter_set,
    _spill,
)

TILE = 256  # density-gate granularity (the JAX package's tile; the CUDA
#             kernels tile internally and take any edge count)
EMIT_TILE = 4096  # edges one block of csrc/stream_emit.cu takes
#                   (wk_stream_tile); the edge cases of its tests sit here
MDUP = 4  # default m-hot multiplicity cap (WUKONG_STREAM_MDUP overrides)


def mhot_enabled() -> bool:
    """Whether the duplicate-anchor m-hot arm is active (the
    WUKONG_ENABLE_STREAM_MHOT A/B toggle)."""
    return os.environ.get("WUKONG_ENABLE_STREAM_MHOT", "1") != "0"


def stream_mdup() -> int:
    """The active multiplicity cap: WUKONG_STREAM_MDUP or MDUP, in [1, 16]."""
    try:
        v = int(os.environ.get("WUKONG_STREAM_MDUP", MDUP))
    except ValueError:
        return MDUP
    return max(1, min(v, 16))


def want_stream(est_out: float, num_edges: int, cap_out: int) -> bool:
    """Host-side dispatch: stream when the expansion is estimated dense
    enough (>= 1/8 of the segment's edges) and the segment spans at least
    four tiles."""
    from wukong_tpu_torch.config import Global

    if not Global.enable_stream_expand:
        return False
    if num_edges < 4 * TILE or cap_out % TILE != 0:
        return False
    return est_out >= num_edges / 8.0


# ---------------------------------------------------------------------------
# K2 / K3: plain versions and kernel wrappers
# ---------------------------------------------------------------------------


def _emit_plain(edges, dsel, dpar, cap_out: int, mhot: bool):
    E = edges.shape[0]
    csel = _cumsum(dsel)
    cpar = _cumsum(dpar)
    m = csel.clamp(min=0) if mhot else (csel > 0).long()
    pos = _cumsum(m) - m  # first output row of each edge
    total = m.sum()
    val = torch.zeros(cap_out + 1, dtype=I32, device=edges.device)
    par = torch.zeros(cap_out + 1, dtype=I32, device=edges.device)
    copies = int(m.max()) if E else 0
    for c in range(copies):
        live = m > c
        tgt = torch.where(live & (pos + c < cap_out), pos + c, cap_out)
        val.scatter_(0, tgt, edges)
        par.scatter_(0, tgt, (cpar + c).to(I32))
    return val[:cap_out], par[:cap_out], total


def stream_emit_plain(edges, dsel, dpar, cap_out: int):
    """K2's plain version: (val [cap_out], par [cap_out], total int64).
    Edge e is selected where cumsum(dsel)[e] > 0; selected edges land in
    edge order with par = cumsum(dpar)[e] (mod 2^32); rows past the
    emitted count are zero."""
    return _emit_plain(edges, dsel, dpar, cap_out, mhot=False)


def stream_emit_m_plain(edges, dsel, drow, cap_out: int):
    """K3's plain version: edge e fills m(e) = max(cumsum(dsel)[e], 0)
    consecutive rows with row = cumsum(drow)[e] + copy."""
    return _emit_plain(edges, dsel, drow, cap_out, mhot=True)


def _launch_emit(fn_name: str, what: str, edges, dsel, dpar, cap_out: int):
    cuda_lib.require_cuda(what, edges, dsel, dpar)
    E = edges.shape[0]
    for t in (edges, dsel, dpar):
        if t.dtype != I32 or t.shape[0] != E:
            raise ValueError(f"{what}: three int32 arrays of one length "
                             "expected")
    dev = edges.device
    # the kernel writes every output row once (emitted rows, then the zero
    # tail), so nothing is pre-zeroed
    val = torch.empty(cap_out, dtype=I32, device=dev)
    par = torch.empty(cap_out, dtype=I32, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    cuda_lib.require_aligned(what, edges, dsel, dpar, val, par)
    lib = cuda_lib.library("stream_emit.cu")
    scratch = torch.empty(lib.wk_stream_scratch_bytes(E), dtype=torch.uint8,
                          device=dev)
    with torch.cuda.device(dev):  # the launch sizes its grid for this card
        rc = getattr(lib, fn_name)(edges.data_ptr(), dsel.data_ptr(),
                                   dpar.data_ptr(), E, cap_out, val.data_ptr(),
                                   par.data_ptr(), total.data_ptr(),
                                   scratch.data_ptr(),
                                   cuda_lib.stream_ptr(edges))
    cuda_lib.check(lib, rc, what)
    return val, par, total


def stream_emit(edges, dsel, dpar, cap_out: int):
    """K2: replaces wukong_tpu/engine/tpu_stream.py:_stream_emit. CUDA
    tensors launch csrc/stream_emit.cu (wk_stream_emit, one single-pass
    look-back scan and a zero-tail fill); CPU tensors run stream_emit_plain.
    Bound: bytes — 8 B read per edge, 4 B per emitted edge, 8 B written per
    output row (see the source note)."""
    if edges.device.type == "cpu":
        return stream_emit_plain(edges, dsel, dpar, cap_out)
    out = _launch_emit("wk_stream_emit", "stream_emit", edges, dsel, dpar,
                       cap_out)
    cuda_lib.count_launch(stream_emit)
    return out


def stream_emit_m(edges, dsel, drow, cap_out: int):
    """K3: replaces wukong_tpu/engine/tpu_stream.py:_stream_emit_m. CUDA
    tensors launch csrc/stream_emit.cu (wk_stream_emit_m); CPU tensors run
    stream_emit_m_plain. Bound: bytes, as K2."""
    if edges.device.type == "cpu":
        return stream_emit_m_plain(edges, dsel, drow, cap_out)
    out = _launch_emit("wk_stream_emit_m", "stream_emit_m", edges, dsel, drow,
                       cap_out)
    cuda_lib.count_launch(stream_emit_m)
    return out


stream_emit.launches = 0
stream_emit_m.launches = 0


# ---------------------------------------------------------------------------
# the drop-in expand (merge_expand contract)
# ---------------------------------------------------------------------------


def _runs(ks, found, deg, is_seg):
    """Per merged row: is it a matched run (found query row with edges), its
    rank among runs, and whether it is the first run of its key."""
    is_run = ~is_seg & found & (deg > 0)
    rank = torch.cumsum(is_run, 0, dtype=torch.int64) - 1
    prev_run = torch.cat([is_run.new_zeros(1), is_run[:-1]])
    prev_ks = torch.cat([ks[:1], ks[:-1]])
    first_occ = is_run & ~(prev_run & (prev_ks == ks))
    return is_run, rank, first_occ


def _deltas(starts, ends, vals, n_valid, Et: int, size: int, like):
    """dsel/dpar-style delta arrays over [Et + DUMP]: +1 at valid starts,
    -1 at valid ends, and ``vals`` deltas at valid starts (the invalid
    entries go to the dump slots past Et, which the caller cuts off)."""
    valid = _arange(size, like) < n_valid
    spill = _spill(size, Et, like)
    s_idx = torch.where(valid, starts.long(), spill)
    dsel = torch.zeros(Et + DUMP, dtype=I32, device=like.device)
    dsel.index_add_(0, s_idx, torch.ones(size, dtype=I32, device=like.device))
    if ends is not None:
        e_idx = torch.where(valid, ends.long(), spill)
        dsel.index_add_(0, e_idx, torch.full((size,), -1, dtype=I32,
                                             device=like.device))
    prev = torch.cat([vals[:1] * 0, vals[:-1]])
    dv = torch.where(valid, vals - prev, 0).to(I32)
    dval = torch.zeros(Et + DUMP, dtype=I32, device=like.device)
    dval.index_add_(0, s_idx, dv)
    return dsel, dval


def stream_expand(skey, sstart, sdeg, edges, cur, n, live, cap_out: int,
                  mult: int | None, mhot: bool = True, mdup: int = MDUP,
                  mult_lo: int = 1):
    """known_to_unknown expansion with the streaming emitter: (val
    [cap_out], parent [cap_out], out_n, total).

    ``mult`` bounds how many live frontier rows (i < n, live) whose key
    has edges in the segment share one key (None: no bound known), and
    ``mult_lo`` is how many such rows each matched key has at least. A
    ``mult`` of at most 1: K2 emits, bit-identical to merge_expand. At most
    mdup: K3 (the same bag in edge-repeat order). With ``mhot=False``, or a
    ``mult_lo`` past mdup, the plain scatter/gather emit (bit-identical to
    merge_expand). Otherwise the true multiplicity, on the device, picks
    K3's rows (at most mdup) or the gather arm's. Nothing is read from the
    card."""
    C = cur.shape[0]
    S = skey.shape[0]
    rows = _arange(C, cur)
    ok_row = (rows < n) & live
    curm = torch.where(ok_row, cur, INT32_MAX)
    ks, ts, found, start, deg, is_seg = _merge_lookup(skey, sstart, sdeg, curm)
    deg = torch.where(is_seg, 0, deg)
    cum = _cumsum(deg)
    total = _saturate_total(cum)
    st_ex = cum - deg

    is_run, rank, first_occ = _runs(ks, found, deg, is_seg)

    Et = edges.shape[0]
    SC = is_run.shape[0]
    if mult is not None and mult <= 1:
        arm = "stream"
    elif not mhot:
        arm = "gather"
    elif mult is not None and mult <= mdup:
        arm = "mhot"
    elif mult_lo > mdup:
        arm = "gather"
    else:
        arm = "device"

    if arm in ("gather", "device"):
        val, parent = _emit_gather(ts, S, start, deg, st_ex, edges, total,
                                   cap_out)
    if arm == "stream":
        # compact matched runs (disjoint, ascending starts in key order)
        tgt = torch.where(is_run, rank, SC)
        rstart = _scatter_set(SC, tgt, start)
        rdeg = _scatter_set(SC, tgt, deg)
        rpar = _scatter_set(SC, tgt, ts - S)
        n_runs = is_run.sum()
        dsel, dpar = _deltas(rstart, rstart + rdeg, rpar, n_runs, Et, SC, cur)
        val, parent, _tot = stream_emit(edges, dsel[:Et], dpar[:Et], cap_out)
    elif arm in ("mhot", "device"):
        n_runs, n_first = is_run.sum(), first_occ.sum()
        if arm == "device":
            # the JAX gate (tpu_stream.py:752-762) on the device: the
            # largest run multiplicity, each run counted from its key's
            # first run; when the gather arm wins, K3 gets no runs and
            # makes one pass over the edges
            dupstart = _cummax(torch.where(first_occ, rank, -1))
            mmax = torch.max(torch.where(is_run, rank - dupstart + 1, 0))
            use_m = mmax <= mdup
            n_runs = torch.where(use_m, n_runs, 0)
            n_first = torch.where(use_m, n_first, 0)
        # dsel over ALL runs: duplicated boundaries accumulate multiplicity
        tgt = torch.where(is_run, rank, SC)
        rstart = _scatter_set(SC, tgt, start)
        rdeg = _scatter_set(SC, tgt, deg)
        dsel, _ = _deltas(rstart, rstart + rdeg, rstart, n_runs, Et, SC, cur)
        # drow: dupstart deltas at FIRST-occurrence run starts only
        rk1 = torch.cumsum(first_occ, 0, dtype=torch.int64) - 1
        tgt1 = torch.where(first_occ, rk1, SC)
        r1start = _scatter_set(SC, tgt1, start)
        r1dst = _scatter_set(SC, tgt1, torch.where(first_occ, rank, 0))
        _, drow = _deltas(r1start, None, r1dst, n_first, Et, SC, cur)
        # parents of found rows in sorted-rank order (the rowpos codomain)
        parents_sorted = _scatter_set(SC, tgt, ts - S)
        val_m, rowpos, _tot = stream_emit_m(edges, dsel[:Et], drow[:Et],
                                            cap_out)
        parent_m = parents_sorted[rowpos.clamp(0, SC - 1).long()]
        if arm == "mhot":
            val, parent = val_m, parent_m
        else:
            val = torch.where(use_m, val_m, val)
            parent = torch.where(use_m, parent_m, parent)
    okj = _arange(cap_out, cur) < total
    return (torch.where(okj, val, 0), torch.where(okj, parent, 0),
            torch.clamp(total, max=cap_out), total)
