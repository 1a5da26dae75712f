"""Sorted-array join primitives for the WCOJ executor and compiled templates.

The port's copy of the JAX package's join/kernels.py. The JAX module writes
every kernel once against a swappable array module (NumPy on the host, XLA
under ``jax.jit`` on the device). Here the same functions take NumPy arrays
(the host route) or torch tensors (the device route: tensors on the proxy's
device, int32 as the JAX device path is with x64 off) and run the matching
library's ops; each torch branch repeats the NumPy one step for step, so
the two routes give the same answers.

Data model: adjacency is the store's CSR triplet (sorted unique ``keys``,
``offsets``, ``edges`` sorted within each key run); candidate sets are
sorted 1-D id arrays. Intersection = membership mask via vectorized binary
search; ragged per-row probes = fixed-iteration branchless lower_bound over
each row's [start, end) edge range.

:func:`level_probe` is the one device computation here that stock torch ops
cannot do in a few launches (``depth`` iterations of about six ops per
adjacency): on a CUDA tensor it launches the hand-written kernel
``csrc/level_probe.cu`` (which replaces the JAX ``jit_level_probe``), on a
CPU tensor it runs :func:`level_probe_plain`, the same function in plain
PyTorch. The stream plane's epoch frontier (``seed_masks``,
``seed_extract``, ``unique_rows_padded``) is a dozen stock torch ops on the
card, batched over terms as one [T, N] computation; the NumPy twins
(``seed_masks_host``, ``seed_extract_host``) are its parity oracles. The
distributed join's ``concat_rows_padded`` waits for the distributed engine
(ROADMAP §A, "``parallel/``, the distributed engine").
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from wukong_tpu_torch.engine import cuda_lib

I32 = torch.int32


def _is_t(a) -> bool:
    return isinstance(a, torch.Tensor)


def member_sorted(sorted_arr, vals):
    """Boolean mask: is ``vals[i]`` present in ``sorted_arr``?

    One vectorized binary search + one gather. Empty set -> all-False."""
    n = int(sorted_arr.shape[0])
    if _is_t(vals):
        if n == 0:
            return torch.zeros(vals.shape[0], dtype=torch.bool,
                               device=vals.device)
        idx = torch.searchsorted(sorted_arr, vals, out_int32=True)
        return (idx < n) & (sorted_arr[idx.clamp(0, n - 1)] == vals)
    if n == 0:
        return np.zeros(vals.shape[0], dtype=bool)
    idx = np.searchsorted(sorted_arr, vals)
    idx_c = np.clip(idx, 0, n - 1)
    return (idx < n) & (sorted_arr[idx_c] == vals)


def intersect_sorted(a, b):
    """Sorted intersection of two sorted unique arrays (result stays
    sorted/unique). The smaller side should be ``a`` — the probe cost is
    ``|a| * log |b|``."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        return a[:0]
    return a[member_sorted(b, a)]


def intersect_many(lists):
    """Fold-intersect sorted unique arrays, smallest first (leapfrog's
    seek-from-the-shortest-list order). Empty input list -> None."""
    if not lists:
        return None
    out = None
    for arr in sorted(lists, key=lambda t: t.shape[0]):
        out = arr if out is None else intersect_sorted(out, arr)
        if out.shape[0] == 0:
            break
    return out


def lookup_ranges(keys, offsets, vids):
    """(start, degree) of each vid's edge range in a CSR (0 when absent).
    NumPy arrays give int64 ranges; torch tensors (int32 tables) give the
    tables' dtype, as the JAX device path's int32."""
    n = int(keys.shape[0])
    if _is_t(vids):
        if n == 0:
            z = torch.zeros(vids.shape[0], dtype=offsets.dtype,
                            device=vids.device)
            return z, z
        idx = torch.searchsorted(keys, vids, out_int32=True)
        idx_c = idx.clamp(0, n - 1)
        found = (idx < n) & (keys[idx_c] == vids)
        lo = offsets[idx_c]
        zero = torch.zeros((), dtype=offsets.dtype, device=vids.device)
        start = torch.where(found, lo, zero)
        deg = torch.where(found, offsets[idx_c + 1] - lo, zero)
        return start, deg
    if n == 0:
        z = np.zeros(vids.shape[0], dtype=np.int64)
        return z, z
    idx = np.searchsorted(keys, vids)
    idx_c = np.clip(idx, 0, n - 1)
    found = (idx < n) & (keys[idx_c] == vids)
    start = np.where(found, offsets[idx_c], 0)
    deg = np.where(found, offsets[idx_c + 1] - offsets[idx_c], 0)
    return start, deg


def expand_ragged(start: np.ndarray, deg: np.ndarray):
    """(row_idx, flat edge positions) for a ragged per-row expansion.

    deg=[2,0,3] -> row_idx=[0,0,2,2,2], pos=[s0,s0+1,s2,s2+1,s2+2]
    (row indices are ORIGINAL positions — zero-degree rows are skipped,
    never compacted away, so callers may index anchors with row_idx).
    Host-side only (the output length is data-dependent — the device path
    pads to a capacity class instead, :func:`expand_padded`)."""
    row_idx = np.repeat(np.arange(len(deg)), deg)
    total = int(deg.sum())
    local = np.ones(total, dtype=np.int64)
    if total:
        starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
        nz = deg > 0
        local[starts[nz]] = np.concatenate([[0], 1 - deg[nz][:-1]])
        local = np.cumsum(local)
    return row_idx, start[row_idx] + local


def pair_member(keys, offsets, edges, anchors, vals, depth=None):
    """Boolean mask: does edge (anchors[i] -> vals[i]) exist in the CSR?

    Branchless lower_bound over each row's sorted [start, end) edge range,
    iterated a FIXED ``log2(len(edges))+1`` times; ``depth`` overrides the
    iteration count (each row's range is ONE key's edge run, so
    ``log2(max_degree)+1`` converges every row — the device path passes the
    table's cached degree bound). NumPy searches in int64, torch in the
    tables' int32 with the midpoint ``lo + (hi - lo) // 2``: ``lo + hi``
    overflows past 2^30 edges (the classic binary-search midpoint bug)."""
    ne = int(edges.shape[0])
    t = _is_t(anchors)
    if ne == 0:
        return (torch.zeros(anchors.shape[0], dtype=torch.bool,
                            device=anchors.device) if t
                else np.zeros(anchors.shape[0], dtype=bool))
    start, deg = lookup_ranges(keys, offsets, anchors)
    if t:
        lo = start
        end = hi = start + deg
    else:
        lo = start.astype(np.int64)
        end = hi = (start + deg).astype(np.int64)
    iters = ne.bit_length() + 1 if depth is None else max(int(depth), 1)
    for _ in range(iters):
        active = lo < hi
        mid = lo + (hi - lo) // 2
        if t:
            less = edges[mid.clamp(0, ne - 1)] < vals
            lo = torch.where(active & less, mid + 1, lo)
            hi = torch.where(active & ~less, mid, hi)
        else:
            less = edges[np.clip(mid, 0, ne - 1)] < vals
            lo = np.where(active & less, mid + 1, lo)
            hi = np.where(active & ~less, mid, hi)
    inb = lo < end
    if t:
        return inb & (edges[lo.clamp(0, ne - 1)] == vals)
    return inb & (edges[np.clip(lo, 0, ne - 1)] == vals)


# ---------------------------------------------------------------------------
# the device level path: padded candidate tensors
# ---------------------------------------------------------------------------

#: smallest padded capacity class — tiny dispatches all share one shape
PAD_FLOOR = 1024


def pad_pow2(n: int, floor: int = PAD_FLOOR) -> int:
    """The device path's capacity class: smallest power of two >=
    max(n, floor). Candidate tensors are padded to it so the device
    programs see a bounded set of shapes (the engine's capacity-class
    discipline)."""
    c = max(int(n), int(floor), 1)
    return 1 << (c - 1).bit_length()


class DeviceRangeError(ValueError):
    """An array holds values outside int32 — the device path (int32, as the
    JAX device path under the default x64-off config) must degrade to host
    rather than silently truncate ids or offsets."""


def check_i32(arr, what: str = "values") -> np.ndarray:
    """``arr`` as a NumPy array, REFUSING (DeviceRangeError) any value
    outside int32 instead of truncating."""
    a = np.asarray(arr)
    if len(a) and a.dtype != np.int32:
        lo, hi = int(a.min()), int(a.max())
        if lo < -(1 << 31) or hi >= (1 << 31):
            raise DeviceRangeError(
                f"{what} [{lo}, {hi}] exceed int32 — host route required")
    return a


def to_device_i32(arr, device) -> torch.Tensor:
    """Host int array -> int32 tensor on ``device``, REFUSING
    (DeviceRangeError) any value outside int32 instead of truncating.
    Offsets past 2^31 (a >2G-edge segment) and out-of-range ids therefore
    degrade the query to the host kernels, never to wrong answers. A copy to
    the card goes through pinned memory without a host sync."""
    from wukong_tpu_torch.engine.tpu_kernels import upload

    a = check_i32(arr).astype(np.int32, copy=False)
    return upload(np.ascontiguousarray(a), torch.device(device))


def level_probe_plain(valid, cand, glob, adj):
    """The level probe in plain PyTorch (same argument layout as
    :func:`level_probe`): ``valid`` AND membership of ``cand`` in the sorted
    ``glob`` (None: no glob) AND, for each adjacency ``(keys, offsets,
    edges, anchors, depth[, index])`` in ``adj``, the edge anchors[i] ->
    cand[i] (a keys index changes no answer and is not read here)."""
    mask = valid.clone()
    if glob is not None:
        mask &= member_sorted(glob, cand)
    for keys, offsets, edges, anchors, depth, *_index in adj:
        mask &= pair_member(keys, offsets, edges, anchors, cand, depth=depth)
    return mask


class _WkAdj(ctypes.Structure):
    """The C ``WkAdj`` descriptor of csrc/level_probe.cu."""

    _fields_ = [("keys", ctypes.c_void_p), ("offsets", ctypes.c_void_p),
                ("edges", ctypes.c_void_p), ("anchors", ctypes.c_void_p),
                ("index", ctypes.c_void_p), ("nkeys", ctypes.c_int),
                ("nedges", ctypes.c_int), ("depth", ctypes.c_int),
                ("nindex", ctypes.c_int)]


_wk = None  # the bound C library, set at the first launch


def _lib():
    global _wk
    if _wk is None:
        lib = cuda_lib.library("level_probe.cu")
        lib.max_adj = int(lib.wk_level_probe_max_adj())
        _wk = lib
    return _wk


def keys_index(keys_host, keys):
    """The level probe's dense index of a staged keys table (``keys`` the
    sorted unique int32 tensor on the card, ``keys_host`` its host copy):
    int64 words, one a 32 ids, holding their bits and the position of the
    first, built on the card when the table is staged and waited for, so
    that any thread or stream may read it once this returns. Pass it as the
    sixth item of the table's adjacency tuples. None on the CPU (the plain
    version searches) and where the keys are too sparse for one (the
    kernel searches them)."""
    n = len(keys_host)
    if keys.device.type == "cpu" or n == 0:
        return None
    lib = _lib()
    nw = int(lib.wk_level_probe_index_words(int(keys_host[0]),
                                            int(keys_host[-1]), n))
    if nw == 0:
        return None
    words = torch.empty(nw, dtype=torch.int64, device=keys.device)
    rc = lib.wk_level_probe_build_index(keys.data_ptr(), n, words.data_ptr(),
                                        nw, keys.get_device(),
                                        cuda_lib.stream_ptr(keys))
    if rc:
        cuda_lib.check(lib, rc, "level_probe keys index")
    torch.cuda.current_stream(keys.device).synchronize()
    return words


def _check_probe_args(valid, cand, glob, adj) -> None:
    C = cand.shape[0]
    if valid.dtype is not torch.bool or cand.dtype is not I32 \
            or cand.dim() != 1 or valid.shape != cand.shape:
        raise ValueError("level_probe: valid must be bool and cand int32, "
                         f"both [C]; got {valid.dtype} {tuple(valid.shape)}, "
                         f"{cand.dtype} {tuple(cand.shape)}")
    tensors = [valid, cand]
    if glob is not None:
        if glob.dtype is not I32 or glob.dim() != 1:
            raise ValueError(f"level_probe: glob must be int32 [n], got "
                             f"{glob.dtype} {tuple(glob.shape)}")
        tensors.append(glob)
    for keys, offsets, edges, anchors, _depth, index in adj:
        if any(a.dtype is not I32 for a in (keys, offsets, edges, anchors)):
            raise ValueError("level_probe: CSR tables and anchors must be "
                             "int32")
        if anchors.shape != (C,) or offsets.shape[0] != keys.shape[0] + 1:
            raise ValueError("level_probe: anchors must be [C] and offsets "
                             "[nkeys + 1]")
        tensors += [keys, offsets, edges, anchors]
        if index is not None:
            if index.dtype is not torch.int64 or index.dim() != 1:
                raise ValueError("level_probe: a keys index must be the "
                                 "int64 words of keys_index")
            tensors.append(index)
    cuda_lib.require_cuda("level_probe", *tensors)
    dev = cand.get_device()
    if any(t.get_device() != dev for t in tensors):
        raise ValueError("level_probe: every tensor must be on one device")


def level_probe(valid, cand, glob, adj):
    """mask[C] of one WCOJ generator group (or a template pair probe):
    ``valid`` AND ``cand`` in the sorted ``glob`` (None: no glob) AND every
    adjacency's edge ``anchors[i] -> cand[i]``; ``adj`` is a sequence of
    ``(keys, offsets, edges, anchors, depth)`` with int32 tables, each
    optionally with a sixth item, the keys' :func:`keys_index` (or None).

    Replaces wukong_tpu/join/kernels.py:jit_level_probe. CUDA tensors
    launch csrc/level_probe.cu (below 2^21 candidates a thread a candidate;
    from there a dense index of the glob built on the card first, the keys'
    indices read where given, a warp's lanes of one anchor sharing its key
    lookup; every adjacency in one probe launch up to its descriptor limit,
    more chaining launches over the mask), counted once a probe launch on
    ``level_probe.launches``; CPU tensors run :func:`level_probe_plain`.
    Bound: bytes (see the source note). No launch for an empty candidate
    tensor. One allocation a call: the mask, with the glob index's scratch
    after it."""
    if cand.device.type == "cpu":
        return level_probe_plain(valid, cand, glob, adj)
    adj = [(a[0], a[1], a[2], a[3], max(int(a[4]), 1),
            a[5] if len(a) > 5 else None) for a in adj]
    _check_probe_args(valid, cand, glob, adj)
    C = cand.shape[0]
    if C == 0:
        return torch.empty(0, dtype=torch.bool, device=cand.device)
    lib = _lib()
    nglob = 0 if glob is None else glob.shape[0]
    gw = int(lib.wk_level_probe_glob_words(C, nglob)) if nglob else 0
    if gw:  # one buffer: the mask, then the glob index's 8-byte words
        at = -(-C // 16) * 16
        buf = torch.empty(at + 8 * gw, dtype=torch.bool, device=cand.device)
        mask, gindex = buf[:C], buf.data_ptr() + at
    else:
        mask, gindex = torch.empty(C, dtype=torch.bool,
                                   device=cand.device), None
    stream = cuda_lib.stream_ptr(cand)
    dev = cand.get_device()
    src = valid
    for k in range(0, max(len(adj), 1), lib.max_adj):
        chunk = adj[k:k + lib.max_adj]
        descs = (_WkAdj * max(len(chunk), 1))()
        for j, (keys, offsets, edges, anchors, depth, index) in \
                enumerate(chunk):
            descs[j] = _WkAdj(keys.data_ptr(), offsets.data_ptr(),
                              edges.data_ptr(), anchors.data_ptr(),
                              None if index is None else index.data_ptr(),
                              keys.shape[0], edges.shape[0], depth,
                              0 if index is None else index.shape[0])
        use_glob = glob is not None and k == 0
        rc = lib.wk_level_probe(
            src.data_ptr(), cand.data_ptr(), C,
            glob.data_ptr() if use_glob else None,
            nglob if use_glob else 0, int(use_glob),
            gindex if use_glob else None, gw if use_glob else 0,
            ctypes.addressof(descs), len(chunk), mask.data_ptr(), dev,
            stream)
        if rc:
            cuda_lib.check(lib, rc, "level_probe")
        cuda_lib.count_launch(level_probe)
        src = mask
    return mask


level_probe.launches = 0


def level_probe_host(valid, cand, glob, *adj):
    """NumPy twin of the level probe in the JAX argument layout (``adj``
    flattened as keys, offsets, edges, anchors per adjacency, searched to
    full depth; ``glob`` None: no glob) — the parity oracle the tests hold
    the device route against, and the JAX module's function of the same
    name."""
    mask = np.asarray(valid).copy()
    if glob is not None:
        mask &= member_sorted(np.asarray(glob), np.asarray(cand))
    for j in range(len(adj) // 4):
        keys, offsets, edges, anchors = adj[4 * j: 4 * j + 4]
        mask &= pair_member(np.asarray(keys), np.asarray(offsets),
                            np.asarray(edges), np.asarray(anchors),
                            np.asarray(cand))
    return mask


# ---------------------------------------------------------------------------
# whole-plan compiled-template kernels (engine/template_compile.py)
# ---------------------------------------------------------------------------

def expand_padded(start, deg, edges, out_cap: int):
    """Order-preserving ragged expansion to a STATIC output capacity, on
    torch tensors (int32).

    The padded twin of :func:`expand_ragged`: rows land in source-row
    order with each row's edges contiguous (np.repeat order), so a
    validity-compacted result is byte-identical to the host expansion.
    Rows the caller masked out must arrive with ``deg == 0``.

    Returns ``(row_idx, values, valid, total, overflow)`` (``total`` and
    ``overflow`` 0-d device tensors: no host sync). The cumulative sum is
    int32 as in the JAX device path and can wrap: a float32 shadow sum of
    the degrees catches totals past 2^31 that the wrapped comparison would
    miss, so ``overflow`` trips on them and the caller regrows or degrades,
    never truncates."""
    n = int(start.shape[0])
    ne = int(edges.shape[0])
    dev = start.device
    cum = torch.cumsum(deg, 0, dtype=I32)
    total = cum[n - 1]
    pos = torch.arange(out_cap, dtype=I32, device=dev)
    row = torch.searchsorted(cum, pos, right=True, out_int32=True)
    rowc = row.clamp(0, n - 1)
    zero = torch.zeros((), dtype=I32, device=dev)
    prev = torch.where(rowc > 0, cum[(rowc - 1).clamp(0, n - 1)], zero)
    local = pos - prev
    if ne:
        values = edges[(start[rowc] + local).clamp(0, ne - 1)]
    else:
        values = torch.zeros(out_cap, dtype=start.dtype, device=dev)
    valid = (pos < total) & (total > 0)
    fsum = deg.to(torch.float32).sum()
    overflow = (total > out_cap) | (total < 0) | (fsum > float(out_cap))
    return rowc, values, valid, total, overflow


# ---------------------------------------------------------------------------
# the stream plane's epoch frontier (stream/continuous.py)
# ---------------------------------------------------------------------------

def seed_masks(s, p, o, tp, ts, to, eq):
    """Every semi-naive term's frontier row mask over an epoch batch,
    [T, N]: triples [N] columns against per-term specs [T] (predicate,
    subject-const, object-const, repeated-var equality; -1 = wildcard
    endpoint). NumPy arrays or torch tensors: the broadcasting below is the
    same in both libraries, so the host twin and the device path are one
    function, as in the JAX module."""
    m = p[None, :] == tp[:, None]
    m &= (ts[:, None] < 0) | (s[None, :] == ts[:, None])
    m &= (to[:, None] < 0) | (o[None, :] == to[:, None])
    m &= (~eq[:, None]) | (s[None, :] == o[None, :])
    return m


def seed_masks_host(s, p, o, tp, ts, to, eq) -> np.ndarray:
    """NumPy instance of :func:`seed_masks` (the parity oracle)."""
    return seed_masks(*(np.asarray(x) for x in (s, p, o, tp, ts, to, eq)))


def _unique_rows_np(ca, cb, valid):
    """The JAX module's padded two-column dedupe, in NumPy: live rows
    lexsorted (first column primary), adjacent duplicates masked, the
    survivors stably compacted to the front, sorted duplicates after."""
    n = int(ca.shape[0])
    order = np.lexsort((cb, ca, ~valid))
    a, b, v = ca[order], cb[order], valid[order]
    first = np.concatenate([np.ones(1, dtype=bool),
                            (a[1:] != a[:-1]) | (b[1:] != b[:-1])])
    uniq = v & first
    count = np.sum(uniq.astype(np.int32))
    comp = np.lexsort((np.arange(n), ~uniq))
    return a[comp], b[comp], count


def _stable_first(flag: torch.Tensor) -> torch.Tensor:
    """Per-row stable permutation that moves the True entries of ``flag``
    [T, N] to the front, in their order."""
    return torch.sort((~flag).to(torch.uint8), dim=1, stable=True).indices


def _unique_rows_t(A: torch.Tensor, B: torch.Tensor, valid: torch.Tensor):
    """The batched dedupe on torch tensors: for each of T rows of [T, N]
    int32 columns, the distinct live (a, b) pairs in ascending order,
    compacted to the front, and their count. One int64 composite key
    (a << 32 | b + 2^31, monotone in (a, b) over all of int32) sorted
    stably, then stably by liveness (a live key may equal any value, so
    dead rows are ordered by a flag, not a sentinel key); an adjacent
    difference marks the first of each run, and a last stable sort
    compacts the survivors. No host sync."""
    key = (A.to(torch.int64) << 32) + (B.to(torch.int64) + (1 << 31))
    order = torch.sort(key, dim=1, stable=True).indices
    key = key.gather(1, order)
    live = valid.gather(1, order)
    order = _stable_first(live)
    key = key.gather(1, order)
    live = live.gather(1, order)
    first = torch.ones_like(live)
    first[:, 1:] = key[:, 1:] != key[:, :-1]
    uniq = live & first
    count = uniq.sum(dim=1, dtype=torch.int32)
    key = key.gather(1, _stable_first(uniq))
    a = (key >> 32).to(torch.int32)
    b = ((key & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)
    return a, b, count


def unique_rows_padded(ca, cb, valid):
    """Padded two-column row dedupe matching ``np.unique(axis=0)`` order:
    ``(col_a, col_b, count)`` with the first ``count`` rows equal, bit for
    bit, to the host oracle's unique rows. A one-column dedupe passes the
    same array as both columns. NumPy input runs the JAX module's lexsort
    twin, whose padding holds the sorted duplicates; torch input runs the
    composite-key sort, whose padding is unspecified (its values are the
    dead rows' and duplicates' in key order)."""
    if _is_t(ca):
        a, b, c = _unique_rows_t(ca[None], cb[None], valid[None])
        return a[0], b[0], c[0]
    return _unique_rows_np(np.asarray(ca), np.asarray(cb),
                           np.asarray(valid))


def seed_extract_term(s, p, o, tp, ts, to, eq, ca, cb):
    """One semi-naive term's fused frontier (NumPy): the seed_masks row
    mask and the term's unique seed rows in one pass over the padded
    epoch batch. ``ca``/``cb`` select the term's seed columns out of the
    stacked (s, p, o) columns (``ca == cb`` for a one-variable term).
    Returns ``(col_a, col_b, count)``, the first ``count`` rows live, in
    np.unique(axis=0) order."""
    m = seed_masks_host(s, p, o, np.asarray([tp]), np.asarray([ts]),
                        np.asarray([to]), np.asarray([eq]))[0]
    cols = np.stack([np.asarray(s), np.asarray(p), np.asarray(o)])
    return _unique_rows_np(cols[int(ca)], cols[int(cb)], m)


def seed_extract_host(s, p, o, tp, ts, to, eq, ca, cb):
    """NumPy twin of :func:`seed_extract` (the parity oracle): a Python
    loop over terms, each through :func:`seed_extract_term`."""
    outs = [seed_extract_term(s, p, o, np.asarray(tp)[t], np.asarray(ts)[t],
                              np.asarray(to)[t], np.asarray(eq)[t],
                              int(ca[t]), int(cb[t]))
            for t in range(len(tp))]
    return (np.stack([a for a, _, _ in outs]),
            np.stack([b for _, b, _ in outs]),
            np.asarray([int(c) for _, _, c in outs]))


def seed_extract(s, p, o, tp, ts, to, eq, ca, cb):
    """Every term's frontier mask AND its deduped seed rows for a whole
    epoch batch, batched over terms as one [T, N] computation on torch
    tensors (the JAX module's ``jit_seed_extract``, a vmap of
    :func:`seed_extract_term`): ``(A [T, N], B [T, N], counts [T])`` int32,
    each term's first ``counts[t]`` rows equal to np.unique(axis=0)'s over
    its matching rows. The padding after them is unspecified (the JAX
    function's holds sorted duplicates). No Python loop over terms and no
    host sync: the caller copies the result back once."""
    m = seed_masks(s, p, o, tp, ts, to, eq)
    cols = torch.stack([s, p, o])
    return _unique_rows_t(cols[ca.long()], cols[cb.long()], m)
