"""Triple-pattern kernels over hashed CSR segments, in PyTorch.

The port of the JAX package's engine/tpu_kernels.py. Binding tables keep the
JAX layout [width, capacity]; every array is int32 (the JAX reference runs
with x64 off) and every function takes a live-row count ``n`` as a 0-d
device tensor, so a chain never reads a device value mid-query. Overflow
totals ride along as 0-d tensors and are checked at the end-of-chain sync.

The hand-written kernels here are K1, ``probe_kernel`` (csrc/probe.cu),
which replaces the Pallas ``pallas_probe``, and ``expand_rows``
(csrc/expand_rows.cu), expand's row plan and gathers after the probe. On a
CUDA tensor each launches its kernel; on a CPU tensor each runs its plain
version (``_hash_find``, ``expand_rows_plain``). Every other function is
plain PyTorch on whatever device its inputs live on.

int32 notes (the places where torch and jnp differ):
- ``torch.cumsum`` of int32 accumulates in int64 here; totals saturate to
  INT32_MAX exactly where the JAX int32 cumsum would have wrapped
  (``_saturate_total``).
- ``.at[idx].max/set/add(mode="drop")`` becomes a scatter into one extra
  dump slot that is cut off afterwards (no boolean indexing, so no sync).
- ``jnp.nonzero(keep, size=cap, fill_value=C-1)`` becomes ``_nonzero_fill``.
- multi-key ``lax.sort`` with a unique trailing tag becomes a stable sort.
"""

from __future__ import annotations

import torch

from wukong_tpu_torch.engine import cuda_lib

INT32_MAX = 2**31 - 1
INT32_MIN = -(2**31)
_HASH_MULT = 2654435761
BUCKET = 8

I32 = torch.int32


def as_count(n, device) -> torch.Tensor:
    """A live-row count as the 0-d int32 device tensor the kernels take
    (from a host int, a fill on the card: no copy, so no host sync)."""
    if isinstance(n, torch.Tensor):
        if n.dtype == I32 and n.dim() == 0 and n.device == torch.device(
                device):
            return n  # the chain's own count: no call into PyTorch's ops
        return n.to(device=device, dtype=I32).reshape(())
    return torch.full((), int(n), dtype=I32, device=device)


def upload(a, device) -> torch.Tensor:
    """A host numpy table on ``device``. To the card it goes through pinned
    memory asynchronously, so the host does not wait for the work already
    queued (a pageable copy synchronizes the stream)."""
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=like.device)


# dropped scatter writes go to DUMP slots past the end, spread by position:
# millions of writes to one address serialize on the card
DUMP = 1024


def _spill(n: int, size: int, like: torch.Tensor) -> torch.Tensor:
    """The dump slot of each of ``n`` scatter sources: size + (i % DUMP)."""
    return size + (torch.arange(n, device=like.device) & (DUMP - 1))


def _dump_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Scatter targets with every out-of-range index sent past ``size``
    (the JAX ``mode="drop"`` rule; the caller cuts the dump slots off)."""
    ok = (idx >= 0) & (idx < size)
    return torch.where(ok, idx.long(), _spill(idx.shape[0], size, idx))


def _scatter_max(size: int, idx, vals) -> torch.Tensor:
    """zeros(size).at[idx].max(vals, mode="drop")."""
    out = torch.zeros(size + DUMP, dtype=I32, device=vals.device)
    out.scatter_reduce_(0, _dump_index(idx, size), vals.to(I32), reduce="amax")
    return out[:size]


def _scatter_set(size: int, idx, vals) -> torch.Tensor:
    """zeros(size).at[idx].set(vals, mode="drop") for unique in-range idx."""
    out = torch.zeros(size + DUMP, dtype=I32, device=vals.device)
    out.scatter_(0, _dump_index(idx, size), vals.to(I32))
    return out[:size]


def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, 0).values


def _nonzero_fill(keep: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """jnp.nonzero(keep, size=size, fill_value=fill)[0]: the first ``size``
    True positions in order, padded with ``fill``."""
    C = keep.shape[0]
    pos = torch.cumsum(keep, 0) - 1
    out = torch.full((size + DUMP,), fill, dtype=torch.int64,
                     device=keep.device)
    tgt = torch.where(keep & (pos < size), pos, _spill(C, size, keep))
    out.scatter_(0, tgt, torch.arange(C, device=keep.device))
    return out[:size]


# ---------------------------------------------------------------------------
# K1: hash probe (hand-written CUDA kernel + plain version)
# ---------------------------------------------------------------------------


def _hash_bucket(cur: torch.Tensor, bmask: int) -> torch.Tensor:
    """(uint32(cur) * 2654435761 mod 2^32) & bmask, in int64 without
    overflow: bmask < 2^31, and the low 31 bits of a product depend only on
    the low 31 bits of its factors, whose product fits in 63 bits."""
    lo = cur.to(torch.int64) & 0x7FFFFFFF
    return (lo * (_HASH_MULT & 0x7FFFFFFF)) & bmask


def _hash_find(bline, bhi, cur, valid, max_probe: int):
    """(found, start, degree) per cur[i] over a table in bucket-line form
    (device_store.line_table): bline [NB, 16] holds a bucket's 8 keys, then
    the (start, degree) pairs of lanes 0-3; bhi [NB*4, 2] the pairs of
    lanes 4-7. The plain version of K1: the first matching lane, in round
    order then lane order, wins; rows with valid False give (False, 0, 0)."""
    NB = bline.shape[0]
    bmask = NB - 1
    C = cur.shape[0]
    hb = _hash_bucket(cur, bmask)
    found = torch.zeros(C, dtype=torch.bool, device=cur.device)
    start = torch.zeros_like(cur)
    deg = torch.zeros_like(cur)
    for r in range(max_probe):
        row = (hb + r) & bmask
        line = bline[row]  # [C, 16]: keys, then lanes 0-3's pairs
        hi = bhi.reshape(NB, 8)[row]  # [C, 8]: lanes 4-7's pairs
        hit = line[:, :BUCKET] == cur[:, None]
        for lane in range(BUCKET):
            src, col = (line, 8 + 2 * lane) if lane < 4 else \
                (hi, 2 * (lane - 4))
            pick = hit[:, lane] & ~found
            start = torch.where(pick, src[:, col], start)
            deg = torch.where(pick, src[:, col + 1], deg)
            found = found | pick
    ok = valid & found
    return ok, torch.where(ok, start, 0), torch.where(ok, deg, 0)


def probe_plain(bline, bhi, cur, n, max_probe: int):
    """K1's plain version with the kernel's signature (row validity from n)."""
    valid = _arange(cur.shape[0], cur) < as_count(n, cur.device)
    return _hash_find(bline, bhi, cur, valid, max_probe)


def check_table(bline, bhi) -> None:
    """Raise unless (bline, bhi) is a table K1 takes: contiguous int32, bline
    [NB, 16] with NB a power of two, bhi [NB*4, 2], and on the card both
    16 B aligned. DeviceStore checks each table once, as it stages it;
    probe_kernel takes the tables as they are."""
    NB = bline.shape[0]
    if (bline.dtype != I32 or bhi.dtype != I32 or NB & (NB - 1)
            or tuple(bline.shape) != (NB, 2 * BUCKET)
            or tuple(bhi.shape) != (NB * 4, 2)
            or not bline.is_contiguous() or not bhi.is_contiguous()):
        raise ValueError("probe_kernel: expected contiguous int32 bline "
                         "[NB, 16] with NB a power of two and bhi [NB*4, 2], "
                         f"got {bline.dtype} {tuple(bline.shape)}, "
                         f"{bhi.dtype} {tuple(bhi.shape)}")
    if bline.is_cuda:
        cuda_lib.require_aligned("probe_kernel", bline, bhi)


_wk_probe = None  # the bound C entry point, set at the first launch


def probe_kernel(bline, bhi, cur, n, max_probe: int):
    """(found bool, start, deg) per frontier row — the _hash_find contract.

    Replaces wukong_tpu/engine/tpu_kernels.py:pallas_probe. CUDA tensors
    launch csrc/probe.cu (a thread a pair of rows, both bucket-line loads
    of a pair in flight at once, a key and most pairs in one 64 B line);
    CPU tensors run the plain version. Bound: bytes (see the source note).
    The tables are a staged segment's (checked by check_table as it was
    staged); ``n`` is best the 0-d int32 tensor on cur's device that the
    chain carries: it is then passed on as it is."""
    global _wk_probe
    if cur.device.type == "cpu":
        return probe_plain(bline, bhi, cur, n, max_probe)
    if (not cur.is_cuda or cur.dtype != I32 or cur.dim() != 1
            or not cur.is_contiguous() or cur.data_ptr() % 4):
        raise ValueError("probe_kernel: cur must be a contiguous CUDA int32 "
                         f"vector, got {cur.dtype} {tuple(cur.shape)}")
    n = as_count(n, cur.device)
    C = cur.shape[0]
    # start and deg from one allocation, each row on a 16 B boundary
    sd = torch.empty((2, -(-C // 4) * 4), dtype=I32, device=cur.device)
    start, deg = (sd[:, :C] if C % 4 else sd).unbind(0)
    found = torch.empty(C, dtype=torch.bool, device=cur.device)
    if C == 0:
        return found, start, deg
    if _wk_probe is None:
        _wk_probe = cuda_lib.library("probe.cu").wk_probe
    rc = _wk_probe(bline.data_ptr(), bhi.data_ptr(), cur.data_ptr(),
                   n.data_ptr(), C, bline.shape[0], max_probe,
                   found.data_ptr(), start.data_ptr(), deg.data_ptr(),
                   cur.get_device(), cuda_lib.stream_ptr(cur))
    if rc:
        cuda_lib.check(cuda_lib.library("probe.cu"), rc, "probe")
    cuda_lib.count_launch(probe_kernel)
    return found, start, deg


probe_kernel.launches = 0


def _probe(bline, bhi, cur, n, max_probe: int):
    """Probe dispatch: every segment, every size, goes through K1 (there is
    no residency budget on the card as there was for the TPU's VMEM)."""
    return probe_kernel(bline, bhi, cur, n, max_probe)


def _range_member(edges, lo, hi, vals, depth: int):
    """Is vals[i] in sorted edges[lo[i]:hi[i]]? Binary search, static depth."""
    E = edges.shape[0]
    end = hi
    for _ in range(depth + 1):
        active = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        mv = edges[mid.clamp(0, E - 1)]
        less = mv < vals
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    inb = lo < end
    return inb & (edges[lo.clamp(0, E - 1)] == vals)


# ---------------------------------------------------------------------------
# pattern kernels — binding table layout [width, capacity]
# ---------------------------------------------------------------------------


def _saturate_total(cum) -> torch.Tensor:
    """Expansion total from an exact (int64) degree cumsum, as int32,
    saturated to INT32_MAX exactly when the JAX int32 cumsum would have
    wrapped (the exact total passes 2^31 - 1): the host's overflow check
    then raises instead of truncating rows."""
    return cum[-1].clamp(max=INT32_MAX).to(I32)


def _cumsum(x) -> torch.Tensor:
    return torch.cumsum(x, 0, dtype=torch.int64)


def _row_plan(table, start, deg, cap_out: int):
    """The row plan of an expansion step from K1's (start, deg): each live
    row's id is scattered at its output start and a running max fills the
    gaps. Returns (srcc, eidx, out_valid, total): each output slot's source
    row, its edge index, whether it holds a row, and the exact (saturated)
    total."""
    W, C = table.shape
    rows = _arange(C, table)
    cum = _cumsum(deg)
    total = _saturate_total(cum)
    starts_excl = cum - deg
    park = torch.where(deg > 0, starts_excl, cap_out)
    marks = _scatter_max(cap_out, park, rows + 1)
    src = _cummax(marks) - 1
    srcc = src.clamp(0, C - 1).long()
    j = _arange(cap_out, table)
    eidx = start[srcc] + (j - starts_excl[srcc])
    return srcc, eidx, (j < total) & (src >= 0), total


def _expand_plan(table, n, bline, bhi, col: int, cap_out: int,
                 max_probe: int):
    """expand2's row plan: K1 probes the anchor column, then ``_row_plan``."""
    _found, start, deg = _probe(bline, bhi, table[col], n, max_probe)
    return _row_plan(table, start, deg, cap_out)


def expand_rows_plain(table, start, deg, edges, cap_out: int):
    """expand_rows' plain version: the row plan, the edge gather and the
    select in PyTorch (the JAX expand after its probe, op for op)."""
    srcc, eidx, out_valid, total = _row_plan(table, start, deg, cap_out)
    val = edges[eidx.clamp(0, edges.shape[0] - 1)]
    out = torch.cat([table[:, srcc], val[None, :]], 0)
    out = torch.where(out_valid[None, :], out, 0)
    return out, torch.clamp(total, max=cap_out), total


_wk_expand_rows = None  # the bound C entry point, set at the first launch


def expand_rows(table, start, deg, edges, cap_out: int):
    """(out [W+1, cap_out], out_n, total) of a known_to_unknown step from
    K1's per-row (start, deg): each row's values repeated over its output
    slots beside its neighbors, zeros past the total, and the step's row
    count and saturated total as 0-d int32 tensors.

    A hand kernel for the XLA computation that follows the probe in
    wukong_tpu/engine/tpu_kernels.py:expand. CUDA tensors launch
    csrc/expand_rows.cu (one launch up to its tile of rows, three past it);
    CPU tensors run ``expand_rows_plain``. Bound: bytes (see the source
    note)."""
    global _wk_expand_rows
    if table.device.type == "cpu":
        return expand_rows_plain(table, start, deg, edges, cap_out)
    W, C = table.shape
    for name, t in (("table", table), ("start", start), ("deg", deg),
                    ("edges", edges)):
        if not t.is_cuda or t.dtype != I32:
            raise ValueError(f"expand_rows: {name} must be a CUDA int32 "
                             f"tensor, got {t.dtype} on {t.device}")
    if (start.dim() != 1 or deg.dim() != 1 or start.shape[0] != C
            or deg.shape[0] != C or start.stride(0) != 1
            or deg.stride(0) != 1 or edges.dim() != 1
            or not edges.is_contiguous() or C == 0 or cap_out <= 0):
        raise ValueError(f"expand_rows: expected start/deg [{C}] and "
                         f"contiguous edges, C > 0 and cap_out > 0; got "
                         f"{tuple(start.shape)}, {tuple(deg.shape)}, "
                         f"{tuple(edges.shape)}, cap_out {cap_out}")
    if _wk_expand_rows is None:
        _wk_expand_rows = cuda_lib.library("expand_rows.cu")
    lib = _wk_expand_rows
    dev = table.device
    out = torch.empty((W + 1, cap_out), dtype=I32, device=dev)
    counts = torch.empty(2, dtype=I32, device=dev)
    words = lib.wk_expand_rows_scratch_words(C)
    scratch = (torch.empty(words, dtype=torch.int64, device=dev)
               if words else None)
    rc = lib.wk_expand_rows(
        table.data_ptr(), table.stride(0), table.stride(1), W, C,
        start.data_ptr(), deg.data_ptr(), edges.data_ptr(), edges.shape[0],
        cap_out, out.data_ptr(), counts.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        table.get_device(), cuda_lib.stream_ptr(table))
    if rc:
        cuda_lib.check(lib, rc, "expand_rows")
    cuda_lib.count_launch(expand_rows)
    out_n, total = counts.unbind(0)
    return out, out_n, total


expand_rows.launches = 0


def expand(table, n, bline, bhi, edges, col: int, cap_out: int,
           max_probe: int):
    """known_to_unknown: expand each live row by its neighbor list: K1
    probes the anchor column, then ``expand_rows``.

    table: [W, C]. Returns (out [W+1, cap_out], out_n, total) — total may
    exceed cap_out; the host checks it at the end-of-chain sync and retries
    at an exact capacity class (rows are never silently dropped)."""
    _found, start, deg = _probe(bline, bhi, table[col], n, max_probe)
    return expand_rows(table, start, deg, edges, cap_out)


def expand2(table, n, bline, bhi, edges_pid, edges_val, col: int,
            cap_out: int, max_probe: int):
    """VERSATILE known_unknown_unknown (?x ?p ?y with x bound,
    sparql.hpp:601-650): expand each live row by its COMBINED adjacency,
    every (predicate, neighbor) pair, binding two new columns. expand's
    machinery plus one gather of the aligned predicate array.

    Returns (out [W+2, cap_out] with the pid row then the value row, out_n,
    total)."""
    srcc, eidx, out_valid, total = _expand_plan(
        table, n, bline, bhi, col, cap_out, max_probe)
    eidx = eidx.clamp(0, edges_val.shape[0] - 1)
    out = torch.cat([table[:, srcc], edges_pid[eidx][None, :],
                     edges_val[eidx][None, :]], 0)
    out = torch.where(out_valid[None, :], out, 0)
    return out, torch.clamp(total, max=cap_out), total


def member_mask_known(table, n, vals, bline, bhi, edges, col: int,
                      max_probe: int, depth: int):
    """known_to_known / known_to_const: per-row membership of vals[i] in
    adj(cur[i]). table: [W, C]; vals: [C]."""
    W, C = table.shape
    valid = _arange(C, table) < n
    cur = table[col]
    found, start, deg = _probe(bline, bhi, cur, n, max_probe)
    ok = _range_member(edges, start, start + deg, vals, depth)
    return valid & found & ok


def compact_to(table, keep, cap_out: int):
    """Compact into a (possibly smaller) capacity class. Returns (out [W,
    cap_out], n, total) — total is the true surviving count; an overflow
    retries the chain at an exact capacity."""
    W, C = table.shape
    total = keep.sum().to(I32)
    idx = _nonzero_fill(keep, cap_out, C - 1)
    out = table[:, idx]
    live = _arange(cap_out, table) < total
    return (torch.where(live[None, :], out, 0),
            torch.clamp(total, max=cap_out), total)


def compact(table, keep):
    out, n, _total = compact_to(table, keep, table.shape[1])
    return out, n


def _gather_clamped(edge_list, pos):
    """edge_list[clip(pos, 0, E - 1)]; zeros for an empty list (an mt
    carrier's share of a short index), where the JAX gather reads no row."""
    if edge_list.shape[0] == 0:
        return torch.zeros_like(pos)
    return edge_list[pos.clamp(0, edge_list.shape[0] - 1)]


def init_from_list(edge_list, real_len: int, cap: int):
    """index/const start: one-row table [1, cap] from an edge list."""
    j = _arange(cap, edge_list)
    vals = _gather_clamped(edge_list, j)
    valid = j < real_len
    table = torch.where(valid, vals, 0)[None, :]
    return table, as_count(min(real_len, cap), edge_list.device)


def init_batch_index(edge_list, real_len: int, B: int, cap: int,
                     slice_mode: bool = False):
    """Batched index-origin start: [2, cap] table with a qid row.

    replicate mode (slice_mode=False): B full copies of the index list —
    B independent instances of the query (throughput batching; amortizes the
    end-of-chain sync across B queries).
    slice mode (slice_mode=True): the index split into B contiguous slices,
    qid = slice id — the reference's mt_factor index-scan slicing
    (sparql.hpp:98-108) as a batch dimension; per-qid counts sum to the
    full query's total.
    """
    j = _arange(cap, edge_list)
    if slice_mode:
        per = max((real_len + B - 1) // B, 1)
        qid = torch.clamp(torch.div(j, per, rounding_mode="floor"), max=B - 1)
        pos = j
        total = real_len
    else:
        r = max(real_len, 1)
        qid = torch.div(j, r, rounding_mode="floor")
        pos = j - qid * r
        total = real_len * B
    vals = _gather_clamped(edge_list, pos)
    valid = j < total
    table = torch.stack([torch.where(valid, qid, 0),
                         torch.where(valid, vals, 0)])
    return table, as_count(min(total, cap), edge_list.device)


def member_mask_list(table, n, col: int, sorted_list, real_len: int):
    """index_to_known / const_to_known: membership of a row in a sorted list."""
    W, C = table.shape
    valid = _arange(C, table) < n
    vals = table[col]
    L = sorted_list.shape[0]
    depth = max(int(L).bit_length(), 1)
    lo = torch.zeros(C, dtype=I32, device=table.device)
    hi = torch.full((C,), min(L, INT32_MAX, int(real_len)), dtype=I32,
                    device=table.device)
    ok = _range_member(sorted_list, lo, hi, vals, depth)
    return valid & ok


# ---------------------------------------------------------------------------
# sort-merge kernels (the batch executor's joins)
# ---------------------------------------------------------------------------


def _merge_lookup(skey, sstart, sdeg, cur):
    """Join cur[i] against a sorted key array. Returns, in MERGED-SORTED
    order over [S + C]: (keys, tag, found, start, deg, is_seg) where tag < S
    marks segment rows and tag - S is the original query row id. The JAX
    sort on (keys, tag) is a stable sort on keys (tag = position)."""
    S = skey.shape[0]
    keys = torch.cat([skey, cur])
    ks, ts = torch.sort(keys, stable=True)
    ts = ts.to(I32)
    is_seg = ts < S
    # segment slots ascend with their (sorted) keys, so cummax == last slot
    slot = _cummax(torch.where(is_seg, ts, -1))
    kprop = _cummax(torch.where(is_seg, ks, INT32_MIN))
    found = (kprop == ks) & (slot >= 0)
    sl = slot.clamp(0, S - 1).long()
    start = torch.where(found, sstart[sl], 0)
    deg = torch.where(found, sdeg[sl], 0)
    return ks, ts, found, start, deg, is_seg


def _emit_gather(ts, S: int, start, deg, st_ex, edges, total, cap_out: int):
    """The scatter+cummax+gather emit over the [cap_out] output grid (shared
    by merge_expand, probe_expand and stream_expand's high-multiplicity
    arm). Returns (val, parent), zero-masked outside [0, total)."""
    base = start - st_ex
    M = ts.shape[0]
    mrows = _arange(M, ts)
    park = torch.where(deg > 0, st_ex, cap_out)
    marks = _scatter_max(cap_out, park, mrows + 1)
    src = _cummax(marks) - 1
    srcc = src.clamp(0, M - 1).long()
    j = _arange(cap_out, ts)
    E = edges.shape[0]
    eidx = base[srcc] + j
    val = edges[eidx.clamp(0, E - 1)]
    parent = ts[srcc] - S
    out_ok = (j < total) & (src >= 0)
    return torch.where(out_ok, val, 0), torch.where(out_ok, parent, 0)


def probe_expand(bline, bhi, edges, cur, n, live, cap_out: int,
                 max_probe: int):
    """known_to_unknown for the merge chain when the frontier is far smaller
    than the segment: an O(C) hash probe (K1) + the shared scatter-emit.
    Same contract as merge_expand — (val, parent, out_n, total), parents are
    input row ids — but output rows come in INPUT row order."""
    C = cur.shape[0]
    rows = _arange(C, cur)
    ok_row = (rows < n) & live
    # bucket pads are -1, so INT32_MAX-masked rows can never match one
    curm = torch.where(ok_row, cur, INT32_MAX)
    found, start, deg = _probe(bline, bhi, curm, n, max_probe)
    deg = torch.where(ok_row & found, deg, 0)
    cum = _cumsum(deg)
    total = _saturate_total(cum)
    st_ex = cum - deg
    val, parent = _emit_gather(rows, 0, start, deg, st_ex, edges, total,
                               cap_out)
    return val, parent, torch.clamp(total, max=cap_out), total


def merge_expand(skey, sstart, sdeg, edges, cur, n, live, cap_out: int):
    """known_to_unknown without probes: (val [cap_out], parent [cap_out]
    into the input row space, out_n, total); rows grouped by anchor value.
    ``live`` is a bool row mask (deferred filters zero degrees here)."""
    C = cur.shape[0]
    rows = _arange(C, cur)
    ok_row = (rows < n) & live
    curm = torch.where(ok_row, cur, INT32_MAX)
    ks, ts, found, start, deg, is_seg = _merge_lookup(skey, sstart, sdeg, curm)
    deg = torch.where(is_seg, 0, deg)
    cum = _cumsum(deg)
    total = _saturate_total(cum)
    st_ex = cum - deg
    val, parent = _emit_gather(ts, skey.shape[0], start, deg, st_ex, edges,
                               total, cap_out)
    return val, parent, torch.clamp(total, max=cap_out), total


def _run_head_match(k_all, extra_eq, is_rel):
    """For each merged row: does its equal-key run begin with a relation
    row? (relation rows sort first within a run). extra_eq narrows run
    equality beyond the primary key (pair membership)."""
    eq_prev = torch.cat([torch.zeros(1, dtype=torch.bool, device=k_all.device),
                         (k_all[1:] == k_all[:-1]) & extra_eq])
    run_start = ~eq_prev
    run_id = torch.cumsum(run_start, 0, dtype=torch.int64)  # 1-based
    packed = torch.where(run_start, run_id * 2 + is_rel.long(), -1)
    prop = _cummax(packed)
    return prop == run_id * 2 + 1


def _unsort(ts, hit, L: int):
    """Scatter merged-order flags back to input order and keep the query
    rows (tags >= L) — the JAX second sort keyed on tag."""
    out = torch.zeros_like(hit)
    out[ts.long()] = hit
    return out[L:]


def merge_member_list(sorted_list, real_len: int, cur, n, live):
    """Membership of cur[i] in a sorted list (k2c against a const object).
    Returns a bool mask in INPUT row order."""
    L = sorted_list.shape[0]
    C = cur.shape[0]
    ok_row = (_arange(C, cur) < n) & live
    curm = torch.where(ok_row, cur, INT32_MAX)
    lkey = torch.where(_arange(L, cur) < real_len, sorted_list,
                       INT32_MAX - 1)  # pad can't match a query pad
    ks, ts = torch.sort(torch.cat([lkey, curm]), stable=True)
    is_rel = ts < L
    hit = _run_head_match(ks, torch.ones(ks.shape[0] - 1, dtype=torch.bool,
                                         device=cur.device), is_rel)
    hit = hit & ~is_rel
    return _unsort(ts, hit, L) & ok_row


def member_list_binsearch(sorted_list, real_len: int, cur, n, live):
    """k2c membership for SMALL frontiers: binary-search each row in the
    sorted const list. Depth derives from the list's padded length."""
    L = sorted_list.shape[0]
    depth = max(int(L - 1).bit_length(), 1)
    C = cur.shape[0]
    ok_row = (_arange(C, cur) < n) & live
    curm = torch.where(ok_row, cur, INT32_MAX)
    lo = torch.zeros(C, dtype=I32, device=cur.device)
    hi = torch.full((C,), int(real_len), dtype=I32, device=cur.device)
    ok = _range_member(sorted_list, lo, hi, curm, depth)
    return ok & ok_row


def merge_member_pairs(ekey, eval_, e_real: int, cur, vals, n, live):
    """known_to_known: does edge (cur[i] -> vals[i]) exist? ekey/eval_ are
    the segment's per-edge (key, neighbor) pairs, lex-sorted. The JAX sort
    on (keys, vals, tag) is a stable sort on keys * 2^32 + (vals + 2^31),
    which orders lexicographically for any int32 pair."""
    E = ekey.shape[0]
    C = cur.shape[0]
    ok_row = (_arange(C, cur) < n) & live
    curm = torch.where(ok_row, cur, INT32_MAX)
    valm = torch.where(ok_row, vals, INT32_MAX)
    epad = _arange(E, cur) < e_real
    ek = torch.where(epad, ekey, INT32_MAX - 1)
    ev = torch.where(epad, eval_, INT32_MAX - 1)
    keys = torch.cat([ek, curm]).long()
    vv = torch.cat([ev, valm]).long()
    _, ts = torch.sort(keys * (1 << 32) + (vv + (1 << 31)), stable=True)
    ks, vs = keys[ts], vv[ts]
    is_rel = ts < E
    hit = _run_head_match(ks, vs[1:] == vs[:-1], is_rel)
    hit = hit & ~is_rel
    return _unsort(ts, hit, E) & ok_row


def gather_col(col, parent):
    """Materialize a column one parent-hop down: col[parent]."""
    L = col.shape[0]
    return col[parent.clamp(0, L - 1).long()]


def merge_compact(vals, parent, keep, n, cap_out: int):
    """Estimate-driven shrink of a (vals, parent) level. Returns (vals',
    parent', n', total)."""
    C = vals.shape[0]
    live = keep & (_arange(C, vals) < n)
    total = live.sum().to(I32)
    idx = _nonzero_fill(live, cap_out, C - 1)
    ok = _arange(cap_out, vals) < total
    return (torch.where(ok, vals[idx], 0), torch.where(ok, parent[idx], 0),
            torch.clamp(total, max=cap_out), total)


def qid_counts_pos0(pos0, n, live, B: int, r: int, slice_mode: bool = False):
    """Per-qid surviving row counts from composed space-0 positions.

    replicate mode: qid = pos0 // r (r = real index length); slice mode:
    qid = min(pos0 // r, B-1) (r = ceil(len / B)). Blind-mode finish."""
    C = pos0.shape[0]
    ok = (_arange(C, pos0) < n) & live
    qid = torch.div(pos0, max(r, 1), rounding_mode="floor")
    if slice_mode:
        qid = torch.clamp(qid, max=B - 1)
    return qid_bincount(torch.where(ok, qid, B), B)


_QID_LANES = 128  # private counters a qid in qid_bincount


def qid_bincount(qid, B: int):
    """jnp.bincount(qid, length=B + 1)[:B] without a host read: values
    outside [0, B) are dropped. (torch.bincount on a CUDA tensor reads the
    input's maximum back to the host to size its output.) Each qid counts
    into _QID_LANES private slots, chosen by row, which are then summed:
    one slot a qid would serialize every row of a qid on one atomic."""
    idx = torch.where((qid >= 0) & (qid < B), qid.long(), B)
    lane = torch.arange(qid.shape[0], device=qid.device) % _QID_LANES
    out = torch.zeros((B + 1) * _QID_LANES, dtype=torch.int64,
                      device=qid.device)
    out.index_add_(0, idx * _QID_LANES + lane, torch.ones_like(idx))
    return out.view(B + 1, _QID_LANES).sum(1)[:B]


def fetch_counts(parts: list) -> list:
    """One device-to-host read for a whole flight: ``parts`` holds, per
    chain, its per-qid counts and its list of 0-d step totals; returns
    [(counts as numpy int64, totals as ints), ...] in the same order."""
    flat = [c.reshape(-1).long() for c, _ in parts]
    flat += [t.reshape(1).long() for _, tot in parts for t in tot]
    host = torch.cat(flat).cpu().numpy()
    out, base, off = [], 0, sum(c.numel() for c, _ in parts)
    for c, tot in parts:
        n = c.numel()
        out.append((host[base:base + n].copy(),
                    [int(x) for x in host[off:off + len(tot)]]))
        base += n
        off += len(tot)
    return out


def next_capacity(total: int, cap_min: int = 1024,
                  cap_max: int | None = None) -> int:
    """Smallest capacity class holding `total` rows (ceiling from config)."""
    if cap_max is None:
        from wukong_tpu_torch.config import Global

        cap_max = Global.table_capacity_max
    c = cap_min
    while c < total and c < cap_max:
        c <<= 1
    return c
