"""The k-NN operator (the query half of the hybrid plane).

One scoring seam, :func:`scores` (cosine / dot / L2 over a swappable array
module, higher = nearer for every metric: L2 ranks by NEGATIVE squared
distance), runs as NumPy on the host (:func:`topk_host`, the oracle every
route must match). The device route is the hand-written kernel
``csrc/knn_scan.cu`` behind :func:`knn_scan`: masked scores and the top k in
(score desc, position asc) order, over a row range of the store's block or
over an int64 slot list, without copying the block. Its plain version,
:func:`knn_scan_plain`, is torch ops with the same formulas and a stable
sort; a CPU tensor takes it, a CUDA tensor launches the kernel or raises.

Ranking is deterministic: the winners re-order by ``(score desc, vid asc)``
on the host, as the JAX ``topk_device`` does, so every route gives the same
reply whenever score gaps exceed float error.

Wide scans split into slot ranges across the engine pool's heavy lane
(:func:`sliced_topk`): claim-once slices, a gather barrier, one inline
retry of a failed slice. Per-row scores are row-independent, so the merge
is exactly the single scan's answer.

The port's copy of the JAX package's vector/knn.py, with two written
deviations (ROADMAP §C):

- **Staging.** The JAX ``topk_device`` pads the candidates to
  ``pad_pow2(n)`` and uploads the whole block on every call. The port
  stages the live ``[n, d]`` block and its ``alive`` mask once per (vstore,
  version, device) (:func:`staged_block`, charged to the device
  observatory's ``knn`` resident kind); an upsert frees the old staging.
  The answers are identical.
- **Degradation.** The JAX ``scan_topk``, ``rank_candidates`` and
  ``_KnnSlice`` degrade a device scan to the host on any exception. The
  port degrades only on the cause the reference names, the
  ``_DEVICE_FAIL_HOOK`` drill (:class:`DeviceDrill`); a CUDA error, a failed
  build, a refused launch or running out of memory reaches the caller.

The scan's charge to ``obs.heat`` waits for that module (ROADMAP §A, "The
rest of the observatory, and the analysis plugins").
"""

from __future__ import annotations

import threading
import warnings

import numpy as np
import torch

from wukong_tpu_torch.analysis.lockdep import declare_leaf, make_lock
from wukong_tpu_torch.engine import cuda_lib
from wukong_tpu_torch.utils.errors import ErrorCode, WukongError
from wukong_tpu_torch.utils.timer import get_usec

#: the metric names behind the one kernel seam (knn_metric knob values)
KNN_METRICS = ("cosine", "dot", "l2")
_METRIC_CODE = {"dot": 0, "cosine": 1, "l2": 2}

#: the capacity-class floor the device observatory names a scan by
PAD_FLOOR = 1024

# the slice claim lock guards one bool — innermost by construction
declare_leaf("vector.slice")

# chaos/bench seam: when set, the device scan path calls it before
# dispatch (raise to simulate a device failure; the measured-demotion
# drill drives this). The one cause a device scan degrades to the host on.
_DEVICE_FAIL_HOOK = None

_stage_lock = make_lock("vector.stage")


class DeviceDrill(Exception):
    """The ``_DEVICE_FAIL_HOOK`` drill fired before a device scan;
    ``reason`` is the demotion reason the JAX package would latch."""

    def __init__(self, cause: BaseException):
        self.reason = (cause.code.name if isinstance(cause, WukongError)
                       else type(cause).__name__)
        super().__init__(f"device scan drill: {self.reason}")


def _metrics():
    from wukong_tpu_torch.obs.metrics import get_registry

    reg = get_registry()
    return (
        reg.histogram("wukong_vector_scan_us",
                      "k-NN scan latency (usec) by executed route",
                      labels=("route",)),
        reg.counter("wukong_vector_scan_slices_total",
                    "Wide k-NN scan slice-range dispatches"),
    )


_M_SCAN_US, _M_SLICES = _metrics()


def pad_pow2(n: int, floor: int = PAD_FLOOR) -> int:
    """Smallest power of two >= max(n, floor): the capacity class the JAX
    device path pads a scan to, and the class the observatory names."""
    c = max(int(n), int(floor), 1)
    return 1 << (c - 1).bit_length()


def scores(base, queries, metric: str, xp=np):
    """``[B, N]`` similarity scores of ``queries [B, d]`` against
    ``base [N, d]`` (higher = nearer for every metric). Pure xp ops."""
    if metric == "dot":
        return queries @ base.T
    if metric == "cosine":
        qn = queries / xp.clip(
            xp.linalg.norm(queries, axis=1, keepdims=True), 1e-12, None)
        bn = base / xp.clip(
            xp.linalg.norm(base, axis=1, keepdims=True), 1e-12, None)
        return qn @ bn.T
    if metric == "l2":
        qq = xp.sum(queries * queries, axis=1, keepdims=True)  # [B, 1]
        bb = xp.sum(base * base, axis=1)  # [N]
        return -(qq - 2.0 * (queries @ base.T) + bb[None, :])
    raise WukongError(ErrorCode.UNSUPPORTED_SHAPE,
                      f"knn_metric must be one of {KNN_METRICS}, "
                      f"got {metric!r}")


def _empty():
    return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.float32)


def topk_host(vids, vecs, alive, anchor, k: int, metric: str):
    """NumPy brute-force top-k over live slots; the oracle every other
    route must match. Ties break ``(score desc, vid asc)``."""
    anchor = np.asarray(anchor, dtype=np.float32)
    if len(vids) == 0 or k <= 0:
        return _empty()
    s = np.asarray(scores(vecs, anchor[None, :], metric, np)[0],
                   dtype=np.float32)
    s = np.where(alive, s, -np.inf)
    order = np.lexsort((vids, -s))
    order = order[np.isfinite(s[order])]
    sel = order[:int(k)]
    return vids[sel].copy(), s[sel].copy()


# ---------------------------------------------------------------------------
# the kernel and its plain version
# ---------------------------------------------------------------------------


def _candidates(base, alive, rows, slots):
    """(rows of base, their alive flags) the call ranks."""
    if slots is not None:
        return base[slots], alive[slots]
    lo, hi = (0, base.shape[0]) if rows is None else rows
    return base[lo:hi], alive[lo:hi]


def knn_scan_plain(base, alive, anchor, k: int, metric: str, rows=None,
                   slots=None):
    """The plain version of :func:`knn_scan`: torch ops with ``scores()``'s
    formulas (the cosine normalises both sides first, as JAX does), dead
    rows at -inf, then a stable descending sort, so ties keep the lower
    position first (``lax.top_k``'s order). Returns (scores float32 [kk],
    positions int64 [kk]), kk = min(k, candidates)."""
    sub, live = _candidates(base, alive, rows, slots)
    q = anchor.to(torch.float32)
    if metric == "dot":
        s = sub @ q
    elif metric == "cosine":
        qn = q / torch.clamp(torch.linalg.vector_norm(q), min=1e-12)
        bn = sub / torch.clamp(
            torch.linalg.vector_norm(sub, dim=1, keepdim=True), min=1e-12)
        s = bn @ qn
    elif metric == "l2":
        qq = torch.sum(q * q)
        bb = torch.sum(sub * sub, dim=1)
        s = -(qq - 2.0 * (sub @ q) + bb)
    else:
        raise WukongError(ErrorCode.UNSUPPORTED_SHAPE,
                          f"knn_metric must be one of {KNN_METRICS}, "
                          f"got {metric!r}")
    s = torch.where(live.to(torch.bool), s + 0.0,
                    torch.full_like(s, float("-inf")))
    kk = min(int(k), int(s.shape[0]))
    vals, idx = torch.sort(s, descending=True, stable=True)
    return vals[:kk].contiguous(), idx[:kk].to(torch.int64).contiguous()


_wk = None  # the loaded knn_scan library
_block_scratch: dict = {}  # (device index, stream) -> the block paths' scratch


def _scratch_of(dev, stream: int) -> torch.Tensor:
    """The block paths' scratch of one stream on ``dev``, made at the
    stream's first call: zeroed once, and left with its ticket at 0 by
    every call, so the calls on a stream (one after another) share it;
    sized once for any k the block paths take."""
    words = int(_wk.wk_knn_block_scratch_words(dev.index))
    t = _block_scratch[(dev.index, stream)] = torch.zeros(
        words, dtype=torch.int64, device=dev)
    return t


def knn_scan(base, alive, anchor, k: int, metric: str, rows=None,
             slots=None):
    """The top ``kk = min(k, m)`` of the m candidates — rows ``rows = (lo,
    hi)`` of ``base`` (all rows when both are None) or ``base[slots]`` —
    scored against ``anchor`` by ``metric`` with dead rows (``alive`` False)
    at -inf, in the order (score desc, position asc). Returns (scores
    float32 [kk], positions int64 [kk]) on base's device.

    ``base`` [n, d] float32, ``alive`` [n] bool, ``anchor`` [d] float32,
    ``slots`` int64. Replaces wukong_tpu/vector/knn.py:_jit_scan (and
    topk_device's selection). CUDA tensors launch csrc/knn_scan.cu (one call
    a scan: one fused launch that scores and selects for k <= 256, a radix
    select past it), counted on ``knn_scan.launches``; CPU tensors run
    :func:`knn_scan_plain`. Bound: bytes (see the source note). No launch
    when there is nothing to rank. One allocation a call for k <= 256 (both
    outputs in one buffer; the scratch is the stream's, kept)."""
    global _wk
    if base.is_cpu:
        return knn_scan_plain(base, alive, anchor, k, metric, rows, slots)
    code = _METRIC_CODE.get(metric)
    if code is None:
        raise WukongError(ErrorCode.UNSUPPORTED_SHAPE,
                          f"knn_metric must be one of {KNN_METRICS}, "
                          f"got {metric!r}")
    if base.dtype is not torch.float32 or base.dim() != 2:
        raise ValueError(f"knn_scan: base must be [n, d] float32, got "
                         f"{base.dtype} {tuple(base.shape)}")
    n, d = base.shape
    if alive.dtype is not torch.bool or alive.dim() != 1 \
            or alive.shape[0] != n:
        raise ValueError(f"knn_scan: alive must be [{n}] bool, "
                         f"got {alive.dtype} {tuple(alive.shape)}")
    if anchor.dtype is not torch.float32 or anchor.dim() != 1 \
            or anchor.shape[0] != d:
        raise ValueError(f"knn_scan: anchor must be [{d}] float32, got "
                         f"{anchor.dtype} {tuple(anchor.shape)}")
    if slots is not None:
        if slots.dtype is not torch.int64 or slots.dim() != 1:
            raise ValueError("knn_scan: slots must be a 1-D int64 tensor")
        cuda_lib.require_cuda("knn_scan", base, alive, anchor, slots)
        lo, m, sp = 0, slots.shape[0], slots.data_ptr()
    else:
        lo, hi = (0, n) if rows is None else map(int, rows)
        if not 0 <= lo <= hi <= n:
            raise ValueError(f"knn_scan: rows {rows} outside [0, {n}]")
        cuda_lib.require_cuda("knn_scan", base, alive, anchor)
        m, sp = hi - lo, None
    di = base.get_device()
    if alive.get_device() != di or anchor.get_device() != di or (
            slots is not None and slots.get_device() != di):
        raise ValueError(f"knn_scan: tensors on more than one device "
                         f"(base on cuda:{di})")
    kk = min(int(k), m)
    if kk <= 0:
        return (torch.empty(0, dtype=torch.float32, device=base.device),
                torch.empty(0, dtype=torch.int64, device=base.device))
    if _wk is None:
        lib = cuda_lib.library("knn_scan.cu")
        lib.max_dim = int(lib.wk_knn_max_dim())
        lib.block_max_k = int(lib.wk_knn_block_max_k())
        _wk = lib
    if d > _wk.max_dim:
        raise ValueError(f"knn_scan: dim {d} above the kernel's "
                         f"{_wk.max_dim}")
    if m >= 2**31 - 1:
        raise ValueError(f"knn_scan: {m} candidates (at most 2^31 - 2)")
    stream = cuda_lib.stream_ptr(base)
    if kk <= _wk.block_max_k:
        scratch = _block_scratch.get((di, stream))
        if scratch is None:
            scratch = _scratch_of(base.device, stream)
    else:  # the radix path's scratch, made a call
        scratch = torch.empty(int(_wk.wk_knn_radix_scratch_words(m, kk)),
                              dtype=torch.int64, device=base.device)
    # both outputs in one buffer: the positions' int64 words, then scores
    out_i, out_s = torch.empty(3 * kk, dtype=torch.float32,
                               device=base.device).split_with_sizes(
                                   (2 * kk, kk))
    out_i = out_i.view(torch.int64)
    rc = _wk.wk_knn_scan(base.data_ptr(), d, alive.data_ptr(), lo, m, sp,
                         anchor.data_ptr(), code, kk, scratch.data_ptr(),
                         out_s.data_ptr(), out_i.data_ptr(), di, stream)
    if rc:
        cuda_lib.check(_wk, rc, "knn_scan")
    cuda_lib.count_launch(knn_scan)
    return out_s, out_i


knn_scan.launches = 0


# ---------------------------------------------------------------------------
# the staged block
# ---------------------------------------------------------------------------


class KnnBlock:
    """One vector store version's block on one device: ``base`` [n, d]
    float32 and ``alive`` [n] bool tensors beside the host ``vids``."""

    __slots__ = ("vids", "base", "alive", "version", "device", "nbytes")

    def __init__(self, vids, base, alive, version: int, device):
        self.vids = vids
        self.base = base
        self.alive = alive
        self.version = int(version)
        self.device = device
        self.nbytes = int(base.numel() * 4 + alive.numel())


def stage_block(vids, vecs, alive, device, version: int = 0) -> KnnBlock:
    """The block of these arrays on ``device``: a CPU device shares the
    host arrays (read only), a CUDA one gets one copy."""
    dev = torch.device(device)
    with warnings.catch_warnings():  # the snapshot arrays are write-protected
        warnings.simplefilter("ignore", UserWarning)
        base = torch.from_numpy(np.ascontiguousarray(vecs, dtype=np.float32))
        live = torch.from_numpy(np.ascontiguousarray(alive, dtype=bool))
    if dev.type != "cpu":
        base, live = base.to(dev), live.to(dev)
    return KnnBlock(np.asarray(vids), base, live, version, dev)


def staged_block(vstore, device) -> KnnBlock:
    """The store's block on ``device`` at its current version, staged once
    per (version, device) and kept on the store (``vstore._knn_block``); a
    newer version frees the old staging before it stages."""
    from wukong_tpu_torch.obs.device import maybe_device_resident
    from wukong_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)  # "cuda" and "cuda:0" name one staging
    with _stage_lock:
        vids, vecs, alive, ver = vstore.snapshot()
        blk = vstore._knn_block
        if blk is not None and blk.version == ver and blk.device == dev:
            return blk
        vstore._knn_block = None
        if blk is not None and blk.device.type != "cpu":
            maybe_device_resident("invalidate", "knn", blk.nbytes,
                                  version=ver)
        del blk  # freed before the new staging takes its room
        blk = stage_block(vids, vecs, alive, dev, ver)
        vstore._knn_block = blk
    if dev.type != "cpu":
        maybe_device_resident("fill", "knn", blk.nbytes)
    return blk


# ---------------------------------------------------------------------------
# the routes
# ---------------------------------------------------------------------------


def topk_device(block: KnnBlock, anchor, k: int, metric: str, rows=None,
                slots=None, cand=None):
    """The device route over a staged block: :func:`knn_scan` over rows
    ``rows`` (or all) or over ``slots`` (whose vertex ids are ``cand``),
    one device-to-host copy of the kk winners, then the finite ones
    re-ordered on the host by the canonical ``(score desc, vid asc)`` tie
    policy. Raises :class:`DeviceDrill` when the drill hook fires."""
    if _DEVICE_FAIL_HOOK is not None:
        try:
            _DEVICE_FAIL_HOOK()
        except Exception as e:
            raise DeviceDrill(e) from e
    if k <= 0:
        return _empty()
    dev = block.device
    q = torch.from_numpy(np.ascontiguousarray(anchor, dtype=np.float32))
    if dev.type != "cpu":
        q = q.to(dev)
    lo = 0 if rows is None else int(rows[0])
    slot_t = None
    if slots is not None:
        slot_t = torch.from_numpy(np.ascontiguousarray(slots, np.int64))
        if dev.type != "cpu":
            slot_t = slot_t.to(dev)
        m = len(slots)
    else:
        m = (block.base.shape[0] if rows is None
             else int(rows[1]) - int(rows[0]))
    if m == 0:
        return _empty()
    t0 = get_usec()
    top_s, top_i = knn_scan(block.base, block.alive, q, k, metric, rows,
                            slot_t)
    top_s = top_s.cpu().numpy()  # the one sync
    top_i = top_i.cpu().numpy()
    from wukong_tpu_torch.obs.device import maybe_device_dispatch

    d = int(block.base.shape[1])
    maybe_device_dispatch(
        "knn.scan", template=f"{metric}:k{len(top_s)}", live=m,
        capacity=pad_pow2(m), wall_us=get_usec() - t0,
        nbytes=m * d * 4 + m + (8 * m if slots is not None else 0) + 4 * d)
    ok = np.isfinite(top_s)
    if slots is not None:
        sel_v = np.asarray(cand)[top_i[ok]]
    else:
        sel_v = block.vids[lo + top_i[ok]]
    sel_s = top_s[ok]
    order = np.lexsort((sel_v, -sel_s))[:int(k)]
    return sel_v[order].copy(), sel_s[order].copy()


def scan_topk(vstore, anchor, k: int, metric: str, route: str = "host",
              device="cpu"):
    """One full-store scan through the route seam. Returns ``(top_vids,
    top_scores, demoted_reason | None)``: the drill degrades the device
    route to the host with the answer intact and the reason latched for the
    proxy's measured-demotion feedback."""
    vids, vecs, alive, _ver = vstore.snapshot()
    t0 = get_usec()
    demoted = None
    used = "host"
    out = None
    if route == "device":
        try:
            out = topk_device(staged_block(vstore, device), anchor, k,
                              metric)
            used = "device"
        except DeviceDrill as e:
            demoted = e.reason
    if out is None:
        out = topk_host(vids, vecs, alive, anchor, k, metric)
    _M_SCAN_US.labels(route=used).observe(get_usec() - t0)
    return out[0], out[1], demoted


def rank_candidates(vstore, cand_vids, anchor, k: int, metric: str,
                    route: str = "host", device="cpu"):
    """Top-k over an explicit candidate id set (pattern-then-rank: the
    BGP's binding set). Candidates missing from the store or tombstoned
    simply don't rank. Same return contract as :func:`scan_topk`; the
    device route gathers the candidates' rows by slot inside the kernel."""
    cand = np.unique(np.asarray(cand_vids, dtype=np.int64))
    vids, vecs, alive, _ver = vstore.snapshot()
    if len(vids) == 0 or cand.size == 0 or k <= 0:
        return (*_empty(), None)
    slot_of = vstore.slot_of
    slots = np.asarray([slot_of.get(v, -1) for v in cand.tolist()],
                       dtype=np.int64)
    hit = slots >= 0
    cand, slots = cand[hit], slots[hit]
    t0 = get_usec()
    demoted = None
    used = "host"
    out = None
    if route == "device":
        try:
            out = topk_device(staged_block(vstore, device), anchor, k,
                              metric, slots=slots, cand=cand)
            used = "device"
        except DeviceDrill as e:
            demoted = e.reason
    if out is None:
        out = topk_host(cand, vecs[slots], alive[slots], anchor, k, metric)
    _M_SCAN_US.labels(route=used).observe(get_usec() - t0)
    return out[0], out[1], demoted


def resolve_anchor(vstore, clause) -> np.ndarray:
    """The clause's anchor as a ``[dim]`` float32 vector: a literal
    vector must match the store's fixed ``vector_dim``; a vertex anchor
    must have a live embedding."""
    if clause.anchor_vec is not None:
        vec = np.asarray(clause.anchor_vec, dtype=np.float32).ravel()
        if vstore is not None and len(vec) != vstore.dim:
            raise WukongError(
                ErrorCode.UNSUPPORTED_SHAPE,
                f"knn literal vector has dim {len(vec)}, store has "
                f"{vstore.dim}")
        return vec
    if vstore is None:
        raise WukongError(ErrorCode.UNSUPPORTED_SHAPE,
                          "knn() anchor needs an attached vector store")
    vec = vstore.get(int(clause.anchor_vid))
    if vec is None:
        raise WukongError(
            ErrorCode.VERTEX_INVALID,
            f"knn() anchor vertex {clause.anchor_vid} has no live "
            "embedding")
    return np.asarray(vec, dtype=np.float32)


def classify_knn_mode(q) -> str:
    """The composition direction (EXPLAIN shows it):

    - ``scan`` — no graph patterns: a pure ranked scan;
    - ``rank_then_pattern`` — the chain STARTS at the knn variable:
      the scan seeds the chain (a seeded walk);
    - ``pattern_then_rank`` — anything else: the BGP runs first and
      the scan ranks its binding set.

    The parser stamps the direction from the TEXTUAL pattern order
    (``KNNClause.mode``), preferred here so a planner reorder after parse
    cannot flip the semantics; the shape-derived fallback covers
    hand-built queries."""
    mode = getattr(q.knn, "mode", "")
    if mode:
        return mode
    pg = q.pattern_group
    if not pg.patterns:
        return "scan"
    if pg.patterns[0].subject == q.knn.var:
        return "rank_then_pattern"
    return "pattern_then_rank"


# ---------------------------------------------------------------------------
# wide-scan slice split (the heavy lane's shape)
# ---------------------------------------------------------------------------


class _KnnSlice:
    """One slot-range slice of a wide scan: a fire-and-forget heavy-lane
    pool item claimable exactly once; engine-thread death reaches
    :meth:`fail_all` via the scheduler's death handler, so the gather
    barrier always wakes."""

    lane = "heavy"

    __slots__ = ("vids", "vecs", "alive", "lo", "hi", "anchor", "k",
                 "metric", "route", "block", "result", "demoted", "event",
                 "error", "_claim_lock", "_claimed")

    def __init__(self, vids, vecs, alive, lo, hi, anchor, k, metric, route,
                 block=None):
        self.vids = vids
        self.vecs = vecs
        self.alive = alive
        self.lo = int(lo)
        self.hi = int(hi)
        self.anchor = anchor
        self.k = k
        self.metric = metric
        self.route = route
        self.block = block
        self.result = None
        self.demoted: str | None = None
        self.event = threading.Event()
        self.error: BaseException | None = None
        self._claim_lock = make_lock("vector.slice")
        self._claimed = False  # guarded by: _claim_lock

    def claim(self) -> bool:
        with self._claim_lock:
            if self._claimed:
                return False
            self._claimed = True
            return True

    def run(self, engine=None) -> None:
        if not self.claim():
            return
        self._execute()

    def _host(self):
        lo, hi = self.lo, self.hi
        return topk_host(self.vids[lo:hi], self.vecs[lo:hi],
                         self.alive[lo:hi], self.anchor, self.k, self.metric)

    def _execute(self) -> None:
        ok = False
        try:
            if self.route == "device":
                try:
                    self.result = topk_device(self.block, self.anchor,
                                              self.k, self.metric,
                                              rows=(self.lo, self.hi))
                except DeviceDrill as e:
                    # per-slice fallback: this slice degrades to host,
                    # the others keep their route
                    self.demoted = e.reason
                    self.result = self._host()
            else:
                self.result = self._host()
            ok = True
        except BaseException as e:
            self.error = e
        finally:
            if not ok and self.error is None:
                self.error = RuntimeError("knn slice aborted")
            self.event.set()

    def retry_inline(self) -> None:
        self.error = None
        self._execute()

    def fail_all(self, exc: BaseException) -> None:
        """Scheduler death-handler / dead-pool contract."""
        if not self.event.is_set():
            self.error = exc
            self.event.set()


def sliced_topk(pool, vstore, anchor, k: int, metric: str,
                route: str, parts: int, device="cpu"):
    """Wide-scan fan-out: split the slot range into ``parts`` slices
    across the engine pool's heavy lane, each computing its local
    top-k (the device route over one staged block, by row range); the
    gather thread works slice 0 itself, claims stragglers inline, retries a
    failed slice once, and merges by the canonical ``(score desc, vid
    asc)`` order — exactly the single-scan answer, since per-element
    scores are row-independent. Returns ``(top_vids, top_scores,
    demoted_reason | None)``."""
    from wukong_tpu_torch.runtime.batcher import (
        HEAVY_GATHER_WAIT_S,
        SLICE_CLAIM_GRACE_S,
    )

    vids, vecs, alive, _ver = vstore.snapshot()
    n = int(len(vids))
    parts = max(min(int(parts), max(n, 1)), 1)
    if parts <= 1 or pool is None:
        return scan_topk(vstore, anchor, k, metric, route=route,
                         device=device)
    t0 = get_usec()
    block = staged_block(vstore, device) if route == "device" else None
    bounds = np.linspace(0, n, parts + 1).astype(np.int64)
    slices = [_KnnSlice(vids, vecs, alive, bounds[i], bounds[i + 1], anchor,
                        k, metric, route, block)
              for i in range(parts)]
    _M_SLICES.inc(len(slices))
    for s in slices[1:]:
        try:
            pool.submit(s, lane="heavy")
        except Exception:
            pass  # claimed and run inline below
    slices[0].run(None)  # the gather thread works its own share first
    for s in slices[1:]:
        if not s.event.wait(SLICE_CLAIM_GRACE_S):
            if s.claim():  # not started yet: run the straggler inline
                s._execute()
            elif not s.event.wait(HEAVY_GATHER_WAIT_S):
                raise WukongError(
                    ErrorCode.UNKNOWN_PATTERN,
                    "knn gather barrier timed out on a claimed slice")
    demoted = None
    for s in slices:
        if s.error is not None:
            # one inline retry on the gather thread; a second failure
            # surfaces to the caller
            s.retry_inline()
            if s.error is not None:
                raise s.error
        if s.demoted is not None:
            demoted = s.demoted
    all_v = np.concatenate([s.result[0] for s in slices])
    all_s = np.concatenate([s.result[1] for s in slices])
    order = np.lexsort((all_v, -all_s))[:int(k)]
    _M_SCAN_US.labels(
        route="device" if route == "device" and demoted is None
        else "host").observe(get_usec() - t0)
    return all_v[order].copy(), all_s[order].copy(), demoted
