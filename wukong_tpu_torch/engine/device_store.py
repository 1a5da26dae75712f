"""Device-resident CSR segment store — the GPUCache analogue.

The port of the JAX package's engine/device_store.py. Host CSR segments are
staged on demand as int32 torch tensors on the store's device, padded to
power-of-two lengths, and cached by key under a byte budget with LRU
eviction; a query pins the segments of its chain (`pin`/`unpin`), as in the
reference's conflict-aware eviction (core/gpu/gpu_cache.hpp).

Serving threads run chains on one store at once. A key is staged once: the
first thread to miss it stages it under that key's own lock, and a thread
that misses the same key waits for that staging, while chains on other
keys go on. The JAX store takes no lock (one thread drives it).

Two staged forms per (pid, dir):
- DeviceSegment: an 8-way bucketized hash table over the keys (probed by
  K1), staged as 64 B bucket lines (`line_table`), plus the edge array;
  the VERSATILE combined segment of a direction (key ("vpv", d)) is one
  more DeviceSegment whose edges are every (predicate, neighbor) pair,
  with the predicates in ``edges2``;
- MergeSegment: sorted key/start/deg arrays plus per-edge (key, neighbor)
  pairs, for the sort-merge kernels and the stream emitters.
Bucket placement (`build_hash_table`) is bit-identical to the JAX package's.

Every staging, eviction and store-version invalidation is charged on the
device observatory's residency ledger (kinds ``segment`` and ``index``,
obs/device.py), as the JAX store charges them.
"""

from __future__ import annotations

import collections
import threading
from dataclasses import dataclass

import numpy as np
import torch

from wukong_tpu_torch.engine.tpu_kernels import check_table
from wukong_tpu_torch.obs.device import maybe_device_resident
from wukong_tpu_torch.types import IN, OUT, PREDICATE_ID, TYPE_ID
from wukong_tpu_torch.utils.device import resolve_device

INT32_MAX = np.iinfo(np.int32).max
BUCKET = 8  # 8-way associative buckets — one bucket row = one 32 B load
_HASH_MULT = np.uint32(2654435761)  # Knuth multiplicative hashing


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


@dataclass
class DeviceSegment:
    """One (pid, dir) CSR segment staged on device, keyed by an 8-way
    bucketized hash table of NB buckets (the reference probes 8-slot buckets
    for the same locality reason — gstore.hpp:55-120, gpu_hash.cu:149-260),
    in the bucket-line form of `line_table`."""

    # int32 [NB, 16]: a bucket's 8 keys (empty = -1), then the (edge range
    # start, length) pairs of its lanes 0-3 (empty = (0, 0))
    bline: torch.Tensor
    bhi: torch.Tensor  # int32 [NB*4, 2] the pairs of lanes 4-7
    edges: torch.Tensor  # int32 [E_pad], padded with INT32_MAX
    num_keys: int
    num_edges: int
    max_probe: int  # probe-round bound
    max_deg_log2: int  # binary-search depth for membership tests
    # combined segments only: per-edge predicate ids aligned with edges
    # (padded with INT32_MAX); expand2 gathers both
    edges2: torch.Tensor | None = None

    @property
    def nbytes(self) -> int:
        n = (self.bline.numel() + self.bhi.numel() + self.edges.numel()) * 4
        if self.edges2 is not None:
            n += self.edges2.numel() * 4
        return n


@dataclass
class MergeSegment:
    """One (pid, dir) CSR segment staged for the sort-merge kernels: sorted
    key/start/deg arrays (padded with INT32_MAX / 0) plus the per-edge
    lex-sorted (key, neighbor) pairs."""

    skey: torch.Tensor  # int32 [K_pad] sorted keys, pad INT32_MAX
    sstart: torch.Tensor  # int32 [K_pad] edge range starts, pad 0
    sdeg: torch.Tensor  # int32 [K_pad] edge range lengths, pad 0
    edges: torch.Tensor  # int32 [E_pad]
    ekey: torch.Tensor  # int32 [E_pad] per-edge key
    num_keys: int
    num_edges: int

    @property
    def nbytes(self) -> int:
        return (self.skey.numel() * 3 + self.edges.numel()
                + self.ekey.numel()) * 4


def fold_key(filters) -> tuple:
    """Canonical cache-key form of a fold's (pid, dir, const) filter list."""
    return tuple(sorted((int(p), int(dd), int(c)) for (p, dd, c) in filters))


def combined_adjacency(g, d: int):
    """(keys, offsets, vals, pids) of one partition's COMBINED adjacency in
    direction d: every (predicate, neighbor) edge keyed by vid, predicate-
    ordered within each vid (stable sort; per-predicate parts are appended
    pid-ascending). OUT includes rdf:type edges, IN excludes them, as the
    host vp lists do (gstore.py)."""
    parts_v, parts_p, parts_w = [], [], []
    for (pid, dd), host in sorted(g.segments.items()):
        if int(dd) != int(d) or len(host.edges) == 0:
            continue
        degs = host.offsets[1:] - host.offsets[:-1]
        parts_v.append(np.repeat(np.asarray(host.keys, np.int64), degs))
        parts_p.append(np.full(len(host.edges), int(pid), np.int64))
        parts_w.append(np.asarray(host.edges, np.int64))
    if not parts_v:
        return (np.empty(0, np.int64), np.zeros(1, np.int64),
                np.empty(0, np.int64), np.empty(0, np.int64))
    v = np.concatenate(parts_v)
    p = np.concatenate(parts_p)
    w = np.concatenate(parts_w)
    order = np.argsort(v, kind="stable")
    v, p, w = v[order], p[order], w[order]
    keys, counts = np.unique(v, return_counts=True)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    return keys, offsets, w, p


def type_index_csr(g):
    """(keys, offsets, edges) of a partition's type index as one CSR keyed by
    type id."""
    pairs = [(t, g.index[(t, IN)]) for t in sorted(g.type_ids)]
    if not pairs:
        return (np.empty(0, np.int64), np.zeros(1, np.int64),
                np.empty(0, np.int64))
    keys = np.asarray([t for t, _ in pairs], dtype=np.int64)
    counts = np.asarray([len(v) for _, v in pairs], dtype=np.int64)
    offsets = np.zeros(len(keys) + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    edges = np.concatenate([v for _, v in pairs])
    return keys, offsets, edges


def build_hash_table(keys: np.ndarray, offsets: np.ndarray,
                     num_buckets: int | None = None):
    """Host-side bucketized table build (vectorized placement rounds).

    Returns (bkey [NB,8], bstart, bdeg, max_probe). Bucket count is sized for
    <=50% load so nearly all keys land in their home bucket (max_probe 1-2).
    Round r places every pending key whose bucket (hb + r) has a free lane,
    in key order within a bucket.
    """
    K = len(keys)
    NB = num_buckets or max(_next_pow2((K + BUCKET // 2 - 1) // (BUCKET // 2)), 2)
    # native fast path (bit-identical placement policy)
    from wukong_tpu_torch.native import build_bucket_table_native

    nat = build_bucket_table_native(np.asarray(keys), np.asarray(offsets), NB)
    if nat is not None:
        return nat
    bmask = np.uint32(NB - 1)
    bkey = np.full((NB, BUCKET), -1, dtype=np.int32)
    bstart = np.zeros((NB, BUCKET), dtype=np.int32)
    bdeg = np.zeros((NB, BUCKET), dtype=np.int32)
    if K == 0:
        return bkey, bstart, bdeg, 1
    starts = offsets[:-1].astype(np.int64)
    degs = (offsets[1:] - offsets[:-1]).astype(np.int64)
    hb = (keys.astype(np.uint32) * _HASH_MULT) & bmask
    used = np.zeros(NB, dtype=np.int64)
    pending = np.arange(K)
    round_ = 0
    while len(pending):
        tb = ((hb[pending] + np.uint32(round_)) & bmask).astype(np.int64)
        order = np.argsort(tb, kind="stable")
        tbs = tb[order]
        # rank within each same-bucket group this round
        idx = np.arange(len(tbs))
        begins = np.flatnonzero(np.concatenate([[True], tbs[1:] != tbs[:-1]]))
        group_id = np.cumsum(np.concatenate([[0], (tbs[1:] != tbs[:-1]).astype(int)]))
        rank = idx - begins[group_id]
        lane = used[tbs] + rank
        ok = lane < BUCKET
        rows = tbs[ok]
        lanes = lane[ok]
        kidx = pending[order[ok]]
        bkey[rows, lanes] = keys[kidx]
        bstart[rows, lanes] = starts[kidx]
        bdeg[rows, lanes] = degs[kidx]
        np.add.at(used, rows, 1)
        placed = np.zeros(len(pending), dtype=bool)
        placed[order[ok]] = True
        pending = pending[~placed]
        round_ += 1
        if round_ > NB:
            raise RuntimeError("bucket hash build failed to converge")
    return bkey, bstart, bdeg, max(round_, 1)


def line_table(bkey: np.ndarray, bstart: np.ndarray, bdeg: np.ndarray):
    """The device form of a bucket table from build_hash_table: (bline
    [NB, 16], bhi [NB*4, 2]), int32. A bucket's 64 B line holds its 8 keys
    and the (start, degree) pairs of lanes 0-3, which placement fills
    first, so K1 reads a key and, for most hits, its pair in one line; the
    pairs of lanes 4-7 go to bhi. Same bytes as keys and pairs apart."""
    NB = bkey.shape[0]
    sd = np.stack([bstart, bdeg], -1)  # [NB, 8, 2]
    bline = np.concatenate([bkey, sd[:, :4].reshape(NB, 8)], 1)
    return bline, sd[:, 4:].reshape(NB * 4, 2)


class DeviceStore:
    """Stages host CSR segments into device memory on demand."""

    def __init__(self, gstore, budget_bytes: int | None = None,
                 device="cuda"):
        self.g = gstore
        self.device = resolve_device(device)
        self.budget = budget_bytes
        # guards the caches, the LRU order, the pins and bytes_used; held
        # only for bookkeeping, never across a staging
        self._mu = threading.Lock()
        self._cache: dict = {}  # segment key -> DeviceSegment | MergeSegment
        self._index_cache: dict = {}  # ("idx"|"rev", ...) -> (tensor, real_len)
        self._lru: list = []
        # pinned key -> the chains holding it (a key stays pinned while any
        # concurrent chain still runs over it)
        self._pinned: collections.Counter = collections.Counter()
        self._staging: dict = {}  # key -> the lock of its staging in flight
        self._fcsr_memo: dict = {}  # filtered host CSRs, per (pid, d, fkey)
        self._maxdeg_memo: dict = {}  # (pid, d) -> largest host degree
        self.bytes_used = 0
        self._seen_version = getattr(gstore, "version", 0)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(
            self.device)

    # ---- segment staging -------------------------------------------------
    def _host_csr(self, pid: int, d: int):
        """(keys, offsets, edges) of a (pid, dir) host CSR, or None;
        TYPE_ID IN resolves to the type index CSR."""
        if int(pid) == TYPE_ID and int(d) == IN:
            keys, offsets, edges = type_index_csr(self.g)
            return (keys, offsets, edges) if len(keys) else None
        host = self.g.segments.get((int(pid), int(d)))
        if host is None:
            return None
        return host.keys, host.offsets, host.edges

    def _cached(self, key, build, table=None):
        """table[key] (the segment cache by default), staged by build() on
        a miss, once: a thread that misses a key while another stages it
        waits on that key's lock and then finds it staged (at LUBM-640 the
        OUT combined segment is 1.48 GB; two stagings of it could run the
        card out of memory). None from build() is not cached."""
        table = self._cache if table is None else table
        self._check_version()
        with self._mu:
            hit = table.get(key)
            if hit is not None:
                self._touch(key)
                return hit
            lock = self._staging.setdefault(key, threading.Lock())
        with lock:
            with self._mu:
                hit = table.get(key)
                if hit is not None:
                    self._touch(key)
                    return hit
            val = None
            try:
                val = build()
            finally:
                # one critical section: a miss between the two would find
                # neither the entry nor a staging to wait for
                with self._mu:
                    if val is not None:
                        table[key] = val
                        self._lru.append(key)
                        self.bytes_used += self._nbytes(val)
                        maybe_device_resident("fill", self._kind(val),
                                              self._nbytes(val))
                        self._enforce_budget()
                    self._staging.pop(key, None)
        return val

    def _check_version(self) -> None:
        """A store mutation (store/dynamic.py, a checkpoint restore) bumps
        the host store's version: drop every staging of the old version,
        whatever the insert touched, charged as ONE residency edge per kind
        (the JAX DeviceStore's invalidation, wukong_tpu/engine/
        device_store.py:249-269).

        Dropping the old stagings frees their memory while a serving thread
        may still have kernels queued that read it. That is safe only
        because every launch runs on the one default stream
        (``cuda_lib.stream_ptr``): the caching allocator hands freed blocks
        out again in stream order, so a later allocation's writes queue
        behind the pending reads. Per-thread streams (ROADMAP A′, "Per-thread
        CUDA streams for serving threads") will
        need ``Tensor.record_stream`` on each staged tensor for every stream
        that reads it, or an event the freeing thread waits on."""
        v = getattr(self.g, "version", 0)
        if v == self._seen_version:
            return
        with self._mu:
            if v == self._seen_version:
                return
            seg_bytes = sum(self._nbytes(s) for s in self._cache.values())
            idx_bytes = max(self.bytes_used - seg_bytes, 0)
            self._cache.clear()
            self._index_cache.clear()
            self._lru.clear()
            self._fcsr_memo.clear()
            self._maxdeg_memo.clear()
            self.bytes_used = 0
            self._seen_version = v
        if seg_bytes:
            maybe_device_resident("invalidate", "segment", seg_bytes,
                                  version=int(v))
        if idx_bytes:
            maybe_device_resident("invalidate", "index", idx_bytes,
                                  version=int(v))

    @staticmethod
    def _nbytes(val) -> int:
        """Device bytes of a cache entry: a segment, or (list, length)."""
        return val[0].numel() * 4 if isinstance(val, tuple) else val.nbytes

    @staticmethod
    def _kind(val) -> str:
        """The residency ledger's kind of a cache entry."""
        return "index" if isinstance(val, tuple) else "segment"

    def segment(self, pid: int, d: int) -> DeviceSegment | None:
        """Stage (pid, dir) in bucket form; TYPE_ID IN resolves to the type
        index CSR."""
        def build():
            csr = self._host_csr(pid, d)
            return None if csr is None else self._stage(*csr)
        return self._cached((int(pid), int(d)), build)

    def versatile_segment(self, d: int) -> DeviceSegment | None:
        """Stage the COMBINED adjacency of direction d: one CSR keyed by vid
        whose edges are every (predicate, neighbor) pair, the device form of
        the VERSATILE per-vid predicate lists (gstore.hpp:890-903). expand2
        probes it (K1) and binds both the predicate and the neighbor."""
        def build():
            keys, offsets, w, p = combined_adjacency(self.g, d)
            if len(keys) == 0:
                return None
            seg = self._stage(keys, offsets, w)
            p_pad = np.full(seg.edges.shape[0], INT32_MAX, dtype=np.int32)
            p_pad[: len(p)] = p
            seg.edges2 = self._dev(p_pad)
            return seg
        return self._cached(("vpv", int(d)), build)

    def merge_segment(self, pid: int, d: int) -> MergeSegment | None:
        """Stage (pid, dir) for the sort-merge kernels."""
        def build():
            csr = self._host_csr(pid, d)
            return None if csr is None else self._stage_merge(*csr)
        return self._cached(("mrg", int(pid), int(d)), build)

    def filtered_merge_segment(self, pid: int, d: int,
                               filters: list) -> MergeSegment | None:
        """Merge segment of (pid, d) with edges restricted to targets that
        satisfy every (fpid, fd, fconst) k2c filter — an expand followed by
        `?v type T` membership becomes ONE expand over the pre-intersected
        segment (the reference planner's type-centric pruning)."""
        fkey = fold_key(filters)

        def build():
            csr = self._filtered_host_csr(pid, d, fkey)
            return None if csr is None else self._stage_merge(*csr)
        return self._cached(("mrgf", int(pid), int(d), fkey), build)

    def filtered_segment(self, pid: int, d: int,
                         filters: list) -> DeviceSegment | None:
        """Bucket-form twin of filtered_merge_segment (probe-lookup path)."""
        fkey = fold_key(filters)

        def build():
            csr = self._filtered_host_csr(pid, d, fkey)
            return None if csr is None else self._stage(*csr)
        return self._cached(("segf", int(pid), int(d), fkey), build)

    def _filtered_host_csr(self, pid: int, d: int, fkey: tuple):
        memo_key = (int(pid), int(d), fkey)
        csr = self._fcsr_memo.get(memo_key)
        if csr is None:
            if len(self._fcsr_memo) > 64:  # bound the host-side copies
                self._fcsr_memo.clear()
            csr = self._fcsr_memo[memo_key] = self._filtered_host_csr_build(
                pid, d, fkey)
        return csr

    def _filtered_host_csr_build(self, pid: int, d: int, fkey: tuple):
        csr = self._host_csr(pid, d)
        if csr is None:
            return None
        keys, offsets, edges = csr
        edges = np.asarray(edges)
        mask = np.ones(len(edges), dtype=bool)
        for (fp, fd, fc) in fkey:
            allowed = self._const_members(fp, fd, fc)
            if len(allowed) == 0:
                mask[:] = False
                break
            # allowed is sorted: O(E log M) membership
            pos = np.clip(np.searchsorted(allowed, edges), 0, len(allowed) - 1)
            mask &= allowed[pos] == edges
        csum = np.concatenate([[0], np.cumsum(mask)])
        new_deg = csum[offsets[1:]] - csum[offsets[:-1]]
        keep_key = new_deg > 0
        fkeys = np.asarray(keys)[keep_key]
        foffs = np.zeros(len(fkeys) + 1, dtype=np.int64)
        np.cumsum(new_deg[keep_key], out=foffs[1:])
        return fkeys, foffs, edges[mask]

    def host_num_keys(self, pid: int, d: int) -> int:
        """Key count of a (pid, dir) segment from HOST metadata only."""
        if int(pid) == TYPE_ID and int(d) == IN:
            return len(self.g.type_ids)
        host = self.g.segments.get((int(pid), int(d)))
        return host.num_keys if host is not None else 0

    def host_num_edges(self, pid: int, d: int) -> int:
        """Edge count of a (pid, dir) segment from HOST metadata only."""
        if int(pid) == TYPE_ID and int(d) == IN:
            return sum(len(self.g.get_index(t, IN)) for t in self.g.type_ids)
        host = self.g.segments.get((int(pid), int(d)))
        return host.num_edges if host is not None else 0

    def host_max_deg(self, pid: int, d: int) -> int:
        """Largest key degree of a (pid, dir) host CSR (0 when absent)."""
        key = (int(pid), int(d))
        m = self._maxdeg_memo.get(key)
        if m is None:
            csr = self._host_csr(pid, d)
            m = 0 if csr is None or len(csr[0]) == 0 else int(
                np.diff(np.asarray(csr[1])).max())
            self._maxdeg_memo[key] = m
        return m

    def host_reverse_max_deg(self, pid: int, d: int) -> int | None:
        """How many (pid, dir) keys can share one neighbour, at most: the
        reverse CSR's largest degree, when that CSR holds every edge of
        (pid, dir) reversed (equal edge counts); None when it does not
        (edges to index-id objects have no reverse edge)."""
        rd = 1 - int(d)
        if self.host_num_edges(pid, d) != self.host_num_edges(pid, rd):
            return None
        return self.host_max_deg(pid, rd)

    # ---- lists -----------------------------------------------------------
    def index_list(self, tpid: int, d: int):
        """Index edge list (type members / pred subjects-objects) on device:
        (tensor padded with INT32_MAX, real length)."""
        return self._cached(
            ("idx", int(tpid), int(d)),
            lambda: self._stage_list(np.asarray(self.g.get_index(tpid, d))),
            self._index_cache)

    def _const_members(self, pid: int, d: int, const: int) -> np.ndarray:
        """Host-side sorted { x : const ∈ adj(x, pid, d) }."""
        pid, d, const = int(pid), int(d), int(const)
        if pid == TYPE_ID and d == OUT:
            host = self.g.get_index(const, IN)
        elif pid == TYPE_ID and d == IN:
            host = self.g.get_triples(const, TYPE_ID, OUT)
        elif pid == PREDICATE_ID:
            host = self.g.get_index(const, IN if d == OUT else OUT)
        else:
            host = self.g.get_triples(const, pid, IN if d == OUT else OUT)
        return np.sort(np.asarray(host, dtype=np.int64))

    def const_list(self, pid: int, d: int, const: int):
        """Sorted set { x : const ∈ adj(x, pid, d) } staged on device — the
        k2c merge relation. Returns (tensor, real_len)."""
        return self._cached(
            ("rev", int(pid), int(d), int(const)),
            lambda: self._stage_list(self._const_members(pid, d, const)),
            self._index_cache)

    def _stage_list(self, arr: np.ndarray):
        padded = np.full(_next_pow2(len(arr)), INT32_MAX, dtype=np.int32)
        padded[: len(arr)] = arr
        return self._dev(padded), len(arr)

    # ---- builders --------------------------------------------------------
    def _stage(self, keys, offsets, edges) -> DeviceSegment:
        K, E = len(keys), len(edges)
        e = np.full(_next_pow2(E), INT32_MAX, dtype=np.int32)
        e[:E] = edges
        bkey, bstart, bdeg, max_probe = build_hash_table(
            np.asarray(keys), np.asarray(offsets))
        bline, bhi = (self._dev(a) for a in line_table(bkey, bstart, bdeg))
        check_table(bline, bhi)
        max_deg = int((offsets[1:] - offsets[:-1]).max()) if K else 1
        return DeviceSegment(
            bline=bline, bhi=bhi, edges=self._dev(e), num_keys=K, num_edges=E, max_probe=max_probe,
            max_deg_log2=max(int(max_deg).bit_length(), 1))

    def _stage_merge(self, keys, offsets, edges) -> MergeSegment:
        K, E = len(keys), len(edges)
        Kp, Ep = _next_pow2(K), _next_pow2(E)
        degs = offsets[1:] - offsets[:-1]
        sk = np.full(Kp, INT32_MAX, dtype=np.int32)
        sk[:K] = keys
        ss = np.zeros(Kp, dtype=np.int32)
        ss[:K] = offsets[:-1]
        sd = np.zeros(Kp, dtype=np.int32)
        sd[:K] = degs
        e = np.full(Ep, INT32_MAX, dtype=np.int32)
        e[:E] = edges
        ek = np.full(Ep, INT32_MAX, dtype=np.int32)
        ek[:E] = np.repeat(np.asarray(keys, dtype=np.int32),
                           np.asarray(degs, dtype=np.int64))
        return MergeSegment(skey=self._dev(sk), sstart=self._dev(ss),
                            sdeg=self._dev(sd), edges=self._dev(e),
                            ekey=self._dev(ek), num_keys=K, num_edges=E)

    # ---- cache management (callers hold _mu) ------------------------------
    def _enforce_budget(self) -> None:
        if self.budget is None:
            return
        while self.bytes_used > self.budget:
            victims = [k for k in self._lru if k not in self._pinned]
            if not victims:
                return
            self._evict(victims[0])

    def _evict(self, key) -> None:
        table = self._cache if key in self._cache else self._index_cache
        val = table.pop(key)
        self.bytes_used -= self._nbytes(val)
        maybe_device_resident("evict", self._kind(val), self._nbytes(val))
        self._lru.remove(key)

    def _touch(self, key) -> None:
        if key in self._lru:
            self._lru.remove(key)
            self._lru.append(key)

    @staticmethod
    def _pin_key(k):
        # (pid, d) pins the bucket staging; string-tagged keys pin as-is
        return k if isinstance(k[0], str) else (int(k[0]), int(k[1]))

    def pin(self, keys) -> None:
        with self._mu:
            self._pinned.update(self._pin_key(k) for k in keys)

    def unpin(self, keys) -> None:
        with self._mu:
            self._pinned.subtract(self._pin_key(k) for k in keys)
            self._pinned += collections.Counter()  # drop counts at 0
            self._enforce_budget()  # pins may have deferred evictions

    def prefetch(self, patterns) -> None:
        """Stage the bucket segments of upcoming pattern steps (the combined
        segment for a variable predicate, the largest staging of a chain)."""
        for p in patterns:
            if p.predicate >= 0:
                self.segment(p.predicate, p.direction)
            else:
                self.versatile_segment(p.direction)
