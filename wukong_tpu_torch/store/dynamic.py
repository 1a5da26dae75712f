"""Dynamic (incremental) store: online bulk insertion — the DynamicGStore role.

The reference's dynamic store (core/store/dynamic_gstore.hpp) swaps the bump
allocator for a real allocator so `load -d <dir>` can insert triples online
(insert_triple_out/in, :537/:603), with lease-based invalidation so remote
RDMA-cached reads stay safe. Here the lease machinery disappears: inserts
append to per-segment DELTA buffers (O(batch) plus a membership probe for
dedup — never an O(segment) rebuild per batch), and the merged CSR
materializes lazily on first read after a write epoch. Each batch bumps a
store version; device-side caches (engine/device_store.py, join/wcoj.py's
table cache, engine/template_compile.py's programs, the proxy's plan cache)
compare versions and restage lazily.

New predicates/types create new segments/indexes, matching DynamicLoader's
support for unseen predicates (core/loader/dynamic_loader.hpp).

The port's copy of the JAX package's store/dynamic.py: the same insert
sequence gives the same arrays, version and ``gstore_digest``. Readers take
no store-wide lock against a writer, as in the JAX package, but each
``DeltaCSRSegment`` holds a lock of its own around ``append`` and the merge
in ``_mat``: without it a serving thread's merge could clear a batch that an
insert appended after the merge took its snapshot (ROADMAP §C). A batch's
version edge goes to the serving plane (``notify_mutation``, inside the
mutation lock) and to the reuse observatory (``maybe_note_invalidation``,
which journals ``cache.invalidate``), as in the JAX package. The migration
dual-write sinks wait for the distributed engine (ROADMAP §A,
"``parallel/``, the distributed engine").
"""

from __future__ import annotations

import numpy as np

from wukong_tpu_torch.analysis.lockdep import declare_leaf, make_lock
from wukong_tpu_torch.store.gstore import GStore, _pred_runs, _triple_argsort
from wukong_tpu_torch.store.segment import CSRSegment
from wukong_tpu_torch.types import IN, NORMAL_ID_START, OUT, TYPE_ID
from wukong_tpu_torch.utils.mathutil import hash_mod

# a segment's lock guards only its own delta buffers; nothing is acquired
# under it
declare_leaf("dynamic.segment")


class DeltaCSRSegment:
    """CSR segment with append-only delta buffers (dynamic_gstore.hpp's role,
    redesigned): writes append (key, value) runs; reads materialize the
    merged CSR once per write epoch. Duck-types CSRSegment — every consumer
    (engines, device staging, checker, persistence) sees merged arrays.
    ``_lock`` serializes ``append`` with the merge: a reader merging while a
    writer appends must not clear the writer's batch.
    """

    __slots__ = ("_base", "_pending", "_n_pending", "_pending_set", "_lock")

    def __init__(self, base: CSRSegment | None):
        self._base = base if base is not None else CSRSegment.empty()
        self._pending: list = []  # guarded by: _lock
        self._n_pending = 0  # guarded by: _lock
        self._pending_set: set = set()  # guarded by: _lock; O(1) dedup probes into the deltas
        self._lock = make_lock("dynamic.segment")

    # ---- writes ----------------------------------------------------------
    def append(self, ks: np.ndarray, vs: np.ndarray, dedup: bool) -> int:
        """Append a batch; with dedup, pairs already present (in the base,
        the pending deltas, or earlier in the batch) are dropped. O(batch)
        plus a base membership probe — never re-scans prior deltas. Returns
        the number of edges actually appended."""
        with self._lock:
            return self._append(ks, vs, dedup)

    def _append(self, ks: np.ndarray, vs: np.ndarray, dedup: bool) -> int:
        if dedup:
            if len(ks):
                pairs = np.stack([ks, vs], axis=1)
                pairs = np.unique(pairs, axis=0)  # in-batch dups
                ks, vs = pairs[:, 0], pairs[:, 1]
            keep = ~self._base.contains_pair(ks, vs)
            if self._pending_set:
                ps = self._pending_set
                keep &= np.fromiter(
                    ((int(k), int(v)) not in ps for k, v in zip(ks, vs)),
                    dtype=bool, count=len(ks))
            ks, vs = ks[keep], vs[keep]
        if len(ks):
            ks = np.asarray(ks, np.int64)
            vs = np.asarray(vs, np.int64)
            self._pending.append((ks, vs))
            self._n_pending += len(ks)
            self._pending_set.update(zip(ks.tolist(), vs.tolist()))
        return int(len(ks))

    # ---- lazy materialization -------------------------------------------
    def _mat(self) -> CSRSegment:
        if not self._pending:  # unguarded: the no-delta fast path; a batch appended after this read is merged by the next read
            return self._base
        with self._lock:
            if self._pending:
                self._merge()
            return self._base

    def _merge(self) -> None:
        """The merged CSR: the JAX merge's arrays (a lexsort of base +
        deltas by (key, value), ties in arrival order), built by sorting
        only the deltas and inserting each after the base's equal pairs —
        two copies of the base instead of a sort of it, which made the
        first read after a write O(segment log segment)."""
        base = self._base
        pk = np.concatenate([p[0] for p in self._pending])
        pv = np.concatenate([p[1] for p in self._pending])
        order = np.lexsort((pv, pk))
        pk, pv = pk[order], pv[order]
        keys, offsets, edges = base.keys, base.offsets, base.edges
        # each delta's key run in the base ([lo, hi); empty for a new key,
        # at the place the key's run will take), then the position after
        # its equal values there: a vectorized binary search
        at = np.searchsorted(keys, pk)
        lo, hi = offsets[at].copy(), offsets[at].copy()
        old = at < len(keys)
        old[old] = keys[at[old]] == pk[old]
        hi[old] = offsets[at[old] + 1]
        while True:
            live = lo < hi
            if not live.any():
                break
            mid = (lo + hi) // 2
            right = np.zeros(len(lo), dtype=bool)
            right[live] = edges[mid[live]] <= pv[live]
            lo = np.where(live & right, mid + 1, lo)
            hi = np.where(live & ~right, mid, hi)
        merged_edges = np.insert(
            edges.astype(np.result_type(edges, pv), copy=False), lo, pv)
        new_keys = sorted_union(keys, pk)
        counts = np.zeros(len(new_keys), dtype=np.int64)
        counts[np.searchsorted(new_keys, keys)] = np.diff(offsets)
        np.add.at(counts, np.searchsorted(new_keys, pk), 1)
        new_offsets = np.zeros(len(new_keys) + 1, dtype=np.int64)
        np.cumsum(counts, out=new_offsets[1:])
        # no pair-dedup here: dedup appends were filtered at write time,
        # non-dedup appends legitimately keep duplicates
        self._base = CSRSegment(keys=new_keys, offsets=new_offsets,
                                edges=merged_edges)
        self._pending.clear()
        self._pending_set.clear()
        self._n_pending = 0

    # ---- CSRSegment interface -------------------------------------------
    @property
    def keys(self):
        return self._mat().keys

    @property
    def offsets(self):
        return self._mat().offsets

    @property
    def edges(self):
        return self._mat().edges

    @property
    def num_keys(self) -> int:
        return self._mat().num_keys

    @property
    def num_edges(self) -> int:  # exact without materializing
        return self._base.num_edges + self._n_pending

    def lookup(self, vid: int):
        return self._mat().lookup(vid)

    def lookup_many(self, vids):
        return self._mat().lookup_many(vids)

    def contains_pair(self, vids, vals):
        return self._mat().contains_pair(vids, vals)

    def memory_bytes(self) -> int:
        return self._base.memory_bytes() + 16 * self._n_pending


def sorted_union(old: np.ndarray, new: np.ndarray) -> np.ndarray:
    """``np.union1d(old, new)`` (same values, same dtype): for a sorted
    unique ``old`` (an index list, a key array, a versatile set) the new
    values it lacks are inserted in place — a copy of ``old`` instead of a
    sort of old + new, which made every insert batch O(index log index).
    Any other ``old`` goes to ``np.union1d``."""
    new = np.asarray(new)
    if (len(old) and old.dtype == np.result_type(old, new)
            and (len(old) < 2 or bool((old[1:] > old[:-1]).all()))):
        new = np.unique(new)
        pos = np.searchsorted(old, new)
        have = pos < len(old)
        have[have] = old[pos[have]] == new[have]
        return np.insert(old, pos[~have], new[~have])
    return np.union1d(old, new)


def insert_triples(g: GStore, triples: np.ndarray, dedup: bool = True,
                   check_ids: bool = True) -> int:
    """Insert an [N,3] batch into this partition. Returns #edges inserted
    (subject-side copies; the object-side copies are inserted symmetrically).

    Bumps g.version so device caches restage affected segments.
    """
    from wukong_tpu_torch.runtime import faults

    # fault hook BEFORE any mutation: an injected transient leaves the store
    # untouched, so a retry replays the batch safely
    faults.site("dynamic.insert", shard=g.sid)
    if check_ids:
        from wukong_tpu_torch.store.gstore import check_vid_range

        check_vid_range(triples)
    s, p, o = triples[:, 0], triples[:, 1], triples[:, 2]
    n = g.num_workers
    mine_out = hash_mod(s, n) == g.sid
    mine_in = (hash_mod(o, n) == g.sid) & (o >= NORMAL_ID_START)

    so, po, oo = s[mine_out], p[mine_out], o[mine_out]
    si, pi, oi = s[mine_in], p[mine_in], o[mine_in]

    order = _triple_argsort(po, so, oo)
    so, po, oo = so[order], po[order], oo[order]
    inserted = 0
    for pid, ks, vs in _pred_runs(po, so, oo):
        inserted += _merge_into(g, (pid, OUT), ks, vs, dedup)
        if pid == TYPE_ID:
            for t in np.unique(vs):
                members = np.unique(ks[vs == t])
                old = g.index.get((int(t), IN), np.empty(0, dtype=np.int64))
                g.index[(int(t), IN)] = sorted_union(old, members)
                g.type_ids.add(int(t))
        else:
            old = g.index.get((pid, IN), np.empty(0, dtype=np.int64))
            g.index[(pid, IN)] = sorted_union(old, np.unique(ks))

    order = _triple_argsort(pi, oi, si)
    si, pi, oi = si[order], pi[order], oi[order]
    for pid, ks, vs in _pred_runs(pi, oi, si):
        _merge_into(g, (pid, IN), ks, vs, dedup)
        old = g.index.get((pid, OUT), np.empty(0, dtype=np.int64))
        g.index[(pid, OUT)] = sorted_union(old, np.unique(ks))

    # versatile structures
    if g.vp:
        g.vp[OUT] = _merge_seg(g.vp.get(OUT), s[mine_out], p[mine_out], True)
        g.vp[IN] = _merge_seg(g.vp.get(IN), oi, pi, True)
        g.v_set = sorted_union(g.v_set, np.concatenate([s[mine_out], oi]))
        tmask = p[mine_out] == TYPE_ID
        g.t_set = sorted_union(g.t_set, o[mine_out][tmask])
        g.p_set = sorted_union(
            g.p_set, np.unique(np.concatenate([p[mine_out][~tmask], pi])))

    g.version = getattr(g, "version", 0) + 1
    return int(inserted)


def _merge_into(g: GStore, key, ks, vs, dedup: bool) -> int:
    seg = g.segments.get(key)
    if not isinstance(seg, DeltaCSRSegment):
        seg = DeltaCSRSegment(seg)
        g.segments[key] = seg
    return seg.append(np.asarray(ks, np.int64), np.asarray(vs, np.int64),
                      dedup)


def _merge_seg(seg, ks, vs, dedup: bool) -> DeltaCSRSegment:
    if not isinstance(seg, DeltaCSRSegment):
        seg = DeltaCSRSegment(seg)
    seg.append(np.asarray(ks, np.int64), np.asarray(vs, np.int64), dedup)
    return seg


def load_dir_into(stores: list[GStore], dirname: str, dedup: bool = True) -> int:
    """`load -d <dir>`: read id-triple files and insert into every partition
    (the RDFEngine::execute_load_data path, core/engine/rdf.hpp)."""
    from wukong_tpu_torch.loader.base import load_triples
    from wukong_tpu_torch.store.gstore import check_vid_range

    triples = load_triples(dirname)
    check_vid_range(triples)  # once, not per store
    return insert_batch_into(stores, triples, dedup)


def insert_batch_into(stores: list[GStore], triples: np.ndarray,
                      dedup: bool = True) -> int:
    """One durable batch insert into every partition: the WAL append hook
    fires BEFORE any store mutates, so an acknowledged batch is always
    replayable and a WAL failure leaves the stores untouched. The mutation
    lock keeps the append + fan-out atomic w.r.t. checkpoint
    serialization (runtime/recovery.py)."""
    from wukong_tpu_torch.obs.reuse import maybe_note_invalidation
    from wukong_tpu_torch.serve import notify_mutation
    from wukong_tpu_torch.store.wal import maybe_wal_append, mutation_lock

    with mutation_lock():
        maybe_wal_append("insert", triples, dedup)
        total = 0
        for g in stores:
            total += insert_triples(g, triples, dedup, check_ids=False)
        # the serving plane's edge: INSIDE the mutation lock, so view
        # maintenance re-keys surviving cache entries atomically with the
        # version bump. One knob check when the result cache is off.
        if stores:
            notify_mutation("insert",
                            version=getattr(stores[0], "version", 0),
                            triples=triples)
    # the observatory's edge kills the stale shadow keys and journals one
    # cache.invalidate event, outside the lock (pure observability)
    if stores:
        maybe_note_invalidation(
            "insert", version=getattr(stores[0], "version", 0),
            n_triples=int(len(triples)))
    return total
