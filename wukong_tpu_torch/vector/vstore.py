"""Per-partition dense embedding store (the vector half of the hybrid
graph+vector plane).

One :class:`VectorStore` hangs off each :class:`GStore` partition
(``g.vstore``, attached by :func:`attach_vstore`) and holds a
``[n_slots, dim]`` float32 block keyed by vertex id, with tombstoned
upserts. It mirrors the triple store's disciplines:

- **Durability**: :func:`upsert_batch_into` is the primary mutation
  path — ``maybe_wal_append("vector", ...)`` fires BEFORE any store
  mutates (``dynamic.insert_batch_into`` parity), so an acknowledged
  batch is always replayable and a WAL failure leaves every store
  untouched. Recovery re-applies the records via
  :func:`apply_vector_record`.
- **Versioning**: every mutation bumps BOTH the vstore's own version
  and the owning partition's ``g.version`` (:func:`bump_store_version`)
  — the plan cache, the device stagings (the k-NN block among them), the
  join-table cache and the k-NN route memos all key on the store version.
- **Snapshot reads**: slot arrays are copy-on-write and published
  write-protected (``setflags(write=False)``): a scan grabs coherent
  immutable references under the slot lock and computes outside it; a
  racing upsert publishes NEW arrays, never mutates the ones a reader
  holds.
- **Partitioning**: ownership is ``hash_mod(vid, num_workers) == sid``,
  the triple store's subject rule.

The port's copy of the JAX package's vector/vstore.py. A batch's version
edge goes to the serving plane (``notify_mutation``) and the reuse
observatory (``maybe_note_invalidation``), as ``insert_batch_into``'s does;
the migration dual-write sinks wait for the distributed engine (ROADMAP §A,
"``parallel/``, the distributed engine").
"""

from __future__ import annotations

import zlib

import numpy as np

from wukong_tpu_torch.analysis.lockdep import declare_leaf, make_lock
from wukong_tpu_torch.utils.errors import ErrorCode, WukongError
from wukong_tpu_torch.utils.mathutil import hash_mod

# the slot lock guards array-reference swaps and dict replacement only —
# innermost by construction, like heat.shard (scans copy references out
# and compute outside it)
declare_leaf("vector.slots")


def _metrics():
    from wukong_tpu_torch.obs.metrics import get_registry

    reg = get_registry()
    return (
        reg.counter("wukong_vector_upserts_total",
                    "Embedding vectors upserted (post-ownership-filter)"),
        reg.counter("wukong_vector_tombstones_total",
                    "Embedding slots tombstoned"),
    )


class VectorStore:
    """One partition's embedding block: vertex id -> ``dim`` float32s."""

    def __init__(self, sid: int, num_workers: int, dim: int):
        if int(dim) <= 0:
            raise WukongError(ErrorCode.UNSUPPORTED_SHAPE,
                              f"vector_dim must be positive, got {dim}")
        self.sid = int(sid)
        self.num_workers = int(num_workers)
        self.dim = int(dim)
        self._lock = make_lock("vector.slots")
        m_up, m_tomb = _metrics()
        self._m_upserts = m_up
        self._m_tombstones = m_tomb
        vids = np.empty(0, dtype=np.int64)
        vecs = np.empty((0, self.dim), dtype=np.float32)
        alive = np.empty(0, dtype=bool)
        for a in (vids, vecs, alive):
            a.setflags(write=False)
        # reference swaps only under the lock; the arrays themselves are
        # immutable (write-protected) and slot_of is replaced wholesale
        self.vids = vids  # guarded by: _lock
        self.vecs = vecs  # guarded by: _lock
        self.alive = alive  # guarded by: _lock
        self.slot_of: dict[int, int] = {}  # guarded by: _lock
        self.version = 0  # guarded by: _lock
        # the block staged for the device scan (vector/knn.py
        # staged_block): one version on one device, dropped by a mutation
        self._knn_block = None

    # ------------------------------------------------------------------
    # the single mutation primitive
    # ------------------------------------------------------------------
    def _apply_slots(self, vids: np.ndarray, vecs: np.ndarray | None,
                     tombstone: bool) -> int:
        """THE slot writer (vector-coherence gate contract: no other
        function touches the slot state, and this one always bumps the
        version). Copy-on-write: builds fresh arrays, publishes them
        write-protected under the lock. New vertex ids append in sorted
        order so the slot layout is canonical — a WAL-replayed store is
        byte-identical to the uninterrupted one. Returns slots written."""
        vids = np.asarray(vids, dtype=np.int64).ravel()
        if vids.size == 0:
            return 0
        if not tombstone:
            vecs = np.asarray(vecs, dtype=np.float32)
            if vecs.ndim != 2 or vecs.shape != (len(vids), self.dim):
                raise WukongError(
                    ErrorCode.UNSUPPORTED_SHAPE,
                    f"vector batch shape {getattr(vecs, 'shape', None)} != "
                    f"({len(vids)}, {self.dim}) (vector_dim is fixed)")
            # in-batch dedup: the LAST occurrence of a vid wins (upsert
            # semantics); np.unique keeps the first, so reverse first
            rev = vids[::-1]
            _, first = np.unique(rev, return_index=True)
            if len(first) < len(vids):  # no duplicate: keep is every row
                keep = np.sort(len(vids) - 1 - first)
                vids, vecs = vids[keep], vecs[keep]
        else:
            vids = np.unique(vids)
        with self._lock:
            cur_vids = np.array(self.vids)  # writable working copies
            cur_vecs = np.array(self.vecs)
            cur_alive = np.array(self.alive)
            slot_of = dict(self.slot_of)
            known = (np.asarray([slot_of.get(v, -1) for v in vids.tolist()],
                                dtype=np.int64).reshape(-1) if slot_of
                     else np.full(len(vids), -1, dtype=np.int64))
            hit = known >= 0
            if tombstone:
                written = int(hit.sum())
                cur_alive[known[hit]] = False
            else:
                cur_vecs[known[hit]] = vecs[hit]
                cur_alive[known[hit]] = True
                # the copies below are skipped where they would be the
                # identity (an all-new batch, already in id order): a
                # batch of millions of vectors is gigabytes
                fresh_v, fresh_x = ((vids, vecs) if not hit.any()
                                    else (vids[~hit], vecs[~hit]))
                if fresh_v.size:
                    if np.any(fresh_v[1:] < fresh_v[:-1]):
                        order = np.argsort(fresh_v, kind="stable")
                        fresh_v, fresh_x = fresh_v[order], fresh_x[order]
                    base = len(cur_vids)
                    slot_of.update(zip(fresh_v.tolist(),
                                       range(base, base + len(fresh_v))))
                    cur_vids = np.concatenate([cur_vids, fresh_v])
                    cur_vecs = np.concatenate([cur_vecs, fresh_x], axis=0)
                    cur_alive = np.concatenate(
                        [cur_alive, np.ones(len(fresh_v), dtype=bool)])
                written = int(len(vids))
            for a in (cur_vids, cur_vecs, cur_alive):
                a.setflags(write=False)
            self.vids = cur_vids
            self.vecs = cur_vecs
            self.alive = cur_alive
            self.slot_of = slot_of
            self.version += 1
            stale, self._knn_block = self._knn_block, None
        if stale is not None and stale.device.type != "cpu":
            from wukong_tpu_torch.obs.device import maybe_device_resident

            maybe_device_resident("invalidate", "knn", stale.nbytes,
                                  version=self.version)
        return written

    # ------------------------------------------------------------------
    # mutation API (ownership-filtered, metric-charged)
    # ------------------------------------------------------------------
    def owned_mask(self, vids: np.ndarray) -> np.ndarray:
        vids = np.asarray(vids, dtype=np.int64)
        return hash_mod(vids, self.num_workers) == self.sid

    def upsert(self, vids, vecs) -> int:
        """Ownership-filtered batch upsert; returns vectors written."""
        vids = np.asarray(vids, dtype=np.int64).ravel()
        vecs = np.asarray(vecs, dtype=np.float32)
        mine = self.owned_mask(vids)
        if not mine.all():
            vids, vecs = vids[mine], vecs[mine]
        n = self._apply_slots(vids, vecs, tombstone=False)
        if n:
            self._m_upserts.inc(n)
        return n

    def tombstone(self, vids) -> int:
        """Ownership-filtered batch delete (slots stay, flagged dead —
        a later upsert of the same vid revives the slot in place)."""
        vids = np.asarray(vids, dtype=np.int64).ravel()
        n = self._apply_slots(vids[self.owned_mask(vids)], None,
                              tombstone=True)
        if n:
            self._m_tombstones.inc(n)
        return n

    # ------------------------------------------------------------------
    # read side
    # ------------------------------------------------------------------
    def snapshot(self):
        """Coherent immutable (vids, vecs, alive, version) references —
        grab under the lock, scan outside it."""
        with self._lock:
            return self.vids, self.vecs, self.alive, self.version

    def get(self, vid: int) -> np.ndarray | None:
        with self._lock:
            slot = self.slot_of.get(int(vid))
            if slot is None or not bool(self.alive[slot]):
                return None
            return self.vecs[slot]

    def live_count(self) -> int:
        with self._lock:
            return int(self.alive.sum())

    def n_slots(self) -> int:
        with self._lock:
            return int(len(self.vids))

    def memory_bytes(self) -> int:
        with self._lock:
            return int(self.vecs.nbytes + self.vids.nbytes
                       + self.alive.nbytes)

    def digest(self) -> int:
        """Order-sensitive content digest (recovery parity drills)."""
        vids, vecs, alive, _v = self.snapshot()
        crc = zlib.crc32(np.ascontiguousarray(vids).tobytes())
        crc = zlib.crc32(np.ascontiguousarray(vecs).tobytes(), crc)
        crc = zlib.crc32(np.ascontiguousarray(alive).tobytes(), crc)
        return crc

    # ------------------------------------------------------------------
    # persist / clone plumbing (store/persist.py carries these arrays
    # inside the gstore bundle, CRC'd like every other array)
    # ------------------------------------------------------------------
    def export_arrays(self) -> dict:
        vids, vecs, alive, _v = self.snapshot()
        return {"vstore_vids": vids, "vstore_vecs": vecs,
                "vstore_alive": alive.astype(np.uint8)}

    @classmethod
    def from_arrays(cls, sid: int, num_workers: int, vids: np.ndarray,
                    vecs: np.ndarray, alive: np.ndarray,
                    version: int = 0) -> "VectorStore":
        vs = cls(sid, num_workers, int(vecs.shape[1]) if vecs.ndim == 2
                 and vecs.shape[1] else 1)
        vids = np.asarray(vids, dtype=np.int64)
        vecs = np.asarray(vecs, dtype=np.float32)
        alive = np.asarray(alive).astype(bool)
        for a in (vids, vecs, alive):
            a.setflags(write=False)
        with vs._lock:
            vs.vids = vids
            vs.vecs = vecs
            vs.alive = alive
            vs.slot_of = dict(zip(vids.tolist(), range(len(vids))))
            vs.version = int(version)
        return vs

    def clone(self) -> "VectorStore":
        """Snapshot copy for shard replication/migration (arrays are
        immutable — sharing references is safe, the CSR-base posture)."""
        vids, vecs, alive, version = self.snapshot()
        return VectorStore.from_arrays(self.sid, self.num_workers, vids,
                                       vecs, alive, version=version)


# ---------------------------------------------------------------------------
# store attachment + the durable commit path
# ---------------------------------------------------------------------------


def attach_vstore(g, dim: int | None = None) -> VectorStore:
    """Create (or return) ``g.vstore`` with the partition's identity."""
    vs = getattr(g, "vstore", None)
    if vs is None:
        from wukong_tpu_torch.config import Global

        dim = int(Global.vector_dim if dim is None else dim)
        vs = VectorStore(getattr(g, "sid", 0),
                         getattr(g, "num_workers", 1), dim)
        g.vstore = vs
    return vs


def bump_store_version(g) -> int:
    """The store-version protocol: vector mutations invalidate every
    version-keyed cache exactly like triple mutations do."""
    g.version = getattr(g, "version", 0) + 1
    return g.version


def _apply_to_store(g, vids, vecs, tombstone: bool, dim: int) -> int:
    """Apply one vector batch to a partition: attach-on-demand (replay
    onto a fresh world must not fail), write, bump the store version."""
    if tombstone:
        if getattr(g, "vstore", None) is None:
            return 0  # nothing attached, nothing to kill
        vs = g.vstore
    else:
        vs = attach_vstore(g, dim)
        if vs.dim != dim:
            raise WukongError(
                ErrorCode.UNSUPPORTED_SHAPE,
                f"vector batch dim {dim} != attached vector_dim {vs.dim}")
    n = vs.tombstone(vids) if tombstone else vs.upsert(vids, vecs)
    bump_store_version(g)
    return n


def upsert_batch_into(stores: list, vids, vecs=None, dedup: bool = True,
                      tombstone: bool = False) -> int:
    """One durable vector batch into every partition — the
    ``insert_batch_into`` twin. The ``vector.upsert`` fault site fires
    BEFORE the WAL append, so an injected failure leaves the WAL and
    every vstore untouched (the batch was never acknowledged); the WAL
    append fires before any store mutates, so an acknowledged batch is
    always replayable. The serving plane's invalidation edge lands INSIDE
    the mutation lock (the insert-batch contract); the observatory's
    outside it."""
    from wukong_tpu_torch.obs.reuse import maybe_note_invalidation
    from wukong_tpu_torch.runtime import faults
    from wukong_tpu_torch.serve import notify_mutation
    from wukong_tpu_torch.store.wal import maybe_wal_append, mutation_lock

    vids = np.asarray(vids, dtype=np.int64).ravel()
    if len(vids) and (int(vids.min()) < 0
                      or int(vids.max()) >= 2**31 - 1):
        raise WukongError(ErrorCode.UNKNOWN_PATTERN,
                          "vector vertex ids must be in [0, 2^31-1)")
    if tombstone:
        dim = (stores[0].vstore.dim if stores
               and getattr(stores[0], "vstore", None) is not None else 0)
        vecs_arr = None
    else:
        vecs_arr = np.asarray(vecs, dtype=np.float32)
        if vecs_arr.ndim != 2 or vecs_arr.shape[0] != len(vids):
            raise WukongError(
                ErrorCode.UNSUPPORTED_SHAPE,
                f"expected [{len(vids)}, dim] float32 vectors, got "
                f"{vecs_arr.shape}")
        dim = int(vecs_arr.shape[1])
    faults.site("vector.upsert")
    with mutation_lock():
        maybe_wal_append("vector", vids, dedup,
                         vecs=vecs_arr, tombstone=bool(tombstone),
                         dim=int(dim))
        total = 0
        for g in stores:
            total += _apply_to_store(g, vids, vecs_arr, tombstone, dim)
        if stores:
            notify_mutation("vector",
                            version=getattr(stores[0], "version", 0))
    if stores:
        maybe_note_invalidation(
            "vector", version=getattr(stores[0], "version", 0),
            n_vecs=int(len(vids)), tombstone=bool(tombstone))
    return total


def apply_vector_record(g, payload: dict) -> int:
    """Re-apply one WAL ``vector`` record to a partition (recovery
    replay, migration catch-up, shard rebuild). No WAL hook, no serving
    notification — the callers own both."""
    vids = np.asarray(payload["triples"], dtype=np.int64).ravel()
    tomb = bool(payload.get("tombstone"))
    vecs = payload.get("vecs")
    dim = int(payload.get("dim") or
              (vecs.shape[1] if vecs is not None else 0))
    return _apply_to_store(g, vids, vecs, tomb, dim)
