"""Owner-routed in-place execution for small-table distributed queries.

The port's copy of the JAX package's parallel/inplace.py. Reference
behavior matched here: light queries never pay fork-join — the
proxy routes a const-start query straight to the start vertex's owner server
(proxy.hpp:201-219) and the engine answers it in place, pulling remote
neighbor lists with one-sided RDMA reads whenever a step leaves the local
partition; only a step whose fetch outgrows `global_rdma_threshold` forks
(sparql.hpp:802-814 need_fork_join). That is why the reference answers
lights in microseconds *on a cluster*.

The single-controller analogue: every partition's CSR already lives
in the controller's host memory, so the "one-sided read" is a direct owner-routed
array access. `InplaceEngine` walks the whole chain host-side with per-row
owner routing and ZERO collectives; `DistEngine._try_inplace` enters it for
chains whose live table stays under `Global.dist_inplace_rows` and aborts
back to the capacity-padded collective path (the fork-join analogue) the
moment a table outgrows the bound. Correctness relies on the partitioning
invariant (store/gstore.py:5-17): vertex v's owner holds v's FULL OUT and
IN adjacency for every predicate, its full type/predicate lists, and its
attributes — so routing each row's lookup to `owner_of_subject(anchor)`
always finds complete data.
"""

from __future__ import annotations

import numpy as np

from wukong_tpu_torch.engine.cpu import CPUEngine
from wukong_tpu_torch.store.gstore import owner_of_subject
from wukong_tpu_torch.types import IN, OUT, PREDICATE_ID, TYPE_ID
from wukong_tpu_torch.utils.mathutil import hash_mod


class FederatedGraph:
    """GStore-lookup facade over all partitions: scalar lookups route to the
    vid's owner; index lists concatenate the shards' owner-local lists into
    the global list (each index member appears on exactly one shard)."""

    def __init__(self, stores: list):
        self.stores = stores
        self.D = len(stores)
        self._index_memo: dict = {}

    def get_triples(self, vid: int, pid: int, d: int) -> np.ndarray:
        return self.stores[hash_mod(int(vid), self.D)].get_triples(
            vid, pid, d)

    def get_index(self, tpid: int, d: int) -> np.ndarray:
        key = (int(tpid), int(d))
        got = self._index_memo.get(key)
        if got is None:
            parts = [np.asarray(st.get_index(tpid, d), dtype=np.int64)
                     for st in self.stores]
            got = (np.concatenate(parts) if parts
                   else np.empty(0, dtype=np.int64))
            self._index_memo[key] = got
        return got

    def get_attr(self, vid: int, aid: int, d: int = OUT):
        return self.stores[hash_mod(int(vid), self.D)].get_attr(vid, aid, d)


class InplaceOverflow(Exception):
    """Live table outgrew dist_inplace_rows — retreat to the collective path."""


class InplaceEngine(CPUEngine):
    """CPUEngine whose three vectorized graph accessors route each row to its
    anchor vertex's owner partition. Per-(pid, dir) shard segments share one
    virtual edge space (shard k's offsets shifted by the edge counts of
    shards < k), so `(start, local)` pairs produced by `_neighbors_many`
    decode back to the owning shard inside `_gather_edges` with no copies."""

    def __init__(self, stores: list, str_server=None):
        super().__init__(FederatedGraph(stores), str_server)
        self._stores = stores
        self._D = len(stores)
        self._shard_segs: dict = {}

    def _segs(self, pid: int, d: int):
        key = (int(pid), int(d))
        got = self._shard_segs.get(key)
        if got is None:
            segs = []
            for st in self._stores:
                if pid == PREDICATE_ID:
                    segs.append(st.vp.get(int(d)))
                else:
                    segs.append(st.segments.get((int(pid), int(d))))
            bases = np.zeros(self._D + 1, dtype=np.int64)
            for k, sg in enumerate(segs):
                bases[k + 1] = bases[k] + (len(sg.edges)
                                           if sg is not None else 0)
            got = (segs, bases)
            self._shard_segs[key] = got
        return got

    # -- vectorized accessors, owner-routed ----------------------------
    def _neighbors_many(self, cur: np.ndarray, pid: int, d: int):
        if pid == TYPE_ID and d == IN:
            # type membership reads the GLOBAL type index (facade concat)
            return super()._neighbors_many(cur, pid, d)
        segs, bases = self._segs(pid, d)
        cur = np.asarray(cur)
        start = np.zeros(len(cur), dtype=np.int64)
        deg = np.zeros(len(cur), dtype=np.int64)
        owners = owner_of_subject(cur, self._D)
        for k in np.unique(owners):  # only shards that own frontier rows
            m = owners == k
            if segs[k] is not None:
                s, dg = segs[k].lookup_many(cur[m])
                start[m] = s + bases[k]
                deg[m] = dg
        return start, deg

    def _gather_edges(self, pid: int, d: int, cur, start, local) -> np.ndarray:
        if pid == TYPE_ID and d == IN:
            return super()._gather_edges(pid, d, cur, start, local)
        segs, bases = self._segs(pid, d)
        pos = np.asarray(start, dtype=np.int64) + np.asarray(local,
                                                            dtype=np.int64)
        out = np.empty(len(pos), dtype=np.int64)
        ks = np.searchsorted(bases, pos, side="right") - 1
        for k in np.unique(ks):  # only shards whose edge ranges are hit
            m = ks == k
            out[m] = np.asarray(segs[k].edges,
                                dtype=np.int64)[pos[m] - bases[k]]
        return out

    def _contains_many(self, cur, pid: int, d: int, vals) -> np.ndarray:
        if pid == TYPE_ID and d == IN:
            return super()._contains_many(cur, pid, d, vals)
        segs, _bases = self._segs(pid, d)
        cur = np.asarray(cur)
        vals = np.asarray(vals)
        ok = np.zeros(len(cur), dtype=bool)
        owners = owner_of_subject(cur, self._D)
        for k in np.unique(owners):
            m = owners == k
            if segs[k] is not None:
                ok[m] = segs[k].contains_pair(cur[m], vals[m])
        return ok

    def _segment(self, pid: int, d: int):
        raise AssertionError(
            "InplaceEngine must never take the single-partition segment "
            "path — a new CPUEngine kernel bypassed the routed accessors")
