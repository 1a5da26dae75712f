"""Partitioned in-memory RDF graph store over CSR segments (host side).

The port's copy of the JAX package's store/gstore.py on its numpy path (the
C++ host library is not ported): the same triples give the same partition,
segment for segment. Semantics, as in the reference (core/store/gstore.hpp):

- Partitioning: triple (s, p, o) lives on worker hash(s)%n as an OUT edge and on
  worker hash(o)%n as an IN edge (base_loader.hpp:172-173).
- Type triples (p == TYPE_ID) have index-id objects; they produce the per-vertex
  type list (v, TYPE_ID, OUT) and the subject-side *type index* tidx[t] ->
  members. No (·, TYPE_ID, IN) normal segment exists.
- Predicate indexes: pidx_in[p] = local subjects having p (from OUT keys),
  pidx_out[p] = local objects under p (from IN keys).
- VERSATILE: per-vertex predicate lists (v, PREDICATE_ID, OUT/IN) plus the
  v/t/p sets (all local entities / types / predicates).
- Attributes: per-attribute sorted (subject -> typed value) maps.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from wukong_tpu_torch.store.segment import CSRSegment
from wukong_tpu_torch.types import IN, NORMAL_ID_START, OUT, PREDICATE_ID, TYPE_ID
from wukong_tpu_torch.utils.errors import ErrorCode, WukongError
from wukong_tpu_torch.utils.mathutil import hash_mod


@dataclass
class AttrSegment:
    keys: np.ndarray  # sorted subject ids
    values: np.ndarray  # typed values (int64 or float64)
    type: int  # AttrType tag

    def lookup(self, vid: int):
        i = np.searchsorted(self.keys, vid)
        if i < len(self.keys) and self.keys[i] == vid:
            return self.values[i], True
        return None, False


@dataclass
class GStore:
    """One worker's partition of the graph."""

    sid: int
    num_workers: int
    # normal segments: (pid, dir) -> CSR; includes (TYPE_ID, OUT) = per-vertex types
    segments: dict = field(default_factory=dict)
    # index lists: (tpid, dir) -> sorted vid array
    #   (pid, IN) = local subjects having pid; (pid, OUT) = local objects under pid
    #   (tid, IN) = local members of type tid
    index: dict = field(default_factory=dict)
    # VERSATILE per-vertex predicate lists: dir -> CSR (key = vid, edges = pids)
    vp: dict = field(default_factory=dict)
    # VERSATILE singleton sets
    v_set: np.ndarray = field(default_factory=lambda: np.empty(0, dtype=np.int64))
    t_set: np.ndarray = field(default_factory=lambda: np.empty(0, dtype=np.int64))
    p_set: np.ndarray = field(default_factory=lambda: np.empty(0, dtype=np.int64))
    # attribute segments: aid -> AttrSegment
    attrs: dict = field(default_factory=dict)
    # which index ids are type ids (objects of rdf:type) vs predicates
    type_ids: set = field(default_factory=set)

    # ---- lookup API (mirrors core/dgraph.hpp:106-145) --------------------
    def get_triples(self, vid: int, pid: int, d: int) -> np.ndarray:
        """Neighbor list of a *local* vertex under a predicate (PREDICATE_ID
        gives the VERSATILE per-vertex predicate list)."""
        if pid == PREDICATE_ID:
            seg = self.vp.get(int(d))
            return seg.lookup(vid) if seg is not None else np.empty(0, dtype=np.int64)
        seg = self.segments.get((int(pid), int(d)))
        return seg.lookup(vid) if seg is not None else np.empty(0, dtype=np.int64)

    def get_index(self, tpid: int, d: int) -> np.ndarray:
        """Index lookup: members of a type (d=IN) or subjects/objects of a predicate."""
        if tpid == TYPE_ID and int(d) == IN:
            return self.v_set  # all local entities (VERSATILE v_set)
        if tpid == TYPE_ID and int(d) == OUT:
            return self.t_set
        if tpid == PREDICATE_ID and int(d) == OUT:
            return self.p_set
        return self.index.get((int(tpid), int(d)), np.empty(0, dtype=np.int64))

    def get_attr(self, vid: int, aid: int, d: int = OUT):
        seg = self.attrs.get(int(aid))
        if seg is None:
            return None, False
        return seg.lookup(vid)

    def memory_bytes(self) -> int:
        n = sum(s.memory_bytes() for s in self.segments.values())
        n += sum(a.nbytes for a in (self.v_set, self.t_set, self.p_set))
        n += sum(s.memory_bytes() for s in self.vp.values())
        n += sum(v.nbytes for v in self.index.values())
        n += sum(a.keys.nbytes + a.values.nbytes for a in self.attrs.values())
        return n


def owner_of_subject(s: np.ndarray, n: int) -> np.ndarray:
    """The partition owning each vertex id: hash(vid) % n."""
    return hash_mod(s, n)


def check_vid_range(triples: np.ndarray) -> None:
    """Device staging narrows ids to int32 and INT32_MAX is the device-side
    padding sentinel, so ids must lie in [0, 2^31 - 1)."""
    if len(triples) and int(triples.max()) >= 2**31 - 1:
        raise WukongError(
            ErrorCode.UNKNOWN_PATTERN,
            f"vertex id {int(triples.max())} >= 2^31 - 1: ids no longer fit "
            "the int32 device representation (see types.py)")
    if len(triples) and int(triples.min()) < 0:
        raise WukongError(ErrorCode.UNKNOWN_PATTERN,
                          f"vertex id {int(triples.min())} < 0")


def _triple_argsort(primary, secondary, tertiary) -> np.ndarray:
    """argsort by (primary, secondary, tertiary) — native radix when available
    (the loader's sorted-run preparation, base_loader.hpp sorts)."""
    from wukong_tpu_torch.native import sort_triples_perm

    perm = sort_triples_perm(primary, secondary, tertiary)
    if perm is not None:
        return perm
    return np.lexsort((tertiary, secondary, primary))


def _pred_runs(p_sorted: np.ndarray, k_sorted: np.ndarray, v_sorted: np.ndarray):
    """Yield (pid, keys, values) slices per predicate run of presorted arrays."""
    if len(p_sorted) == 0:
        return
    upids, starts = np.unique(p_sorted, return_index=True)
    bounds = np.append(starts, len(p_sorted))
    for i, pid in enumerate(upids):
        sl = slice(bounds[i], bounds[i + 1])
        yield int(pid), k_sorted[sl], v_sorted[sl]


def build_partition(triples: np.ndarray, sid: int, num_workers: int,
                    attr_triples=None, versatile: bool = True,
                    check_ids: bool = True) -> GStore:
    """Build worker `sid`'s GStore from the full [M,3] triple array, one
    direction at a time (slice -> sort -> segments -> free) to bound peak
    host memory. ``attr_triples`` is the column tuple (subjects, attribute
    ids, value-type tags, values) that ``loader.lubm.generate_lubm_attrs``
    returns."""
    g = GStore(sid=sid, num_workers=num_workers)
    if check_ids:
        check_vid_range(triples)
    s, p, o = triples[:, 0], triples[:, 1], triples[:, 2]

    # pso order: (p, s, o) — each predicate run becomes one OUT segment
    mine_out = hash_mod(s, num_workers) == sid
    so, po, oo = s[mine_out], p[mine_out], o[mine_out]
    del mine_out
    order = _triple_argsort(po, so, oo)
    so, po, oo = so[order], po[order], oo[order]
    del order
    for pid, ks, vs in _pred_runs(po, so, oo):
        g.segments[(pid, OUT)] = CSRSegment.from_sorted_pairs(ks, vs)
        if pid != TYPE_ID:
            g.index[(pid, IN)] = g.segments[(pid, OUT)].keys.copy()
    if versatile:  # subject-side versatile pieces, before freeing the copies
        vp_out = CSRSegment.from_pairs(so, po)  # includes TYPE_ID edges
        v_sub = np.unique(so)
        p_out = np.unique(po[po != TYPE_ID])
    del so, po, oo

    # pos order: (p, o, s) — each predicate run becomes one IN segment; the
    # object side never stores type triples as normal edges
    mine_in = (hash_mod(o, num_workers) == sid) & (o >= NORMAL_ID_START)
    si, pi, oi = s[mine_in], p[mine_in], o[mine_in]
    del mine_in
    order = _triple_argsort(pi, oi, si)
    si, pi, oi = si[order], pi[order], oi[order]
    del order
    for pid, ks, vs in _pred_runs(pi, oi, si):
        g.segments[(pid, IN)] = CSRSegment.from_sorted_pairs(ks, vs)
        g.index[(pid, OUT)] = g.segments[(pid, IN)].keys.copy()

    # type index: t -> local members (subject-side)
    tseg = g.segments.get((TYPE_ID, OUT))
    if tseg is not None:
        ts = np.repeat(tseg.keys, np.diff(tseg.offsets))
        to = tseg.edges
        order = np.argsort(to, kind="stable")
        ts, to = ts[order], to[order]
        for t, ks, _vs in _pred_runs(to, ts, ts):
            g.index[(t, IN)] = np.unique(ks)
            g.type_ids.add(t)

    if versatile:
        g.vp[OUT] = vp_out
        g.vp[IN] = CSRSegment.from_pairs(oi, pi)
        g.v_set = np.union1d(v_sub, oi)
        g.t_set = (np.unique(tseg.edges) if tseg is not None
                   else np.empty(0, dtype=np.int64))
        g.p_set = np.union1d(p_out, pi)
    if attr_triples is not None:
        _build_attrs(g, attr_triples)
    return g


def build_all_partitions(triples: np.ndarray, num_workers: int,
                         attr_triples=None, versatile: bool = True
                         ) -> list[GStore]:
    """Every worker's partition of one triple array (the id range checked
    once, not per partition), built on host threads (one a partition, at
    most one a CPU). The slicing, sorting and CSR building are numpy and
    native/ calls that release the GIL, so the partitions' builds overlap;
    each is what build_partition alone builds."""
    from concurrent.futures import ThreadPoolExecutor

    check_vid_range(triples)

    def one(i: int) -> GStore:
        return build_partition(triples, i, num_workers, attr_triples,
                               versatile, check_ids=False)

    n = min(num_workers, os.cpu_count() or 1)
    if n <= 1:
        return [one(i) for i in range(num_workers)]
    with ThreadPoolExecutor(max_workers=n) as ex:
        return list(ex.map(one, range(num_workers)))


def _build_attrs(g: GStore, attr_triples) -> None:
    """One AttrSegment per attribute id over this worker's subjects, rows
    ordered by (subject, type, value) and typed by the first row's tag."""
    s, aid, at, av = (np.asarray(c) for c in attr_triples)
    mine = hash_mod(s, g.num_workers) == g.sid
    s, aid, at, av = s[mine], aid[mine], at[mine], av[mine]
    order = np.lexsort((av, at, s, aid))
    s, aid, at, av = s[order], aid[order], at[order], av[order]
    for a, ks, sl in _pred_runs(aid, s, np.arange(len(s))):
        t = int(at[sl[0]])
        dtype = np.float64 if t in (2, 3) else np.int64
        g.attrs[a] = AttrSegment(keys=ks.astype(np.int64),
                                 values=av[sl].astype(dtype), type=t)


def gstore_from_numpy(segments: dict, index: dict, type_ids=None,
                      v_set=None, t_set=None, p_set=None,
                      sid: int = 0, num_workers: int = 1) -> GStore:
    """Carry a partition built elsewhere into the port's GStore.

    ``segments`` maps (pid, dir) -> (keys, offsets, edges) and ``index``
    maps (tpid, dir) -> sorted vid array, all plain numpy (the JAX package's
    GStore fields converted). ``type_ids`` defaults to the distinct objects
    of the (TYPE_ID, OUT) segment. The VERSATILE per-vertex predicate lists
    and the attributes are not carried, so a host-engine versatile or
    attribute step over such a store sees no edges; the device's combined
    adjacency is built from the segments and needs neither.
    """
    g = GStore(sid=sid, num_workers=num_workers)
    for (pid, d), (keys, offsets, edges) in segments.items():
        g.segments[(int(pid), int(d))] = CSRSegment(
            keys=np.asarray(keys, dtype=np.int64),
            offsets=np.asarray(offsets, dtype=np.int64),
            edges=np.asarray(edges, dtype=np.int64))
    for (tpid, d), arr in index.items():
        g.index[(int(tpid), int(d))] = np.asarray(arr, dtype=np.int64)
    if type_ids is None:
        tseg = g.segments.get((TYPE_ID, OUT))
        type_ids = () if tseg is None else np.unique(tseg.edges).tolist()
    g.type_ids = {int(t) for t in type_ids}
    for name, arr in (("v_set", v_set), ("t_set", t_set), ("p_set", p_set)):
        if arr is not None:
            setattr(g, name, np.asarray(arr, dtype=np.int64))
    return g
