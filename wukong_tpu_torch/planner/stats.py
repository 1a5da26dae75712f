"""Type-centric statistics for the cost-based optimizer.

Mirrors the reference's Stats (core/stats.hpp): per-type entity counts
(`tyscount`), predicate -> subject-type / object-type histograms
(`pstype`/`potype`), and the fine-grained (type, pred, dir) -> neighbor-type
histogram (`fine_type`) — stats.hpp:658-869 walks gstore buckets; here the
whole computation is vectorized over the triple array.

Vertices with multiple types or no type get *complex types* synthesized from
their type-set / predicate-set composition (stats.hpp:46-75 type_t,
get_simple_type 642-655): complex ids are negative to stay clear of real type
ids, and `members_of` exposes the base types a complex type contains (so a
type filter can keep matching complex types).

Persisted to a stat file like the reference's `<input>/statfile`
(stats.hpp:585-640) — ours is an npz bundle.

The port's copy of the JAX package's planner/stats.py: the same statistics
from the same triples, and the same npz layout, so a stat file either package
writes loads in the other.
"""

from __future__ import annotations

import json
from collections import defaultdict

import numpy as np

from wukong_tpu_torch.types import IN, NORMAL_ID_START, OUT, TYPE_ID


class Stats:
    def __init__(self):
        self.tyscount: dict[int, int] = {}  # type id -> #entities
        self.pstype: dict[int, dict[int, int]] = {}  # pid -> {stype: count}
        self.potype: dict[int, dict[int, int]] = {}  # pid -> {otype: count}
        # (type, pid, dir) -> {neighbor_type: edge count}
        self.fine_type: dict[tuple, dict[int, int]] = {}
        self.pred_edges: dict[int, int] = {}  # pid -> total triples
        self.distinct_subj: dict[int, int] = {}  # pid -> #distinct subjects
        self.distinct_obj: dict[int, int] = {}  # pid -> #distinct objects
        # complex type composition: complex id (<0) -> frozenset(base type ids)
        self.complex_members: dict[int, frozenset] = {}
        self.vtype: np.ndarray | None = None  # entity -> (simple|complex) type
        self.vtype_ids: np.ndarray | None = None  # sorted entity ids for vtype

    # ------------------------------------------------------------------
    def type_of(self, vid: int) -> int:
        i = np.searchsorted(self.vtype_ids, vid)
        if i < len(self.vtype_ids) and self.vtype_ids[i] == vid:
            return int(self.vtype[i])
        return 0

    def types_containing(self, base_type: int) -> list[int]:
        """All (simple + complex) type ids whose members include base_type."""
        out = [base_type] if base_type in self.tyscount else []
        for cid, members in self.complex_members.items():
            if base_type in members:
                out.append(cid)
        return out

    def count_containing(self, base_type: int) -> int:
        return sum(self.tyscount.get(t, 0) for t in self.types_containing(base_type))

    # ------------------------------------------------------------------
    @staticmethod
    def generate(triples: np.ndarray) -> "Stats":
        """Build statistics from the full [M,3] id-triple array."""
        st = Stats()
        s, p, o = triples[:, 0], triples[:, 1], triples[:, 2]
        is_type = p == TYPE_ID

        # ---- per-vertex simple/complex type ------------------------------
        ts, to = s[is_type], o[is_type]
        order = np.argsort(ts, kind="stable")
        ts, to = ts[order], to[order]
        uniq_v, starts = np.unique(ts, return_index=True)
        bounds = np.append(starts, len(ts))
        complex_ids: dict[frozenset, int] = {}
        next_complex = -1
        simple_counts: dict[int, int] = defaultdict(int)
        if len(uniq_v) == len(ts):
            # every vertex single-typed (all LUBM-shaped data): the
            # per-vertex frozenset loop is O(V) Python objects — at
            # LUBM-10240 (220 M typed vertices) it OOM-killed the host;
            # the vectorized equivalent is two array ops
            typed_types = to[starts].astype(np.int64)
            for t, c in zip(*np.unique(typed_types, return_counts=True)):
                simple_counts[int(t)] += int(c)
        else:
            vtypes: list[int] = []
            for i, v in enumerate(uniq_v):
                tset = frozenset(int(x) for x in to[bounds[i]:bounds[i + 1]])
                if len(tset) == 1:
                    t = next(iter(tset))
                else:
                    if tset not in complex_ids:
                        complex_ids[tset] = next_complex
                        next_complex -= 1
                    t = complex_ids[tset]
                vtypes.append(t)
                simple_counts[t] += 1
            typed_types = np.asarray(vtypes, dtype=np.int64)
        # untyped vertices: complex type from their out-predicate set
        all_vs = np.unique(np.concatenate(
            [s, o[o >= NORMAL_ID_START]]))
        untyped = np.setdiff1d(all_vs, uniq_v)
        untyped_types = np.empty(0, dtype=np.int64)
        if len(untyped):
            norm = ~is_type
            so_, po_ = s[norm], p[norm]
            # untyped subjects actually carrying out-edges (in LUBM-shaped
            # data the untyped set is literal pools with NO out-edges, so
            # this mask is empty and the whole branch is one shared class).
            # ONE membership pass serves both the branch decision and the
            # vectorized path below — each isin sorts the full edge list
            keep = np.isin(so_, untyped)
            n_out_subj = len(np.unique(so_[keep])) if keep.any() else 0
            if n_out_subj > 200_000:
                # vectorized signature path: group by out-predicate SET
                # via a commutative 64-bit mix over unique (s, p) pairs —
                # the per-vertex frozenset loop at this cardinality is
                # Python-object OOM territory
                from wukong_tpu_torch.utils.mathutil import hash_u64

                # pack (s, p) into one int64: pred ids < 2^17 (NORMAL_ID_
                # START) by construction, subject ids < 2^31 -> 48 bits
                code = np.unique((so_[keep].astype(np.int64) << 17)
                                 | po_[keep].astype(np.int64))
                cs_, cp_ = code >> 17, code & ((1 << 17) - 1)
                upids = np.unique(cp_)
                hmap = np.asarray([hash_u64(int(x)) for x in upids],
                                  dtype=np.uint64)
                mixed = hmap[np.searchsorted(upids, cp_)]
                uv2, ustarts2 = np.unique(cs_, return_index=True)
                sig = np.add.reduceat(mixed, ustarts2)  # commutative mix
                sgu, sinv = np.unique(sig, return_inverse=True)
                sig_cids = np.arange(next_complex,
                                     next_complex - len(sgu), -1,
                                     dtype=np.int64)
                for k in range(len(sgu)):
                    # representative member set is informational only —
                    # the loop path also strips ("p", x) tuples to {}
                    complex_ids[frozenset({("sig", int(sgu[k]))})] = \
                        int(sig_cids[k])
                next_complex -= len(sgu)
                cid_by_subject = sig_cids[sinv]  # aligned with uv2
                pos2 = np.searchsorted(uv2, untyped)
                pos2c = np.clip(pos2, 0, max(len(uv2) - 1, 0))
                found2 = ((pos2 < len(uv2)) & (len(uv2) > 0)
                          & (uv2[pos2c] == untyped))
                empty_cid = 0
                if not found2.all():
                    # no-out-edge literals: one shared class, minted only
                    # when such vertices exist (the loop path allocates on
                    # first use; a phantom zero-member class would leak
                    # into complex_members/statfiles)
                    key = frozenset()
                    if key not in complex_ids:
                        complex_ids[key] = next_complex
                        next_complex -= 1
                    empty_cid = complex_ids[key]
                untyped_types = np.where(
                    found2, cid_by_subject[pos2c] if len(uv2) else 0,
                    empty_cid).astype(np.int64)
                for t, c in zip(*np.unique(untyped_types,
                                           return_counts=True)):
                    simple_counts[int(t)] += int(c)
            elif n_out_subj == 0:
                # all-literal untyped set: one shared empty-pset class
                key = frozenset()
                if key not in complex_ids:
                    complex_ids[key] = next_complex
                    next_complex -= 1
                untyped_types = np.full(len(untyped), complex_ids[key],
                                        dtype=np.int64)
                simple_counts[complex_ids[key]] += len(untyped)
            else:
                order2 = np.argsort(so_, kind="stable")
                so2, po2 = so_[order2], po_[order2]
                uv, ustarts = np.unique(so2, return_index=True)
                ubounds = np.append(ustarts, len(so2))
                pos = np.searchsorted(uv, untyped)
                uvt: list[int] = []
                for v, j in zip(untyped, pos):
                    if j < len(uv) and uv[j] == v:
                        pset = frozenset(
                            int(x) for x in po2[ubounds[j]:ubounds[j + 1]])
                    else:
                        pset = frozenset()
                    key = frozenset({("p", x) for x in pset})
                    if key not in complex_ids:
                        complex_ids[key] = next_complex
                        next_complex -= 1
                    uvt.append(complex_ids[key])
                    simple_counts[complex_ids[key]] += 1
                untyped_types = np.asarray(uvt, dtype=np.int64)
        st.vtype_ids = np.concatenate([uniq_v, untyped]).astype(np.int64)
        st.vtype = np.concatenate([typed_types, untyped_types])
        order3 = np.argsort(st.vtype_ids)
        st.vtype_ids = st.vtype_ids[order3]
        st.vtype = st.vtype[order3]
        st.tyscount = dict(simple_counts)
        st.complex_members = {
            cid: frozenset(x for x in key if not isinstance(x, tuple))
            for key, cid in complex_ids.items()}

        # ---- predicate histograms ----------------------------------------
        norm = ~is_type
        sn, pn, on = s[norm], p[norm], o[norm]
        stype = st._lookup_types(sn)
        otype = st._lookup_types(on)
        for pid in np.unique(pn):
            m = pn == pid
            st.pred_edges[int(pid)] = int(m.sum())
            st.distinct_subj[int(pid)] = int(len(np.unique(sn[m])))
            st.distinct_obj[int(pid)] = int(len(np.unique(on[m])))
            st.pstype[int(pid)] = _hist(stype[m])
            st.potype[int(pid)] = _hist(otype[m])
            for t, c in _hist_pairs(stype[m], otype[m]).items():
                st.fine_type.setdefault((t[0], int(pid), OUT), {})
                st.fine_type[(t[0], int(pid), OUT)][t[1]] = \
                    st.fine_type[(t[0], int(pid), OUT)].get(t[1], 0) + c
                st.fine_type.setdefault((t[1], int(pid), IN), {})
                st.fine_type[(t[1], int(pid), IN)][t[0]] = \
                    st.fine_type[(t[1], int(pid), IN)].get(t[0], 0) + c
        # rdf:type participates as a predicate too (k2c type filters)
        st.pred_edges[int(TYPE_ID)] = int(is_type.sum())
        st.pstype[int(TYPE_ID)] = _hist(st._lookup_types(s[is_type]))
        return st

    def _lookup_types(self, vids: np.ndarray) -> np.ndarray:
        idx = np.searchsorted(self.vtype_ids, vids)
        idx = np.clip(idx, 0, max(len(self.vtype_ids) - 1, 0))
        found = self.vtype_ids[idx] == vids
        return np.where(found, self.vtype[idx], 0)

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        meta = {
            "tyscount": {str(k): v for k, v in self.tyscount.items()},
            "pstype": {str(k): {str(a): b for a, b in v.items()}
                       for k, v in self.pstype.items()},
            "potype": {str(k): {str(a): b for a, b in v.items()}
                       for k, v in self.potype.items()},
            "fine_type": [[list(k), {str(a): b for a, b in v.items()}]
                          for k, v in self.fine_type.items()],
            "pred_edges": {str(k): v for k, v in self.pred_edges.items()},
            "distinct_subj": {str(k): v for k, v in self.distinct_subj.items()},
            "distinct_obj": {str(k): v for k, v in self.distinct_obj.items()},
            "complex_members": {str(k): sorted(v) for k, v in
                                self.complex_members.items()},
        }
        np.savez(path, _meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
                 vtype=self.vtype, vtype_ids=self.vtype_ids)

    @staticmethod
    def load(path: str) -> "Stats":
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        meta = json.loads(bytes(z["_meta"]).decode())
        st = Stats()
        st.tyscount = {int(k): v for k, v in meta["tyscount"].items()}
        st.pstype = {int(k): {int(a): b for a, b in v.items()}
                     for k, v in meta["pstype"].items()}
        st.potype = {int(k): {int(a): b for a, b in v.items()}
                     for k, v in meta["potype"].items()}
        st.fine_type = {tuple(k): {int(a): b for a, b in v.items()}
                        for k, v in meta["fine_type"]}
        st.pred_edges = {int(k): v for k, v in meta["pred_edges"].items()}
        st.distinct_subj = {int(k): v for k, v in
                            meta.get("distinct_subj", {}).items()}
        st.distinct_obj = {int(k): v for k, v in
                           meta.get("distinct_obj", {}).items()}
        st.complex_members = {int(k): frozenset(v) for k, v in
                              meta["complex_members"].items()}
        st.vtype = z["vtype"]
        st.vtype_ids = z["vtype_ids"]
        return st


def _hist(arr: np.ndarray) -> dict[int, int]:
    u, c = np.unique(arr, return_counts=True)
    return {int(a): int(b) for a, b in zip(u, c)}


def _hist_pairs(a: np.ndarray, b: np.ndarray) -> dict[tuple, int]:
    if len(a) == 0:
        return {}
    order = np.lexsort((b, a))
    aa, bb = a[order], b[order]
    new = np.ones(len(aa), dtype=bool)
    new[1:] = (aa[1:] != aa[:-1]) | (bb[1:] != bb[:-1])
    starts = np.flatnonzero(new)
    counts = np.diff(np.append(starts, len(aa)))
    return {(int(aa[i]), int(bb[i])): int(c) for i, c in zip(starts, counts)}
