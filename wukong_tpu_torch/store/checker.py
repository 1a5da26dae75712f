"""Store consistency checker — the ``gsck`` console command.

Mirrors GChecker (core/store/gchecker.hpp:28-90 ff.): cross-validates index
lists against normal segments in both directions on each partition. The
reference runs this as its de-facto integration test after loading.

The port's copy of the JAX package's store/checker.py, with the same
violation messages.
"""

from __future__ import annotations

import numpy as np

from wukong_tpu_torch.store.gstore import GStore
from wukong_tpu_torch.types import IN, NORMAL_ID_START, OUT, TYPE_ID
from wukong_tpu_torch.utils.mathutil import hash_mod


def check_partition(g: GStore, index_check: bool = True,
                    normal_check: bool = True) -> list[str]:
    """Returns a list of violation descriptions (empty = consistent)."""
    errors: list[str] = []

    if index_check:
        # every member of the type index has that type in its OUT type list
        tseg = g.segments.get((TYPE_ID, OUT))
        for (tpid, d), members in g.index.items():
            if d == IN and tpid in g.type_ids:
                # type index
                if tseg is None:
                    errors.append(f"type index {tpid} but no (TYPE_ID, OUT) segment")
                    continue
                ok = tseg.contains_pair(members, np.full(len(members), tpid))
                for v in members[~ok]:
                    errors.append(f"tidx[{tpid}] member {v} lacks type edge")
            elif d == IN:
                # predicate index IN: subject must have a (pid, OUT) edge list
                seg = g.segments.get((int(tpid), OUT))
                if seg is None:
                    errors.append(f"pidx_in[{tpid}] but no (pid, OUT) segment")
                    continue
                _, deg = seg.lookup_many(members)
                for v in members[deg == 0]:
                    errors.append(f"pidx_in[{tpid}] subject {v} has no OUT edges")
            elif d == OUT:
                seg = g.segments.get((int(tpid), IN))
                if seg is None:
                    errors.append(f"pidx_out[{tpid}] but no (pid, IN) segment")
                    continue
                _, deg = seg.lookup_many(members)
                for v in members[deg == 0]:
                    errors.append(f"pidx_out[{tpid}] object {v} has no IN edges")

    if normal_check:
        # every OUT key appears in pidx_in / every type edge in tidx
        for (pid, d), seg in g.segments.items():
            if d == OUT and pid == TYPE_ID:
                for t in np.unique(seg.edges):
                    tlist = g.index.get((int(t), IN))
                    if tlist is None:
                        errors.append(f"type {t} present in edges but no tidx")
                        continue
                    # all subjects with this type must be in tidx[t]
                    has_t = seg.contains_pair(seg.keys, np.full(len(seg.keys), t))
                    missing = np.setdiff1d(seg.keys[has_t], tlist)
                    for v in missing:
                        errors.append(f"vertex {v} of type {t} missing from tidx")
            elif d == OUT:
                plist = g.index.get((int(pid), IN))
                if plist is None:
                    errors.append(f"segment ({pid}, OUT) but no pidx_in")
                    continue
                missing = np.setdiff1d(seg.keys, plist)
                for v in missing:
                    errors.append(f"subject {v} of pred {pid} missing from pidx_in")
            elif d == IN:
                plist = g.index.get((int(pid), OUT))
                if plist is None:
                    errors.append(f"segment ({pid}, IN) but no pidx_out")
                    continue
                missing = np.setdiff1d(seg.keys, plist)
                for v in missing:
                    errors.append(f"object {v} of pred {pid} missing from pidx_out")

    return errors


def check_cross_partition(stores: list[GStore]) -> list[str]:
    """Every OUT edge (s,p,o) must have the IN copy (o,p,s) on o's owner."""
    errors: list[str] = []
    n = len(stores)
    for g in stores:
        for (pid, d), seg in g.segments.items():
            if d != OUT or pid == TYPE_ID:
                continue
            s = np.repeat(seg.keys, np.diff(seg.offsets))
            o = seg.edges
            norm = o >= NORMAL_ID_START
            s, o = s[norm], o[norm]
            owners = hash_mod(o, n)
            for dst in range(n):
                m = owners == dst
                if not m.any():
                    continue
                rseg = stores[dst].segments.get((pid, IN))
                if rseg is None:
                    errors.append(f"worker {dst} missing segment ({pid}, IN)")
                    continue
                ok = rseg.contains_pair(o[m], s[m])
                for ss, oo in zip(s[m][~ok], o[m][~ok]):
                    errors.append(
                        f"edge ({ss},{pid},{oo}) OUT@{g.sid} lacks IN copy @{dst}")
    return errors
