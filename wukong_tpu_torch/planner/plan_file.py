"""User-defined query plans (.fmt files) — planner-off mode.

Mirrors Planner::set_plan / set_direction (core/planner.hpp:1647-1755):
each line is "<pattern#> <dir>" (1-based pattern number in the parsed query);
dirs: '>' OUT as written, '<' IN (swap subject/object),
'<<' predicate-index start IN, '>>' predicate-index start OUT
(subject becomes the predicate id, predicate becomes __PREDICATE__).
A '<' on a type pattern starts from the type index (subject becomes the type
id const with predicate rdf:type). Lines may repeat a pattern (re-executed as
a filter step) and nested UNION/OPTIONAL blocks recurse.

The port's copy of the JAX package's planner/plan_file.py.
"""

from __future__ import annotations

import logging

from wukong_tpu_torch.sparql.ir import Pattern, PatternGroup
from wukong_tpu_torch.types import IN, OUT, PREDICATE_ID

_log = logging.getLogger(__name__)


def set_plan(group: PatternGroup, fmt_text: str, ptypes_pos: list | None = None) -> bool:
    """Apply a plan to a pattern group. Returns False on malformed input."""
    lines = iter(fmt_text.splitlines())
    return _set_plan_group(group, lines, ptypes_pos)


def _set_plan_group(group: PatternGroup, lines, ptypes_pos) -> bool:
    orders: list[int] = []
    dirs: list[str] = []
    nunions = noptionals = 0
    for raw in lines:
        line = raw.strip()
        if not line or line.startswith("#") or line == "{":
            continue
        if line == "}":
            break
        low = line.lower()
        if low.startswith("union"):
            if not _set_plan_group(group.unions[nunions], lines, None):
                return False
            nunions += 1
            continue
        if low.startswith("optional"):
            if not _set_plan_group(group.optional[noptionals], lines, None):
                return False
            noptionals += 1
            continue
        parts = line.split()
        try:
            orders.append(int(parts[0]))
        except (ValueError, IndexError):
            _log.error("bad plan line: %r", line)
            return False
        dirs.append(parts[1] if len(parts) > 1 else ">")

    if len(orders) < len(group.patterns):
        _log.error("wrong format file content (fewer plan lines than patterns)")
        return False
    bad = [o for o in orders if not (1 <= o <= len(group.patterns))]
    if bad:
        _log.error("plan pattern numbers out of range: %s (query has %d "
                   "patterns)", bad, len(group.patterns))
        return False
    _set_direction(group, orders, dirs, ptypes_pos)
    return True


def _set_direction(group: PatternGroup, orders, dirs, ptypes_pos) -> None:
    out = []
    # remap %placeholder slots to their new pattern positions (planner.hpp
    # set_ptypes_pos): a placeholder at original pattern k moves with it.
    pos_remap = {}
    for i, order in enumerate(orders):
        src = group.patterns[order - 1]
        p = Pattern(src.subject, src.predicate, src.direction, src.object,
                    src.pred_type)
        d = dirs[i]
        if d == "<":
            p.direction = IN
            p.subject, p.object = p.object, p.subject
        elif d == ">":
            p.direction = OUT
        elif d == "<<":
            p.direction = IN
            p.object = p.subject
            p.subject = p.predicate
            p.predicate = PREDICATE_ID
        elif d == ">>":
            # object keeps the original object var (the index's OUT side)
            p.direction = OUT
            p.subject = p.predicate
            p.predicate = PREDICATE_ID
        else:
            _log.warning("unknown plan direction %r, treating as '>'", d)
            p.direction = OUT
        if ptypes_pos is not None:
            for slot, (pi, fld) in enumerate(ptypes_pos):
                if pi == order - 1:
                    newfld = fld
                    if d == "<":
                        newfld = "subject" if fld == "object" else "object"
                    pos_remap[slot] = (len(out), newfld)
        out.append(p)
    group.patterns[:] = out
    if ptypes_pos is not None:
        for slot, np_ in pos_remap.items():
            ptypes_pos[slot] = np_
