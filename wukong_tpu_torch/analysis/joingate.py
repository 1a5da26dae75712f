"""join-strategy gate: execution-strategy AND level-route outcomes stay
closed sets.

The planner's ``choose_strategy`` (and any future strategy chooser) routes
every query to exactly one execution strategy; the device chooser
(``choose_join_route``/``classify_join_route``) picks each wcoj query's
level route. A typo'd or undeclared strategy/route string would silently
mis-route queries — the proxy would fall through to the walk (or the host
kernels) and the wcoj/device path would never fire, with no error
anywhere. This gate holds the invariants statically:

- ``join/__init__.py`` declares the literal
  ``JOIN_STRATEGIES`` registry;
- every string-literal ``return`` inside any function named
  ``choose_strategy``/``classify_join_strategy`` is a declared strategy;
- when any ROUTE chooser (``choose_join_route``/``classify_join_route``)
  exists, the literal ``JOIN_ROUTES`` registry must exist and every
  string-literal return must be a declared route;
- the ``join_strategy`` knob is documented in a README knob table, and —
  when routes are declared — so is the ``join_device`` knob (the
  config-readme gate checks the field docs; this one pins the
  operator-facing table rows).
"""

from __future__ import annotations

import ast

from wukong_tpu_torch.analysis.drift import _table_cells
from wukong_tpu_torch.analysis.framework import (
    AnalysisPlugin,
    RepoContext,
    Violation,
    register,
)

JOIN_MODULE = "join/__init__.py"
REGISTRY_NAME = "JOIN_STRATEGIES"
ROUTE_REGISTRY_NAME = "JOIN_ROUTES"
#: functions whose string-literal returns must be declared strategies
CHOOSER_NAMES = ("choose_strategy", "classify_join_strategy")
#: functions whose string-literal returns must be declared ROUTES
ROUTE_CHOOSER_NAMES = ("choose_join_route", "classify_join_route")


def _registry(ctx: RepoContext, name: str):
    """(members, lineno) from a literal registry assignment in the join
    module, or (None, 0) when absent."""
    if JOIN_MODULE not in ctx.paths():
        return None, 0
    sf = ctx.file(JOIN_MODULE)
    if sf.tree is None:
        return None, 0
    for st in sf.tree.body:
        tgt = st.targets[0] if isinstance(st, ast.Assign) else (
            st.target if isinstance(st, ast.AnnAssign) else None)
        if isinstance(tgt, ast.Name) and tgt.id == name:
            names = set()
            for n in ast.walk(st):
                if isinstance(n, ast.Constant) and isinstance(n.value, str):
                    names.add(n.value)
            return names, st.lineno
    return None, 0


@register
class JoinStrategyGate(AnalysisPlugin):
    name = "join-strategy"
    description = ("strategy/route chooser outcomes are declared "
                   "JOIN_STRATEGIES/JOIN_ROUTES members and the "
                   "join_strategy/join_device knob rows exist in README")

    def run(self, ctx: RepoContext) -> list[Violation]:
        if JOIN_MODULE not in ctx.paths():
            return []  # tree without a join subsystem: nothing to check
        declared, reg_line = self._declared(ctx)
        if declared is None:
            return [Violation(self.name, JOIN_MODULE, 1,
                              f"no literal {REGISTRY_NAME} registry found — "
                              "declare every execution strategy centrally")]
        routes, route_line = _registry(ctx, ROUTE_REGISTRY_NAME)
        out: list[Violation] = []
        for sf in ctx.iter_files():
            if sf.tree is None:
                continue
            for node in ast.walk(sf.tree):
                if not (isinstance(node, ast.FunctionDef)
                        and node.name in CHOOSER_NAMES
                        + ROUTE_CHOOSER_NAMES):
                    continue
                is_route = node.name in ROUTE_CHOOSER_NAMES
                if is_route:
                    if routes is None:
                        out.append(Violation(
                            self.name, sf.rel, node.lineno,
                            f"{node.name}() exists but {JOIN_MODULE} "
                            f"declares no literal {ROUTE_REGISTRY_NAME} "
                            "registry — declare every level route "
                            "centrally"))
                        continue
                members = routes if is_route else declared
                reg = ROUTE_REGISTRY_NAME if is_route else REGISTRY_NAME
                for ret in ast.walk(node):
                    if not isinstance(ret, ast.Return):
                        continue
                    val = ret.value
                    if (isinstance(val, ast.Constant)
                            and isinstance(val.value, str)
                            and val.value not in members):
                        out.append(Violation(
                            self.name, sf.rel, ret.lineno,
                            f"{node.name}() returns {val.value!r} which is "
                            f"not declared in {JOIN_MODULE}::{reg}"))
        readme = ctx.readme_text()
        if readme is not None:
            knob_rows = {part.strip().strip("`")
                         for tok, _ln in _table_cells(readme, "knob")
                         for part in tok.split("/")}
            if "join_strategy" not in knob_rows:
                out.append(Violation(
                    self.name, "", reg_line,
                    "README has no knob-table row for `join_strategy` — "
                    "the strategy knob must be operator-documented"))
            if routes is not None and "join_device" not in knob_rows:
                out.append(Violation(
                    self.name, "", route_line,
                    "README has no knob-table row for `join_device` — "
                    "the level-route knob must be operator-documented"))
        return out

    def _declared(self, ctx: RepoContext):
        return _registry(ctx, REGISTRY_NAME)
