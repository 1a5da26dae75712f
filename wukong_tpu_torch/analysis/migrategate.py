"""migration-safety gate: the shard-migration actuator stays crash-honest.

The port's copy of the JAX package's analysis/migrategate.py. A migration
that can crash mid-clone or mid-cutover is only as safe as the invariants
this gate holds mechanically true, over runtime/migration.py and the
sharded store's cutover surface:

- ``MIGRATION_PHASES`` (a literal tuple in ``runtime/migration.py``) must
  exist — the state machine's order is a registry, not an implementation
  detail — and every phase transition must journal: for each of
  ``start`` / ``catchup`` / ``cutover`` / ``retire`` / ``abort`` the
  literal ``shard.migrate.<kind>`` must be emitted (``emit_event``) in
  the module, so a crash always leaves a journal to roll forward from.
- every shard-cutover path (any function whose name contains
  ``cutover`` in ``runtime/migration.py`` / ``parallel/sharded_store.py``)
  must either take the migration lock in a ``with`` scope or be annotated
  ``# guarded by:`` / ``# caller holds:`` naming it — the read-path swap
  is the one step that must never run unguarded.
- every ``make_lock("migration.*")`` those modules create must be
  declared a lockdep leaf in the same module (the new locks guard plain
  list/dict publications; anything acquired under them is an inversion
  lockdep must see declared).
"""

from __future__ import annotations

import ast

from wukong_tpu_torch.analysis.framework import (
    AnalysisPlugin,
    RepoContext,
    Violation,
    register,
)
from wukong_tpu_torch.analysis.telemetry import _str_const
from wukong_tpu_torch.analysis.placegate import _literal_tuple

MIGRATION_MODULE = "runtime/migration.py"
CUTOVER_MODULES = ("runtime/migration.py", "parallel/sharded_store.py")
PHASES_REGISTRY_NAME = "MIGRATION_PHASES"
#: every phase transition the actuator must journal (crash forensics +
#: the /events -K shard.migrate timeline)
REQUIRED_EVENTS = ("start", "catchup", "cutover", "retire", "abort")


def _mentions_migration(node) -> bool:
    """Does an expression reference a name/attribute containing
    'migration' (e.g. ``self._migration_lock``)?"""
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and "migration" in n.attr:
            return True
        if isinstance(n, ast.Name) and "migration" in n.id:
            return True
    return False


@register
class MigrationSafetyGate(AnalysisPlugin):
    name = "migration-safety"
    description = ("migration phases journaled, cutover paths guarded by "
                   "the migration lock, migration locks declared lockdep "
                   "leaves")

    def run(self, ctx: RepoContext) -> list[Violation]:
        if MIGRATION_MODULE not in ctx.paths():
            return []  # tree without an actuator: nothing to check
        out: list[Violation] = []
        out.extend(self._check_phase_events(ctx.file(MIGRATION_MODULE)))
        for rel in CUTOVER_MODULES:
            if rel not in ctx.paths():
                continue
            sf = ctx.file(rel)
            out.extend(self._check_cutover_guarded(sf))
            out.extend(self._check_leaf_locks(sf))
        return out

    # ------------------------------------------------------------------
    def _check_phase_events(self, sf) -> list[Violation]:
        phases, line = _literal_tuple(sf, PHASES_REGISTRY_NAME)
        if phases is None:
            return [Violation(
                self.name, sf.rel, line or 1,
                f"no literal {PHASES_REGISTRY_NAME} tuple found — the "
                "actuator's phase order is the crash-recovery contract "
                "and must be a registry")]
        emitted: set[str] = set()
        if sf.tree is not None:
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                fname = node.func.attr if isinstance(
                    node.func, ast.Attribute) else (
                    node.func.id if isinstance(node.func, ast.Name) else "")
                if fname not in ("emit_event", "emit"):
                    continue
                s = _str_const(node.args[0])
                if s is not None:
                    emitted.add(s)
        out = []
        for kind in REQUIRED_EVENTS:
            want = f"shard.migrate.{kind}"
            if want not in emitted:
                out.append(Violation(
                    self.name, sf.rel, line,
                    f"phase transition {want!r} is never journaled in "
                    f"{sf.rel} — a crash there would leave no event to "
                    "roll forward from"))
        return out

    # ------------------------------------------------------------------
    def _check_cutover_guarded(self, sf) -> list[Violation]:
        """Every *cutover* function holds (or documents holding) the
        migration lock."""
        if sf.tree is None:
            return []
        out = []
        for node in ast.walk(sf.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if "cutover" not in node.name:
                continue
            guarded = False
            for inner in ast.walk(node):
                if isinstance(inner, ast.With) and any(
                        _mentions_migration(item.context_expr)
                        for item in inner.items):
                    guarded = True
                    break
            if not guarded:
                # an annotation naming the lock counts: the function runs
                # with the lock already held by its caller
                end = getattr(node, "end_lineno", node.lineno)
                for ln in range(node.lineno - 1, end + 1):
                    c = sf.comment(ln)
                    if (("guarded by:" in c or "caller holds:" in c)
                            and "migration" in c):
                        guarded = True
                        break
            if not guarded:
                out.append(Violation(
                    self.name, sf.rel, node.lineno,
                    f"shard-cutover path {node.name!r} neither takes the "
                    "migration lock in a `with` scope nor carries a "
                    "`# guarded by:`/`# caller holds:` annotation naming "
                    "it — the read-path swap must never run unguarded"))
        return out

    def _check_leaf_locks(self, sf) -> list[Violation]:
        """make_lock("migration.*") must be declare_leaf'd in-module."""
        if sf.tree is None:
            return []
        made: dict[str, int] = {}
        declared: set[str] = set()
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fname = node.func.id if isinstance(node.func, ast.Name) else (
                node.func.attr if isinstance(node.func, ast.Attribute)
                else "")
            s = _str_const(node.args[0])
            if s is None or not s.startswith("migration."):
                continue
            if fname in ("make_lock", "make_rlock", "make_condition"):
                made.setdefault(s, node.lineno)
            elif fname == "declare_leaf":
                declared.add(s)
        return [Violation(
            self.name, sf.rel, line,
            f"migration lock {name!r} is not declared a lockdep leaf in "
            f"{sf.rel} — the cutover/state locks guard plain "
            "publications; any acquisition under them must be flagged")
            for name, line in sorted(made.items()) if name not in declared]
