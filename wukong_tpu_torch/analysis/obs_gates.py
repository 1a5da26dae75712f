"""The three lint gates of the JAX package's analysis/obs_gates.py, over
the port's tree.

Semantics and message texts are the JAX gates'; the allowlists name the
port's functions, each with its reason:

- ``no-bare-print`` — library code reports through utils/logger or
  obs/metrics; stdout belongs to the console/monitor report surfaces and
  CLI ``main``\\ s only.
- ``batcher-route`` — no direct ``engine.execute(`` under ``runtime/``
  outside the serving machinery itself, so nothing silently reopens a
  one-query-per-dispatch path next to the coalescer.
- ``wal-hook`` — any function calling ``insert_triples(`` must route
  through ``maybe_wal_append(`` in the same top-level function or be
  allowlisted, keeping acknowledged mutations durable.
"""

from __future__ import annotations

import ast
import os

from wukong_tpu_torch.analysis.framework import (
    AnalysisPlugin,
    RepoContext,
    Violation,
    register,
)

ALLOWED_FILES = {
    "runtime/console.py",
    "runtime/monitor.py",
}
ALLOWED_FUNCS = {"main"}

# (runtime-relative file, enclosing function) pairs allowed to call an
# engine dispatch entry point (``.execute(`` or any ``.execute_batch*(``)
# directly — the serving machinery itself
EXECUTE_ALLOWLIST = {
    # the batcher entry / bypass site: the JAX package's _serve_execute,
    # whose dispatch the port splits out so the result-cache lease wraps it
    ("proxy.py", "_dispatch"),
    ("proxy.py", "_run_repeats"),     # shape/capacity degradation re-runs
    # B replicate instances of one index-origin text in one chain, the
    # heavy-batch measurement entry (chip_smoke.py phases 7 and 9) — a
    # batch of its own by construction, like the emulator's flights
    ("proxy.py", "serve_batch_index"),
    ("scheduler.py", "_engine_loop"),  # pool engines executing popped work
    ("batcher.py", "_run_single"),    # per-query fallback of a fused group
    ("batcher.py", "_run_fused"),     # the fused dispatch itself
    ("batcher.py", "_run_slice"),     # the heavy lane's sliced dispatch
    ("emulator.py", "run"),           # device-class warm-up before timing
    ("emulator.py", "_device_batch"),  # compiled-batch emulator flights
    # the cached read-mostly drill's byte-identity oracle MUST bypass
    # the serving path (and its result cache) — comparing the cache
    # against itself would prove nothing
    ("emulator.py", "_readmostly_oracle"),
}

#: engine attrs the batcher-route gate treats as dispatch entry points
DISPATCH_ATTRS = frozenset({
    "execute", "execute_batch", "execute_batch_many", "execute_batch_mixed",
    "execute_batch_index", "execute_batch_index_many",
})

# (package-relative file, top-level function) pairs allowed to call
# ``insert_triples(`` without the WAL append hook. The JAX list's
# worker-process replays come with runtime/procs.py (ROADMAP §A 7b).
WAL_ALLOWLIST = {
    # the per-partition mutation primitive itself (hooked at batch level)
    ("store/dynamic.py", "insert_triples"),
    # private window store: derived state, rebuilt from WAL-logged epochs
    ("stream/continuous.py", "_on_epoch_windowed"),
    # recovery replay re-applies durable records under WAL suppression
    ("runtime/recovery.py", "_replay_wal"),
    # shard rebuild replays the durable tail onto a checkpoint clone before
    # it is promoted (the records are already logged)
    ("runtime/recovery.py", "_rebuild_shard_locked"),
    # migration catch-up replays the durable tail onto the not-yet-serving
    # recipient under WAL suppression
    ("runtime/migration.py", "_phase_catchup"),
}


class _FuncStackVisitor(ast.NodeVisitor):
    def __init__(self):
        self.func_stack: list[str] = []

    def visit_FunctionDef(self, node):
        self.func_stack.append(node.name)
        self.generic_visit(node)
        self.func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef


class _PrintFinder(_FuncStackVisitor):
    def __init__(self):
        super().__init__()
        self.hits: list[int] = []  # line numbers of disallowed prints

    def visit_Call(self, node):
        if (isinstance(node.func, ast.Name) and node.func.id == "print"
                and not (set(self.func_stack) & ALLOWED_FUNCS)):
            self.hits.append(node.lineno)
        self.generic_visit(node)


class _ExecuteFinder(_FuncStackVisitor):
    """Direct engine-dispatch calls (``<obj>.execute(...)`` and the
    ``.execute_batch*`` family) with their enclosing function."""

    def __init__(self):
        super().__init__()
        self.hits: list[tuple[int, str]] = []  # (lineno, enclosing func)

    def visit_Call(self, node):
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in DISPATCH_ATTRS:
            self.hits.append(
                (node.lineno, self.func_stack[-1] if self.func_stack else ""))
        self.generic_visit(node)


class _MutationFinder(_FuncStackVisitor):
    """Per TOP-LEVEL function: does it (or any nested def) call
    ``insert_triples`` / the WAL hook ``maybe_wal_append``? Nested defs
    attribute to their outermost function — the hook protects the whole
    batch path, wherever the loop body lives."""

    def __init__(self):
        super().__init__()
        # top-level func -> [first insert lineno | None, saw_hook]
        self.funcs: dict[str, list] = {}

    @staticmethod
    def _name_of(func) -> str:
        if isinstance(func, ast.Name):
            return func.id
        if isinstance(func, ast.Attribute):
            return func.attr
        return ""

    def visit_Call(self, node):
        name = self._name_of(node.func)
        if name in ("insert_triples", "maybe_wal_append") and self.func_stack:
            top = self.func_stack[0]
            ent = self.funcs.setdefault(top, [None, False])
            if name == "insert_triples" and ent[0] is None:
                ent[0] = node.lineno
            if name == "maybe_wal_append":
                ent[1] = True
        self.generic_visit(node)


@register
class BarePrintGate(AnalysisPlugin):
    name = "no-bare-print"
    description = ("bare print() in library code (stdout belongs to the "
                   "console/monitor surfaces and CLI mains)")

    def run(self, ctx: RepoContext) -> list[Violation]:
        out = []
        for sf in ctx.iter_files():
            if sf.tree is None or sf.rel in ALLOWED_FILES:
                continue
            finder = _PrintFinder()
            finder.visit(sf.tree)
            out.extend(Violation(
                self.name, sf.rel, ln,
                "bare print() in library code "
                "(use utils.logger or obs.metrics)")
                for ln in finder.hits)
        return out


@register
class BatcherRouteGate(AnalysisPlugin):
    name = "batcher-route"
    description = ("direct engine.execute() under runtime/ outside the "
                   "serving machinery")

    def run(self, ctx: RepoContext) -> list[Violation]:
        out = []
        for sf in ctx.iter_files():
            if sf.tree is None:
                continue
            head, _, fn = sf.rel.rpartition("/")
            if os.path.basename(head) != "runtime":
                continue
            ef = _ExecuteFinder()
            ef.visit(sf.tree)
            out.extend(Violation(
                self.name, sf.rel, ln,
                "direct engine.execute() bypasses the batcher entry point "
                "(route through Proxy._serve_execute or extend "
                "EXECUTE_ALLOWLIST)")
                for ln, func in ef.hits
                if (fn, func) not in EXECUTE_ALLOWLIST)
        return out


@register
class WalHookGate(AnalysisPlugin):
    name = "wal-hook"
    description = "insert_triples() without maybe_wal_append() in scope"

    def run(self, ctx: RepoContext) -> list[Violation]:
        out = []
        for sf in ctx.iter_files():
            if sf.tree is None:
                continue
            mf = _MutationFinder()
            mf.visit(sf.tree)
            out.extend(Violation(
                self.name, sf.rel, ln,
                "insert_triples() without the WAL append hook — an "
                "acknowledged mutation this path commits is lost on crash "
                "(call maybe_wal_append before mutating, or extend "
                "WAL_ALLOWLIST for derived-state writers)")
                for func, (ln, hooked) in sorted(mf.funcs.items())
                if ln is not None and not hooked
                and (sf.rel, func) not in WAL_ALLOWLIST)
        return out


#: the legacy gate set scripts/lint_obs.py runs (and the only gates that
#: make sense on a bare temp tree with no README/config/tests around it)
LEGACY_GATES = ("no-bare-print", "batcher-route", "wal-hook")
