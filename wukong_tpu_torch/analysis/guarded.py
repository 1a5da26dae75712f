"""GUARDED_BY lock-discipline checker (static, AST-based).

The runtime is a concurrent system — proxy threads, the engine pool's five
lanes, the batcher flusher, the heal/checkpoint watchers — and its shared
state is protected by a lock-per-structure convention that until now lived
only in comments and in people's heads. This gate makes the convention
*declarative and enforced*:

Annotation vocabulary (ordinary ``#`` comments, read via tokenize):

- ``# guarded by: <lock>`` on an attribute's initializing assignment
  (normally in ``__init__``; module-level names work too) declares that
  every read/write of the attribute must happen inside a ``with`` scope
  holding that lock. ``<lock>`` is the attribute/global name of the lock
  (``_results_lock``), or ``<fn>()`` for a lock reached through a factory
  call (``mutation_lock()``).
- ``# caller holds: <lock>`` on a ``def`` line declares the whole method
  runs with the lock already held (the ``*_locked`` helper convention).
- ``# unguarded: <reason>`` on an access line allowlists that one access;
  the reason is the review artifact (CPython-atomic op, report-only
  snapshot, ...).
- ``# lock-free: <reason>`` on an initializing assignment declares the
  attribute intentionally lock-free (single-writer slots, atomic deque
  ops); it is registered but never enforced, so the concurrency story is
  still written down where the attribute is born.

A class is enforced when it has at least one guarded attribute AND more
than one *thread entry point* — public methods plus any method used as a
``threading.Thread(target=self.<m>)`` anywhere in the file (single-entry
classes cannot race with themselves). ``__init__`` bodies are exempt:
construction happens-before publication.

The central registry below supplements inline annotations for attributes
whose guard cannot sit on one line (declared per (file, class)); inline
and registry declarations merge, inline winning on conflict.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from wukong_tpu_torch.analysis.framework import (
    AnalysisPlugin,
    RepoContext,
    Violation,
    register,
)

#: {pkg-relative path: {class ("" = module level): {attr: lock-spec}}} —
#: supplements inline ``# guarded by:`` comments (inline wins on conflict).
#: Keep this list SHORT: the inline form keeps the declaration next to the
#: attribute it protects, which is where a reader looks.
GUARDED_BY_REGISTRY: dict[str, dict[str, dict[str, str]]] = {
    # the engine pool's per-engine queues are guarded by the matching
    # element of `locks` — per-element guards cannot be expressed on one
    # annotation line, so they are declared here
    "runtime/scheduler.py": {"EnginePool": {"queues": "locks"}},
}

_GUARDED_TAG = "guarded by:"
_CALLER_TAG = "caller holds:"
_UNGUARDED_TAG = "unguarded:"
_LOCKFREE_TAG = "lock-free:"


def _tag_value(comment: str, tag: str) -> str | None:
    c = comment.strip()
    if c.lower().startswith(tag):
        return c[len(tag):].strip()
    return None


def _lock_name_of(expr: ast.expr) -> str | None:
    """Normalize a with-item / annotation lock expression to a spec string.

    ``self._lock`` -> "_lock"; ``self._metric._lock`` -> "_metric._lock";
    ``_state_lock`` -> "_state_lock"; ``mutation_lock()`` /
    ``wal.mutation_lock()`` -> "mutation_lock()";
    ``self.locks[i]`` -> "locks".
    """
    if isinstance(expr, ast.Call) and not expr.args and not expr.keywords:
        base = _lock_name_of(expr.func)
        if base is None:
            return None
        # qualified factory calls normalize to the bare function name, so
        # `wal.mutation_lock()` and `mutation_lock()` share one spec
        return f"{base.rpartition('.')[2]}()"
    if isinstance(expr, ast.Subscript):
        return _lock_name_of(expr.value)
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        if isinstance(expr.value, ast.Name) and expr.value.id == "self":
            return expr.attr
        base = _lock_name_of(expr.value)
        if base is not None and not base.endswith("()"):
            return f"{base}.{expr.attr}"  # self._metric._lock etc.
        return expr.attr
    return None


@dataclass
class _ClassInfo:
    name: str
    node: ast.ClassDef
    guarded: dict[str, str] = field(default_factory=dict)  # attr -> lock
    lockfree: set[str] = field(default_factory=set)
    entry_points: set[str] = field(default_factory=set)


def _thread_targets(tree: ast.Module) -> set[str]:
    """Method names passed as ``target=self.<m>`` / ``target=<m>`` to a
    Thread constructor anywhere in the file."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fname = node.func.attr if isinstance(node.func, ast.Attribute) else (
            node.func.id if isinstance(node.func, ast.Name) else "")
        if fname != "Thread":
            continue
        for kw in node.keywords:
            if kw.arg == "target":
                if isinstance(kw.value, ast.Attribute):
                    out.add(kw.value.attr)
                elif isinstance(kw.value, ast.Name):
                    out.add(kw.value.id)
    return out


def _collect_class(sf, cls: ast.ClassDef, thread_targets: set[str],
                   registry: dict[str, dict[str, str]]) -> _ClassInfo:
    info = _ClassInfo(cls.name, cls)
    info.guarded.update(registry.get(cls.name, {}))
    body_stmts = set(map(id, cls.body))  # direct class-level statements
    for node in ast.walk(cls):
        tgt = None
        if isinstance(node, ast.Assign) and node.targets:
            tgt = node.targets[0]
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            tgt = node.target
        if tgt is None:
            continue
        if (isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name) and tgt.value.id == "self"):
            attr = tgt.attr
        elif isinstance(tgt, ast.Name) and id(node) in body_stmts:
            # class-level attribute: membership in cls.body, never a
            # hardcoded indent column (nested classes indent deeper)
            attr = tgt.id
        else:
            continue
        # the annotation may sit on the statement's last physical line
        # (multi-line initializers put the comment after the close paren)
        for ln in range(node.lineno, (node.end_lineno or node.lineno) + 1):
            c = sf.comment(ln)
            v = _tag_value(c, _GUARDED_TAG)
            if v is not None:
                info.guarded[attr] = v
            elif _tag_value(c, _LOCKFREE_TAG) is not None:
                info.lockfree.add(attr)
    for st in cls.body:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not st.name.startswith("_") or st.name in thread_targets:
                info.entry_points.add(st.name)
    return info


class _AccessChecker(ast.NodeVisitor):
    """Walk one method body tracking the set of held lock specs."""

    def __init__(self, sf, cls: _ClassInfo, method: str,
                 held0: frozenset[str], out: list[Violation]):
        self.sf = sf
        self.cls = cls
        self.method = method
        self.held: set[str] = set(held0)
        self.out = out

    # -- lock scopes ----------------------------------------------------
    def visit_With(self, node: ast.With):
        added = []
        for item in node.items:
            spec = _lock_name_of(item.context_expr)
            if spec is not None and spec not in self.held:
                self.held.add(spec)
                added.append(spec)
        for item in node.items:  # `with a as b:` expressions still checked
            self.visit(item.context_expr)
        for st in node.body:
            self.visit(st)
        for spec in added:
            self.held.discard(spec)

    visit_AsyncWith = visit_With

    # nested defs inherit the lexical held set (a closure defined under a
    # lock but invoked later elsewhere is attributed to its definition
    # site — a deliberate static approximation)
    def visit_FunctionDef(self, node):
        for st in node.body:
            self.visit(st)

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- accesses -------------------------------------------------------
    def visit_Attribute(self, node: ast.Attribute):
        if (isinstance(node.value, ast.Name) and node.value.id == "self"
                and node.attr in self.cls.guarded):
            lock = self.cls.guarded[node.attr]
            if lock not in self.held:
                if _tag_value(self.sf.comment(node.lineno),
                              _UNGUARDED_TAG) is None:
                    self.out.append(Violation(
                        GuardedByGate.name, self.sf.rel, node.lineno,
                        f"{self.cls.name}.{self.method}: access to "
                        f"{node.attr!r} (guarded by {lock!r}) outside its "
                        f"lock scope — wrap in `with self.{lock}:` or "
                        "annotate the line with `# unguarded: <reason>`"))
        self.generic_visit(node)


class _ModuleAccessChecker(ast.NodeVisitor):
    """Same discipline for module-level guarded globals."""

    def __init__(self, sf, guarded: dict[str, str], out: list[Violation]):
        self.sf = sf
        self.guarded = guarded
        self.held: set[str] = set()
        self.out = out
        self.func_depth = 0

    def visit_With(self, node: ast.With):
        added = []
        for item in node.items:
            spec = _lock_name_of(item.context_expr)
            if spec is not None and spec not in self.held:
                self.held.add(spec)
                added.append(spec)
        for st in node.body:
            self.visit(st)
        for spec in added:
            self.held.discard(spec)

    visit_AsyncWith = visit_With

    def visit_FunctionDef(self, node):
        held0 = self.held
        caller = _tag_value(self.sf.comment(node.lineno), _CALLER_TAG)
        self.held = set(held0) | ({caller} if caller else set())
        self.func_depth += 1
        for st in node.body:
            self.visit(st)
        self.func_depth -= 1
        self.held = held0

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Name(self, node: ast.Name):
        if (self.func_depth > 0 and node.id in self.guarded
                and self.guarded[node.id] not in self.held):
            if _tag_value(self.sf.comment(node.lineno),
                          _UNGUARDED_TAG) is None:
                self.out.append(Violation(
                    GuardedByGate.name, self.sf.rel, node.lineno,
                    f"module global {node.id!r} (guarded by "
                    f"{self.guarded[node.id]!r}) accessed outside its lock "
                    "scope"))
        self.generic_visit(node)


@register
class GuardedByGate(AnalysisPlugin):
    name = "guarded-by"
    description = ("declared-guarded attributes accessed outside their "
                   "lock scope in multi-threaded classes")

    def run(self, ctx: RepoContext) -> list[Violation]:
        out: list[Violation] = []
        for sf in ctx.iter_files():
            if sf.tree is None:
                continue
            registry = GUARDED_BY_REGISTRY.get(sf.rel, {})
            targets = _thread_targets(sf.tree)
            # module-level guarded globals
            mod_guarded: dict[str, str] = dict(registry.get("", {}))
            for st in sf.tree.body:
                tgt = None
                if isinstance(st, ast.Assign) and st.targets:
                    tgt = st.targets[0]
                elif isinstance(st, ast.AnnAssign):
                    tgt = st.target
                if isinstance(tgt, ast.Name):
                    for ln in range(st.lineno,
                                    (st.end_lineno or st.lineno) + 1):
                        v = _tag_value(sf.comment(ln), _GUARDED_TAG)
                        if v is not None:
                            mod_guarded[tgt.id] = v
            if mod_guarded:
                _ModuleAccessChecker(sf, mod_guarded, out).visit(sf.tree)
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                info = _collect_class(sf, node, targets, registry)
                if not info.guarded or len(info.entry_points) <= 1:
                    continue
                for st in node.body:
                    if not isinstance(st, (ast.FunctionDef,
                                           ast.AsyncFunctionDef)):
                        continue
                    if st.name == "__init__":
                        continue  # construction happens-before publication
                    held0 = set()
                    caller = _tag_value(sf.comment(st.lineno), _CALLER_TAG)
                    if caller:
                        held0.add(caller)
                    chk = _AccessChecker(sf, info, st.name,
                                         frozenset(held0), out)
                    for b in st.body:
                        chk.visit(b)
        return out
