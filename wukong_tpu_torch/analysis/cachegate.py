"""cache-coherence gate: the serving-cache observatory stays honest.

The port's copy of the JAX package's analysis/cachegate.py. One
addition: :data:`PENDING_CAUSES` names each declared invalidation cause
whose producer the port does not have yet, with the ROADMAP item that
ports it; such a cause is exempt from the two call-site rules below until
then, and a pending cause that has a call site is itself a violation (a
stale entry). The port's ``INVALIDATION_CAUSES`` stays equal to the JAX
tuple.

ROADMAP item 7's materialized-view serving cache will consume the reuse
observatory's ``CACHE_INPUTS`` (obs/reuse.py) the way item 3's migration
planner consumes ``PLACEMENT_INPUTS`` — and its correctness rests on ONE
invariant: every store-mutation path that inserts triples bumps the
version the cache keys on and (when the observatory is enabled) lands a
``cache.invalidate`` edge. This gate holds both halves mechanically true,
the heat-/slo-/placement-telemetry pattern applied to the cache plane:

- ``CACHE_INPUTS`` (a literal dict in ``obs/reuse.py``) must exist and
  every metric it maps a signal to must actually be registered somewhere
  in the package — a caching decision must never read a number no
  exporter can scrape. Every ``wukong_*`` literal the module passes to a
  tsdb trend read must be named in the map (the placegate rule).
- ``INVALIDATION_CAUSES`` (a literal tuple in ``obs/reuse.py``) is the
  closed set of mutation-edge causes: every literal cause passed to
  ``maybe_note_invalidation`` anywhere in the package must be declared,
  and every declared cause must have >=1 call site (a dead registry
  entry means a mutation class silently stopped invalidating).
- every top-level function that calls ``insert_triples`` (the per-
  partition mutation primitive, which bumps ``g.version``) must also
  call ``maybe_note_invalidation`` in scope, or be named in
  ``CACHE_ALLOWLIST`` with a justification — the wal-hook discipline,
  applied to cache coherence.
- every mutable shared structure created in ``obs/reuse.py`` ``__init__``
  bodies carries a ``# guarded by:`` / ``# lock-free:`` annotation, and
  every lockdep factory lock the module creates is declared a leaf there
  (ledger/shadow counters are innermost by construction — probes fire
  from the proxy reply path).

The ACTUATOR half (``serve/`` — the materialized-view serving
plane, checked only when the tree has serve/ files):

- ``serve/result_cache.py`` must declare a literal ``CONSUMED_INPUTS``
  tuple, every element a ``CACHE_INPUTS`` key — the cache's admission
  reads are the PLACEMENT_INPUTS consumer contract, held literal.
- its literal ``MUTATION_EDGES`` dict's keys must equal
  ``INVALIDATION_CAUSES`` exactly: a mutation class the observatory
  journals but the actuator ignores would serve stale bytes silently,
  and a declared edge with no journaled cause is a phantom consumer.
- every declared cause must reach the actuator through >=1
  ``notify_mutation`` call site (with a declared cause literal), so the
  real cache hears every edge the shadow cache hears.
- serve/ ``__init__`` shared state is annotated like reuse.py's, and
  every lockdep lock ``serve/result_cache.py`` creates is declared a
  leaf there (the cache lock guards dict updates only; the view
  registry's lock is deliberately NOT a leaf — it is held across
  delta evaluation).
"""

from __future__ import annotations

import ast

from wukong_tpu_torch.analysis.framework import (
    AnalysisPlugin,
    RepoContext,
    Violation,
    register,
)
from wukong_tpu_torch.analysis.telemetry import (
    _annotated,
    _is_mutable_container,
    _str_const,
)

REUSE_MODULE = "obs/reuse.py"
INPUTS_NAME = "CACHE_INPUTS"
CAUSES_NAME = "INVALIDATION_CAUSES"
SERVE_CACHE_MODULE = "serve/result_cache.py"
CONSUMED_NAME = "CONSUMED_INPUTS"
EDGES_NAME = "MUTATION_EDGES"
#: tsdb query methods whose metric-name argument is a cache-plane READ
TSDB_READS = ("rate", "rate_by_label", "series", "quantile", "latest")

#: declared invalidation causes whose producer is not ported yet -> the
#: ROADMAP item that ports it (exempt from the call-site rules until then)
PENDING_CAUSES: dict = {}

#: (package-relative file, top-level function) pairs allowed to call
#: ``insert_triples(`` without a maybe_note_invalidation in scope. The JAX
#: list's worker-process replays come with runtime/procs.py (ROADMAP §A
#: 7b).
CACHE_ALLOWLIST = {
    # the per-partition mutation primitive itself: it bumps g.version;
    # the invalidation note fires at the batch/epoch commit level
    ("store/dynamic.py", "insert_triples"),
    # private window store: derived state a result cache never reads
    ("stream/continuous.py", "_on_epoch_windowed"),
    # recovery replay re-applies durable records during recover(), which
    # notes ONE conservative "restore" purge after the tail replays
    ("runtime/recovery.py", "_replay_wal"),
    # shard heal rebuilds a copy back to its correct byte content — the
    # serving world is unchanged once the rebuild promotes
    ("runtime/recovery.py", "_rebuild_shard_locked"),
    # migration catch-up replays onto the NOT-yet-serving recipient; the
    # cutover that publishes it notes the "cutover" purge
    ("runtime/migration.py", "_phase_catchup"),
}


class _CoherenceFinder(ast.NodeVisitor):
    """Per TOP-LEVEL function: first ``insert_triples`` call line and
    whether ``maybe_note_invalidation`` is called in scope (nested defs
    attribute to their outermost function, the wal-hook posture)."""

    def __init__(self):
        self.func_stack: list[str] = []
        self.funcs: dict[str, list] = {}  # top func -> [lineno|None, noted]

    def visit_FunctionDef(self, node):
        self.func_stack.append(node.name)
        self.generic_visit(node)
        self.func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    @staticmethod
    def _name_of(func) -> str:
        if isinstance(func, ast.Name):
            return func.id
        if isinstance(func, ast.Attribute):
            return func.attr
        return ""

    def visit_Call(self, node):
        name = self._name_of(node.func)
        if name in ("insert_triples", "maybe_note_invalidation") \
                and self.func_stack:
            top = self.func_stack[0]
            ent = self.funcs.setdefault(top, [None, False])
            if name == "insert_triples" and ent[0] is None:
                ent[0] = node.lineno
            if name == "maybe_note_invalidation":
                ent[1] = True
        self.generic_visit(node)


@register
class CacheCoherenceGate(AnalysisPlugin):
    name = "cache-coherence"
    description = ("CACHE_INPUTS backed by registered metrics; every "
                   "insert path notes its invalidation edge; causes a "
                   "closed literal set; reuse.py shared state annotated "
                   "+ locks declared lockdep leaves")

    # ------------------------------------------------------------------
    def _literal_dict(self, sf, name: str):
        """(str->str dict, lineno) of a module-level literal dict."""
        if sf.tree is None:
            return None, 0
        for st in sf.tree.body:
            tgt = st.targets[0] if isinstance(st, ast.Assign) else (
                st.target if isinstance(st, ast.AnnAssign) else None)
            if not (isinstance(tgt, ast.Name) and tgt.id == name):
                continue
            if not isinstance(st.value, ast.Dict):
                return None, st.lineno
            out = {}
            for k, v in zip(st.value.keys, st.value.values):
                ks, vs = _str_const(k), _str_const(v)
                if ks is None or vs is None:
                    return None, st.lineno  # non-literal: unverifiable
                out[ks] = vs
            return out, st.lineno
        return None, 0

    def _literal_tuple(self, sf, name: str):
        if sf.tree is None:
            return None, 0
        for st in sf.tree.body:
            tgt = st.targets[0] if isinstance(st, ast.Assign) else (
                st.target if isinstance(st, ast.AnnAssign) else None)
            if not (isinstance(tgt, ast.Name) and tgt.id == name):
                continue
            if not isinstance(st.value, (ast.Tuple, ast.List)):
                return None, st.lineno
            out = []
            for el in st.value.elts:
                s = _str_const(el)
                if s is None:
                    return None, st.lineno
                out.append(s)
            return out, st.lineno
        return None, 0

    def _registered_metrics(self, ctx: RepoContext) -> set[str]:
        names: set[str] = set()
        for sf in ctx.iter_files():
            if sf.tree is None:
                continue
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                fname = node.func.attr if isinstance(
                    node.func, ast.Attribute) else ""
                if fname in ("counter", "gauge", "histogram"):
                    s = _str_const(node.args[0])
                    if s:
                        names.add(s)
        return names

    # ------------------------------------------------------------------
    def run(self, ctx: RepoContext) -> list[Violation]:
        if REUSE_MODULE not in ctx.paths():
            return []  # tree without a reuse plane: nothing to check
        sf = ctx.file(REUSE_MODULE)
        out: list[Violation] = []

        inputs, line = self._literal_dict(sf, INPUTS_NAME)
        if inputs is None:
            out.append(Violation(
                self.name, REUSE_MODULE, line or 1,
                f"no literal {INPUTS_NAME} dict found — declare every "
                "signal the serving cache will read and its backing "
                "metric centrally"))
        else:
            registered = self._registered_metrics(ctx)
            for signal, metric in sorted(inputs.items()):
                if metric not in registered:
                    out.append(Violation(
                        self.name, REUSE_MODULE, line,
                        f"cache input {signal!r} claims metric "
                        f"{metric!r}, but no code path registers it — a "
                        "caching decision would read an unscrapeable "
                        "number"))
            out.extend(self._check_trend_reads(sf, set(inputs.values())))

        causes, causes_line = self._literal_tuple(sf, CAUSES_NAME)
        out.extend(self._check_causes(ctx, causes, causes_line))
        out.extend(self._check_mutation_paths(ctx))
        out.extend(self._check_init_annotations(sf))
        out.extend(self._check_leaf_locks(sf))
        out.extend(self._check_serve_plane(ctx, inputs, causes))
        return out

    # ------------------------------------------------------------------
    def _check_trend_reads(self, sf, declared: set[str]) -> list[Violation]:
        """Every wukong_* metric literal reuse.py passes to a tsdb query
        must be a declared cache input (the placegate rule)."""
        if sf.tree is None:
            return []
        out = []
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fname = node.func.attr if isinstance(
                node.func, ast.Attribute) else (
                node.func.id if isinstance(node.func, ast.Name) else "")
            if fname not in TSDB_READS:
                continue
            s = _str_const(node.args[0])
            if s is None or not s.startswith("wukong_"):
                continue
            if s not in declared:
                out.append(Violation(
                    self.name, sf.rel, node.lineno,
                    f"reuse trend read {s!r} is not named in "
                    f"{INPUTS_NAME} — every cache-plane signal must be "
                    "declared centrally"))
        return out

    def _check_causes(self, ctx: RepoContext, causes,
                      line: int) -> list[Violation]:
        """INVALIDATION_CAUSES is a closed set: literal causes at call
        sites must be declared, declared causes must be used."""
        if causes is None:
            return [Violation(
                self.name, REUSE_MODULE, line or 1,
                f"no literal {CAUSES_NAME} tuple found — the mutation-"
                "edge causes are the invalidation contract and must be "
                "a registry")]
        out = []
        used: set[str] = set()
        for mod in ctx.iter_files():
            if mod.tree is None:
                continue
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                fname = node.func.attr if isinstance(
                    node.func, ast.Attribute) else (
                    node.func.id if isinstance(node.func, ast.Name)
                    else "")
                if fname != "maybe_note_invalidation":
                    continue
                s = _str_const(node.args[0])
                if s is None:
                    continue
                used.add(s)
                if s not in causes:
                    out.append(Violation(
                        self.name, mod.rel, node.lineno,
                        f"invalidation cause {s!r} is not declared in "
                        f"{REUSE_MODULE}::{CAUSES_NAME}"))
        for c in sorted(set(causes) - used - set(PENDING_CAUSES)):
            out.append(Violation(
                self.name, REUSE_MODULE, line,
                f"declared invalidation cause {c!r} has no "
                "maybe_note_invalidation call site — a mutation class "
                "silently stopped invalidating the cache plane"))
        out.extend(self._stale_pending(used, REUSE_MODULE, line,
                                       "maybe_note_invalidation"))
        return out

    def _stale_pending(self, used: set, rel: str, line: int,
                       site: str) -> list[Violation]:
        """A pending cause with a call site has its producer: the
        declaration is stale."""
        return [Violation(
            self.name, rel, line,
            f"pending invalidation cause {c!r} now has a {site} call site "
            "— remove it from analysis/cachegate.py::PENDING_CAUSES")
            for c in sorted(set(PENDING_CAUSES) & used)]

    def _check_mutation_paths(self, ctx: RepoContext) -> list[Violation]:
        out = []
        for sf in ctx.iter_files():
            if sf.tree is None:
                continue
            cf = _CoherenceFinder()
            cf.visit(sf.tree)
            out.extend(Violation(
                self.name, sf.rel, ln,
                "insert_triples() without a cache-invalidation note — "
                "this mutation path bumps the version the serving cache "
                "keys on but never lands the cache.invalidate edge "
                "(call maybe_note_invalidation, or extend "
                "CACHE_ALLOWLIST for non-serving writers)")
                for func, (ln, noted) in sorted(cf.funcs.items())
                if ln is not None and not noted
                and (sf.rel, func) not in CACHE_ALLOWLIST)
        return out

    # ------------------------------------------------------------------
    def _check_init_annotations(self, sf) -> list[Violation]:
        """Mutable self.X containers created in __init__ need a
        concurrency annotation (the telemetry-gate rule applied to the
        reuse plane's classes)."""
        if sf.tree is None:
            return []
        out = []
        for cls in ast.walk(sf.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            init = next((n for n in cls.body
                         if isinstance(n, ast.FunctionDef)
                         and n.name == "__init__"), None)
            if init is None:
                continue
            for node in ast.walk(init):
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    targets = [node.target]
                else:
                    continue
                for tgt in targets:
                    if not (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"):
                        continue
                    if not _is_mutable_container(node.value):
                        continue
                    if not _annotated(sf, node.lineno):
                        out.append(Violation(
                            self.name, sf.rel, node.lineno,
                            f"shared reuse structure "
                            f"{cls.name}.{tgt.attr} carries no "
                            "`# guarded by:` / `# lock-free:` annotation "
                            "— declare its concurrency contract where it "
                            "is created"))
        return out

    def _check_leaf_locks(self, sf) -> list[Violation]:
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
            if s is None:
                continue
            if fname in ("make_lock", "make_rlock", "make_condition"):
                made.setdefault(s, node.lineno)
            elif fname == "declare_leaf":
                declared.add(s)
        return [Violation(
            self.name, sf.rel, line,
            f"cache-plane lock {name!r} is not declared a lockdep leaf "
            f"in {sf.rel} — ledger/shadow/result-cache counters must be "
            "innermost (declare_leaf) so lockdep flags any acquisition "
            "under them")
            for name, line in sorted(made.items()) if name not in declared]

    # ------------------------------------------------------------------
    # the actuator half: the serving plane (serve/)
    # ------------------------------------------------------------------
    def _check_serve_plane(self, ctx: RepoContext, inputs,
                           causes) -> list[Violation]:
        serve_files = [p for p in ctx.paths() if p.startswith("serve/")]
        if not serve_files:
            return []  # observe-only tree: no actuator to check
        out: list[Violation] = []
        if SERVE_CACHE_MODULE not in ctx.paths():
            return [Violation(
                self.name, serve_files[0], 1,
                f"serve/ exists but {SERVE_CACHE_MODULE} does not — the "
                "serving plane's consumer contract (CONSUMED_INPUTS + "
                "MUTATION_EDGES) has no home")]
        sf = ctx.file(SERVE_CACHE_MODULE)

        consumed, line = self._literal_tuple(sf, CONSUMED_NAME)
        if consumed is None:
            out.append(Violation(
                self.name, SERVE_CACHE_MODULE, line or 1,
                f"no literal {CONSUMED_NAME} tuple found — declare every "
                "observatory signal the cache's admission reads"))
        elif inputs is not None:
            for signal in consumed:
                if signal not in inputs:
                    out.append(Violation(
                        self.name, SERVE_CACHE_MODULE, line,
                        f"consumed input {signal!r} is not a declared "
                        f"{INPUTS_NAME} signal — the actuator reads a "
                        "number the observatory never promised"))

        edges, eline = self._literal_dict(sf, EDGES_NAME)
        if edges is None:
            out.append(Violation(
                self.name, SERVE_CACHE_MODULE, eline or 1,
                f"no literal {EDGES_NAME} dict found — declare what the "
                "serving plane does on each journaled mutation edge"))
        elif causes is not None:
            for c in sorted(set(causes) - set(edges)):
                out.append(Violation(
                    self.name, SERVE_CACHE_MODULE, eline,
                    f"mutation cause {c!r} is journaled by the "
                    f"observatory but missing from {EDGES_NAME} — the "
                    "actuator would serve stale bytes through that edge"))
            for c in sorted(set(edges) - set(causes)):
                out.append(Violation(
                    self.name, SERVE_CACHE_MODULE, eline,
                    f"{EDGES_NAME} declares edge {c!r} which is not an "
                    f"{CAUSES_NAME} member (phantom consumer)"))

        out.extend(self._check_notify_sites(ctx, causes))
        for rel in serve_files:
            mod = ctx.file(rel)
            out.extend(self._check_init_annotations(mod))
        out.extend(self._check_leaf_locks(sf))
        return out

    def _check_notify_sites(self, ctx: RepoContext,
                            causes) -> list[Violation]:
        """Every notify_mutation call site uses a declared cause, and
        every declared cause reaches the actuator through >=1 site."""
        if causes is None:
            return []
        out: list[Violation] = []
        used: set[str] = set()
        for mod in ctx.iter_files():
            if mod.tree is None:
                continue
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                fname = node.func.attr if isinstance(
                    node.func, ast.Attribute) else (
                    node.func.id if isinstance(node.func, ast.Name)
                    else "")
                if fname != "notify_mutation":
                    continue
                s = _str_const(node.args[0])
                if s is None:
                    continue
                used.add(s)
                if s not in causes:
                    out.append(Violation(
                        self.name, mod.rel, node.lineno,
                        f"serving-plane mutation edge {s!r} is not "
                        f"declared in {REUSE_MODULE}::{CAUSES_NAME}"))
        for c in sorted(set(causes) - used - set(PENDING_CAUSES)):
            out.append(Violation(
                self.name, SERVE_CACHE_MODULE, 1,
                f"declared invalidation cause {c!r} never reaches the "
                "serving plane (no notify_mutation call site) — the "
                "real cache would miss an edge the shadow cache hears"))
        out.extend(self._stale_pending(used, SERVE_CACHE_MODULE, 1,
                                       "notify_mutation"))
        return out
