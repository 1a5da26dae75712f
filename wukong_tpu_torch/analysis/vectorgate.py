"""vector-coherence gate: the hybrid graph+vector plane keeps its
invariants mechanically true.

The k-NN serving path keys every cache it touches (plan cache, result
cache, route memos) on the store version, publishes immutable slot
arrays, and reports itself through a declared metric surface. Each of
those is a convention a refactor could silently break with no error
anywhere — a mutation path that forgets the version bump serves stale
k-NN answers forever. This gate holds them statically:

- ``vector/__init__.py`` declares the literal ``VECTOR_METRICS``
  registry; every metric it names must actually be registered somewhere
  in the package (a ``counter``/``gauge``/``histogram`` call with that
  literal name), and every registered ``wukong_vector_*`` metric must
  appear in the literal — the two surfaces never drift apart in either
  direction.
- slot-writer discipline in ``vector/vstore.py``: the slot state
  (``vids``/``vecs``/``alive``/``slot_of``/``version``) is written only
  by the declared writers (``__init__``, ``_apply_slots``,
  ``from_arrays``), and ``_apply_slots`` always bumps the version — the
  copy-on-write snapshot contract scans depend on.
- every module-level mutation path in ``vector/vstore.py`` that applies
  an upsert/tombstone to a partition also calls ``bump_store_version``
  — vector mutations must invalidate version-keyed caches exactly like
  triple inserts do.
- every lockdep factory lock created in ``vector/`` files is declared a
  leaf in the same file (slot swaps and slice claims are innermost by
  construction) or, in the port, named with its reason in
  :data:`NON_LEAF_LOCKS` (the staging lock), and every mutable shared
  structure created in a
  ``vector/`` ``__init__`` body carries a ``# guarded by:`` /
  ``# lock-free:`` annotation.
"""

from __future__ import annotations

import ast

from wukong_tpu_torch.analysis.framework import (
    AnalysisPlugin,
    RepoContext,
    Violation,
    register,
)

#: port-only vector locks that are deliberately NOT lockdep leaves ->
#: why (a declared leaf listed here is a stale entry)
NON_LEAF_LOCKS = {
    "vector.stage": (
        "vector/knn.py staged_block: serializes the one staging of a store "
        "version on a device (a block is gigabytes) and is held across the "
        "store's snapshot (vector.slots, a leaf) and the residency charge "
        "(device.residency, a leaf); it is taken under no other lock, and "
        "the scans' heat charge comes after it is released"),
}

VECTOR_INIT = "vector/__init__.py"
VSTORE_MODULE = "vector/vstore.py"
REGISTRY_NAME = "VECTOR_METRICS"
METRIC_PREFIX = "wukong_vector_"
#: attributes forming the vstore's published slot state
SLOT_STATE = ("vids", "vecs", "alive", "slot_of", "version")
#: the only functions allowed to assign slot state
SLOT_WRITERS = ("__init__", "_apply_slots", "from_arrays")
_ANNOTATIONS = ("guarded by:", "lock-free:", "unguarded:", "caller holds:")
_MUTABLE_CTORS = {"dict", "list", "set", "deque", "defaultdict",
                  "OrderedDict", "Counter"}


def _str_const(node) -> str | None:
    return node.value if (isinstance(node, ast.Constant)
                          and isinstance(node.value, str)) else None


def _is_mutable_container(node) -> bool:
    if isinstance(node, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                         ast.ListComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        fn = node.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else "")
        return name in _MUTABLE_CTORS
    return False


def _call_name(node: ast.Call) -> str:
    fn = node.func
    return fn.id if isinstance(fn, ast.Name) else (
        fn.attr if isinstance(fn, ast.Attribute) else "")


@register
class VectorCoherenceGate(AnalysisPlugin):
    name = "vector-coherence"
    description = ("VECTOR_METRICS <-> registrations parity; vstore slot "
                   "state written only by declared writers with a version "
                   "bump; mutation paths bump the store version; vector "
                   "locks are lockdep leaves and shared state annotated")

    # ------------------------------------------------------------------
    def run(self, ctx: RepoContext) -> list[Violation]:
        if VECTOR_INIT not in ctx.paths():
            return []  # tree without a vector plane: nothing to check
        out: list[Violation] = []
        out.extend(self._check_metrics(ctx))
        if VSTORE_MODULE in ctx.paths():
            sf = ctx.file(VSTORE_MODULE)
            out.extend(self._check_slot_writers(sf))
            out.extend(self._check_version_bumps(sf))
        for sf in ctx.iter_files():
            if sf.rel.startswith("vector/") and sf.tree is not None:
                out.extend(self._check_leaf_locks(sf))
                out.extend(self._check_init_annotations(sf))
        return out

    # ------------------------------------------------------------------
    # VECTOR_METRICS <-> registry parity (both directions)
    # ------------------------------------------------------------------
    def _declared_metrics(self, sf):
        """(name -> metric dict, lineno) from the literal assignment."""
        if sf.tree is None:
            return None, 0
        for st in sf.tree.body:
            tgt = st.targets[0] if isinstance(st, ast.Assign) else (
                st.target if isinstance(st, ast.AnnAssign) else None)
            if not (isinstance(tgt, ast.Name) and tgt.id == REGISTRY_NAME):
                continue
            val = st.value
            if not isinstance(val, ast.Dict):
                return None, st.lineno
            decl = {}
            for k, v in zip(val.keys, val.values):
                ks, vs = _str_const(k), _str_const(v)
                if ks is None or vs is None:
                    return None, st.lineno  # non-literal: unverifiable
                decl[ks] = vs
            return decl, st.lineno
        return None, 0

    def _registered_metrics(self, ctx: RepoContext) -> dict[str, tuple]:
        """metric name -> (rel, lineno) for every registration call."""
        found: dict[str, tuple] = {}
        for sf in ctx.iter_files():
            if sf.tree is None:
                continue
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                if _call_name(node) in ("counter", "gauge", "histogram"):
                    s = _str_const(node.args[0])
                    if s:
                        found.setdefault(s, (sf.rel, node.lineno))
        return found

    def _check_metrics(self, ctx: RepoContext) -> list[Violation]:
        sf = ctx.file(VECTOR_INIT)
        decl, line = self._declared_metrics(sf)
        if decl is None:
            return [Violation(
                self.name, VECTOR_INIT, line or 1,
                f"no literal {REGISTRY_NAME} dict found — declare every "
                "vector-plane signal and its backing metric centrally")]
        out = []
        registered = self._registered_metrics(ctx)
        for signal, metric in sorted(decl.items()):
            if metric not in registered:
                out.append(Violation(
                    self.name, VECTOR_INIT, line,
                    f"vector signal {signal!r} claims metric {metric!r}, "
                    "but no code path registers it — the declared surface "
                    "would advertise an unscrapeable number"))
        declared_names = set(decl.values())
        for metric, (rel, mline) in sorted(registered.items()):
            if metric.startswith(METRIC_PREFIX) \
                    and metric not in declared_names:
                out.append(Violation(
                    self.name, rel, mline,
                    f"metric {metric!r} is registered but absent from "
                    f"{VECTOR_INIT}::{REGISTRY_NAME} — the vector plane's "
                    "metric surface must stay centrally declared"))
        return out

    # ------------------------------------------------------------------
    # vstore slot-writer + version-bump discipline
    # ------------------------------------------------------------------
    def _check_slot_writers(self, sf) -> list[Violation]:
        if sf.tree is None:
            return []
        out = []
        bumps_version = False
        for fn in ast.walk(sf.tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                    targets = [node.target]
                else:
                    continue
                for tgt in targets:
                    # slot state lives on VectorStore instances (`self`
                    # in methods, `vs` in the module helpers) — a bare
                    # `g.version` write is the partition's version, the
                    # _check_version_bumps contract, not this one's
                    if not (isinstance(tgt, ast.Attribute)
                            and tgt.attr in SLOT_STATE
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id in ("self", "vs")):
                        continue
                    if fn.name == "_apply_slots" and tgt.attr == "version" \
                            and isinstance(node, ast.AugAssign):
                        bumps_version = True
                    if fn.name not in SLOT_WRITERS:
                        out.append(Violation(
                            self.name, sf.rel, node.lineno,
                            f"{fn.name}() writes slot state "
                            f"`.{tgt.attr}` — only "
                            f"{'/'.join(SLOT_WRITERS)} may touch it (the "
                            "copy-on-write snapshot contract)"))
        has_apply = any(isinstance(n, ast.FunctionDef)
                        and n.name == "_apply_slots"
                        for n in ast.walk(sf.tree))
        if has_apply and not bumps_version:
            out.append(Violation(
                self.name, sf.rel, 1,
                "_apply_slots() never bumps `.version` — every slot write "
                "must advance the version the k-NN caches key on"))
        return out

    def _check_version_bumps(self, sf) -> list[Violation]:
        """Module-level functions applying upserts/tombstones to a
        partition must call bump_store_version (methods of VectorStore
        write through _apply_slots and are covered above)."""
        if sf.tree is None:
            return []
        out = []
        for fn in sf.tree.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            applies = any(isinstance(n, ast.Call)
                          and isinstance(n.func, ast.Attribute)
                          and n.func.attr in ("upsert", "tombstone")
                          for n in ast.walk(fn))
            bumps = any(isinstance(n, ast.Call)
                        and _call_name(n) == "bump_store_version"
                        for n in ast.walk(fn))
            if applies and not bumps:
                out.append(Violation(
                    self.name, sf.rel, fn.lineno,
                    f"{fn.name}() applies a vector mutation but never "
                    "calls bump_store_version() — version-keyed caches "
                    "would serve stale k-NN answers"))
        return out

    # ------------------------------------------------------------------
    # lock + annotation discipline (telemetry-gate posture)
    # ------------------------------------------------------------------
    def _check_leaf_locks(self, sf) -> list[Violation]:
        made: dict[str, int] = {}
        declared: set[str] = set()
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fname = _call_name(node)
            s = _str_const(node.args[0])
            if s is None:
                continue
            if fname in ("make_lock", "make_rlock", "make_condition"):
                made.setdefault(s, node.lineno)
            elif fname == "declare_leaf":
                declared.add(s)
        out = [Violation(
            self.name, sf.rel, line,
            f"vector lock {name!r} is not declared a lockdep leaf in "
            f"{sf.rel} — slot swaps and slice claims are innermost by "
            "construction (declare_leaf) so lockdep flags any "
            "acquisition under them")
            for name, line in sorted(made.items())
            if name not in declared and name not in NON_LEAF_LOCKS]
        out.extend(Violation(
            self.name, sf.rel, made.get(name, 1),
            f"vector lock {name!r} is declared a lockdep leaf but listed in "
            "analysis/vectorgate.py::NON_LEAF_LOCKS (stale entry)")
            for name in sorted(declared & set(NON_LEAF_LOCKS)))
        return out

    def _check_init_annotations(self, sf) -> list[Violation]:
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
                    if not any(tok in sf.comment(node.lineno)
                               for tok in _ANNOTATIONS):
                        out.append(Violation(
                            self.name, sf.rel, node.lineno,
                            f"shared vector-plane structure "
                            f"{cls.name}.{tgt.attr} carries no "
                            "`# guarded by:` / `# lock-free:` annotation "
                            "— declare its concurrency contract where it "
                            "is created"))
        return out
