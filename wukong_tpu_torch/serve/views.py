"""Materialized hot-template views: the serving plane's rung ii.

The port's copy of the JAX package's serve/views.py. Rung i's result cache
dies on every store-version edge. This module is the Wukong+S answer — a hot
template that stays hot across version edges is promoted into an
*incrementally maintained* standing result, so its cache entry survives
writes instead of dying on every version bump.

The machinery is deliberately NOT new: a promoted template is registered
through :class:`wukong_tpu_torch.stream.continuous.ContinuousEngine` — the
semi-naive delta planner. Registration buys three things:

- **the rejection rules**: UNION / OPTIONAL / variable predicates /
  ORDER/LIMIT/OFFSET / cartesian shapes raise ``UNSUPPORTED_SHAPE`` at
  registration, exactly the shapes with no incremental semantics — the
  template is banned back to plain (version-keyed) cache entries;
- **the per-term plans**: each pattern's frontier-seeded remainder,
  planned once (``plan_seeded_group``), replayed per edge;
- **the SupportIndex**: per-result evidence bookkeeping, armed so the
  windowed retraction path (windows.py) applies unchanged if a view is
  ever scoped to a window (the append-only main store never retires
  epochs, so retraction never fires here — evidence is telemetry).

Per mutation edge (insert batch / stream epoch — called INSIDE the
WAL-mutation-locked commit, so a view is never visible at a version it
doesn't match) each view runs the semi-naive term union over the batch:
seed pattern i's frontier from the epoch delta (``match_delta``), run
the planned remainder against the merged store, and count DERIVED ROWS
— not fresh-vs-seen rows, because a duplicate derivation of an
already-known row still appends a duplicate row to the uncached reply
(non-dedup inserts are real), and byte-identity is the contract. Zero
derived rows across every term proves the template's reply bytes are
unchanged by the edge: the cache entry is RE-KEYED to the new version
and the hit survives the write. Any derived row marks the view touched:
its entry drops and the next read re-fills it at the new version (the
lazy refresh — the mutation-locked commit pays only the delta
evaluation, never a full re-execution).

Demotion (``view_demote_touch_pct``): a view touched on most recent
edges is paying delta evaluation per write for no surviving hits — it
is demoted back to plain cache entries, like a registration rejection.

Every view's frontier for one edge is one batched device computation
(stream/continuous.py ``device_seed_extract``) on the attached world's
``device``. As there, it degrades to the host masks only on ids past int32
and on the knobs; any other error, a CUDA one among them, reaches the
writer (the JAX registry catches any exception and latches host).
"""

from __future__ import annotations

from wukong_tpu_torch.analysis.lockdep import make_lock
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.utils.errors import WukongError
from wukong_tpu_torch.utils.logger import log_info, log_warn

_M_VIEWS = get_registry().counter(
    "wukong_views_total",
    "Materialized-view lifecycle events (promoted/rejected/demoted per "
    "template; survived/touched per view per mutation edge)",
    labels=("event",))
get_registry().gauge(
    "wukong_views_registered",
    "Templates currently maintained as materialized views"
).set_function(lambda: _registered_count())


def _registered_count() -> int:
    from wukong_tpu_torch.serve import get_serve

    return get_serve().views.count()


class MaterializedView:
    """One promoted template: its standing-query registration plus the
    maintenance-economics counters the demotion rule reads."""

    __slots__ = ("material", "text", "qid", "edges_seen", "touched",
                 "survived")

    def __init__(self, material, text: str, qid: int):
        self.material = material
        self.text = text
        self.qid = qid
        self.edges_seen = 0
        self.touched = 0
        self.survived = 0


class ViewRegistry:
    """The promoted-template registry over one host partition.

    ``_lock`` is an ordinary tracked lock (NOT a lockdep leaf): it is
    held across standing-query registration and per-edge delta
    evaluation, both of which execute engine queries. ``on_mutation``
    additionally runs under the WAL mutation lock (its caller's), so
    maintenance is serialized against commits by construction.
    """

    def __init__(self):
        self._lock = make_lock("serve.views")
        # material -> MaterializedView / rejected+demoted materials /
        # the lazy ContinuousEngine + CPUEngine over the attached world
        self._views: dict = {}  # guarded by: _lock
        self._banned: set = set()  # guarded by: _lock
        self._ce = None  # guarded by: _lock
        self._engine = None  # guarded by: _lock
        self._g = None  # guarded by: _lock
        self._ss = None  # guarded by: _lock
        self.device = "cuda"  # guarded by: _lock
        self.promoted = 0  # guarded by: _lock
        self.rejected = 0  # guarded by: _lock
        self.demoted = 0  # guarded by: _lock

    # ------------------------------------------------------------------
    def attach(self, gstore, str_server, device="cuda") -> None:
        """Bind to a (new) serving world: registrations from the old
        world are dropped wholesale — their plans reference its store.
        ``device`` is where the views' epoch frontier runs."""
        with self._lock:
            self.device = device
            if self._g is gstore:
                return
            self._g = gstore
            self._ss = str_server
            self._ce = None
            self._engine = None
            self._views.clear()
            self._banned.clear()

    def count(self) -> int:
        with self._lock:
            return len(self._views)

    # ------------------------------------------------------------------
    def promote(self, material, text: str) -> bool:
        """Register one hot template as a maintained view. Shapes the
        delta planner rejects (UNION/OPTIONAL/var-pred/LIMIT/cartesian)
        are banned back to plain cache entries."""
        if not Global.enable_views or not text:
            return False
        with self._lock:
            if (self._g is None or material in self._views
                    or material in self._banned):
                return False
            if len(self._views) >= max(int(Global.views_max), 1):
                return False
            if self._ce is None:
                from wukong_tpu_torch.engine.cpu import CPUEngine
                from wukong_tpu_torch.stream.continuous import ContinuousEngine

                self._engine = CPUEngine(self._g, self._ss)
                self._ce = ContinuousEngine(self._g, self._ss,
                                            engine=self._engine,
                                            device=self.device)
            try:
                qid = self._ce.register(text)
            except WukongError as e:
                # the delta-eval rejection rules: no incremental
                # semantics for this shape — plain cache entries only
                self._banned.add(material)
                self.rejected += 1
                _M_VIEWS.labels(event="rejected").inc()
                log_info(f"view promotion rejected ({e.code.name}): "
                         f"{text[:80]!r}")
                return False
            sq = self._ce.queries[qid]
            if sq.support is None:
                # arm the per-result evidence ledger (windows.py): the
                # retraction machinery's input, telemetry on the
                # append-only main store
                from wukong_tpu_torch.stream.windows import SupportIndex

                sq.support = SupportIndex()
                sq.support.note_base(sq.seen)
            self._views[material] = MaterializedView(material, text, qid)
            self.promoted += 1
        _M_VIEWS.labels(event="promoted").inc()
        log_info(f"template promoted to a materialized view "
                 f"({material[0]}): {text[:80]!r}")
        return True

    # ------------------------------------------------------------------
    def on_mutation(self, triples, version: int) -> set:
        """One append-only edge (caller holds the WAL mutation lock):
        run every view's semi-naive term union over the batch and return
        the set of SURVIVOR materials — templates whose reply bytes the
        edge provably did not change. Touched views count toward the
        demotion rule."""
        import numpy as np

        survivors: set = set()
        if triples is None:
            return survivors
        triples = np.asarray(triples)
        with self._lock:
            if not self._views or self._ce is None:
                return survivors
            # epoch-batched device frontier: EVERY view's per-term seed
            # extraction for this edge is one device computation; None
            # (host knob / small epoch / ids past int32) keeps the
            # per-term host path, byte-identical by construction
            from wukong_tpu_torch.stream.continuous import device_seed_extract

            flat: list = []
            spans: dict = {}
            for material, view in self._views.items():
                sq = self._ce.queries.get(view.qid)
                if sq is None:
                    continue
                spans[material] = (len(flat), len(flat) + len(sq.patterns))
                flat.extend(sq.patterns)
            all_seeds = device_seed_extract(flat, triples, owner=self)
            demote = []
            for material, view in self._views.items():
                sq = self._ce.queries.get(view.qid)
                if sq is None:
                    demote.append(material)
                    continue
                view.edges_seen += 1
                lo, hi = spans.get(material, (0, 0))
                touched = self._derives_rows(
                    sq, triples, version,
                    seeds=(all_seeds[lo:hi] if all_seeds is not None
                           else None))
                if touched:
                    view.touched += 1
                    _M_VIEWS.labels(event="touched").inc()
                else:
                    view.survived += 1
                    survivors.add(material)
                    _M_VIEWS.labels(event="survived").inc()
                # maintenance economics: a view touched on most edges
                # pays delta evaluation per write for no surviving hits
                pct = max(int(Global.view_demote_touch_pct), 1)
                if (view.edges_seen >= 8
                        and view.touched * 100 > pct * view.edges_seen):
                    demote.append(material)
            for material in demote:
                self._demote_locked(material)
        return survivors

    def _derives_rows(self, sq, triples, version: int,  # caller holds: _lock
                      seeds=None) -> bool:
        """The semi-naive term union, counting DERIVED rows (duplicates
        included): True when the batch contributes >=1 complete
        derivation — the reply bytes changed. Term failures are
        conservative touches (degraded, never a stale hit). ``seeds``
        carries this view's slice of the epoch-batched device frontier
        (on_mutation's single fused dispatch); None runs the per-term
        host extraction."""
        from wukong_tpu_torch.stream.continuous import match_delta
        from wukong_tpu_torch.utils.errors import ErrorCode

        derived = set()
        for i, pat in enumerate(sq.patterns):
            if seeds is not None:
                vars_, seed = seeds[i]
            else:
                vars_, seed = match_delta(pat, triples)
            if len(seed) == 0:
                continue
            q = self._ce._make_delta_query(sq, i, vars_, seed)
            try:
                out = self._engine.execute(q, from_proxy=False)
            except Exception as e:
                log_warn(f"view delta term {i} failed: {e!r}")
                return True
            if out.result.status_code != ErrorCode.SUCCESS:
                return True
            if out.result.nrows > 0:
                try:
                    derived |= self._ce._project(out.result,
                                                 sq.required_vars)
                except WukongError:
                    return True
        if derived:
            # evidence for the retraction machinery + the standing set
            # (the rows now derivable through this epoch's triples)
            if sq.support is not None:
                sq.support.note_epoch(version, derived)
            sq.seen |= derived
            return True
        return False

    def _demote_locked(self, material) -> None:  # caller holds: _lock
        view = self._views.pop(material, None)
        if view is None:
            return
        self._banned.add(material)
        self.demoted += 1
        try:
            self._ce.unregister(view.qid)
        except WukongError:
            pass
        _M_VIEWS.labels(event="demoted").inc()
        log_info(f"materialized view demoted (touched "
                 f"{view.touched}/{view.edges_seen} edges): "
                 f"{view.text[:80]!r}")

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            views = [{"template": v.material[0], "edges": v.edges_seen,
                      "touched": v.touched, "survived": v.survived,
                      "text": v.text[:96]}
                     for v in self._views.values()]
            return {"registered": len(self._views),
                    "capacity": max(int(Global.views_max), 1),
                    "promoted": self.promoted,
                    "rejected": self.rejected,
                    "demoted": self.demoted,
                    "banned": len(self._banned),
                    "views": views}

    def reset(self) -> None:
        with self._lock:
            self._views.clear()
            self._banned.clear()
            self._ce = None
            self._engine = None
            self.promoted = self.rejected = self.demoted = 0
