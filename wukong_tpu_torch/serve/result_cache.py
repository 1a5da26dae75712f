"""The version-keyed result cache: the serving plane's rung i.

The port's copy of the JAX package's serve/result_cache.py, an actuator
over the serving-cache observatory (obs/reuse.py):

- **The key is the shadow cache's key, verbatim**: ``classify(q)``'s
  material (plan-cache signature digest + abstracted constants + filters
  + projection + blind mode) plus the PLAN-time store version
  (``q._rver`` — the version the read executed under, stashed where the
  plan cache read it). A write landing between plan and reply can never
  file a result under a version the read did not see.
- **Admission reads the observatory, never its own counters**: a reply
  is admitted only when the popularity ledger's arrival/cacheability
  verdict for its template says yes — read through
  :func:`wukong_tpu_torch.obs.reuse.read_cache_input` by the
  ``CACHE_INPUTS`` names declared in :data:`CONSUMED_INPUTS`. With
  ``enable_reuse`` off the ledger is empty and the cache admits nothing.
- **Request collapsing**: concurrent misses on the same key elect ONE
  leader; followers wait on the leader's settlement and re-probe — a
  thundering herd on a hot template costs one execution, not N.
- **Bounded bytes** (``result_cache_mb``): entries are evicted by held
  bytes; an entry over a quarter of the budget is refused outright.
- **Invalidation is the journaled ``cache.invalidate`` edges**
  (:data:`MUTATION_EDGES`, keys == ``INVALIDATION_CAUSES``): insert
  batches and stream epochs drop stale-version entries (or re-key them
  when a materialized view proves the template untouched — serve/views.py,
  rung ii); recovery restore purges conservatively.

Result tables are stored write-protected (``setflags(write=False)``) and
handed back by reference: a hit costs dict probes and metadata copies,
never an array copy, and any downstream mutation attempt raises instead of
corrupting the cached bytes. The port's replies carry host NumPy tables
(the GPU engine copies its result to the host), so a hit launches no
kernel and makes no device sync; a reply whose table is not a NumPy array
(a tensor on the card) is refused, so no CUDA tensor enters the cache.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np

from wukong_tpu_torch.analysis.lockdep import declare_leaf, make_lock
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.types import AttrType
from wukong_tpu_torch.utils.timer import get_usec

_SID = int(AttrType.SID_t)

#: every observatory signal this cache's admission path consumes, by its
#: ``CACHE_INPUTS`` name — read exclusively through
#: ``obs.reuse.read_cache_input``
CONSUMED_INPUTS = ("template_popularity", "uncacheable")

#: what the serving plane does on each journaled mutation edge. The keys
#: must equal ``obs/reuse.py::INVALIDATION_CAUSES`` exactly (a test holds
#: them): a mutation class the observatory journals but the actuator
#: ignores would serve stale bytes silently.
MUTATION_EDGES = {
    "insert": "drop stale-version entries; re-key entries whose "
              "materialized view proves the template untouched",
    "epoch": "drop stale-version entries; re-key entries whose "
             "materialized view proves the template untouched",
    "cutover": "conservative full purge (read-path swap: version "
               "counters are not comparable across the publication)",
    "restore": "conservative full purge (checkpointed world: restored "
               "versions are not comparable to the cached keys')",
    "vector": "drop stale-version entries (embedding mutations carry no "
              "triples, so no view can prove a template untouched — every "
              "key re-keys at the bumped version or dies)",
}

#: ceiling on a follower's wait for its leader's settlement (a wedged
#: leader surfaces as a plain miss, never a hung client); the member's
#: own deadline tightens it further
COLLAPSE_WAIT_S = 60.0

# entries / in-flight leader table / promotion votes are dict updates
# only — innermost by construction, like reuse.ledger/reuse.shadow (the
# probe fires from the serving path, the edge hook under the WAL
# mutation lock; nothing is ever acquired under it)
declare_leaf("serve.cache")

_M_CACHE = get_registry().counter(
    "wukong_result_cache_total",
    "Real result-cache outcomes (hit/miss per probe; fill/evict/killed "
    "per entry; collapsed per follower served off a leader's execution; "
    "refused per reply the admission rules rejected)",
    labels=("result",))
_M_DIVERGE = get_registry().counter(
    "wukong_cache_divergence_total",
    "Probes where the real result cache and the shadow cache disagreed "
    "on the same key (hit vs miss)")

# pre-resolved label children for the per-probe outcomes: labels() costs
# a kwargs hash + dict probe per call, and the hit path pays it per reply
_C_HIT = _M_CACHE.labels(result="hit")
_C_MISS = _M_CACHE.labels(result="miss")
_C_FILL = _M_CACHE.labels(result="fill")
_C_REFUSED = _M_CACHE.labels(result="refused")


def _modifier_refusal(q) -> str | None:
    """Result-shaping modifiers and attribute patterns change the reply
    BYTES without changing the shadow key — a result cache must refuse
    them (the shadow's key covers the plan cache's refusals; these are
    the reply-side shapes only a byte cache cares about)."""
    if q.distinct or q.orders or q.limit >= 0 or q.offset > 0:
        return "modifier"
    if getattr(q, "mt_factor", 1) > 1:
        return "mt_factor"
    if any(p.pred_type != _SID for p in q.pattern_group.patterns):
        return "attr"
    return None


class _Entry:
    """One cached reply: the write-protected result table + the metadata
    needed to rebuild a byte-identical reply object."""

    __slots__ = ("version", "table", "v2c_map", "col_num", "nrows",
                 "blind", "required_vars", "nvars", "nbytes", "t_us",
                 "cost_us")

    def __init__(self, version: int, q) -> None:
        res = q.result
        table = res.table
        table.setflags(write=False)
        self.version = int(version)
        self.table = table
        self.v2c_map = dict(res.v2c_map)  # lock-free: write-once snapshot, never mutated after construction
        self.col_num = int(res.col_num)
        self.nrows = int(res.nrows)
        self.blind = bool(res.blind)
        self.required_vars = list(res.required_vars)  # lock-free: write-once snapshot, never mutated after construction
        self.nvars = int(res.nvars)
        self.nbytes = int(table.nbytes) + 256  # metadata overhead
        self.t_us = get_usec()
        # recompute cost: the leader's measured execution time (stamped
        # by _Lease.settle), else a rows-based estimate — the cost-model
        # admission bar and eviction scoring read this
        self.cost_us = (max(float(q.__dict__.get("_exec_us", 0.0)), 0.0)
                        or self.nrows * 2.0 + 50.0)


class _Lease:
    """The leader's obligation: settle (fill on success, or just release)
    exactly once, waking every follower queued on the key."""

    __slots__ = ("cache", "key", "version", "event", "_settled", "t0_us")

    def __init__(self, cache: "ResultCache", key, version: int,
                 event: threading.Event) -> None:
        self.cache = cache
        self.key = key
        self.version = version
        self.event = event
        self._settled = False
        self.t0_us = get_usec()  # recompute-cost clock (cost model)

    def settle(self, q) -> None:
        if self._settled:  # idempotent: finally-paths may double-call
            return
        self._settled = True
        # the lease's lifetime IS the leader's execution: stamp the
        # recompute cost for the fill's cost-model admission (unless an
        # outer layer already measured it more precisely)
        if "_exec_us" not in q.__dict__:
            q._exec_us = get_usec() - self.t0_us
        try:
            self.cache.fill(self.key, self.version, q)
        finally:
            with self.cache._lock:
                if self.cache._inflight.get(self.key) is self.event:
                    self.cache._inflight.pop(self.key, None)
            self.event.set()


class ResultCache:
    """Bounded-bytes version-keyed full-result cache with request
    collapsing. One live version per key material: a fill replaces any
    older-version entry (which a version bump made unreachable anyway).
    """

    def __init__(self, capacity_mb: int | None = None):
        self._capacity_mb = capacity_mb
        self._lock = make_lock("serve.cache")
        self._entries: OrderedDict = OrderedDict()  # guarded by: _lock
        # key -> the collapsing leader's settlement Event
        self._inflight: dict = {}  # guarded by: _lock
        # version-edge promotion votes: material -> (last fill version,
        # edge-refill count) — the rung-ii promotion signal ("stays hot
        # across version edges"), bounded like reuse._DIGESTS
        self._votes: dict = {}  # guarded by: _lock
        self._votes_cap = 8192
        # (query text, blind) -> key material, learned at fill time: the
        # zero-parse fast path resolves repeated texts straight to their
        # cache key, skipping parse + plan entirely on a hit. Bounded
        # like _votes; entries never go stale (a text's material depends
        # only on the text — version freshness is checked per probe).
        self._texts: dict = {}  # guarded by: _lock
        self.bytes_held = 0  # guarded by: _lock
        self.hits = 0  # guarded by: _lock
        self.misses = 0  # guarded by: _lock
        self.fills = 0  # guarded by: _lock
        self.evicts = 0  # guarded by: _lock
        self.killed = 0  # guarded by: _lock
        self.collapsed = 0  # guarded by: _lock
        self.refused = 0  # guarded by: _lock
        self.purges = 0  # guarded by: _lock
        # rung-ii wiring (set by the ServePlane): called as
        # on_promote(material, text) when a key's votes cross
        # view_promote_edges
        self.on_promote = None

    def _cap_bytes(self) -> int:
        mb = self._capacity_mb or max(int(Global.result_cache_mb), 1)
        return int(mb) << 20

    # ------------------------------------------------------------------
    # the serving path
    # ------------------------------------------------------------------
    def acquire(self, q) -> tuple[bool, "_Lease | None"]:
        """One serving-path probe for a PLANNED query. Returns
        ``(served, lease)``: served=True installed a cached reply (done);
        otherwise the caller must execute, and a non-None lease makes it
        the key's collapsing leader (settle it in a finally)."""
        from wukong_tpu_torch.obs.reuse import classify

        version = q.__dict__.get("_rver")
        if version is None:  # no plan-time version: user plan file etc.
            return False, None
        reason = _modifier_refusal(q)
        if reason is None:
            key, reason = classify(q)
            # the reply-side observatory reuses this verdict instead of
            # re-classifying (modifier refusals are NOT stashed: their
            # reasons are cache-local, not UNCACHEABLE_REASONS members)
            q._ckey = (key, reason)
        if reason is not None:
            _C_REFUSED.inc()
            with self._lock:
                self.refused += 1
            return False, None
        served, lease, wait = self._probe(key, int(version), q)
        if wait is None:
            return served, lease
        # follower: wait out the leader's execution, then re-probe once
        timeout = COLLAPSE_WAIT_S
        dl = getattr(q, "deadline", None)
        if dl is not None:
            rem = dl.remaining_s()
            if rem is not None:
                timeout = min(max(rem, 0.0), COLLAPSE_WAIT_S)
        wait.wait(timeout)
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None and ent.version == int(version):
                self._entries.move_to_end(key)
                self.hits += 1
                self.collapsed += 1
            else:
                ent = None
                self.misses += 1
        if ent is not None:
            _C_HIT.inc()
            _M_CACHE.labels(result="collapsed").inc()
            self._install(q, ent)
            return True, None
        # the leader failed or was refused admission: execute directly
        # (no new lease — a failing key must not convoy its followers)
        _C_MISS.inc()
        q._rc_probe = "miss"
        return False, None

    def _probe(self, key, version: int, q):
        """(served, lease, wait_event) under one lock acquisition."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None and ent.version == version:
                self._entries.move_to_end(key)
                self.hits += 1
                hit = ent
            else:
                hit = None
                ev = self._inflight.get(key)
                if ev is not None:
                    return False, None, ev  # follower: wait outside
                self._inflight[key] = ev = threading.Event()
                lease = _Lease(self, key, version, ev)
                self.misses += 1
        if hit is not None:
            _C_HIT.inc()
            self._install(q, hit)
            return True, None, None
        _C_MISS.inc()
        q._rc_probe = "miss"
        return False, lease, None

    def fast_probe(self, text: str, blind: bool, version: int):
        """The zero-parse fast path's probe: resolve a repeated query
        text straight to its key material (learned at fill time) and
        return ``(key, entry)`` on a fresh-version hit, else None — the
        caller falls through to the full parse/plan/probe path. Counts
        as a hit; misses are NOT counted here (the slow path will probe
        and count the same key properly)."""
        with self._lock:
            key = self._texts.get((text, blind))
            if key is None:
                return None
            ent = self._entries.get(key)
            if ent is None or ent.version != version:
                return None
            self._entries.move_to_end(key)
            self.hits += 1
        _C_HIT.inc()
        return key, ent

    def build_reply(self, key, ent: "_Entry"):
        """A reply shell for a fast-path hit: a fresh SPARQLQuery with
        the cached result installed and the classification verdict
        stashed (the reply-side observatory never needs the patterns)."""
        from wukong_tpu_torch.sparql.ir import SPARQLQuery

        q = SPARQLQuery()
        self._install(q, ent)
        res = q.result
        res.required_vars = list(ent.required_vars)
        res.nvars = ent.nvars
        q._ckey = (key, None)
        q._rver = ent.version
        return q

    def _vote_locked(self, key, version: int) -> int:  # caller holds: _lock
        """Promotion bookkeeping at fill time: a re-fill at a NEWER
        version than the key's last fill means the template stayed hot
        across a store-version edge — rung ii's promotion signal.
        Returns the key's accumulated edge votes."""
        if len(self._votes) >= self._votes_cap:
            self._votes.clear()  # rare full reset beats an LRU here
        last, n = self._votes.get(key, (None, 0))
        if last is not None and last < version:
            n += 1
        self._votes[key] = (version, n)
        return n

    @staticmethod
    def _install(q, ent: "_Entry") -> None:
        """Rebuild the reply from a cached entry (the table is shared,
        write-protected; metadata is copied)."""
        from wukong_tpu_torch.utils.errors import ErrorCode

        res = q.result
        res.status_code = ErrorCode.SUCCESS
        res.complete = True
        res.dropped_patterns = []
        res.table = ent.table
        res.nrows = ent.nrows
        res.col_num = ent.col_num
        res.v2c_map = dict(ent.v2c_map)
        res.blind = ent.blind
        q.pattern_step = len(q.pattern_group.patterns)
        q._rc_probe = "hit"

    # ------------------------------------------------------------------
    # fills + admission
    # ------------------------------------------------------------------
    @staticmethod
    def _admit_bar(ent: "_Entry") -> int:
        """The popularity bar this entry must clear, cost-weighted
        (``result_cache_cost_model``): bytes held per microsecond of
        recompute saved is the caching-benefit density — a bulky reply
        that recomputes cheaply must prove 2-4x the popularity before it
        may displace working-set bytes, while compact expensive entries
        keep the base bar. Off-knob: the flat ``result_cache_min_reads``."""
        base = max(int(Global.result_cache_min_reads), 0)
        if not Global.result_cache_cost_model:
            return base
        density = ent.nbytes / max(ent.cost_us, 1.0)  # bytes per us saved
        if density >= 4096.0:
            return max(base, 1) * 4
        if density >= 512.0:
            return max(base, 1) * 2
        return base

    def _pick_victim_locked(self, keep):  # caller holds: _lock
        """Eviction victim: pure LRU head off-knob; with the cost model
        on, the LOWEST benefit score (recompute us per byte held) among
        the 8 oldest entries — a cheap-to-recompute giant goes before an
        expensive small entry even when slightly fresher. ``keep`` (the
        just-filled key) is never chosen."""
        it = (k for k in self._entries if k != keep)
        victim = next(it)
        if not Global.result_cache_cost_model:
            return victim
        best = (self._entries[victim].cost_us
                / max(self._entries[victim].nbytes, 1))
        for _ in range(7):
            k = next(it, None)
            if k is None:
                break
            s = self._entries[k].cost_us / max(self._entries[k].nbytes, 1)
            if s < best:
                victim, best = k, s
        return victim

    def fill(self, key, version: int, q) -> bool:
        """Admit one executed reply (the leader's settlement path).
        Admission: SUCCESS + complete, the popularity ledger's verdict
        for the template (read through the ``CACHE_INPUTS`` map), and
        the byte bound."""
        from wukong_tpu_torch.obs.reuse import read_cache_input
        from wukong_tpu_torch.utils.errors import ErrorCode

        res = q.result
        if (res.status_code != ErrorCode.SUCCESS or not res.complete
                or not isinstance(res.table, np.ndarray)):
            # host bytes only: a table on the card would pin device memory
            # in the cache and make every hit a device read
            _C_REFUSED.inc()
            with self._lock:
                self.refused += 1
            return False
        # the popularity/cacheability verdict, with THIS reply counted as
        # its own evidence (the ledger charges at the reply point, after
        # this fill): reads+1 must clear the arrival bar — weighted by
        # the entry's cost model (cheap-to-recompute giants must prove
        # MORE popularity) — and a template never seen before is clean
        # by definition
        ent = _Entry(version, q)
        v = read_cache_input("template_popularity", template=key[0])
        unc = read_cache_input("uncacheable", template=key[0])
        if (v["reads"] + 1 < self._admit_bar(ent)
                or (v["reads"] > 0 and sum(unc.values()) > 0)):
            _C_REFUSED.inc()
            with self._lock:
                self.refused += 1
            return False
        cap = self._cap_bytes()
        if ent.nbytes > cap // 4:
            _C_REFUSED.inc()
            with self._lock:
                self.refused += 1
            return False
        evicted = 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes_held -= old.nbytes
                self.killed += 1  # the version bump already made it stale
            self._entries[key] = ent
            self.bytes_held += ent.nbytes
            self.fills += 1
            while self.bytes_held > cap and len(self._entries) > 1:
                _k = self._pick_victim_locked(keep=key)
                dead = self._entries.pop(_k)
                self.bytes_held -= dead.nbytes
                evicted += 1
            self.evicts += evicted
            votes = self._vote_locked(key, int(version))
            # teach the zero-parse fast path this text's key material
            text = q.__dict__.get("_qtext")
            if text:
                if len(self._texts) >= self._votes_cap:
                    self._texts.clear()
                self._texts[(text, ent.blind)] = key
        _C_FILL.inc()
        if old is not None:
            _M_CACHE.labels(result="killed").inc()
        if evicted:
            _M_CACHE.labels(result="evict").inc(evicted)
        # rung-ii promotion: the template survived view_promote_edges
        # version edges while staying hot — hand it to the view registry
        if (self.on_promote is not None and Global.enable_views
                and votes >= max(int(Global.view_promote_edges), 1)):
            text = q.__dict__.get("_qtext")
            if text:
                self.on_promote(key, text)
        return True

    # ------------------------------------------------------------------
    # mutation edges (ServePlane.on_mutation; caller holds the WAL
    # mutation lock on insert/epoch edges)
    # ------------------------------------------------------------------
    def apply_edge(self, new_version: int, survivors) -> int:
        """One append-only version edge: entries whose material a
        materialized view proved untouched are re-keyed to the new
        version (the hit survives the write); every other stale-version
        entry drops. Returns the kill count.

        Only entries at the IMMEDIATE pre-edge version re-key: this
        edge's survivorship proves only that THIS batch left the
        template's bytes unchanged. An entry that lagged further (a fill
        that raced an earlier edge landed at an older version while the
        template had no resident entry to judge) never received that
        edge's touch verdict — re-keying it could publish bytes a
        touching write already changed, so it drops instead. Mutation
        edges bump the host version by exactly one (one insert_triples
        per batch/epoch), so the pre-edge version is new_version - 1."""
        new_version = int(new_version)
        killed = 0
        with self._lock:
            for key in list(self._entries):
                ent = self._entries[key]
                if ent.version == new_version:
                    continue  # a racing fill already refreshed it
                if key in survivors and ent.version == new_version - 1:
                    ent.version = new_version
                else:
                    self.bytes_held -= ent.nbytes
                    del self._entries[key]
                    killed += 1
            self.killed += killed
        if killed:
            _M_CACHE.labels(result="killed").inc(killed)
        return killed

    def purge(self) -> int:
        """Conservative full purge (cutover/restore edges, world
        re-attach): every entry drops; in-flight leaders settle normally
        (their fills land at post-purge versions)."""
        with self._lock:
            killed = len(self._entries)
            self._entries.clear()
            self.bytes_held = 0
            self.killed += killed
            self.purges += 1
            self._votes.clear()
            # a purge may mean a NEW WORLD (attach/restore): the same
            # text then parses to different ids, so the text memo is
            # conservatively dropped with the entries
            self._texts.clear()
        if killed:
            _M_CACHE.labels(result="killed").inc(killed)
        return killed

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            probes = self.hits + self.misses
            return {"hits": self.hits, "misses": self.misses,
                    "hit_rate": (round(self.hits / probes, 4)
                                 if probes else None),
                    "entries": len(self._entries),
                    "bytes_held": self.bytes_held,
                    "capacity_bytes": self._cap_bytes(),
                    "fills": self.fills, "evicts": self.evicts,
                    "killed": self.killed, "collapsed": self.collapsed,
                    "refused": self.refused, "purges": self.purges,
                    "inflight": len(self._inflight)}

    def hit_rate(self) -> float | None:
        with self._lock:
            n = self.hits + self.misses
            return self.hits / n if n else None

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()
            self._votes.clear()
            self._texts.clear()
            self.bytes_held = 0
            self.hits = self.misses = self.fills = self.evicts = 0
            self.killed = self.collapsed = self.refused = self.purges = 0


# ---------------------------------------------------------------------------
# real-vs-shadow divergence (the observatory stays honest about itself)
# ---------------------------------------------------------------------------

_diverged = 0  # lock-free: GIL-atomic int bump; an approximate tally feeding a counter


def note_shadow_outcome(q, shadow_hit) -> None:
    """Fold the shadow cache's verdict for THIS reply against the real
    cache's (stamped on the query at probe time): a disagreement on the
    same key means the observatory's prediction model has drifted from
    the actuator it predicts — counted, never corrected silently."""
    global _diverged
    if shadow_hit is None:
        return
    real = q.__dict__.get("_rc_probe")
    if real is None:
        return
    if (real == "hit") != bool(shadow_hit):
        _diverged += 1
        _M_DIVERGE.inc()


def divergence_total() -> int:
    return _diverged


def reset_divergence() -> None:
    global _diverged
    _diverged = 0


# registry pull gauges: scrape-time reads of the live cache (the plane
# singleton resolves lazily so import order never matters)
def _plane_cache():
    from wukong_tpu_torch.serve import get_serve

    return get_serve().cache


get_registry().gauge(
    "wukong_result_cache_bytes",
    "Result bytes held by the real serving cache"
).set_function(lambda: _plane_cache().stats()["bytes_held"])
get_registry().gauge(
    "wukong_result_cache_entries",
    "Entries resident in the real serving cache"
).set_function(lambda: _plane_cache().stats()["entries"])
