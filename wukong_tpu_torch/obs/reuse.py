"""Serving-cache observatory: template popularity, shadow cache, invalidation.

The port's copy of the JAX package's obs/reuse.py: the result cache's
(serve/result_cache.py) decision substrate, which says what hit rate a
version-keyed result cache would achieve and which mutation paths
invalidate it. Three planes, all observe-only (the store and the replies
are never touched — ``Emulator.run_readmostly`` pins the content digest):

- :class:`TemplatePopularityLedger` — charged at the proxy's reply point:
  per-template (plan-cache signature, constants abstracted) read counts,
  windowed arrival rates, tenant attribution, store-version-at-read, and
  a Zipf-skew estimate over the template popularity ranking.
- :class:`ShadowCache` — a bounded version-keyed key ring holding KEYS
  ONLY (key = plan signature + consts + store version, the result cache's
  key; no results are stored): every served query simulates
  hit/miss/fill/evict, reporting the achievable hit rate, a bytes-saved
  estimate (rows x payload width), the staleness window between version
  bumps, and per-template cacheability verdicts — uncacheable shapes
  (corun / ambiguous-const / planner-empty / partial / error) classified
  by exactly the :class:`~wukong_tpu_torch.runtime.batcher.PlanCache`
  rules.
- **invalidation telemetry** — every store-mutation path (dynamic insert
  batches, stream epochs, recovery restore, vector batches) calls
  :func:`maybe_note_invalidation`, which kills the stale shadow keys and
  journals a ``cache.invalidate`` ClusterEvent carrying the version edge
  and the kill count.

``CACHE_INPUTS`` maps every signal the result cache reads to the
registered metric behind it. Surfaced as the ``cache`` console verb
(:func:`render_cache`) and the Monitor's ``Cache[...]`` line. Everything
is gated on ``enable_reuse`` (default on, as in the JAX package: the
per-reply cost is a few leaf-lock updates); off, every hook is one knob
check. ``reuse_sample_every`` samples the shadow probe (1 = every reply).
A migration cutover (runtime/migration.py) notes the ``cutover`` edge, a
conservative full purge.
"""

from __future__ import annotations

import math
import zlib
from collections import OrderedDict, deque

from wukong_tpu_torch.analysis.lockdep import (
    declare_leaf,
    make_lock,
    register_global_lock,
)
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.types import NORMAL_ID_START
from wukong_tpu_torch.utils.errors import ErrorCode
from wukong_tpu_torch.utils.timer import get_usec

#: every signal the result cache reads, mapped to the registered metric
#: that backs it (scrape-able truth for each number a caching decision
#: consumes); every tsdb trend read in this module stays inside this map
CACHE_INPUTS = {
    "template_popularity": "wukong_reuse_template_reads_total",
    "shadow_outcomes": "wukong_reuse_shadow_total",
    "predicted_hit_rate": "wukong_reuse_hit_rate",
    "bytes_saved": "wukong_reuse_bytes_saved_total",
    "staleness_window": "wukong_reuse_staleness_s",
    "invalidations": "wukong_reuse_invalidations_total",
    "keys_killed": "wukong_reuse_keys_killed_total",
    "uncacheable": "wukong_reuse_uncacheable_total",
    "zipf_skew": "wukong_reuse_zipf_alpha",
    "parse_cache": "wukong_parse_cache_total",
    "plan_cache": "wukong_plan_cache_total",
}

#: the store-mutation paths that must invalidate a version-keyed result
#: cache (each has a maybe_note_invalidation call site): dynamic insert
#: batches, stream epochs, migration cutover (the distributed engine's),
#: recovery restore, vector upsert/tombstone batches (vector/vstore.py —
#: embedding mutations bump the store version too, so cached knn replies
#: never survive them)
INVALIDATION_CAUSES = ("insert", "epoch", "cutover", "restore", "vector")

#: why a reply could not have been served from a version-keyed result
#: cache — mirroring PlanCache's uncacheable rules (shape/planner_empty/
#: corun/ambiguous_const are build_plan_recipe's exact refusals) plus the
#: reply-side classes a result cache must never store
UNCACHEABLE_REASONS = ("shape", "planner_empty", "corun", "ambiguous_const",
                       "partial", "error")

#: the bounded-cardinality catch-all template label (the tenant-label
#: posture: a workload minting unbounded template shapes must not mint
#: unbounded metric series)
OVERFLOW_TEMPLATE = "__overflow__"

#: "no stashed signature" sentinel (None is a meaningful sig value)
_UNSET = object()

# every lock here guards dict/deque/int updates only — innermost by
# construction, like heat.shard/slo.tenants (probes and charges fire from
# the proxy reply path, outside every other tracked lock; the
# cache.invalidate event is emitted AFTER the shadow lock releases, since
# events.ring is itself a leaf)
declare_leaf("reuse.ledger")
declare_leaf("reuse.shadow")

_M_READS = get_registry().counter(
    "wukong_reuse_template_reads_total",
    "Template+const reads charged at the proxy reply point",
    labels=("template",))
_M_SHADOW = get_registry().counter(
    "wukong_reuse_shadow_total",
    "Shadow-cache probe outcomes (observe-only simulation)",
    labels=("result",))
_M_UNCACHEABLE = get_registry().counter(
    "wukong_reuse_uncacheable_total",
    "Replies a version-keyed result cache could not serve, by reason",
    labels=("reason",))
_M_INVALID = get_registry().counter(
    "wukong_reuse_invalidations_total",
    "Store-mutation invalidation edges observed, by cause",
    labels=("cause",))
_M_KILLED = get_registry().counter(
    "wukong_reuse_keys_killed_total",
    "Shadow keys killed by invalidation edges")
_M_SAVED = get_registry().counter(
    "wukong_reuse_bytes_saved_total",
    "Estimated result bytes a cache hit would not have recomputed")
_M_STALE = get_registry().histogram(
    "wukong_reuse_staleness_s",
    "Seconds between consecutive store-version invalidation edges",
    buckets=(0.01, 0.1, 1, 5, 15, 60, 300, 1800, 7200))

# pre-resolved shadow-outcome children: the probe pays labels()'s kwargs
# hash per reply otherwise (the serve plane's hot-path discipline)
_C_SHADOW_HIT = _M_SHADOW.labels(result="hit")
_C_SHADOW_MISS = _M_SHADOW.labels(result="miss")


# signature -> digest memo: repr+crc32 per reply was the observe hook's
# single biggest cost on the serving micro; distinct signatures are
# bounded in practice (and the dict is bounded here regardless)
_DIGESTS: dict = {}  # lock-free: GIL-atomic get/set of immutable values; worst case a racing reply recomputes the same digest
_DIGESTS_CAP = 4096


def _sig_digest(sig) -> str:
    """Process-stable template digest, the SAME ``sig:%08x`` form
    obs/profile.py ``template_key`` mints — attribution baselines and
    the cache verb's popularity rows correlate by construction."""
    d = _DIGESTS.get(sig)
    if d is None:
        d = f"sig:{zlib.crc32(repr(sig).encode()):08x}"
        if len(_DIGESTS) >= _DIGESTS_CAP:
            _DIGESTS.clear()  # rare full reset beats an LRU on this path
        _DIGESTS[sig] = d
    return d


def classify(q):
    """(shadow key material | None, uncacheable reason | None) for a
    PLANNED query — the structural half of the cacheability verdict,
    mirroring PlanCache's rules exactly: no template signature (unions /
    optionals / empty), planner-proved-empty plans (constant-dependent),
    corun, and positionally-ambiguous duplicate abstracted constants are
    the shapes ``build_plan_recipe`` refuses too. The reply-side classes
    (partial / error) are the observatory's call sites' business —
    :meth:`ReuseObservatory.observe` applies them."""
    # the proxy stashes the plan-time signature on the query (_tsig) so
    # the reply hook never re-walks the patterns; a query that skipped
    # the plan path (user plan file, hand-built test query) computes it
    sig = q.__dict__.get("_tsig", _UNSET) if hasattr(q, "__dict__") \
        else _UNSET
    if sig is _UNSET:
        from wukong_tpu_torch.runtime.batcher import template_signature

        sig = template_signature(q)
    if sig is None:
        return None, "shape"
    if q.planner_empty:
        return None, "planner_empty"
    if q.corun_enabled:
        return None, "corun"
    pg = q.pattern_group
    seen: dict[int, int] = {}
    preds = set()
    consts = []
    for p in pg.patterns:
        if p.predicate >= 0:
            preds.add(p.predicate)
        for v in (p.subject, p.object):
            if v >= NORMAL_ID_START:
                seen[v] = seen.get(v, 0) + 1
                consts.append(int(v))
    if any(n > 1 for v, n in seen.items() if v not in preds):
        # a duplicated abstracted constant is positionally ambiguous for
        # the plan recipe AND for const substitution in a cached result
        return None, "ambiguous_const"
    # a knn() clause changes the reply without changing the pattern
    # signature: the clause joins the key (anchor bytes for literal
    # vectors), so a hybrid query never collides with its knn-free twin
    # or with a different anchor/k/metric
    knn = getattr(q, "knn", None)
    key = (_sig_digest(sig), tuple(consts),
           repr(pg.filters) if pg.filters else "",
           tuple(q.result.required_vars), bool(q.result.blind))
    if knn is not None:
        key = key + ((int(knn.var), int(knn.k), str(knn.metric),
                      int(knn.anchor_vid) if knn.anchor_vid is not None
                      else knn.anchor_vec.tobytes()),)
    return key, None


def _payload_estimate(q) -> int:
    """Estimated result payload bytes: rows x live columns x int64 width.
    Shape arithmetic only — never touches the table's contents."""
    res = q.result
    return int(res.nrows) * max(int(getattr(res, "col_num", 0)), 1) * 8


# ---------------------------------------------------------------------------
# the template popularity ledger
# ---------------------------------------------------------------------------

class _TemplateStat:
    """One template's popularity record (mutated under the ledger lock)."""

    __slots__ = ("reads", "arrivals_us", "tenants", "last_version",
                 "uncacheable", "example", "child")

    def __init__(self, window: int, child):
        self.reads = 0
        self.arrivals_us: deque = deque(maxlen=window)  # caller holds: reuse.ledger (the ledger lock)
        self.tenants: dict[str, int] = {}  # caller holds: reuse.ledger (the ledger lock)
        self.last_version = 0
        self.uncacheable: dict[str, int] = {}  # caller holds: reuse.ledger (the ledger lock)
        self.example = ""
        # the template's read-counter series, resolved once: a reply
        # pays no labels() lookup (the serve plane's hot-path discipline)
        self.child = child


class TemplatePopularityLedger:
    """Per-template windowed arrival accounting, tenant attribution, and
    the Zipf-skew estimate over the popularity ranking."""

    def __init__(self, window: int | None = None,
                 max_templates: int | None = None):
        self._window = window
        self._max = max_templates
        self._lock = make_lock("reuse.ledger")
        self._templates: dict[str, _TemplateStat] = {}  # guarded by: _lock

    # ------------------------------------------------------------------
    def _cap(self) -> int:
        return self._max or max(int(Global.reuse_templates_max), 1)

    def charge(self, template: str, tenant: str, version: int,
               example: str = "") -> str:
        """Account one reply against ``template``; returns the bounded
        label actually charged (``__overflow__`` past the cap)."""
        now = get_usec()
        win = self._window or max(int(Global.reuse_window), 16)
        with self._lock:
            st = self._templates.get(template)
            if st is None:
                if len(self._templates) >= self._cap():
                    template = OVERFLOW_TEMPLATE
                    st = self._templates.get(template)
                if st is None:
                    st = self._templates[template] = _TemplateStat(
                        win, _M_READS.labels(template=template))
            st.reads += 1
            st.arrivals_us.append(now)
            st.tenants[tenant] = st.tenants.get(tenant, 0) + 1
            st.last_version = int(version)
            if example and not st.example:
                st.example = " ".join(example.split())[:96]
            child = st.child
        child.inc()
        return template

    def note_uncacheable(self, template: str, reason: str) -> None:
        with self._lock:
            st = self._templates.get(template)
            if st is not None:
                st.uncacheable[reason] = st.uncacheable.get(reason, 0) + 1

    def verdict(self, template: str) -> dict:
        """One template's admission verdict (the serving cache's read,
        via :func:`read_cache_input`): reads, windowed arrival rate, and
        whether any reply was ever uncacheable. ONE lock acquisition."""
        with self._lock:
            st = self._templates.get(template)
            if st is None:
                return {"reads": 0, "rate_qps": 0.0, "cacheable": True}
            reads = st.reads
            arrivals = list(st.arrivals_us)
            unc = sum(st.uncacheable.values())
        rate = 0.0
        if len(arrivals) >= 2:
            span = (arrivals[-1] - arrivals[0]) / 1e6
            if span > 0:
                rate = (len(arrivals) - 1) / span
        return {"reads": reads, "rate_qps": round(rate, 2),
                "cacheable": unc == 0}

    def uncacheable_counts(self, template: str) -> dict:
        """One template's uncacheable-reply tally by reason (the serving
        cache's second admission read)."""
        with self._lock:
            st = self._templates.get(template)
            return dict(st.uncacheable) if st is not None else {}

    # ------------------------------------------------------------------
    def zipf_alpha(self) -> float:
        """Least-squares slope of log(reads) vs log(rank) over the
        popularity ranking — the Zipf skew estimate (0 = uniform; >=1 =
        the read-mostly serving regime where a small cache wins). Needs
        >=3 templates to be meaningful; returns 0.0 below that."""
        with self._lock:
            counts = sorted((st.reads for st in self._templates.values()
                             if st.reads > 0), reverse=True)
        if len(counts) < 3:
            return 0.0
        xs = [math.log(r) for r in range(1, len(counts) + 1)]
        ys = [math.log(c) for c in counts]
        mx = sum(xs) / len(xs)
        my = sum(ys) / len(ys)
        var = sum((x - mx) ** 2 for x in xs)
        if var <= 0:
            return 0.0
        cov = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
        return max(round(-cov / var, 3), 0.0)

    def report(self, k: int | None = None) -> dict:
        """The popularity report: per-template reads/share/windowed rate/
        tenants/cacheability verdict, ranked by reads. ONE lock
        acquisition snapshots everything."""
        with self._lock:
            snap = {t: (st.reads, list(st.arrivals_us), dict(st.tenants),
                        st.last_version, dict(st.uncacheable), st.example)
                    for t, st in self._templates.items()}
        total = sum(r for (r, *_rest) in snap.values()) or 1
        rows = []
        for t, (reads, arrivals, tenants, version, unc, example) in \
                snap.items():
            rate = 0.0
            if len(arrivals) >= 2:
                span = (arrivals[-1] - arrivals[0]) / 1e6
                if span > 0:
                    rate = (len(arrivals) - 1) / span
            uncacheable = sum(unc.values())
            rows.append({
                "template": t,
                "reads": reads,
                "share": round(reads / total, 4),
                "rate_qps": round(rate, 2),
                "tenants": tenants,
                "last_version": version,
                "cacheable": uncacheable == 0,
                "uncacheable_by_reason": unc,
                "example": example,
            })
        rows.sort(key=lambda r: (-r["reads"], r["template"]))
        kk = k if k is not None else max(int(Global.top_k), 1)
        return {"total_reads": total if snap else 0,
                "templates": len(snap),
                "zipf_alpha": self.zipf_alpha(),
                "ranked": rows[:kk]}

    def reset(self) -> None:
        """Drop ledger state (tests / scenario runs). Registry counters
        are cumulative and stay."""
        with self._lock:
            self._templates.clear()


# ---------------------------------------------------------------------------
# the observe-only shadow cache
# ---------------------------------------------------------------------------

class _ShadowEntry:
    __slots__ = ("version", "rows", "nbytes", "t_us")

    def __init__(self, version: int, rows: int, nbytes: int, t_us: int):
        self.version = version
        self.rows = rows
        self.nbytes = nbytes
        self.t_us = t_us


class ShadowCache:
    """Bounded version-keyed key ring simulating the result cache.

    Holds KEYS + shape metadata only — never a result byte. ``probe()``
    simulates the cache's read path per served query; ``invalidate()``
    simulates what a store-version edge would do to the resident keys.
    """

    def __init__(self, capacity: int | None = None):
        self._capacity = capacity
        self._lock = make_lock("reuse.shadow")
        self._entries: OrderedDict = OrderedDict()  # guarded by: _lock
        self.hits = 0  # guarded by: _lock
        self.misses = 0  # guarded by: _lock
        self.evicts = 0  # guarded by: _lock
        self.killed = 0  # guarded by: _lock
        self.bytes_saved = 0  # guarded by: _lock
        self._version = 0  # guarded by: _lock
        self._last_bump_us = 0  # guarded by: _lock

    def _cap(self) -> int:
        return self._capacity or max(int(Global.shadow_cache_size), 1)

    # ------------------------------------------------------------------
    def probe(self, key_material, version: int, rows: int,
              nbytes: int) -> bool:
        """Simulate one cache read for a served query; True = the query
        WOULD have been a cache hit. A miss simulates the fill (and any
        LRU eviction it forces) so the steady-state key population is the
        one a real cache of ``shadow_cache_size`` entries would hold."""
        key = (key_material, int(version))
        cap = self._cap()
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                saved = ent.nbytes
                self.bytes_saved += saved
            else:
                self.misses += 1
                self._entries[key] = _ShadowEntry(int(version), int(rows),
                                                  int(nbytes), get_usec())
                evicted = 0
                while len(self._entries) > cap:
                    self._entries.popitem(last=False)
                    evicted += 1
                self.evicts += evicted
        if ent is not None:
            _C_SHADOW_HIT.inc()
            _M_SAVED.inc(saved)
            return True
        _C_SHADOW_MISS.inc()
        if evicted:
            _M_SHADOW.labels(result="evict").inc(evicted)
        return False

    # ------------------------------------------------------------------
    def invalidate(self, version: int | None, cause: str,
                   shard=None, **attrs) -> int:
        """One store-version edge: kill the shadow keys the edge makes
        stale (all of them on a ``None`` version — the conservative purge
        a read-path swap or restore implies), observe the staleness
        window since the previous edge, and journal the ``cache.invalidate``
        ClusterEvent. Returns the kill count."""
        now = get_usec()
        with self._lock:
            old = self._version
            if version is None:
                killed = len(self._entries)
                self._entries.clear()
            else:
                version = int(version)
                stale = [k for k, e in self._entries.items()
                         if e.version != version]
                for k in stale:
                    del self._entries[k]
                killed = len(stale)
                self._version = version
            self.killed += killed
            stale_s = ((now - self._last_bump_us) / 1e6
                       if self._last_bump_us else None)
            self._last_bump_us = now
        # metrics + journal OUTSIDE the shadow leaf lock: events.ring is
        # itself a lockdep leaf, and a leaf may never be taken under
        # another leaf
        _M_INVALID.labels(cause=cause).inc()
        if killed:
            _M_KILLED.inc(killed)
        if stale_s is not None:
            _M_STALE.observe(stale_s)
        from wukong_tpu_torch.obs.events import emit_event

        emit_event("cache.invalidate", shard=shard, cause=cause,
                   version_from=old,
                   version_to="purge" if version is None else version,
                   killed=killed, **attrs)
        return killed

    # ------------------------------------------------------------------
    def hit_rate(self) -> float | None:
        with self._lock:
            n = self.hits + self.misses
            return self.hits / n if n else None

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "hit_rate": (round(self.hits / (self.hits + self.misses),
                                       4)
                                 if self.hits + self.misses else None),
                    "keys": len(self._entries), "capacity": self._cap(),
                    "evicts": self.evicts, "killed": self.killed,
                    "bytes_saved": self.bytes_saved,
                    "version": self._version}

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()
            self.hits = self.misses = self.evicts = self.killed = 0
            self.bytes_saved = 0
            self._version = 0
            self._last_bump_us = 0


# ---------------------------------------------------------------------------
# the observatory (ledger + shadow + classification, one reply hook)
# ---------------------------------------------------------------------------

class ReuseObservatory:
    """The serving-cache observatory: one :meth:`observe` call per proxy
    reply feeds the ledger and (sampled) the shadow cache."""

    def __init__(self, window: int | None = None,
                 capacity: int | None = None):
        self.ledger = TemplatePopularityLedger(window=window)
        self.shadow = ShadowCache(capacity=capacity)
        self._probe_seq = 0  # unguarded: sampling cursor — an occasional lost increment only shifts which reply is sampled

    # ------------------------------------------------------------------
    def observe(self, q, tenant: str, version: int,
                text: str = "") -> bool | None:
        """Fold one served reply into the observatory. ``version`` is the
        store version the read executed against (the host partition's —
        the same version the plan cache keys on). Returns the shadow
        probe's verdict (True = would have hit) or None when the reply
        was uncacheable / the probe was sampled out — the real cache's
        divergence counter compares against exactly this value."""
        # the serving plane's probe (serve/result_cache.py) stashes its
        # classification verdict on the query — one classify per reply,
        # and the fast-path reply shell (no patterns) stays classifiable
        ck = q.__dict__.get("_ckey")
        key, reason = ck if ck is not None else classify(q)
        if key is not None:
            tkey = key[0]  # the signature digest
        else:
            tkey = " ".join((text or "").split())[:96] or "<unparsed>"
        tkey = self.ledger.charge(tkey, tenant, version, example=text)
        if key is not None:
            # reply-side uncacheability: a result cache must never store
            # an error or a deadline-truncated partial table
            if q.result.status_code != ErrorCode.SUCCESS:
                reason = "error"
            elif not q.result.complete:
                reason = "partial"
        if reason is not None:
            _M_UNCACHEABLE.labels(reason=reason).inc()
            self.ledger.note_uncacheable(tkey, reason)
            return None
        every = max(int(Global.reuse_sample_every), 1)
        if every > 1:
            self._probe_seq += 1
            if self._probe_seq % every:
                return None
        return self.shadow.probe(key, version, int(q.result.nrows),
                                 _payload_estimate(q))

    # ------------------------------------------------------------------
    def report(self, k: int | None = None) -> dict:
        uncach = {}
        snap = get_registry().snapshot().get(
            "wukong_reuse_uncacheable_total", {})
        for s in snap.get("series", []):
            uncach[s.get("labels", {}).get("reason", "?")] = int(
                s.get("value", 0))
        return {
            "enabled": bool(Global.enable_reuse),
            "sample_every": max(int(Global.reuse_sample_every), 1),
            "popularity": self.ledger.report(k),
            "shadow": self.shadow.stats(),
            "uncacheable_by_reason": uncach,
            "inputs": dict(CACHE_INPUTS),
        }

    def reset(self) -> None:
        self.ledger.reset()
        self.shadow.reset()


# process-wide observatory (the proxy hook, the cache verb and the Monitor
# share it)
_observatory = ReuseObservatory()
# checked mode (lockdep.install) rebuilds the process-wide ledgers' locks
register_global_lock(_observatory.ledger, "_lock", "reuse.ledger")
register_global_lock(_observatory.shadow, "_lock", "reuse.shadow")

get_registry().gauge(
    "wukong_reuse_hit_rate",
    "Shadow-cache achievable hit rate (hits / probes; 0 before traffic)"
).set_function(lambda: _observatory.shadow.hit_rate() or 0.0)
get_registry().gauge(
    "wukong_reuse_zipf_alpha",
    "Zipf-skew estimate over the template popularity ranking"
).set_function(lambda: _observatory.ledger.zipf_alpha())


def get_reuse() -> ReuseObservatory:
    return _observatory


def maybe_observe_reuse(q, tenant: str, version: int,
                        text: str = "") -> bool | None:
    """The proxy's reply hook: one knob check when the observatory is
    off. Returns the shadow probe's verdict (None when off / not
    probed) for the real cache's divergence comparison."""
    if not Global.enable_reuse:
        return None
    return _observatory.observe(q, tenant, version, text=text)


def read_cache_input(signal: str, template: str | None = None):
    """The serving plane's ONLY read path into the observatory: every
    number a caching decision consumes is read here by its
    ``CACHE_INPUTS`` name, so the map stays the literal truth about what
    the actuator depends on (the ``ADMISSION_INPUTS`` consumer contract —
    serve/result_cache.py declares its reads in ``CONSUMED_INPUTS``)."""
    if signal not in CACHE_INPUTS:
        raise KeyError(f"{signal!r} is not a declared cache input "
                       f"(see {sorted(CACHE_INPUTS)})")
    if signal == "template_popularity":
        return _observatory.ledger.verdict(template or "")
    if signal == "uncacheable":
        return _observatory.ledger.uncacheable_counts(template or "")
    if signal == "predicted_hit_rate":
        return _observatory.shadow.hit_rate()
    if signal == "zipf_skew":
        return _observatory.ledger.zipf_alpha()
    raise KeyError(f"cache input {signal!r} has no live read path here "
                   "— scrape its backing metric "
                   f"{CACHE_INPUTS[signal]!r} instead")


def maybe_note_invalidation(cause: str, version: int | None = None,
                            shard=None, **attrs) -> int:
    """THE store-mutation hook: every
    path that inserts triples calls this with the post-mutation store
    version (None = conservative full purge, the read-path-swap /
    restore posture). One knob check when the observatory is off."""
    if not Global.enable_reuse:
        return 0
    return _observatory.shadow.invalidate(version, cause, shard=shard,
                                          **attrs)


def reuse_trend(window_s: float | None = None) -> dict:
    """Write-rate vs reuse-rate over the tsdb trend window: windowed read
    / shadow-probe / invalidation rates, empty when the ring holds <2
    samples. Every metric literal read here is declared in
    CACHE_INPUTS."""
    from wukong_tpu_torch.obs.tsdb import get_tsdb

    ts = get_tsdb()
    # every read goes through rate_by_label, not rate(): a window whose
    # FIRST sample predates a counter's first increment has no series
    # there, and rate()'s two-point contract would answer None for the
    # exact cold-start window the trend exists to describe —
    # rate_by_label treats missing-in-first as the zero baseline
    reads_by = ts.rate_by_label("wukong_reuse_template_reads_total",
                                "template", window_s)
    if not reads_by:
        return {}
    out = {"reads_per_s": round(sum(reads_by.values()), 2)}
    # probes = hit + miss only: a capacity-bound shadow also counts one
    # "evict" per fill, and summing the whole family would double-count
    # every miss once the ring is full
    by = ts.rate_by_label("wukong_reuse_shadow_total", "result",
                          window_s)
    if by:
        out["probes_per_s"] = round(
            by.get("hit", 0.0) + by.get("miss", 0.0), 2)
    inval = ts.rate_by_label("wukong_reuse_invalidations_total", "cause",
                             window_s)
    if inval:
        out["invalidations_per_s"] = round(sum(inval.values()), 3)
    killed = ts.rate("wukong_reuse_keys_killed_total", window_s)
    if killed is not None:
        out["keys_killed_per_s"] = round(killed, 2)
    return out


def _cache_counter_rates(snap: dict, name: str) -> dict:
    """{label value: count} for one single-label counter family."""
    out: dict[str, int] = {}
    for s in snap.get(name, {}).get("series", []):
        lbls = s.get("labels", {})
        out[next(iter(lbls.values()), "?")] = int(s.get("value", 0))
    return out


def cache_hit_rates() -> dict:
    """Parse/plan/shadow cache hit rates from the live registry (the cache
    report and the Monitor line share this). The rate's
    denominator is LOOKUPS (hit + miss) only: ``uncacheable`` counts per
    refused record and ``invalidated`` bulk-counts per entry dropped by
    a store-change clear — neither is a lookup, and folding them in
    would deflate the rate on every dynamic load."""
    snap = get_registry().snapshot()
    out = {}
    for short, metric in (("parse", "wukong_parse_cache_total"),
                          ("plan", "wukong_plan_cache_total")):
        by = _cache_counter_rates(snap, metric)
        lookups = by.get("hit", 0) + by.get("miss", 0)
        out[short] = {"total": lookups, "by_result": by,
                      "hit_rate": (round(by.get("hit", 0) / lookups, 4)
                                   if lookups else None)}
    out["shadow"] = {"hit_rate": _observatory.shadow.hit_rate()}
    return out


# ---------------------------------------------------------------------------
# the cache report (console verb + Monitor line)
# ---------------------------------------------------------------------------

def _real_cache_report() -> dict:
    """The serving plane's live state (serve/): the real cache's stats,
    the view registry, and the real-vs-shadow divergence tally."""
    from wukong_tpu_torch.serve import get_serve
    from wukong_tpu_torch.serve.result_cache import divergence_total

    plane = get_serve()
    return {"enabled": bool(Global.enable_result_cache),
            "views_enabled": bool(Global.enable_views),
            "cache": plane.cache.stats(),
            "views": plane.views.stats(),
            "divergence": divergence_total()}


def render_cache(k: int | None = None) -> tuple[str, dict]:
    """(plain-text table, JSON dict) for the ``cache`` console verb: the REAL result cache + view registry on
    top (serve/), the shadow-cache economics under it, the template
    popularity ranking below, parse/plan cache hit rates and the trend
    window at the bottom."""
    rep = _observatory.report(k)
    rates = cache_hit_rates()
    trend = reuse_trend()
    real = _real_cache_report()
    js = {**rep, "caches": rates, "trend": trend, "real": real}
    pop = rep["popularity"]
    sh = rep["shadow"]

    lines = ["wukong-cache  (materialized-view serving plane + "
             "observatory)", ""]
    rc = real["cache"]
    rhr = rc["hit_rate"]
    if real["enabled"]:
        lines.append(
            f"REAL    hit_rate {'-' if rhr is None else format(rhr, '.1%')}  "
            f"entries {rc['entries']}  "
            f"held {rc['bytes_held']:,}/{rc['capacity_bytes']:,}B  "
            f"hits {rc['hits']:,}  misses {rc['misses']:,}  "
            f"collapsed {rc['collapsed']:,}  killed {rc['killed']:,}  "
            f"views {real['views']['registered']}"
            f"/{real['views']['capacity']}  "
            f"diverged {real['divergence']:,}")
        vs = real["views"]
        if vs["promoted"] or vs["rejected"] or vs["demoted"]:
            lines.append(
                f"VIEWS   promoted {vs['promoted']}  rejected "
                f"{vs['rejected']}  demoted {vs['demoted']}  "
                + "  ".join(
                    f"{v['template']}:{v['survived']}/{v['edges']}ok"
                    for v in vs["views"][:4]))
    else:
        lines.append("REAL    (enable_result_cache is OFF — the "
                     "observatory below is observe-only)")
    hr = sh["hit_rate"]
    lines.append(
        f"SHADOW  hit_rate {'-' if hr is None else format(hr, '.1%')}  "
        f"keys {sh['keys']}/{sh['capacity']}  hits {sh['hits']:,}  "
        f"misses {sh['misses']:,}  evicts {sh['evicts']:,}  "
        f"killed {sh['killed']:,}  saved {sh['bytes_saved']:,}B  "
        f"store v{sh['version']}")
    if not rep["enabled"]:
        lines.append("  (enable_reuse is OFF — nothing is being observed)")
    if rep["sample_every"] > 1:
        lines.append(f"  (shadow probe sampled 1-in-"
                     f"{rep['sample_every']} — reuse_sample_every)")
    lines.append("")
    lines.append(f"TEMPLATES by reads (total {pop['total_reads']:,}, "
                 f"{pop['templates']} templates, "
                 f"zipf α≈{pop['zipf_alpha']:.2f})")
    lines.append(f"{'template':<14} {'reads':>8} {'share':>6} "
                 f"{'rate/s':>8} {'cache':>6} {'v':>4}  tenants")
    for r in pop["ranked"]:
        tens = ",".join(f"{t}:{n}" for t, n in sorted(
            r["tenants"].items())[:3])
        verdict = ("yes" if r["cacheable"]
                   else max(r["uncacheable_by_reason"],
                            key=r["uncacheable_by_reason"].get))
        lines.append(f"{r['template']:<14.14} {r['reads']:>8,} "
                     f"{r['share']:>6.1%} {r['rate_qps']:>8,.1f} "
                     f"{verdict:>6.6} {r['last_version']:>4}  {tens[:40]}")
    if not pop["ranked"]:
        lines.append("  (no replies observed — enable_reuse on and "
                     "traffic flowing?)")
    lines.append("")
    unc = rep["uncacheable_by_reason"]
    if unc:
        lines.append("UNCACHEABLE  " + "  ".join(
            f"{r2}:{n}" for r2, n in sorted(unc.items())))
    parse, plan = rates["parse"], rates["plan"]

    def _fmt(c):
        return ("-" if c["hit_rate"] is None
                else format(c["hit_rate"], ".1%"))

    lines.append(f"CACHES  parse {_fmt(parse)} ({parse['total']:,})  "
                 f"plan {_fmt(plan)} ({plan['total']:,})")
    if trend:
        lines.append("TREND   " + "  ".join(
            f"{k2} {v:,.2f}" for k2, v in sorted(trend.items())))
    return "\n".join(lines) + "\n", js
