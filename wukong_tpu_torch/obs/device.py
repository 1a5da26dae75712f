"""Device-cost observatory: dispatch accounting, compile ledger, residency.

The port's copy of the JAX package's obs/device.py. Three planes, all
observe-only (no dispatch is re-routed here):

- :class:`DispatchLedger` — charged at every device sync point through
  :func:`maybe_device_dispatch` (the WCOJ level probe, the compiled
  template programs) or, for a chain of steps that syncs once,
  :func:`charge_steps` (the GPU engine's chains, the merge executor):
  per (site, template, capacity class) dispatch counts, wall time from
  launch to sync, live rows vs padded capacity (padding efficiency, the
  pad_pow2 discipline's measured waste) and bytes moved device<->host.
- :class:`CompileLedger` — cold-vs-warm split by first-call detection per
  (site, template, capacity) variant, per-site variant counts, and the
  **variant-storm sentinel**: a site minting more than
  ``device_variant_limit`` variants inside one ``device_storm_cooldown_s``
  window journals a ``device.variant_storm`` event (obs/events.py) and
  force-dumps the trace ring. The port compiles no XLA programs: a
  "variant" is a new (template, capacity) shape of a device program, whose
  first call pays the host-side set-up (staging, allocations) instead of
  a compile.
- :class:`ResidencyLedger` — device-resident bytes per kind (``join_table``
  = JoinTableCache device tables, ``segment`` / ``index`` =
  engine/device_store.py stagings, ``template`` = compiled template
  programs' staged operands) against the ``device_budget_mb`` ceiling,
  with fills/evictions/invalidations counted per store-version edge.

``DEVICE_INPUTS`` maps every signal the compiled-template route chooser may
read to the registered metric that backs it; :func:`read_device_input` is
its only read path. Surfaced as the ``device`` console verb and
``Monitor.device_lines``. Everything gates on ``enable_device_obs``
(default on; off, every seam is one knob check). The JAX module's
``device_trend`` and its ``/device`` HTTP endpoint wait for the HTTP plane
(ROADMAP §A, "The rest of the observatory, and the analysis plugins").
"""

from __future__ import annotations

import time
from collections import deque

from wukong_tpu_torch.analysis.lockdep import declare_leaf, make_lock
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.utils.timer import get_usec

#: every signal the compiled-template route chooser may read, mapped to
#: the registered metric that backs it (scrape-able truth for each number
#: the actuator consumes; the JAX package's device-telemetry analysis
#: gate holds the same map).
DEVICE_INPUTS = {
    "dispatches": "wukong_device_dispatch_total",
    "dispatch_wall": "wukong_device_dispatch_us",
    "padding_efficiency": "wukong_device_padding_efficiency",
    "padded_rows": "wukong_device_rows_total",
    "bytes_moved": "wukong_device_bytes_moved_total",
    "variants": "wukong_device_variants",
    "variant_storms": "wukong_device_variant_storms_total",
    "resident_bytes": "wukong_device_resident_bytes",
    "residency_events": "wukong_device_residency_total",
    "residency_high_water": "wukong_device_resident_high_water_bytes",
    "compile_cache": "wukong_device_compile_cache_total",
    "feedback": "wukong_device_feedback_total",
}

#: bounded-cardinality catch-all template label (the reuse-observatory
#: posture: unbounded template shapes must not mint unbounded series)
OVERFLOW_TEMPLATE = "__overflow__"
_TEMPLATES_CAP = 512

# every lock here guards dict/deque/int updates only — innermost by
# construction, like reuse.ledger/heat.shard (charges fire from engine
# sync points and store staging paths, outside every other tracked
# lock; the device.variant_storm event + recorder dump are emitted
# AFTER the compile lock releases, since events.ring is itself a leaf)
declare_leaf("device.dispatch")
declare_leaf("device.compile")
declare_leaf("device.residency")

_M_DISPATCH = get_registry().counter(
    "wukong_device_dispatch_total",
    "Device dispatches charged at the sync point, by site",
    labels=("site",))
_M_DISPATCH_US = get_registry().histogram(
    "wukong_device_dispatch_us",
    "Device dispatch wall time (usec) by site and cold/warm temperature "
    "(cold = first call of a program variant, set-up included)",
    labels=("site", "temp"))
_M_ROWS = get_registry().counter(
    "wukong_device_rows_total",
    "Rows through device dispatches by site: live vs padded capacity "
    "(live/padded = the padding efficiency the pad_pow2 classes cost)",
    labels=("site", "kind"))
_M_BYTES = get_registry().counter(
    "wukong_device_bytes_moved_total",
    "Bytes moved across the host<->device boundary per dispatch site",
    labels=("site",))
_M_STORMS = get_registry().counter(
    "wukong_device_variant_storms_total",
    "Variant-storm sentinel trips (a site minted more than "
    "device_variant_limit program variants in one window)",
    labels=("site",))
_M_RESIDENCY = get_registry().counter(
    "wukong_device_residency_total",
    "Device-residency edges by kind and event (fill/evict/invalidate)",
    labels=("kind", "event"))
_M_COMPILE_CACHE = get_registry().counter(
    "wukong_device_compile_cache_total",
    "Compile-cache outcomes by site (engine/template_compile.py "
    "whole-plan program cache hits/misses/evictions)",
    labels=("outcome", "site"))
_M_FEEDBACK = get_registry().counter(
    "wukong_device_feedback_total",
    "Measured-feedback route decisions charged through the observatory "
    "(proxy demotions + heavy-split choices, correlated with device cost)",
    labels=("kind", "reason"))


def _budget_bytes() -> int:
    return max(int(Global.device_budget_mb), 1) * (1 << 20)


# ---------------------------------------------------------------------------
# the dispatch ledger
# ---------------------------------------------------------------------------

class _SiteStat:
    """One (site, template, capacity) dispatch record (mutated under the
    dispatch lock)."""

    __slots__ = ("count", "live", "padded", "wall_us", "nbytes", "cold")

    def __init__(self):
        self.count = 0
        self.live = 0
        self.padded = 0
        self.wall_us = 0
        self.nbytes = 0
        self.cold = 0


class DispatchLedger:
    """Per (site, template, capacity class) dispatch accounting: counts,
    device wall time, live rows vs padded capacity, bytes moved."""

    def __init__(self, max_keys: int | None = None):
        self._max = max_keys or _TEMPLATES_CAP
        self._lock = make_lock("device.dispatch")
        # (site, template, capacity) -> _SiteStat
        self._stats: dict[tuple, _SiteStat] = {}  # guarded by: _lock

    def charge(self, site: str, template: str, capacity: int, live: int,
               wall_us: int, nbytes: int, cold: bool, count: int) -> str:
        """Account ``count`` dispatches; returns the bounded template
        label actually charged (``__overflow__`` past the key cap)."""
        return self.charge_many(
            site, [(template, capacity, live, wall_us, nbytes, cold,
                    count)])[0]

    def charge_many(self, site: str, rows) -> list[str]:
        """:meth:`charge` for several ``(template, capacity, live, wall_us,
        nbytes, cold, count)`` rows of one site under ONE lock
        acquisition; returns each row's charged template label."""
        labels = []
        with self._lock:
            for template, capacity, live, wall_us, nbytes, cold, count \
                    in rows:
                key = (site, template, int(capacity))
                st = self._stats.get(key)
                if st is None:
                    if len(self._stats) >= self._max:
                        key = (site, OVERFLOW_TEMPLATE, int(capacity))
                        st = self._stats.get(key)
                    if st is None:
                        st = self._stats[key] = _SiteStat()
                st.count += count
                st.live += int(live)
                st.padded += int(capacity) * count
                st.wall_us += int(wall_us)
                st.nbytes += int(nbytes)
                if cold:
                    st.cold += 1
                labels.append(key[1])
        return labels

    # ------------------------------------------------------------------
    def padding_efficiency(self, site: str | None = None) -> float | None:
        """live / padded over every charged dispatch (optionally one
        site's) — None before any dispatch carried capacity."""
        with self._lock:
            live = padded = 0
            for (s, _t, _c), st in self._stats.items():
                if site is not None and s != site:
                    continue
                live += st.live
                padded += st.padded
        return (live / padded) if padded else None

    def site_efficiencies(self) -> dict[str, float]:
        """{site: live/padded} for the callback gauge (sites with no
        padded rows yet are absent, not 0 — absent series drop)."""
        agg: dict[str, list] = {}
        with self._lock:
            for (s, _t, _c), st in self._stats.items():
                a = agg.setdefault(s, [0, 0])
                a[0] += st.live
                a[1] += st.padded
        return {s: v[0] / v[1] for s, v in agg.items() if v[1]}

    def dispatch_counts(self, site: str | None = None) -> dict:
        """{count, cold, warm, wall_us} totals (optionally one site's) —
        the route chooser's dispatch-amortization read."""
        with self._lock:
            count = cold = wall = 0
            for (s, _t, _c), st in self._stats.items():
                if site is not None and s != site:
                    continue
                count += st.count
                cold += st.cold
                wall += st.wall_us
        return {"count": count, "cold": cold, "warm": count - cold,
                "wall_us": wall}

    def report(self, k: int | None = None) -> list[dict]:
        """Per (site, template, capacity) rows ranked by wall time. ONE
        lock acquisition snapshots everything."""
        with self._lock:
            snap = [((s, t, c), st.count, st.live, st.padded, st.wall_us,
                     st.nbytes, st.cold)
                    for (s, t, c), st in self._stats.items()]
        rows = []
        for (s, t, c), count, live, padded, wall, nbytes, cold in snap:
            rows.append({
                "site": s, "template": t, "capacity": c,
                "dispatches": count,
                "live_rows": live, "padded_rows": padded,
                "padding_efficiency": (round(live / padded, 4)
                                       if padded else None),
                "wall_us": wall, "bytes_moved": nbytes,
                "cold": cold, "warm": count - cold,
            })
        rows.sort(key=lambda r: (-r["wall_us"], r["site"], r["capacity"]))
        kk = k if k is not None else max(int(Global.top_k), 1)
        return rows[:kk]

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()


# ---------------------------------------------------------------------------
# the compile ledger + variant-storm sentinel
# ---------------------------------------------------------------------------

class _SiteVariants:
    """One site's minted program variants (mutated under the compile lock)."""

    __slots__ = ("variants", "mints_us", "last_trip_us")

    def __init__(self):
        self.variants: set = set()  # caller holds: device.compile (the compile lock)
        self.mints_us: deque = deque(maxlen=4096)  # caller holds: device.compile (the compile lock)
        self.last_trip_us = 0


class CompileLedger:
    """First-call (cold) detection per (site, template, capacity)
    variant, per-site variant counts, and the variant-storm sentinel."""

    def __init__(self, limit: int | None = None,
                 cooldown_s: float | None = None):
        self._limit = limit
        self._cooldown_s = cooldown_s
        self._lock = make_lock("device.compile")
        self._sites: dict[str, _SiteVariants] = {}  # guarded by: _lock

    def _lim(self) -> int:
        return self._limit or max(int(Global.device_variant_limit), 1)

    def _cool_us(self) -> int:
        s = (self._cooldown_s if self._cooldown_s is not None
             else float(Global.device_storm_cooldown_s))
        return int(max(s, 0.001) * 1e6)

    def note(self, site: str, template: str, capacity: int) -> tuple:
        """Record one dispatch of a (template, capacity) variant at
        ``site``. Returns ``(cold, storm_minted | None)`` — cold is True
        on the variant's first call; storm_minted is the in-window mint
        count when the sentinel just tripped (the caller journals the
        event OUTSIDE this lock)."""
        colds, storm = self.note_many(site, template, (capacity,))
        return colds[0], (storm[0] if storm is not None else None)

    def note_many(self, site: str, template: str, capacities) -> tuple:
        """:meth:`note` for one dispatch of each ``(template, capacity)``
        variant in turn, under ONE lock acquisition. Returns ``([cold,
        ...], (storm_minted, variants_then) | None)``: the sentinel trips
        at most once a cooldown, so at most once a call, and
        ``variants_then`` is the site's variant count at the trip."""
        now = get_usec()
        cool = self._cool_us()
        storm = None
        colds = []
        with self._lock:
            sv = self._sites.get(site)
            if sv is None:
                sv = self._sites[site] = _SiteVariants()
            for capacity in capacities:
                cold = (template, int(capacity)) not in sv.variants
                colds.append(cold)
                if not cold:
                    continue
                sv.variants.add((template, int(capacity)))
                sv.mints_us.append(now)
                while sv.mints_us and now - sv.mints_us[0] > cool:
                    sv.mints_us.popleft()
                if (len(sv.mints_us) > self._lim()
                        and now - sv.last_trip_us >= cool):
                    sv.last_trip_us = now
                    storm = (len(sv.mints_us), len(sv.variants))
        return colds, storm

    def variant_counts(self) -> dict[str, int]:
        with self._lock:
            return {s: len(sv.variants) for s, sv in self._sites.items()}

    def reset(self) -> None:
        with self._lock:
            self._sites.clear()


# ---------------------------------------------------------------------------
# the residency ledger
# ---------------------------------------------------------------------------

class ResidencyLedger:
    """Device-resident bytes per kind against the ``device_budget_mb``
    ceiling, with fill/evict/invalidate edges counted per store-version
    edge (an invalidation clearing N entries is ONE edge)."""

    def __init__(self):
        self._lock = make_lock("device.residency")
        self._bytes: dict[str, int] = {}  # guarded by: _lock
        self._high_water = 0  # guarded by: _lock
        self._versions: dict[str, int] = {}  # guarded by: _lock

    def fill(self, kind: str, nbytes: int) -> None:
        with self._lock:
            self._bytes[kind] = self._bytes.get(kind, 0) + int(nbytes)
            total = sum(self._bytes.values())
            if total > self._high_water:
                self._high_water = total
        _M_RESIDENCY.labels(kind=kind, event="fill").inc()

    def evict(self, kind: str, nbytes: int) -> None:
        with self._lock:
            self._bytes[kind] = max(
                self._bytes.get(kind, 0) - int(nbytes), 0)
        _M_RESIDENCY.labels(kind=kind, event="evict").inc()

    def invalidate(self, kind: str, nbytes: int | None = None,
                   version: int | None = None) -> bool:
        """One store-version edge dropped ``nbytes`` (None = everything
        of ``kind``). Returns False when the same version edge was
        already counted for this kind — a store bump that clears three
        caches is still ONE invalidation edge per kind."""
        with self._lock:
            if version is not None:
                if self._versions.get(kind) == int(version):
                    # the byte drop still applies; the edge was counted
                    if nbytes is None:
                        self._bytes[kind] = 0
                    else:
                        self._bytes[kind] = max(
                            self._bytes.get(kind, 0) - int(nbytes), 0)
                    return False
                self._versions[kind] = int(version)
            if nbytes is None:
                self._bytes[kind] = 0
            else:
                self._bytes[kind] = max(
                    self._bytes.get(kind, 0) - int(nbytes), 0)
        _M_RESIDENCY.labels(kind=kind, event="invalidate").inc()
        return True

    # ------------------------------------------------------------------
    def totals(self) -> dict[str, int]:
        with self._lock:
            return dict(self._bytes)

    def total_bytes(self) -> int:
        with self._lock:
            return sum(self._bytes.values())

    def high_water(self) -> int:
        with self._lock:
            return self._high_water

    def stats(self) -> dict:
        with self._lock:
            total = sum(self._bytes.values())
            return {"by_kind": dict(self._bytes), "total_bytes": total,
                    "high_water_bytes": self._high_water,
                    "budget_bytes": _budget_bytes(),
                    "over_budget": total > _budget_bytes()}

    def reset(self) -> None:
        with self._lock:
            self._bytes.clear()
            self._versions.clear()
            self._high_water = 0


# ---------------------------------------------------------------------------
# the observatory facade
# ---------------------------------------------------------------------------

def _record(site: str, template: str, capacity: int, live: int, count: int,
            wall_us: int, temp: str) -> dict:
    """One dispatch record, as EXPLAIN ANALYZE's device table reads it."""
    return {"site": site, "template": template, "capacity": int(capacity),
            "live": int(live), "dispatches": int(count),
            "wall_us": int(wall_us), "temp": temp,
            "padding_efficiency": (round(live / (capacity * count), 4)
                                   if capacity and count else None)}


class DeviceObservatory:
    """Dispatch + compile + residency ledgers behind the single
    :func:`maybe_device_dispatch` / :func:`maybe_device_resident`
    seams."""

    def __init__(self, variant_limit: int | None = None,
                 cooldown_s: float | None = None):
        self.dispatch_ledger = DispatchLedger()
        self.compile_ledger = CompileLedger(limit=variant_limit,
                                            cooldown_s=cooldown_s)
        self.residency = ResidencyLedger()

    # ------------------------------------------------------------------
    def dispatch(self, site: str, template: str = "", live: int = 0,
                 capacity: int = 0, wall_us: int = 0, nbytes: int = 0,
                 count: int = 1) -> dict:
        """Charge one sync point: ``count`` dispatches at ``site`` of the
        ``(template, capacity)`` program variant that carried ``live`` rows
        against ``capacity``-row padded tensors and took ``wall_us`` on
        the device. Returns the per-step record EXPLAIN ANALYZE's device
        table consumes. Metrics and the storm journal run OUTSIDE the
        ledger leaves (events.ring is itself a leaf)."""
        cold, storm = self.compile_ledger.note(site, template, capacity)
        tmpl = self.dispatch_ledger.charge(site, template, capacity, live,
                                           wall_us, nbytes, cold, count)
        temp = "cold" if cold else "warm"
        _M_DISPATCH.labels(site=site).inc(count)
        _M_DISPATCH_US.labels(site=site, temp=temp).observe(wall_us)
        if capacity:
            _M_ROWS.labels(site=site, kind="live").inc(live)
            _M_ROWS.labels(site=site, kind="padded").inc(capacity * count)
        if nbytes:
            _M_BYTES.labels(site=site).inc(nbytes)
        if storm is not None:
            self._journal_storm(site, storm)
        return _record(site, tmpl, capacity, live, count, wall_us, temp)

    def dispatch_steps(self, site: str, steps, wall_us: int,
                       nbytes: int = 0) -> list[dict]:
        """Charge one chain sync: one dispatch of template ``d<n>`` per
        device step ``(step, total, cap)`` (live = ``min(total, cap)``),
        with the sync's wall split evenly across the ``n`` steps and
        ``nbytes`` charged to the first. The same ledger and metric
        readings as :meth:`dispatch` once a step, at two ledger-lock
        acquisitions and one metric update per series for the whole
        sync. Returns one record a step, ``step`` set."""
        n = len(steps)
        template = f"d{n}"
        per_us = int(wall_us) // n
        caps = [int(c) for _s, _t, c in steps]
        lives = [min(int(t), c) for (_s, t, _c), c in zip(steps, caps)]
        colds, storm = self.compile_ledger.note_many(site, template, caps)
        tmpls = self.dispatch_ledger.charge_many(site, [
            (template, c, live, per_us, nbytes if i == 0 else 0, cold, 1)
            for i, (c, live, cold) in enumerate(zip(caps, lives, colds))])
        ncold = sum(colds)
        _M_DISPATCH.labels(site=site).inc(n)
        if ncold:
            _M_DISPATCH_US.labels(site=site, temp="cold").observe(
                per_us, ncold)
        if n - ncold:
            _M_DISPATCH_US.labels(site=site, temp="warm").observe(
                per_us, n - ncold)
        padded = sum(caps)
        if padded:
            _M_ROWS.labels(site=site, kind="live").inc(sum(lives))
            _M_ROWS.labels(site=site, kind="padded").inc(padded)
        if nbytes:
            _M_BYTES.labels(site=site).inc(nbytes)
        if storm is not None:
            self._journal_storm(site, *storm)
        recs = []
        for (s, _t, _c), tmpl, c, live, cold in zip(steps, tmpls, caps,
                                                    lives, colds):
            rec = _record(site, tmpl, c, live, 1, per_us,
                          "cold" if cold else "warm")
            rec["step"] = int(s)
            recs.append(rec)
        return recs

    def _journal_storm(self, site: str, minted: int,
                       variants: int | None = None) -> None:
        """Journal the sentinel trip and force-dump the trace ring (the
        LatencyAttributor regression posture: event first, dump carries
        its id)."""
        _M_STORMS.labels(site=site).inc()
        from wukong_tpu_torch.obs.events import emit_event
        from wukong_tpu_torch.obs.recorder import get_recorder

        eid = emit_event("device.variant_storm", site=site,
                         minted_in_window=minted,
                         limit=max(int(Global.device_variant_limit), 1),
                         variants_total=(
                             variants if variants is not None
                             else self.compile_ledger.variant_counts()
                             .get(site, 0)))
        rec = get_recorder()
        recent = rec.last(1)
        if recent:
            # the storm fires mid-dispatch, before its own query's trace
            # completes — the newest ring entry is the closest witness
            rec.dump(recent[-1], "DEVICE_VARIANT_STORM", event_id=eid)

    # ------------------------------------------------------------------
    def report(self, k: int | None = None) -> dict:
        counts = self.dispatch_ledger.dispatch_counts()
        return {
            "enabled": bool(Global.enable_device_obs),
            "dispatches": counts,
            "padding_efficiency": self.dispatch_ledger.padding_efficiency(),
            "by_site_efficiency": {
                s: round(v, 4) for s, v in
                sorted(self.dispatch_ledger.site_efficiencies().items())},
            "variants": self.compile_ledger.variant_counts(),
            "ranked": self.dispatch_ledger.report(k),
            "residency": self.residency.stats(),
            "inputs": dict(DEVICE_INPUTS),
        }

    def reset(self) -> None:
        self.dispatch_ledger.reset()
        self.compile_ledger.reset()
        self.residency.reset()


# process-wide observatory (the engine seams, /device, and Monitor share it)
_observatory = DeviceObservatory()

get_registry().gauge(
    "wukong_device_padding_efficiency",
    "Live rows / padded capacity over charged dispatches, by site "
    "(1.0 = zero padding waste)",
    labels=("site",),
).set_function(
    lambda: {(s,): v
             for s, v in _observatory.dispatch_ledger
             .site_efficiencies().items()})
get_registry().gauge(
    "wukong_device_variants",
    "Distinct (template, capacity) program variants minted per dispatch site",
    labels=("site",),
).set_function(
    lambda: {(s,): float(n)
             for s, n in _observatory.compile_ledger
             .variant_counts().items()})
get_registry().gauge(
    "wukong_device_resident_bytes",
    "Device-resident bytes by kind (join tables / segment stagings / "
    "index lists / knn blocks)",
    labels=("kind",),
).set_function(
    lambda: {(k,): float(v)
             for k, v in _observatory.residency.totals().items()})
get_registry().gauge(
    "wukong_device_resident_high_water_bytes",
    "High-water total of device-resident bytes since process start "
    "(compare against device_budget_mb)",
).set_function(lambda: float(_observatory.residency.high_water()))


def get_device_obs() -> DeviceObservatory:
    return _observatory


def maybe_device_dispatch(site: str, template: str = "", live: int = 0,
                          capacity: int = 0, wall_us: int = 0,
                          nbytes: int = 0, count: int = 1) -> dict | None:
    """THE device-dispatch instrumentation seam: every device sync point in
    engine/ and join/ charges here. One knob check
    when the observatory is off. Returns the per-step record (None when
    off) — call sites append it to ``q.device_steps`` for EXPLAIN
    ANALYZE's device table."""
    if not Global.enable_device_obs:
        return None
    return _observatory.dispatch(site, template=template, live=live,
                                 capacity=capacity, wall_us=wall_us,
                                 nbytes=nbytes, count=count)


def charge_steps(site: str, steps, wall_us: int, nbytes: int = 0,
                 q=None) -> None:
    """THE chain-sync seam: a chain of device steps that syncs ONCE
    charges one dispatch a step ``(step, total, cap)`` here, the sync's
    wall split evenly (per-step device time is not observable) and
    ``nbytes`` charged to the first step. With ``q`` the records land on
    ``q.device_steps`` for EXPLAIN ANALYZE's device table (the JAX
    engines' ``_charge_chain`` / ``_charge_merge``). One knob check when
    the observatory is off."""
    if not steps or not Global.enable_device_obs:
        return
    recs = _observatory.dispatch_steps(site, steps, wall_us, nbytes)
    if q is not None:
        dev = getattr(q, "device_steps", None)
        if dev is None:
            dev = q.device_steps = []
        dev.extend(recs)


def maybe_device_resident(event: str, kind: str, nbytes: int | None = None,
                          version: int | None = None) -> None:
    """THE residency seam: stores charge ``fill`` / ``evict`` /
    ``invalidate`` edges with the nbytes they staged or dropped. One
    knob check when the observatory is off."""
    if not Global.enable_device_obs:
        return
    if event == "fill":
        _observatory.residency.fill(kind, int(nbytes or 0))
    elif event == "evict":
        _observatory.residency.evict(kind, int(nbytes or 0))
    else:
        _observatory.residency.invalidate(kind, nbytes, version=version)


def note_feedback(kind: str, reason: str) -> None:
    """The measured-feedback records (`_record_route_feedback`, the knn
    demotion latch, the heavy-split decision) charge their decisions
    here so the template route chooser can correlate route demotions with the
    device cost that motivated them — the decision logic itself stays in
    runtime/proxy.py untouched."""
    if not Global.enable_device_obs:
        return
    _M_FEEDBACK.labels(kind=kind, reason=reason).inc()


def note_compile_cache(outcome: str, site: str = "boot") -> None:
    """Compile-cache outcomes by site: engine/template_compile.py charges
    its whole-plan program cache (``hit`` / ``miss`` / ``evict``, site
    ``template``) — a storm of whole-plan variants is visible to the same
    counter the compile ledger's amortization claim reads."""
    _M_COMPILE_CACHE.labels(outcome=outcome, site=site).inc()


def read_device_input(signal: str, site: str | None = None):
    """The route chooser's ONLY read path into the observatory: every number the
    compiled-template route chooser consumes is read here by its
    ``DEVICE_INPUTS`` name, so the map stays the literal truth about
    what the actuator depends on."""
    if signal not in DEVICE_INPUTS:
        raise KeyError(f"{signal!r} is not a declared device input "
                       f"(see {sorted(DEVICE_INPUTS)})")
    if signal == "padding_efficiency":
        return _observatory.dispatch_ledger.padding_efficiency(site)
    if signal == "dispatches":
        return _observatory.dispatch_ledger.dispatch_counts(site)
    if signal == "variants":
        counts = _observatory.compile_ledger.variant_counts()
        return counts.get(site) if site is not None else counts
    if signal == "resident_bytes":
        return _observatory.residency.totals()
    if signal == "residency_high_water":
        return _observatory.residency.high_water()
    raise KeyError(f"device input {signal!r} has no live read path here "
                   "— scrape its backing metric "
                   f"{DEVICE_INPUTS[signal]!r} instead")


# ---------------------------------------------------------------------------
# the /device report (endpoint + console verb + Monitor line)
# ---------------------------------------------------------------------------

def render_device(k: int | None = None) -> tuple[str, dict]:
    """(plain-text table, JSON dict) for the /device endpoint and the
    ``device`` console verb: dispatch totals + padding efficiency on
    top, the per-(site, template, capacity) ranking under it, variants
    and the residency ledger against the budget below."""
    rep = _observatory.report(k)
    js = {**rep,
          "knobs": {"device_budget_mb": int(Global.device_budget_mb),
                    "device_variant_limit":
                        int(Global.device_variant_limit),
                    "xprof_dir": str(Global.xprof_dir)}}
    d = rep["dispatches"]
    eff = rep["padding_efficiency"]
    res = rep["residency"]

    lines = ["wukong-device  (device dispatch / compile / residency "
             "observatory)", ""]
    lines.append(
        f"DISPATCH count {d['count']:,}  cold {d['cold']:,}  "
        f"warm {d['warm']:,}  wall {d['wall_us'] / 1e3:,.1f}ms  "
        f"pad_eff {'-' if eff is None else format(eff, '.1%')}")
    if not rep["enabled"]:
        lines.append("  (enable_device_obs is OFF — nothing is being "
                     "observed)")
    lines.append("")
    lines.append(f"{'site':<18} {'template':<12} {'cap':>9} {'disp':>7} "
                 f"{'eff':>6} {'cold':>5} {'wall_ms':>9} {'moved':>10}")
    for r in rep["ranked"]:
        e = r["padding_efficiency"]
        lines.append(
            f"{r['site']:<18.18} {r['template']:<12.12} "
            f"{r['capacity']:>9,} {r['dispatches']:>7,} "
            f"{'-' if e is None else format(e, '.0%'):>6} "
            f"{r['cold']:>5,} {r['wall_us'] / 1e3:>9,.1f} "
            f"{r['bytes_moved']:>10,}")
    if not rep["ranked"]:
        lines.append("  (no dispatches charged — device routes idle?)")
    lines.append("")
    if rep["variants"]:
        lines.append("VARIANTS  " + "  ".join(
            f"{s}:{n}" for s, n in sorted(rep["variants"].items()))
            + f"  (limit {Global.device_variant_limit}/window)")
    # compiled-template demotion latches (engine/template_compile.py):
    # a failed/losing whole-plan compile is diagnosable here without a
    # trace dump (imported here: the engine imports this module)
    from wukong_tpu_torch.engine.template_compile import demotion_report

    demoted = demotion_report()
    if demoted:
        js["template_demotions"] = dict(demoted)
        lines.append("TEMPLATE  demoted  " + "  ".join(
            f"{t[:16]}:{r}" for t, r in sorted(demoted.items())))
    lines.append(
        f"RESIDENT  total {res['total_bytes']:,}B  "
        f"high-water {res['high_water_bytes']:,}B  "
        f"budget {res['budget_bytes']:,}B"
        + ("  OVER BUDGET" if res["over_budget"] else ""))
    if res["by_kind"]:
        lines.append("  by kind  " + "  ".join(
            f"{kk}:{v:,}B" for kk, v in sorted(res["by_kind"].items())))
    return "\n".join(lines) + "\n", js
