"""Tenant-aware SLO plane: per-tenant accounting, error budgets, burn-rate
sentinels, and the overload signal bus.

The port's copy of the JAX package's obs/slo.py:

- :class:`SLOSpec` / :class:`SLOTracker` — per-tenant SLO declarations (a
  latency-percentile target and an availability target, from the
  ``slo_specs`` knob or registered at runtime) and a rolling tracker fed at
  the proxy's reply point. It computes per-tenant compliance, the remaining
  error budget, and burn rates over a fast (``slo_fast_window_s``) and a
  slow (``slo_slow_window_s``) window.
- the **burn-rate sentinel** — when both windows exceed their thresholds
  (``slo_burn_fast_x`` / ``slo_burn_slow_x``) for a spec'd tenant, it
  counts ``wukong_slo_burn_alerts_total{tenant,window}``, journals a
  ``slo.burn`` event and dumps the tenant's trace through the flight
  recorder (reason ``SLO_BURN``), re-armed per tenant after
  ``slo_dump_cooldown_s``: one burn episode is one dump.
- :class:`OverloadSignals` — the overload signal bus: per-lane queue-delay
  EWMA, lane depth, pool utilization, sheds by cause, and per-tenant
  in-flight and arrival-rate EWMAs, published as pull gauges.
  ``ADMISSION_INPUTS`` maps each signal the admission controller reads
  (through :func:`read_admission_input`, its only read path) to the
  registered metric behind it.

Tenant labels are bounded: past ``max_tenants`` distinct values a new
tenant lands in the ``"__overflow__"`` bucket. Everything is gated on
``enable_tenant_accounting``; off, every hook is one knob check. All of it
is host bookkeeping at the reply point; nothing here touches a tensor.
"""

from __future__ import annotations

import sys
from collections import deque
from dataclasses import dataclass

from wukong_tpu_torch.analysis.lockdep import (
    declare_leaf,
    make_lock,
    register_global_lock,
)
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.obs.recorder import get_recorder
from wukong_tpu_torch.utils.logger import log_warn
from wukong_tpu_torch.utils.timer import get_usec

#: the bounded-cardinality catch-all tenant label
OVERFLOW_TENANT = "__overflow__"

#: every signal the admission controller reads, mapped to
#: the registered metric that backs it — scrape-able truth for each number
#: an admission decision reads (tests/test_torch_slo.py holds each named
#: metric to a registered one).
ADMISSION_INPUTS = {
    "lane_queue_delay_ewma": "wukong_lane_queue_delay_us",
    "lane_depth": "wukong_pool_lane_depth",
    "pool_utilization": "wukong_pool_utilization",
    "shed_by_cause": "wukong_shed_total",
    "tenant_inflight": "wukong_tenant_inflight",
    "tenant_arrival_rate": "wukong_tenant_arrival_rate",
    "tenant_latency": "wukong_tenant_latency_us",
    "tenant_replies": "wukong_queries_total",
}

EWMA_ALPHA = 0.2  # the JAX package's smoothing

#: replies a burn window needs before the sentinel may page from it — a
#: single bad reply after a quiet period is noise, not a budget cliff
BURN_MIN_SAMPLES = 16

# every lock here guards deque/dict/float updates only — innermost by
# construction (observes fire outside every other lock)
declare_leaf("slo.labels")
declare_leaf("slo.tenants")
declare_leaf("slo.signals")

_M_LATENCY = get_registry().histogram(
    "wukong_tenant_latency_us", "Per-tenant reply latency (usec)",
    labels=("tenant",))
_M_SHED = get_registry().counter(
    "wukong_shed_total", "Queries shed/degraded by cause and tenant",
    labels=("cause", "tenant"))
_M_ALERTS = get_registry().counter(
    "wukong_slo_burn_alerts_total",
    "Burn-rate sentinel alerts by tenant and window",
    labels=("tenant", "window"))


# ---------------------------------------------------------------------------
# bounded tenant labels
# ---------------------------------------------------------------------------

_label_lock = make_lock("slo.labels")
_seen_tenants: set = set()  # guarded by: _label_lock


def tenant_label(tenant) -> str:
    """The bounded metric-label form of a tenant id: itself while under
    ``max_tenants`` distinct values, ``__overflow__`` past the cap."""
    t = str(tenant) if tenant else "default"
    cap = max(int(Global.max_tenants), 1)
    with _label_lock:
        if t in _seen_tenants:
            return t
        if len(_seen_tenants) >= cap:
            return OVERFLOW_TENANT
        _seen_tenants.add(t)
        return t


def reset_labels() -> None:
    """Drop the seen-tenant set (tests / scenario runs)."""
    with _label_lock:
        _seen_tenants.clear()


# ---------------------------------------------------------------------------
# SLO specs + tracker
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SLOSpec:
    """One tenant's SLO: a latency-percentile target (``latency_ms`` at
    ``percentile``; 0 disables the latency SLI) and an availability
    target. A reply is *good* when it succeeded AND met the latency
    target; the error budget is ``1 - availability``."""

    tenant: str
    percentile: float = 0.95
    latency_ms: float = 0.0
    availability: float = 0.99

    @property
    def budget(self) -> float:
        return max(1.0 - float(self.availability), 1e-9)


def parse_specs(text: str) -> list[SLOSpec]:
    """Parse the ``slo_specs`` knob: ";"-separated
    ``<tenant>:<percentile>:<latency_ms>:<availability>`` entries.
    Percentile AND availability accept either fraction (0.999) or percent
    (99.9) form — an availability of 99.9 taken literally would leave a
    1e-9 error budget and page on every blip. Out-of-range values are a
    config error, not a silent mis-arm."""
    out = []
    for ent in (text or "").split(";"):
        ent = ent.strip()
        if not ent:
            continue
        parts = ent.split(":")
        if len(parts) != 4:
            raise ValueError(
                f"bad slo_specs entry {ent!r} (want "
                "tenant:percentile:latency_ms:availability)")
        p = float(parts[1])
        a = float(parts[3])
        a = a / 100.0 if a > 1 else a
        if not (0.0 < a < 1.0):
            raise ValueError(
                f"bad availability {parts[3]!r} in {ent!r} "
                "(want a fraction in (0,1) or a percent in (0,100))")
        out.append(SLOSpec(tenant=parts[0].strip(),
                           percentile=p / 100.0 if p > 1 else p,
                           latency_ms=float(parts[2]),
                           availability=a))
    return out


#: burn-window bucket width: the slow window aggregates into this many
#: time buckets (a bounded ring regardless of qps — a raw sample deque
#: would cap the slow window at slo_window recent samples and make the
#: two burn windows see identical data under any real load)
BURN_BUCKETS = 360


class _TenantSLO:
    """One tenant's rolling window (mutated under the tracker lock)."""

    __slots__ = ("samples", "buckets", "total", "good", "errors", "alerts",
                 "last_alert_us", "failed_trace")

    def __init__(self, window: int):
        # (t_us, dur_us, good) triples, newest last — feeds the latency
        # percentile and the windowed compliance view
        self.samples: deque = deque(maxlen=window)  # caller holds: slo.tenants (the tracker lock)
        # (bucket_start_us, n, bad) time buckets, newest last — feed the
        # burn-rate windows with bounded memory at ANY qps; pruned past
        # the slow window on every observe
        self.buckets: deque = deque()  # caller holds: slo.tenants (the tracker lock)
        self.total = 0
        self.good = 0
        self.errors = 0
        self.alerts = 0
        # sentinel cooldown cursor: None until the first alert, so a host
        # whose clock (uptime) is below the cooldown can still alert once
        self.last_alert_us = None
        # the newest failed reply's trace: what a burn dump shows
        self.failed_trace = None

    def charge_bucket(self, now: int, good: bool, slow_window_s: int) -> None:
        """Caller holds the tracker lock. Bucket width tracks the slow
        window so the ring stays ~BURN_BUCKETS entries."""
        width_us = max(slow_window_s * 1_000_000 // BURN_BUCKETS, 1)
        start = now - now % width_us
        if self.buckets and self.buckets[-1][0] == start:
            s, n, bad = self.buckets[-1]
            self.buckets[-1] = (s, n + 1, bad + int(not good))
        else:
            self.buckets.append((start, 1, int(not good)))
        cut = now - slow_window_s * 1_000_000 - width_us
        while self.buckets and self.buckets[0][0] < cut:
            self.buckets.popleft()


class SLOTracker:
    """Per-tenant SLO accounting fed at the reply observation point."""

    def __init__(self, window: int | None = None):
        self._window = window
        self._lock = make_lock("slo.tenants")
        self._tenants: dict[str, _TenantSLO] = {}  # guarded by: _lock
        self._specs: dict[str, SLOSpec] = {}  # guarded by: _lock
        # last parsed slo_specs text (change-detection for runtime reloads)
        self._specs_src = None  # guarded by: _lock

    # ------------------------------------------------------------------
    def register(self, spec: SLOSpec) -> None:
        """Runtime SLO registration (idempotent per tenant; last wins)."""
        with self._lock:
            self._specs[spec.tenant] = spec

    def spec(self, tenant: str) -> SLOSpec | None:
        self._reload_config_specs()
        with self._lock:
            return self._specs.get(tenant)

    def _reload_config_specs(self) -> None:
        """Fold ``slo_specs`` into the registry when the knob changed
        (runtime ``config -s`` reload picks up new declarations)."""
        src = Global.slo_specs
        with self._lock:
            if src == self._specs_src:
                return
            self._specs_src = src
        try:
            specs = parse_specs(src)
        except ValueError as e:
            log_warn(f"slo_specs ignored: {e}")
            return
        for sp in specs:
            self.register(sp)

    # ------------------------------------------------------------------
    def observe(self, tenant: str, dur_us: int, ok: bool,
                trace=None) -> dict | None:
        """Fold one reply into its tenant's window; returns the burn
        verdict when the sentinel trips, else None. ``tenant`` must
        already be the bounded label (``tenant_label``). The tripped
        tenant's trace (when one rode the query) auto-dumps through the
        flight recorder with reason ``SLO_BURN``: the tenant's newest
        failed reply's trace, which carries the failure's evidence (a
        ``fault.injected`` event, a timeout), else this reply's. (The JAX
        sentinel dumps the reply that tripped it, which may be a good
        one; the verdicts are the same.)"""
        self._reload_config_specs()
        now = get_usec()
        win = self._window or max(int(Global.slo_window), 16)
        verdict = None
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                st = self._tenants[tenant] = _TenantSLO(win)
            spec = self._specs.get(tenant)
            good = bool(ok) and (spec is None or spec.latency_ms <= 0
                                 or dur_us <= spec.latency_ms * 1000.0)
            st.samples.append((now, int(dur_us), good))
            st.charge_bucket(now, good,
                             max(int(Global.slo_slow_window_s), 1))
            st.total += 1
            st.good += int(good)
            st.errors += int(not ok)
            if not ok and trace is not None:
                st.failed_trace = trace
            if spec is not None:
                verdict = self._maybe_alert(st, spec, now)
                if verdict is not None and st.failed_trace is not None:
                    trace = st.failed_trace
        _M_LATENCY.labels(tenant=tenant).observe(dur_us)
        if verdict is not None:
            for w in verdict["windows"]:
                _M_ALERTS.labels(tenant=tenant, window=w).inc()
            # the burn lands in the cluster-event journal FIRST so the
            # flight-recorder dump can reference its triggering event id
            from wukong_tpu_torch.obs.events import emit_event

            eid = emit_event("slo.burn", tenant=tenant,
                             fast_burn=verdict["fast_burn"],
                             slow_burn=verdict["slow_burn"])
            verdict["event_id"] = eid
            if trace is not None:
                get_recorder().dump(trace, "SLO_BURN", event_id=eid)
            log_warn(
                f"SLO burn: tenant {tenant} fast={verdict['fast_burn']:.1f}x"
                f" slow={verdict['slow_burn']:.1f}x (budget "
                f"{spec.budget:.4f}"
                + (f", event {eid}" if eid else "") + "); "
                + ("trace dumped" if trace is not None
                   else "no trace on this reply (enable_tracing for dumps)"))
        return verdict

    def _maybe_alert(self, st: _TenantSLO, spec: SLOSpec,
                     now: int) -> dict | None:
        """Caller holds the tracker lock. The SRE-workbook multi-window
        rule: page only when BOTH the fast and the slow window burn the
        budget faster than their thresholds."""
        if st.last_alert_us is not None and now - st.last_alert_us < max(
                int(Global.slo_dump_cooldown_s), 0) * 1_000_000:
            return None
        fast, n_fast = self._burn(
            st, now, max(int(Global.slo_fast_window_s), 1), spec.budget)
        slow, _n_slow = self._burn(
            st, now, max(int(Global.slo_slow_window_s), 1), spec.budget)
        if n_fast < BURN_MIN_SAMPLES:
            return None  # one bad reply after a quiet spell is not a cliff
        fast_hit = fast >= max(float(Global.slo_burn_fast_x), 1.0)
        slow_hit = slow >= max(float(Global.slo_burn_slow_x), 1.0)
        if not (fast_hit and slow_hit):
            return None
        st.alerts += 1
        st.last_alert_us = now
        return {"tenant": spec.tenant, "fast_burn": round(fast, 2),
                "slow_burn": round(slow, 2),
                "windows": ("fast", "slow")}

    @staticmethod
    def _burn(st: _TenantSLO, now: int, window_s: int,
              budget: float) -> tuple[float, int]:
        """(burn rate, sample count) over one window: the window's bad
        fraction divided by the error budget — 1.0 means the budget is
        being consumed at exactly the rate that exhausts it over the SLO
        period. Reads the time-bucket ring, NOT the bounded sample deque:
        the slow window must see its full history at any qps, or the
        multi-window filter degenerates into two copies of the fast one."""
        cut = now - window_s * 1_000_000
        n = bad = 0
        for (t, cnt, b) in reversed(st.buckets):
            if t < cut:
                break
            n += cnt
            bad += b
        return ((bad / n) / budget if n else 0.0), n

    # ------------------------------------------------------------------
    def compliance(self, tenant: str) -> dict | None:
        """One tenant's SLO view: windowed compliance, observed latency
        percentile, remaining error budget, and both burn rates."""
        self._reload_config_specs()
        now = get_usec()
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                return None
            spec = self._specs.get(tenant)
            samples = list(st.samples)
            total, cum_good, errors, alerts = (st.total, st.good,
                                               st.errors, st.alerts)
            fast = slow = None
            if spec is not None:
                fast, _ = self._burn(st, now, max(
                    int(Global.slo_fast_window_s), 1), spec.budget)
                slow, _ = self._burn(st, now, max(
                    int(Global.slo_slow_window_s), 1), spec.budget)
        n = len(samples)
        good = sum(1 for (_t, _d, g) in samples if g)
        lats = sorted(d for (_t, d, _g) in samples)
        p = spec.percentile if spec is not None else 0.95
        p_us = lats[min(int(p * n), n - 1)] if n else 0
        out = {
            "tenant": tenant,
            "samples": n,
            "total": total,
            "errors": errors,
            "compliance": round(good / n, 4) if n else None,
            "cum_compliance": round(cum_good / total, 4) if total else None,
            "latency_p_us": int(p_us),
            "alerts": alerts,
            "spec": None,
        }
        if spec is not None:
            bad_frac = (n - good) / n if n else 0.0
            out["spec"] = {"percentile": spec.percentile,
                           "latency_ms": spec.latency_ms,
                           "availability": spec.availability}
            # fraction of the error budget still unspent over the window
            out["error_budget_remaining"] = round(
                1.0 - bad_frac / spec.budget, 4)
            out["burn"] = {"fast": round(fast, 2), "slow": round(slow, 2)}
            out["latency_met"] = (spec.latency_ms <= 0
                                  or p_us <= spec.latency_ms * 1000.0)
        return out

    def report(self) -> dict:
        """Every tracked tenant's compliance view (spec'd tenants first,
        worst fast-burn first)."""
        with self._lock:
            tenants = list(self._tenants)
        rows = [c for t in tenants if (c := self.compliance(t)) is not None]
        rows.sort(key=lambda r: (-(r.get("burn") or {}).get("fast", -1.0),
                                 r["tenant"]))
        return {"tenants": rows,
                "specs": len([r for r in rows if r["spec"] is not None])}

    def reset(self) -> None:
        """Drop tracker state (tests / scenario runs). Registry counters
        are cumulative and stay."""
        with self._lock:
            self._tenants.clear()
            self._specs.clear()
            self._specs_src = None


# ---------------------------------------------------------------------------
# the overload signal bus
# ---------------------------------------------------------------------------

class _LaneSignal:
    __slots__ = ("ewma_us", "count")

    def __init__(self):
        self.ewma_us = 0.0
        self.count = 0


class _TenantSignal:
    __slots__ = ("inflight", "arrival_ewma_qps", "last_arrival_us")

    def __init__(self):
        self.inflight = 0
        self.arrival_ewma_qps = 0.0
        self.last_arrival_us = 0


class OverloadSignals:
    """The inputs the admission controller reads, accumulated
    where the events happen (scheduler pops, shed sites, proxy admission)
    and published as pull gauges — see ``ADMISSION_INPUTS``."""

    def __init__(self):
        self._lock = make_lock("slo.signals")
        self._lanes: dict[str, _LaneSignal] = {}  # guarded by: _lock
        self._tenants: dict[str, _TenantSignal] = {}  # guarded by: _lock
        self._sheds: dict[str, int] = {}  # guarded by: _lock
        # (cause, tenant) -> count: who absorbed each shed class — the
        # admission drill's "bulk absorbs the damage" evidence
        self._shed_tenants: dict = {}  # guarded by: _lock

    # -- producers ------------------------------------------------------
    def note_queue_delay(self, lane: str, dur_us: int) -> None:
        """One pool-queue wait, charged by the popping engine."""
        with self._lock:
            s = self._lanes.get(lane)
            if s is None:
                s = self._lanes[lane] = _LaneSignal()
            s.count += 1
            s.ewma_us = (float(dur_us) if s.count == 1
                         else EWMA_ALPHA * dur_us
                         + (1 - EWMA_ALPHA) * s.ewma_us)

    def note_admit(self, tenant: str) -> None:
        """One query admitted for a tenant (proxy entry)."""
        now = get_usec()
        with self._lock:
            s = self._tenants.get(tenant)
            if s is None:
                s = self._tenants[tenant] = _TenantSignal()
            s.inflight += 1
            if s.last_arrival_us:
                gap = max(now - s.last_arrival_us, 1)
                s.arrival_ewma_qps = (EWMA_ALPHA * (1e6 / gap)
                                      + (1 - EWMA_ALPHA)
                                      * s.arrival_ewma_qps)
            s.last_arrival_us = now

    def note_done(self, tenant: str) -> None:
        with self._lock:
            s = self._tenants.get(tenant)
            if s is not None:
                s.inflight = max(s.inflight - 1, 0)

    def note_shed(self, cause: str, tenant: str) -> None:
        with self._lock:
            self._sheds[cause] = self._sheds.get(cause, 0) + 1
            k = (cause, tenant)
            self._shed_tenants[k] = self._shed_tenants.get(k, 0) + 1
        _M_SHED.labels(cause=cause, tenant=tenant).inc()

    # -- pull-gauge feeds ----------------------------------------------
    def lane_delay_series(self) -> dict:
        with self._lock:
            return {(lane,): s.ewma_us for lane, s in self._lanes.items()}

    def inflight_series(self) -> dict:
        with self._lock:
            return {(t,): s.inflight for t, s in self._tenants.items()}

    def arrival_series(self) -> dict:
        with self._lock:
            return {(t,): s.arrival_ewma_qps
                    for t, s in self._tenants.items()}

    # -- the bus view ---------------------------------------------------
    def report(self) -> dict:
        """One structured snapshot of every admission input (the slo
        report's ``signals`` section). Lane depths and pool utilization are
        read from their live pull sources so the bus never caches them."""
        with self._lock:
            lanes = {lane: {"queue_delay_ewma_us": round(s.ewma_us, 1),
                            "pops": s.count}
                     for lane, s in self._lanes.items()}
            tenants = {t: {"inflight": s.inflight,
                           "arrival_qps": round(s.arrival_ewma_qps, 2)}
                       for t, s in self._tenants.items()}
            sheds = dict(self._sheds)
            shed_tenants = {f"{c}/{t}": n
                            for (c, t), n in self._shed_tenants.items()}
        depths = {}
        util = 0.0
        try:
            from wukong_tpu_torch.runtime.scheduler import (
                _lane_depth_series,
                _pool_utilization,
            )

            depths = {k[0]: int(v) for k, v in
                      _lane_depth_series().items()}
            util = _pool_utilization()
        except Exception:
            pass  # no pool module state yet: the bus stays readable
        for lane, d in depths.items():
            lanes.setdefault(lane, {"queue_delay_ewma_us": 0.0,
                                    "pops": 0})["depth"] = d
        return {"lanes": lanes, "pool_utilization": round(util, 4),
                "shed_by_cause": sheds, "shed_by_tenant": shed_tenants,
                "tenants": tenants,
                "inputs": dict(ADMISSION_INPUTS)}

    def reset(self) -> None:
        with self._lock:
            self._lanes.clear()
            self._tenants.clear()
            self._sheds.clear()
            self._shed_tenants.clear()


# process-wide instances (the proxy, scheduler, batcher and the slo verb
# share them)
_tracker = SLOTracker()
_signals = OverloadSignals()
# checked mode (lockdep.install) rebuilds the process-wide ledgers' locks
register_global_lock(_tracker, "_lock", "slo.tenants")
register_global_lock(_signals, "_lock", "slo.signals")
register_global_lock(sys.modules[__name__], "_label_lock", "slo.labels")

get_registry().gauge(
    "wukong_lane_queue_delay_us",
    "Per-lane pool queue-delay EWMA (usec)",
    labels=("lane",)).set_function(_signals.lane_delay_series)
get_registry().gauge(
    "wukong_tenant_inflight", "In-flight queries per tenant",
    labels=("tenant",)).set_function(_signals.inflight_series)
get_registry().gauge(
    "wukong_tenant_arrival_rate",
    "Per-tenant arrival-rate EWMA (queries/s)",
    labels=("tenant",)).set_function(_signals.arrival_series)


def get_slo() -> SLOTracker:
    return _tracker


def get_overload() -> OverloadSignals:
    return _signals


def maybe_note_queue_delay(lane: str, dur_us: int) -> None:
    """The scheduler's pop hook: one knob check when accounting is off."""
    if not Global.enable_tenant_accounting:
        return
    _signals.note_queue_delay(lane, dur_us)


def maybe_note_shed(cause: str, tenant) -> None:
    """Shed-site hook (scheduler queue expiry, batcher member
    settlement, reply-side timeout/budget): one knob check when off."""
    if not Global.enable_tenant_accounting:
        return
    _signals.note_shed(cause, tenant_label(tenant))


# ---------------------------------------------------------------------------
# the admission controller's ONLY read path
# ---------------------------------------------------------------------------

def read_admission_input(signal: str):
    """The single accessor through which the admission controller
    (runtime/admission.py) reads the overload bus. Every signal name must
    be declared in ``ADMISSION_INPUTS`` (KeyError otherwise; the
    controller's literal ``CONSUMED_INPUTS`` is held to this registry by
    tests/test_torch_admission.py). Returns live values, never cached:

    - ``lane_queue_delay_ewma`` -> {lane: ewma_us}
    - ``lane_depth``            -> {lane: queued items}
    - ``pool_utilization``      -> float 0..1
    - ``tenant_inflight``       -> {tenant: in-flight count}
    - ``tenant_arrival_rate``   -> {tenant: arrival EWMA q/s}
    - ``shed_by_cause``         -> {cause: count}
    - ``tenant_latency``        -> {tenant: windowed p-latency us}
    - ``tenant_replies``        -> {tenant: windowed reply count}
    """
    if signal not in ADMISSION_INPUTS:
        raise KeyError(f"undeclared admission input {signal!r} "
                       f"(declared: {sorted(ADMISSION_INPUTS)})")
    if signal == "lane_queue_delay_ewma":
        return {lane: v for (lane,), v
                in _signals.lane_delay_series().items()}
    if signal == "tenant_inflight":
        return {t: v for (t,), v in _signals.inflight_series().items()}
    if signal == "tenant_arrival_rate":
        return {t: v for (t,), v in _signals.arrival_series().items()}
    if signal == "shed_by_cause":
        with _signals._lock:
            return dict(_signals._sheds)
    if signal in ("lane_depth", "pool_utilization"):
        try:
            from wukong_tpu_torch.runtime.scheduler import (
                _lane_depth_series,
                _pool_utilization,
            )
        except Exception:
            return {} if signal == "lane_depth" else 0.0
        if signal == "lane_depth":
            return {k[0]: int(v) for k, v in _lane_depth_series().items()}
        return float(_pool_utilization())
    # tenant_latency / tenant_replies: the tracker's windowed view
    rep = _tracker.report()
    if signal == "tenant_latency":
        return {r["tenant"]: r["latency_p_us"] for r in rep["tenants"]}
    return {r["tenant"]: r["samples"] for r in rep["tenants"]}


# ---------------------------------------------------------------------------
# the slo report (console verb + Monitor line)
# ---------------------------------------------------------------------------

def render_slo(k: int | None = None) -> tuple[str, dict]:
    """(plain-text table, JSON dict) for the
    ``slo`` console verb: per-tenant compliance / error budget / burn
    rates on top, the overload signal bus below."""
    rep = _tracker.report()
    sig = _signals.report()
    kk = k if k is not None else max(int(Global.top_k), 1)
    js = {"tenants": rep["tenants"], "signals": sig}

    lines = ["wukong-slo  (per-tenant SLO + overload signals)", ""]
    lines.append(f"{'tenant':<14} {'samples':>8} {'compl':>7} "
                 f"{'budget':>7} {'burn_f':>7} {'burn_s':>7} "
                 f"{'p_us':>9} {'alerts':>6} {'target':>16}")
    for r in rep["tenants"][:kk]:
        spec = r["spec"]
        tgt = ("-" if spec is None else
               f"p{int(spec['percentile'] * 100)}"
               + (f"<{spec['latency_ms']:g}ms" if spec["latency_ms"] > 0
                  else "")
               + f"@{spec['availability']:g}")
        burn = r.get("burn") or {}
        budget = r.get("error_budget_remaining")
        if budget is not None:
            budget = max(budget, -9.0)  # display floor; JSON stays exact
        lines.append(
            f"{r['tenant']:<14.14} {r['samples']:>8,} "
            f"{'-' if r['compliance'] is None else format(r['compliance'], '.1%'):>7} "
            f"{'-' if budget is None else format(budget, '.0%'):>7} "
            f"{'-' if 'fast' not in burn else format(burn['fast'], '.1f'):>7} "
            f"{'-' if 'slow' not in burn else format(burn['slow'], '.1f'):>7} "
            f"{r['latency_p_us']:>9,} {r['alerts']:>6} {tgt:>16}")
    if not rep["tenants"]:
        lines.append("  (no tenant replies observed — "
                     "enable_tenant_accounting on?)")
    lines.append("")
    lines.append(f"SIGNALS  pool_utilization {sig['pool_utilization']:.0%}")
    for lane, d in sorted(sig["lanes"].items()):
        lines.append(f"  lane[{lane}]: delay_ewma "
                     f"{d['queue_delay_ewma_us']:,.0f}us"
                     + (f", depth {d['depth']}" if "depth" in d else "")
                     + f" ({d['pops']:,} pops)")
    for cause, n in sorted(sig["shed_by_cause"].items()):
        lines.append(f"  shed[{cause}]: {n:,}")
    for t, d in sorted(sig["tenants"].items()):
        lines.append(f"  tenant[{t}]: inflight {d['inflight']}, "
                     f"arrival {d['arrival_qps']:,.1f} q/s")
    return "\n".join(lines) + "\n", js
