"""The admission control plane: the decision half of the tenant SLO plane.

The port's copy of the JAX package's runtime/admission.py, consulted at the
proxy's admission point before any work reaches an engine:

- :class:`AdmissionController` — per-tenant quotas (token-bucket q/s,
  in-flight caps, aggregate row budgets, from the ``admission_quotas``
  knob) plus the three-rung overload degrade ladder. Every signal it reads
  comes through ``obs.slo.read_admission_input`` and is named in the
  literal ``CONSUMED_INPUTS`` tuple below.
- **Degrade before drop**: rung 1 DEFERS the query past the batch window
  (closed-loop clients slow down, congestion drains), rung 2 serves a
  PARTIAL result through the ``mark_partial``/Deadline machinery (a
  tighter deadline and row budget stamped at admission; on the GPU engine
  a chain that has launched runs to its end, and the partial reply keeps
  the rows it produced), rung 3 REJECTS with a structured
  ``CAPACITY_EXCEEDED`` reply carrying a retry-after hint — an admission
  reply that reaches no engine, never the proxy's host fallback. The
  ladder applies lowest-weight-first (``rung = level - 2*rank``): bulk is
  deferred at level 1 and partialed at level 2 before silver is first
  touched at level 3, and the top weight class is never ladder-degraded.
  A token shortfall the bucket refills within the defer window defers
  instead of rejecting.
- :class:`FairQueue` — deficit-round-robin over per-tenant sub-queues,
  layered under the engine pool's lanes when admission is armed: default
  lane submissions land in per-tenant sub-queues and engines drain them by
  weight. An item carrying ``owner_tenant`` is queued and weighted as its
  owner (priority inheritance).
- Congestion: the per-lane queue-delay EWMAs and the aggregate in-flight
  and queued depth against the in-flight ceiling set
  :meth:`AdmissionController.overload_level`, which picks the rung.

Sheds are charged to ``wukong_shed_total`` under the closed ``SHED_CAUSES``
set and journaled (``admission.shed`` / ``admission.quota``, at most one
event per tenant and cause a second). Off by default
(``enable_admission``): every hook is one knob check and the serving path
is unchanged. Both locks are lockdep leaves: the controller and the queue
never call out while holding them.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from wukong_tpu_torch.analysis.lockdep import (
    declare_leaf,
    make_lock,
    register_global_lock,
)
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.obs.events import emit_event
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.obs.slo import (
    EWMA_ALPHA,
    maybe_note_shed,
    read_admission_input,
    tenant_label,
)
from wukong_tpu_torch.utils.timer import get_usec

#: every overload-bus signal this controller reads — each element must
#: be an ``ADMISSION_INPUTS`` key (obs/slo.py), and every
#: ``read_admission_input`` call site below must name one of these.
#: tests/test_torch_admission.py holds both containments.
CONSUMED_INPUTS = (
    "lane_queue_delay_ewma",
    "lane_depth",
    "pool_utilization",
    "tenant_inflight",
    "tenant_arrival_rate",
    "shed_by_cause",
)

#: the closed set of shed causes this plane may charge to
#: ``wukong_shed_total`` — one per ladder rung plus the quota breach.
#: tests/test_torch_admission.py checks that every literal cause at a
#: maybe_note_shed call site here is declared, and every declared cause
#: has one.
SHED_CAUSES = (
    "admission_defer",
    "admission_partial",
    "admission_reject",
    "admission_quota",
)

#: ladder rung names, index = rung (0 admits)
_RUNGS = ("admit", "defer", "partial", "reject")

#: at most one journaled event per (kind, tenant, cause) per this many
#: usec — a shed storm is one timeline entry, not a thousand
EVENT_COOLDOWN_US = 1_000_000

#: overload-level recompute interval: the level is derived from EWMAs,
#: so reusing it for 2ms decides identically and keeps the armed
#: plane's per-admit cost to a clock read instead of the signal scans
_LEVEL_TTL_US = 2_000

# both admission locks guard dict/float updates only and never call out
# while held (signal reads happen before, metrics/events after) —
# innermost by construction, and declared so
declare_leaf("admission.state")
declare_leaf("admission.queue")

_M_DECISIONS = get_registry().counter(
    "wukong_admission_decisions_total",
    "Admission decisions by outcome and tenant",
    labels=("decision", "tenant"))
_M_LEVEL = get_registry().gauge(
    "wukong_admission_overload_level",
    "Current overload level (0 calm .. 3 shedding)")


# ---------------------------------------------------------------------------
# quotas
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TenantQuota:
    """One tenant's admission contract: DRR/shed weight, token-bucket
    q/s quota, in-flight cap, and aggregate intermediate-row budget
    (rows/s across all its queries). 0 disables that limit."""

    tenant: str
    weight: int = 1
    qps: float = 0.0
    inflight: int = 0
    rows_per_s: int = 0


def parse_quotas(text: str) -> dict[str, TenantQuota]:
    """Parse the ``admission_quotas`` knob: ";"-separated
    ``<tenant>:<weight>:<qps>:<inflight>:<rows_per_s>`` entries.
    Malformed entries are a config error, not a silent mis-arm."""
    out: dict[str, TenantQuota] = {}
    for ent in (text or "").split(";"):
        ent = ent.strip()
        if not ent:
            continue
        parts = ent.split(":")
        if len(parts) != 5:
            raise ValueError(
                f"bad admission_quotas entry {ent!r} (want "
                "tenant:weight:qps:inflight:rows_per_s)")
        t = parts[0].strip()
        w = int(parts[1])
        if not t or w < 1:
            raise ValueError(
                f"bad admission_quotas entry {ent!r} (weight >= 1)")
        out[t] = TenantQuota(t, w, float(parts[2]), int(parts[3]),
                             int(parts[4]))
    return out


def effective_tenant(obj) -> str:
    """The identity an item is scheduled AS: its owner when it is
    maintenance work for a standing query (priority inheritance), else
    its own tenant stamp, else the default tenant."""
    t = getattr(obj, "owner_tenant", None)
    if not t:
        t = getattr(obj, "tenant", None)
    return str(t) if t else "default"


# ---------------------------------------------------------------------------
# decisions
# ---------------------------------------------------------------------------

class Decision:
    """One admission verdict. ``action`` is an ``_RUNGS`` member;
    ``wait_s`` is the rung-1 defer the CALLER sleeps (the controller
    never blocks under its lock); ``retry_after_s`` rides the rung-3
    ``CAPACITY_EXCEEDED`` reply."""

    __slots__ = ("action", "cause", "tenant", "wait_s", "retry_after_s",
                 "level", "reason")

    def __init__(self, action: str, tenant: str, cause: str | None = None,
                 wait_s: float = 0.0, retry_after_s: float = 0.0,
                 level: int = 0, reason: str = ""):
        self.action = action
        self.tenant = tenant
        self.cause = cause
        self.wait_s = wait_s
        self.retry_after_s = retry_after_s
        self.level = level
        self.reason = reason

    @property
    def admitted(self) -> bool:
        return self.action in ("admit", "defer", "partial")

    def apply(self, q) -> None:
        """Stamp a rung-2 PARTIAL admission onto a prepared query: the
        tightened deadline + row budget whose expiry the
        ``mark_partial`` machinery converts into a complete=False reply
        with the rows produced so far."""
        if self.action != "partial":
            return
        from wukong_tpu_torch.runtime.resilience import Deadline

        q.deadline = Deadline(
            max(int(Global.admission_partial_deadline_ms), 1),
            max(int(Global.admission_partial_budget_rows), 0))


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

class _TenantState:
    """Per-tenant quota state: the token bucket + the aggregate-row
    EWMA. All fields guarded by the controller's state lock."""

    __slots__ = ("tokens", "last_refill_us", "rows_rate", "last_rows_us")

    def __init__(self, burst: float):
        self.tokens = burst
        self.last_refill_us = 0
        self.rows_rate = 0.0
        self.last_rows_us = 0


class AdmissionController:
    """Per-tenant quotas + the overload degrade ladder, consulted at
    the proxy admission point (after ``_admit`` notes the arrival, so
    the tenant's in-flight signal already includes the query under
    decision). Reads ONLY ``CONSUMED_INPUTS`` signals."""

    def __init__(self, clock=None):
        self._lock = make_lock("admission.state")
        self._tenants: dict[str, _TenantState] = {}  # guarded by: _lock
        self._decisions: dict = {}  # guarded by: _lock
        self._last_event: dict = {}  # guarded by: _lock
        # quota-parse cache: an immutable (src, parsed) pair swapped
        # wholesale, so weight()/quota_for() stay lock-free (the fair
        # queue and the heavy-lane cap consult them under pool locks)
        self._qcache: tuple = ("", {})  # lock-free: atomic tuple swap
        self._clock = clock or get_usec  # lock-free: injectable (tests)
        self.last_level = 0  # lock-free: int gauge feed, monotonic GIL
        # (stamp_us, level): the computed overload level, reused within
        # _LEVEL_TTL_US so the armed plane's per-query cost stays flat
        self._level_cache: tuple = (-_LEVEL_TTL_US, 0)  # lock-free: tuple swap

    # -- quotas (lock-free reads) --------------------------------------
    def _quota_map(self) -> dict[str, TenantQuota]:
        src = str(Global.admission_quotas)
        cached_src, cached = self._qcache
        if cached_src == src:
            return cached
        parsed = parse_quotas(src)
        self._qcache = (src, parsed)  # benign race: idempotent re-parse
        return parsed

    def quota_for(self, tenant: str) -> TenantQuota:
        q = self._quota_map().get(tenant)
        if q is None:
            q = TenantQuota(tenant,
                            max(int(Global.admission_default_weight), 1))
        return q

    def weight(self, tenant: str) -> int:
        return self.quota_for(tenant).weight

    def heavy_cap_for(self, tenant: str, cap: int, holders: dict) -> int:
        """Per-tenant share of the heavy lane's ``cap`` slots: weighted
        by quota weight across the tenants currently holding slots plus
        the requester (work-conserving — a lone tenant gets the whole
        lane). Pure function of the quota map: safe under pool locks."""
        active = set(holders) | {tenant}
        total_w = sum(self.weight(t) for t in active) or 1
        return max((cap * self.weight(tenant)) // total_w, 1)

    # -- overload level -------------------------------------------------
    def _inflight_cap(self) -> int:
        cap = int(Global.admission_max_inflight)
        if cap > 0:
            return cap
        # derived capacity: 4x the live engine count when a pool runs
        # (structural config, not a telemetry signal), else a fixed 8
        # for the direct-execution serving path
        try:
            from wukong_tpu_torch.runtime.scheduler import _live_engine_count

            n = _live_engine_count()
        except Exception:
            n = 0
        return 4 * n if n > 0 else 8

    def overload_level(self) -> int:
        """0 calm .. 3 shedding, from the congestion signals: the worst
        per-lane queue-delay EWMA vs ``admission_delay_budget_us``, and
        aggregate in-flight + queued depth vs the in-flight ceiling.
        Each doubling past budget raises the level one rung.

        Recomputed at most once per ``_LEVEL_TTL_US`` — the inputs are
        EWMAs, so a 2ms-stale level decides identically while keeping
        the armed plane's per-query hot path to a clock read (the
        uncached walk costs ~15us of signal scans per admit)."""
        stamp, lvl = self._level_cache
        now = self._clock()
        if 0 <= now - stamp < _LEVEL_TTL_US:
            return lvl
        delays = read_admission_input("lane_queue_delay_ewma")
        depths = read_admission_input("lane_depth")
        inflight = read_admission_input("tenant_inflight")
        budget = max(int(Global.admission_delay_budget_us), 1)
        cap = max(self._inflight_cap(), 1)
        x = max(
            (max(delays.values()) if delays else 0.0) / budget,
            sum(inflight.values()) / cap if inflight else 0.0,
            sum(depths.values()) / cap if depths else 0.0,
        )
        level = 0 if x < 1.0 else 1 if x < 2.0 else 2 if x < 4.0 else 3
        self._level_cache = (now, level)  # benign race: idempotent
        self.last_level = level
        _M_LEVEL.set(level)
        return level

    def _rank(self, tenant: str) -> tuple[int, int]:
        """(weight rank, top rank) among the active tenants — quota-
        declared ones plus whoever the arrival signal currently sees.
        Rank 0 is the lowest weight class (shed first)."""
        active = set(self._quota_map()) | {tenant}
        arrivals = read_admission_input("tenant_arrival_rate")
        active.update(t for t, r in arrivals.items() if r > 0)
        weights = sorted({self.weight(t) for t in active})
        return weights.index(self.weight(tenant)), len(weights) - 1

    # -- the admission verdict ------------------------------------------
    def admit(self, tenant, cached: bool = False) -> Decision:
        """One query's verdict. ``cached`` marks a result-cache fast
        hit: it consumes no engine capacity, so only the q/s + in-flight
        quotas apply (the ladder never degrades a hit). Signal reads
        happen before the state lock, metrics/events after — the state
        lock stays a leaf."""
        ten = tenant_label(tenant)
        quota = self.quota_for(ten)
        now = self._clock()
        defer_s = self._defer_s()

        # quota signals read outside the lock
        inflight = (read_admission_input("tenant_inflight").get(ten, 0)
                    if quota.inflight > 0 else 0)

        verdict: Decision | None = None
        with self._lock:
            st = self._tenants.get(ten)
            if st is None:
                st = self._tenants[ten] = _TenantState(
                    self._burst(quota))
                st.last_refill_us = now
            if quota.qps > 0:
                self._refill(st, quota, now)
                if st.tokens >= 1.0:
                    st.tokens -= 1.0
                else:
                    wait_s = (1.0 - st.tokens) / quota.qps
                    if wait_s <= defer_s:
                        # degrade before drop: the bucket refills within
                        # the defer window — pre-charge it and wait
                        st.tokens -= 1.0
                        verdict = Decision(
                            "defer", ten, "admission_defer",
                            wait_s=wait_s, reason="quota_qps")
                    else:
                        verdict = Decision(
                            "reject", ten, "admission_quota",
                            retry_after_s=max(
                                wait_s,
                                float(Global.admission_retry_after_s)),
                            reason="quota_qps")
            if verdict is None and quota.inflight > 0 \
                    and inflight > quota.inflight:
                verdict = Decision(
                    "reject", ten, "admission_quota",
                    retry_after_s=float(Global.admission_retry_after_s),
                    reason="quota_inflight")
            if verdict is None and quota.rows_per_s > 0 \
                    and st.rows_rate > quota.rows_per_s and not cached:
                # over the aggregate row budget: this tenant's replies
                # degrade to partials until the rate decays back under
                verdict = Decision("partial", ten, "admission_partial",
                                   reason="quota_rows")
        if verdict is None and not cached:
            verdict = self._ladder(ten)
        if verdict is None:
            verdict = Decision("admit", ten)
        self._record(verdict)
        return verdict

    def _ladder(self, ten: str) -> Decision | None:
        """The lowest-weight-first degrade ladder. The top weight class
        is never ladder-degraded (its protection is the point of the
        plane; its own quotas and deadlines still apply), and each
        weight class runs two rungs behind the one below it — bulk is
        partialed before silver is first touched."""
        level = self.overload_level()
        if level <= 0:
            return None
        rank, top = self._rank(ten)
        if rank >= top:
            return None  # protected: the highest active weight class
        rung = min(level - 2 * rank, 3)
        if rung <= 0:
            return None
        action = _RUNGS[rung]
        if action == "defer":
            return Decision("defer", ten, "admission_defer",
                            wait_s=self._defer_s(), level=level,
                            reason="overload")
        if action == "partial":
            return Decision("partial", ten, "admission_partial",
                            level=level, reason="overload")
        return Decision(
            "reject", ten, "admission_reject",
            retry_after_s=float(Global.admission_retry_after_s),
            level=level, reason="overload")

    # -- bucket / rate plumbing -----------------------------------------
    @staticmethod
    def _burst(quota: TenantQuota) -> float:
        return max(quota.qps * max(float(Global.admission_burst_x), 1.0),
                   1.0)

    def _refill(self, st: _TenantState, quota: TenantQuota,
                now: int) -> None:
        dt = max(now - st.last_refill_us, 0) / 1e6
        st.last_refill_us = now
        st.tokens = min(st.tokens + dt * quota.qps, self._burst(quota))

    @staticmethod
    def _defer_s() -> float:
        ms = int(Global.admission_defer_ms)
        if ms > 0:
            return ms / 1e3
        return 2.0 * max(int(Global.batch_window_us), 0) / 1e6 or 0.002

    def note_reply(self, tenant, rows: int) -> None:
        """Reply-side aggregate-row accounting (the proxy's reply
        observation point): folds this reply's result rows into the
        tenant's rows/s EWMA — the signal the row-budget quota gates
        on."""
        ten = tenant_label(tenant)
        now = self._clock()
        with self._lock:
            st = self._tenants.get(ten)
            if st is None:
                st = self._tenants[ten] = _TenantState(
                    self._burst(self.quota_for(ten)))
                st.last_refill_us = now
            if st.last_rows_us:
                gap_s = max(now - st.last_rows_us, 1) / 1e6
                inst = rows / gap_s
                st.rows_rate = (EWMA_ALPHA * inst
                                + (1 - EWMA_ALPHA) * st.rows_rate)
            st.last_rows_us = now

    # -- bookkeeping ------------------------------------------------------
    def _record(self, d: Decision) -> None:
        emit = False
        with self._lock:
            k = (d.action, d.tenant)
            self._decisions[k] = self._decisions.get(k, 0) + 1
            if d.action != "admit":
                kind = ("admission.quota" if d.cause == "admission_quota"
                        else "admission.shed")
                ek = (kind, d.tenant, d.cause)
                now = self._clock()
                if now - self._last_event.get(ek, -EVENT_COOLDOWN_US) \
                        >= EVENT_COOLDOWN_US:
                    self._last_event[ek] = now
                    emit = True
        if d.action == "admit":
            _M_DECISIONS.labels(decision="admit", tenant=d.tenant).inc()
            return
        # shed charge + journal entry OUTSIDE the state lock (both take
        # their own leaf locks)
        _M_DECISIONS.labels(decision=d.action, tenant=d.tenant).inc()
        if d.cause == "admission_defer":
            maybe_note_shed("admission_defer", d.tenant)
        elif d.cause == "admission_partial":
            maybe_note_shed("admission_partial", d.tenant)
        elif d.cause == "admission_quota":
            maybe_note_shed("admission_quota", d.tenant)
        else:
            maybe_note_shed("admission_reject", d.tenant)
        if emit:
            kind = ("admission.quota" if d.cause == "admission_quota"
                    else "admission.shed")
            emit_event(kind, tenant=d.tenant, rung=d.action,
                       cause=d.cause, level=d.level, reason=d.reason,
                       retry_after_s=round(d.retry_after_s, 3))

    def report(self) -> dict:
        """The admission report: quotas, per-tenant bucket state,
        decision counts, and the live overload view (every signal read
        through the declared accessor)."""
        with self._lock:
            tenants = {t: {"tokens": round(st.tokens, 2),
                           "rows_rate": round(st.rows_rate, 1)}
                       for t, st in self._tenants.items()}
            decisions = {f"{a}/{t}": n
                         for (a, t), n in self._decisions.items()}
        return {
            "enabled": bool(Global.enable_admission),
            "level": self.overload_level(),
            "inflight_cap": self._inflight_cap(),
            "quotas": {t: {"weight": q.weight, "qps": q.qps,
                           "inflight": q.inflight,
                           "rows_per_s": q.rows_per_s}
                       for t, q in self._quota_map().items()},
            "default_weight": max(int(Global.admission_default_weight), 1),
            "tenants": tenants,
            "decisions": decisions,
            "signals": {
                "lane_queue_delay_ewma":
                    read_admission_input("lane_queue_delay_ewma"),
                "lane_depth": read_admission_input("lane_depth"),
                "pool_utilization":
                    read_admission_input("pool_utilization"),
                "tenant_inflight":
                    read_admission_input("tenant_inflight"),
                "tenant_arrival_rate":
                    read_admission_input("tenant_arrival_rate"),
                "shed_by_cause": read_admission_input("shed_by_cause"),
            },
            "consumed_inputs": list(CONSUMED_INPUTS),
        }

    def reset(self) -> None:
        """Drop controller state (tests / scenario runs)."""
        with self._lock:
            self._tenants.clear()
            self._decisions.clear()
            self._last_event.clear()
        self._level_cache = (-_LEVEL_TTL_US, 0)
        self.last_level = 0


# ---------------------------------------------------------------------------
# weighted-fair queueing (DRR over per-tenant sub-queues)
# ---------------------------------------------------------------------------

class FairQueue:
    """Deficit-round-robin over per-tenant sub-queues.

    The engine pool layers this UNDER its lanes when admission is armed:
    default-lane submissions are pushed with their effective tenant (the
    owner, for standing-query maintenance — priority inheritance) and a
    weight the CALLER resolves (the queue never calls out under its
    lock, keeping ``admission.queue`` a leaf). Each tenant at the head
    of the round earns ``admission_drr_quantum x weight`` credits; one
    credit drains one item — a weight-8 tenant drains 8 items per round
    while a weight-1 flood drains 1, so fairness holds under a hostile
    bulk flood without starving anyone (every active tenant earns
    credit every round)."""

    def __init__(self):
        self._lock = make_lock("admission.queue")
        self._queues: dict[str, deque] = {}  # guarded by: _lock
        self._order: deque = deque()  # guarded by: _lock
        self._deficit: dict[str, float] = {}  # guarded by: _lock
        self._weights: dict[str, int] = {}  # guarded by: _lock
        self._size = 0  # guarded by: _lock

    def push(self, tenant: str, item, weight: int = 1) -> None:
        with self._lock:
            dq = self._queues.get(tenant)
            if dq is None:
                dq = self._queues[tenant] = deque()
                self._order.append(tenant)
                self._deficit.setdefault(tenant, 0.0)
            self._weights[tenant] = max(int(weight), 1)
            dq.append(item)
            self._size += 1

    def pop(self):
        """One DRR pop, or None when empty. Bounded: two passes over
        the active round always yield an item when any queue is
        non-empty (a tenant with an empty queue leaves the round and
        forfeits its deficit — credit never accumulates while idle)."""
        q = max(int(Global.admission_drr_quantum), 1)
        with self._lock:
            if self._size == 0:
                return None
            for _ in range(2 * len(self._order) + 1):
                if not self._order:
                    return None
                t = self._order[0]
                dq = self._queues.get(t)
                if not dq:
                    self._order.popleft()
                    self._queues.pop(t, None)
                    self._deficit.pop(t, None)
                    continue
                if self._deficit.get(t, 0.0) >= 1.0:
                    self._deficit[t] -= 1.0
                    self._size -= 1
                    return dq.popleft()
                self._deficit[t] = (self._deficit.get(t, 0.0)
                                    + q * self._weights.get(t, 1))
                self._order.rotate(-1)
            # defensive: quantum*weight >= 1 makes this unreachable
            for dq in self._queues.values():
                if dq:
                    self._size -= 1
                    return dq.popleft()
            return None

    def __len__(self) -> int:
        with self._lock:
            return self._size

    def depths(self) -> dict[str, int]:
        with self._lock:
            return {t: len(dq) for t, dq in self._queues.items() if dq}


# ---------------------------------------------------------------------------
# process-wide instance + the zero-touch hook
# ---------------------------------------------------------------------------

_controller = AdmissionController()
# checked mode (lockdep.install) rebuilds the process-wide ledgers' locks
register_global_lock(_controller, "_lock", "admission.state")


def get_admission() -> AdmissionController:
    return _controller


def maybe_admission() -> AdmissionController | None:
    """The serving path's hook: one knob check when the plane is off."""
    if not Global.enable_admission:
        return None
    return _controller


# ---------------------------------------------------------------------------
# the admission report (console verb + Monitor line)
# ---------------------------------------------------------------------------

def render_admission(k: int | None = None) -> tuple[str, dict]:
    """(plain-text table, JSON dict) for
    the ``admission`` console verb."""
    rep = _controller.report()
    kk = k if k is not None else max(int(Global.top_k), 1)

    lines = ["wukong-admission  (quotas + degrade ladder)", ""]
    lines.append(f"enabled {str(rep['enabled']).lower()}  "
                 f"overload_level {rep['level']}  "
                 f"inflight_cap {rep['inflight_cap']}")
    lines.append("")
    lines.append(f"{'tenant':<14} {'weight':>6} {'qps':>8} {'infl':>5} "
                 f"{'rows/s':>9} {'tokens':>8} {'rows_rate':>10}")
    quotas = rep["quotas"] or {}
    shown = 0
    for t in sorted(set(quotas) | set(rep["tenants"])):
        if shown >= kk:
            break
        shown += 1
        qd = quotas.get(t)
        st = rep["tenants"].get(t, {})
        lines.append(
            f"{t:<14.14} "
            f"{(qd['weight'] if qd else rep['default_weight']):>6} "
            f"{(qd['qps'] if qd else 0):>8g} "
            f"{(qd['inflight'] if qd else 0):>5} "
            f"{(qd['rows_per_s'] if qd else 0):>9} "
            f"{st.get('tokens', '-'):>8} {st.get('rows_rate', '-'):>10}")
    if not shown:
        lines.append("  (no quotas declared, no tenants seen)")
    if rep["decisions"]:
        lines.append("")
        lines.append("DECISIONS")
        for key, n in sorted(rep["decisions"].items()):
            lines.append(f"  {key}: {n:,}")
    sig = rep["signals"]
    lines.append("")
    lines.append(f"SIGNALS  pool_utilization {sig['pool_utilization']:.0%}")
    for lane, v in sorted(sig["lane_queue_delay_ewma"].items()):
        d = sig["lane_depth"].get(lane)
        lines.append(f"  lane[{lane}]: delay_ewma {v:,.0f}us"
                     + (f", depth {d}" if d is not None else ""))
    for cause, n in sorted(sig["shed_by_cause"].items()):
        lines.append(f"  shed[{cause}]: {n:,}")
    for t in sorted(sig["tenant_inflight"]):
        lines.append(
            f"  tenant[{t}]: inflight {sig['tenant_inflight'][t]}, "
            f"arrival {sig['tenant_arrival_rate'].get(t, 0.0):,.1f} q/s")
    return "\n".join(lines) + "\n", rep
