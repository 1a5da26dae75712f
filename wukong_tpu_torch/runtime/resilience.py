"""Resilience layer: deadlines and work budgets.

The port's copy of the JAX package's runtime/resilience.py:

- :class:`Deadline` — per-query wall-clock limit + intermediate-row work
  budget, carried on the query (``q.deadline``) and checked at every BGP
  step and device chain attempt. Expiry raises ``QueryTimeout`` /
  ``BudgetExceeded`` (utils/errors.py).
- :class:`CircuitBreaker` — per-key consecutive-failure breaker with a
  half-open probe after a cooldown; the batcher keeps one, so a fused
  dispatch that keeps failing is not paid for again on every group.
- :func:`mark_partial` — graceful degradation: tag the reply incomplete
  (``result.complete = False``) with the dropped patterns, keeping the rows
  produced so far.

The clocks are injectable, so tests replay schedules deterministically. A
breaker trip or close is a ``breaker.trip`` / ``breaker.close`` event on the
ambient trace and in the cluster-event journal (obs/events.py), both sent
outside the breaker's lock.
- :func:`retry_call` — exponential backoff with equal jitter around a
  transient-failure-prone call (the HDFS client, the sharded store's shard
  fetches, the distributed chain's dispatch), with a ``retry`` event on the
  ambient trace, an optional per-key circuit breaker and deadline.
"""

from __future__ import annotations

import random
import time

import numpy as np

from wukong_tpu_torch.analysis.lockdep import declare_leaf, make_lock
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.obs.trace import trace_event
from wukong_tpu_torch.utils.errors import (
    BudgetExceeded,
    QueryTimeout,
    RetryExhausted,
)

_M_RETRIES = get_registry().counter(
    "wukong_retry_attempts_total",
    "Failed attempts that entered retry backoff", labels=("site",))
_M_BREAKER_TRIPS = get_registry().counter(
    "wukong_breaker_trips_total",
    "Circuit breaker open/reopen transitions", labels=("key",))

# breaker state locks are innermost: nothing is acquired under one
declare_leaf("breaker.state")



def _emit_breaker_event(kind: str, key) -> None:
    """Cluster-event journal hook for breaker transitions: an int key (or
    a tuple led by one) is the event's shard correlation key. Called
    outside the breaker lock."""
    from wukong_tpu_torch.obs.events import emit_event

    shard = key if isinstance(key, int) else (
        key[0] if isinstance(key, tuple) and key
        and isinstance(key[0], int) else None)
    emit_event(kind, shard=shard, key=str(key))


# serializes Deadline.charge_rows across threads sharing one deadline;
# nothing is ever acquired under it
declare_leaf("resilience.charge")
_CHARGE_LOCK = make_lock("resilience.charge")


class Deadline:
    """Wall-clock deadline + intermediate-row budget for one query."""

    __slots__ = ("_clock", "_expires_at", "budget_rows", "rows_charged")

    def __init__(self, timeout_ms: int = 0, budget_rows: int = 0,
                 clock=time.monotonic):
        self._clock = clock
        self._expires_at = (clock() + timeout_ms / 1e3
                            if timeout_ms and timeout_ms > 0 else None)
        self.budget_rows = int(budget_rows or 0)
        self.rows_charged = 0

    @classmethod
    def from_config(cls) -> "Deadline | None":
        """A Deadline per the Global knobs, or None when both are off."""
        if Global.query_deadline_ms <= 0 and Global.query_budget_rows <= 0:
            return None
        return cls(Global.query_deadline_ms, Global.query_budget_rows)

    def expired(self) -> bool:
        return self._expires_at is not None and self._clock() >= self._expires_at

    def remaining_s(self) -> float | None:
        if self._expires_at is None:
            return None
        return max(self._expires_at - self._clock(), 0.0)

    def check(self, where: str = "") -> None:
        if self.expired():
            raise QueryTimeout(where)

    def charge_rows(self, n: int, where: str = "") -> None:
        # a module-level lock, not one per instance: a Deadline may be
        # shared by concurrent chargers, and a lock attribute would make
        # queries carrying deadlines undeepcopyable
        with _CHARGE_LOCK:
            self.rows_charged += int(n)
            total = self.rows_charged
        if self.budget_rows and total > self.budget_rows:
            raise BudgetExceeded(
                f"{total:,} rows > budget "
                f"{self.budget_rows:,}" + (f" at {where}" if where else ""))


def check_query(q, where: str = "") -> None:
    """Deadline check for a query that may or may not carry one."""
    dl = getattr(q, "deadline", None)
    if dl is not None:
        dl.check(where)


def charge_query(q, rows: int, where: str = "") -> None:
    """Charge a step's output rows against the query's work budget."""
    dl = getattr(q, "deadline", None)
    if dl is not None:
        dl.charge_rows(rows, where)


def mark_partial(q, exc) -> None:
    """Graceful degradation on deadline/budget expiry: keep the rows
    produced so far, record what was dropped, surface the structured code."""
    res = q.result
    res.status_code = exc.code
    res.complete = False
    dropped = [repr(p) for p in q.pattern_group.patterns[q.pattern_step:]]
    if q.pattern_group.unions and not q.union_done:
        dropped.append(f"UNION x{len(q.pattern_group.unions)}")
    dropped += [f"OPTIONAL#{i}" for i in
                range(q.optional_step, len(q.pattern_group.optional))]
    res.dropped_patterns = dropped
    if not Global.enable_partial_results:
        res.table = np.empty((0, res.col_num), dtype=np.int64)
        res.nrows = 0


class CircuitBreaker:
    """Per-key consecutive-failure circuit breaker.

    closed -> (threshold consecutive failures) -> open -> (cooldown) ->
    half-open: one trial call is allowed; success closes the breaker,
    failure reopens it for another cooldown. Thread-safe.
    """

    def __init__(self, threshold: int | None = None,
                 cooldown_ms: float | None = None, clock=time.monotonic):
        self.threshold = (Global.breaker_threshold
                          if threshold is None else int(threshold))
        self.cooldown_s = (Global.breaker_cooldown_ms
                           if cooldown_ms is None else cooldown_ms) / 1e3
        self._clock = clock
        self._lock = make_lock("breaker.state")
        # key -> [consecutive_failures, opened_at | None, half_open_inflight]
        self._st: dict = {}  # guarded by: _lock
        # key -> clock time of the most recent open/reopen (trip)
        self._last_trip: dict = {}  # guarded by: _lock

    def _slot(self, key):  # caller holds: _lock
        return self._st.setdefault(key, [0, None, False])

    def _state_of(self, slot, now: float) -> str:
        """Classify one slot; caller holds the lock."""
        _fails, opened_at, half = slot
        if opened_at is None:
            return "closed"
        if half or now - opened_at >= self.cooldown_s:
            return "half_open"
        return "open"

    def state(self, key) -> str:
        with self._lock:
            return self._state_of(self._slot(key), self._clock())

    def allow(self, key) -> bool:
        """True when a call may proceed. The transition to half-open admits
        ONE trial at a time; concurrent callers keep getting False until
        the trial reports an outcome."""
        with self._lock:
            slot = self._slot(key)
            _fails, opened_at, half = slot
            if opened_at is None:
                return True
            if half:
                return False  # a trial is already in flight
            if self._clock() - opened_at >= self.cooldown_s:
                slot[2] = True  # admit the half-open trial
                return True
            return False

    def record_success(self, key) -> None:
        with self._lock:
            was_open = self._st.get(key, [0, None, False])[1] is not None
            self._st[key] = [0, None, False]
        if was_open:  # a half-open trial just recovered the key
            trace_event("breaker.close", key=str(key))
            _emit_breaker_event("breaker.close", key)

    def record_abort(self, key) -> None:
        """The admitted call never dispatched: release a held half-open
        trial slot without judging the key either way."""
        with self._lock:
            self._slot(key)[2] = False

    def record_failure(self, key) -> None:
        tripped = False
        with self._lock:
            slot = self._slot(key)
            slot[0] += 1
            if slot[1] is not None or slot[0] >= self.threshold:
                # a failed half-open trial (or a failure while open)
                # reopens; the threshold-th consecutive failure opens
                slot[1] = self._clock()
                slot[2] = False
                self._last_trip[key] = slot[1]
                tripped = True
        if tripped:  # outside the lock: the breaker lock is a leaf
            trace_event("breaker.trip", key=str(key))
            _M_BREAKER_TRIPS.labels(key=str(key)).inc()
            _emit_breaker_event("breaker.trip", key)

    def tripped(self, key) -> bool:
        return self.state(key) != "closed"

    def tripped_keys(self) -> list:
        """Every key whose breaker is open or half-open (the heal
        watcher's sick-shard signal)."""
        with self._lock:
            return [k for k, slot in self._st.items() if slot[1] is not None]

    def snapshot(self) -> dict:
        """Per key: state, consecutive failures, and the age of the most
        recent trip (None = never tripped)."""
        with self._lock:
            now = self._clock()
            out = {}
            for k, slot in self._st.items():
                trip = self._last_trip.get(k)
                out[k] = {"state": self._state_of(slot, now),
                          "consecutive_failures": slot[0],
                          "last_trip_age_s":
                              (now - trip) if trip is not None else None}
            return out


# ---------------------------------------------------------------------------
# retry with exponential backoff + jitter
# ---------------------------------------------------------------------------

_retry_rng = random.Random()  # jitter source; tests inject their own


def retry_call(fn, *, site: str = "", attempts: int | None = None,
               base_ms: float | None = None, max_ms: float | None = None,
               retry_on: tuple = (), breaker: "CircuitBreaker | None" = None,
               key=None, rng: random.Random | None = None, sleep=time.sleep,
               deadline: "Deadline | None" = None):
    """Call ``fn()``; on an exception in ``retry_on`` back off and retry.

    Backoff is exponential with equal jitter: half the window fixed, half
    uniform, so synchronized retry storms decorrelate. A breaker (keyed by
    ``key``) short-circuits calls while open and records outcomes; a
    deadline bounds the total retry time. Non-retryable exceptions (and
    faults.ShardDown) propagate immediately. Exhaustion raises
    RetryExhausted carrying the last exception.
    """
    from wukong_tpu_torch.runtime.faults import TransientFault
    from wukong_tpu_torch.utils.errors import ShardUnavailable

    attempts = Global.retry_max_attempts if attempts is None else attempts
    base_ms = Global.retry_base_ms if base_ms is None else base_ms
    max_ms = Global.retry_max_ms if max_ms is None else max_ms
    retry_on = tuple(retry_on) or (TransientFault, OSError)
    rng = rng or _retry_rng
    attempts = max(int(attempts), 1)
    last: BaseException | None = None
    for i in range(attempts):
        if breaker is not None and not breaker.allow(key):
            trace_event("breaker.open", site=site, key=str(key))
            raise ShardUnavailable(
                f"circuit open for {key!r} at {site}",
                shard=key if isinstance(key, int) else None)
        # past this point an admitted half-open trial must be settled on
        # every exit path, or the breaker keeps its trial slot forever
        if deadline is not None:
            try:
                deadline.check(site)
            except BaseException:
                if breaker is not None:
                    breaker.record_abort(key)
                raise
        try:
            out = fn()
        except retry_on as e:
            last = e
            trace_event("retry", site=site, attempt=i, error=repr(e))
            _M_RETRIES.labels(site=site or "?").inc()
            if breaker is not None:
                breaker.record_failure(key)
            if i == attempts - 1:
                break
            window = min(base_ms * (2 ** i), max_ms) / 1e3
            delay = window / 2 + rng.random() * window / 2
            if deadline is not None:
                rem = deadline.remaining_s()
                if rem is not None and delay >= rem:
                    raise QueryTimeout(
                        f"deadline inside retry backoff at {site}") from e
            sleep(delay)
        except BaseException:
            # a non-retryable failure did run and did fail: count it, so a
            # persistent fault trips the breaker and a half-open trial is
            # settled
            if breaker is not None:
                breaker.record_failure(key)
            raise
        else:
            if breaker is not None:
                breaker.record_success(key)
            return out
    raise RetryExhausted(
        f"{attempts} attempts failed at {site}: {last!r}", last=last)
