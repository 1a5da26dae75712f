"""Resilience layer: deadlines and work budgets.

The port's copy of the JAX package's runtime/resilience.py:

- :class:`Deadline` — per-query wall-clock limit + intermediate-row work
  budget, carried on the query (``q.deadline``) and checked at every BGP
  step and device chain attempt. Expiry raises ``QueryTimeout`` /
  ``BudgetExceeded`` (utils/errors.py).
- :func:`mark_partial` — graceful degradation: tag the reply incomplete
  (``result.complete = False``) with the dropped patterns, keeping the rows
  produced so far.

The clock is injectable, so tests replay schedules deterministically. The
JAX module's ``retry_call`` and ``CircuitBreaker`` wait for their first
caller in the port, the distributed engine.
"""

from __future__ import annotations

import time

import numpy as np

from wukong_tpu_torch.analysis.lockdep import declare_leaf, make_lock
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.utils.errors import BudgetExceeded, QueryTimeout

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
