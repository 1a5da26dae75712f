"""Flight recorder: bounded ring of completed traces + slow/failed dumps.

The port's copy of the JAX package's obs/recorder.py. It keeps the last N
completed :class:`QueryTrace`s in a ring (console verb ``trace``), and
dumps the full trace when a query ends in one of the resilience failure
codes (QUERY_TIMEOUT / BUDGET_EXCEEDED / SHARD_UNAVAILABLE) or passes the
slow-query threshold (``trace_slow_ms``); the SLO burn sentinel and the
latency-regression sentinel force dumps through :meth:`FlightRecorder.dump`.

Dumps land in memory (the ``dumps`` ring) and, when ``trace_dump_dir`` (or
``WUKONG_TRACE_DIR``) names a directory, as one JSON file per trace,
pruned to the newest ``trace_dump_max``.
"""

from __future__ import annotations

import json
import os
from collections import deque

from wukong_tpu_torch.analysis.lockdep import (
    declare_leaf,
    make_lock,
    register_global_lock,
)
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.obs.trace import QueryTrace
from wukong_tpu_torch.utils.errors import ErrorCode
from wukong_tpu_torch.utils.logger import log_warn

# the ring lock guards deque appends only (the journal event and the dump
# file are written outside it): innermost by construction
declare_leaf("obs.recorder")

#: reply codes that auto-dump their trace (the resilience failure taxonomy)
DUMP_CODES = frozenset({ErrorCode.QUERY_TIMEOUT, ErrorCode.BUDGET_EXCEEDED,
                        ErrorCode.SHARD_UNAVAILABLE})


class FlightRecorder:
    def __init__(self, capacity: int | None = None):
        self.capacity = capacity
        self._lock = make_lock("obs.recorder")
        self._ring: deque[QueryTrace] = deque(
            maxlen=capacity or max(int(Global.trace_ring), 1))  # guarded by: _lock
        self.dumps: deque[tuple[str, QueryTrace]] = deque(maxlen=64)  # guarded by: _lock
        # per-dump metadata incl. the cluster-event id the dump references
        # (the triggering event — SLO_BURN dumps carry their slo.burn
        # event's id — else a trace.dump event emitted here)
        self.dump_meta: deque = deque(maxlen=64)  # guarded by: _lock
        reg = get_registry()
        self._m_recorded = reg.counter(
            "wukong_traces_recorded_total", "Completed query traces kept")
        self._m_dumped = reg.counter(
            "wukong_trace_dumps_total", "Auto-dumped traces", labels=("reason",))

    # ------------------------------------------------------------------
    def on_complete(self, trace: QueryTrace | None,
                    status: ErrorCode | int | str = ErrorCode.SUCCESS) -> None:
        """Record one finished trace; dump it when the status or duration
        says so. Accepts None so callers can pass ``q.trace`` unchecked."""
        if trace is None:
            return
        code: ErrorCode | None
        try:
            code = ErrorCode(status) if not isinstance(status, str) else None
        except ValueError:
            code = None
        trace.finish(code.name if code is not None else str(status))
        want = self.capacity or max(int(Global.trace_ring), 1)
        with self._lock:
            if self._ring.maxlen != want:
                # trace_ring is runtime-mutable; re-size lazily, keeping
                # the tail (check+swap+append in ONE critical section — a
                # concurrent completion must never land in the old deque)
                self._ring = deque(self._ring, maxlen=want)
            self._ring.append(trace)
        self._m_recorded.inc()
        reason = None
        if code is not None and code in DUMP_CODES:
            reason = code.name
        elif (Global.trace_slow_ms > 0
              and trace.dur_us >= Global.trace_slow_ms * 1000):
            reason = "SLOW_QUERY"
        if reason is not None:
            self._dump(trace, reason)

    def dump(self, trace: QueryTrace, reason: str,
             event_id: str | None = None) -> None:
        """Force-dump one trace (the latency-attribution regression
        sentinel's entry: an anomalous query auto-dumps its trace with
        reason ``LATENCY_REGRESSION`` even though its reply code and
        duration look ordinary). ``event_id`` names the cluster-journal
        event that triggered the dump (obs/events.py) — SLO burns pass
        their ``slo.burn`` event so the dump and the journal cross-link."""
        self._dump(trace, reason, event_id=event_id)

    def _dump(self, trace: QueryTrace, reason: str,
              event_id: str | None = None) -> None:
        if event_id is None:
            # no upstream trigger: journal the dump itself so the
            # timeline still carries one correlated entry per dump
            from wukong_tpu_torch.obs.events import emit_event

            event_id = emit_event(
                "trace.dump", tenant=getattr(trace, "tenant", None),
                qid=getattr(trace, "qid", None), reason=reason,
                trace=trace.trace_id)
        with self._lock:
            self.dumps.append((reason, trace))
            self.dump_meta.append({
                "reason": reason, "trace_id": trace.trace_id,
                "tenant": getattr(trace, "tenant", "default"),
                "qid": getattr(trace, "qid", None),
                "event_id": event_id})
        self._m_dumped.labels(reason=reason).inc()
        # the tenant rides the log line and the JSON (via to_dict) so an
        # anomaly dump is attributable without replaying the trace
        log_warn(f"flight recorder: trace {trace.trace_id} "
                 f"(tenant {getattr(trace, 'tenant', 'default')}) dumped "
                 f"({reason}, {trace.dur_us:,}us, {len(trace.spans)} spans"
                 + (f", event {event_id}" if event_id else "") + ")")
        dump_dir = Global.trace_dump_dir or os.environ.get("WUKONG_TRACE_DIR")
        if dump_dir:
            try:
                os.makedirs(dump_dir, exist_ok=True)
                path = os.path.join(dump_dir,
                                    f"trace_{trace.trace_id}.json")
                with open(path, "w") as f:
                    json.dump({"reason": reason,
                               **({"event_id": event_id} if event_id
                                  else {}),
                               **trace.to_dict()}, f,
                              indent=1, sort_keys=True)
                self._prune_dump_dir(dump_dir)
            except OSError as e:  # a full disk must not fail the query path
                log_warn(f"flight recorder: dump write failed: {e}")

    @staticmethod
    def _prune_dump_dir(dump_dir: str) -> None:
        """Dump-dir retention (``trace_dump_max``): auto-dump storms used
        to accumulate trace files without bound — keep the newest N,
        evict the oldest by mtime. 0 disables (the legacy behavior)."""
        cap = int(Global.trace_dump_max)
        if cap <= 0:
            return
        try:
            names = [n for n in os.listdir(dump_dir)
                     if n.startswith("trace_") and n.endswith(".json")]
            if len(names) <= cap:
                return
            paths = sorted((os.path.join(dump_dir, n) for n in names),
                           key=lambda p: (os.path.getmtime(p), p))
            for p in paths[:len(paths) - cap]:
                os.remove(p)
        except OSError as e:  # racing evictors / vanished files are fine
            log_warn(f"flight recorder: dump-dir prune failed: {e}")

    # ------------------------------------------------------------------
    def last(self, n: int | None = None) -> list[QueryTrace]:
        with self._lock:
            traces = list(self._ring)
        return traces if n is None else traces[-n:]

    def find(self, key) -> QueryTrace | None:
        """Look up a ring entry by qid (int) or trace id (str)."""
        with self._lock:
            traces = list(self._ring)
        for tr in reversed(traces):
            if tr.trace_id == key or str(tr.qid) == str(key):
                return tr
        return None

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dumps.clear()
            self.dump_meta.clear()


_recorder = FlightRecorder()
# checked mode (lockdep.install) rebuilds the process-wide ledgers' locks
register_global_lock(_recorder, "_lock", "obs.recorder")


def get_recorder() -> FlightRecorder:
    return _recorder
