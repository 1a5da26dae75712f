"""Observability: tracing, metrics, the flight recorder, exporters, the SLO
plane and the event journal (the port's copy of the JAX package's obs/).

- trace.py    — per-query :class:`QueryTrace` (trace id + span stack),
  thread-ambient activation for deep layers, sampling knobs, StepTrace
- metrics.py  — the process-wide :class:`MetricsRegistry`
- recorder.py — :class:`FlightRecorder`: a ring of recent traces, dumped
  on resilience failures, slow queries and SLO burns
- export.py   — Chrome trace-event JSON and the torch.profiler device trace
- slo.py      — per-tenant SLO accounting, error budgets, burn-rate
  sentinels and the overload signal bus (``ADMISSION_INPUTS``) the
  admission controller (runtime/admission.py) reads
- events.py   — the cluster-event journal with shard/tenant/qid keys
- profile.py  — EXPLAIN / EXPLAIN ANALYZE and the latency attributor
- device.py   — the device-cost observatory: dispatch, compile and
  residency ledgers behind ``maybe_device_dispatch`` / ``charge_steps``
  / ``maybe_device_resident``, ``DEVICE_INPUTS``, ``render_device``
- tsdb.py     — the metrics time-series ring (windowed rates and
  percentiles; the ``history`` verb)
- reuse.py    — the serving-cache observatory: template popularity, the
  shadow cache, invalidation telemetry (the ``cache`` verb)

The JAX package's heat and placement observatories, its HTTP endpoints and
its metrics snapshotter wait for the subsystems they observe (ROADMAP §A,
"The rest of the observatory, and the analysis plugins").
"""

from wukong_tpu_torch.obs.events import (
    ClusterEvent,
    EventJournal,
    emit_event,
    get_journal,
    render_events,
)
from wukong_tpu_torch.obs.export import (
    chrome_trace_events,
    device_trace,
    maybe_device_trace,
    write_chrome_trace,
)
from wukong_tpu_torch.obs.metrics import MetricsRegistry, get_registry
from wukong_tpu_torch.obs.recorder import (
    DUMP_CODES,
    FlightRecorder,
    get_recorder,
)
from wukong_tpu_torch.obs.slo import (
    ADMISSION_INPUTS,
    SLOSpec,
    get_overload,
    get_slo,
    render_slo,
)
from wukong_tpu_torch.obs.reuse import get_reuse, render_cache
from wukong_tpu_torch.obs.trace import (
    QueryTrace,
    Span,
    StepTrace,
    activate,
    current,
    maybe_start_trace,
    trace_event,
)
from wukong_tpu_torch.obs.tsdb import (
    get_tsdb,
    maybe_start_tsdb,
    render_history,
    stop_tsdb,
)

__all__ = [
    "ADMISSION_INPUTS", "ClusterEvent", "DUMP_CODES", "EventJournal",
    "FlightRecorder", "MetricsRegistry", "QueryTrace", "SLOSpec", "Span",
    "StepTrace", "activate", "chrome_trace_events", "current",
    "device_trace", "emit_event", "get_journal", "get_overload",
    "get_recorder", "get_registry", "get_reuse", "get_slo", "get_tsdb",
    "maybe_device_trace", "maybe_start_trace", "maybe_start_tsdb",
    "render_cache", "render_events", "render_history", "render_slo",
    "stop_tsdb", "trace_event", "write_chrome_trace",
]
