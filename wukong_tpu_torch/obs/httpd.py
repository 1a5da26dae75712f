"""HTTP scrape endpoint + periodic snapshot-to-file for the metrics registry.

The port's copy of the JAX package's obs/httpd.py:

- :func:`maybe_start_metrics_http` — a stdlib ``http.server`` daemon thread
  serving ``GET /metrics`` (Prometheus text exposition), ``/metrics.json``
  (the JSON snapshot), and the report planes, each as text or ``.json``:
  ``/top`` (shards / templates / lanes, obs/profile.py ``render_top``),
  ``/slo``, ``/admission``, ``/history``, ``/events``, ``/plan``,
  ``/cache`` and ``/device``; ``?k=N`` sizes every section and
  ``/plan?sweep=1`` runs one advisory sweep. ``/healthz`` is the
  ``{live, ready, degraded}`` body. Gated on the ``metrics_port`` knob (0
  = off, the default); idempotent per process.
- :class:`MetricsSnapshotter` — a daemon thread that writes the registry's
  JSON snapshot to a file every ``interval_s`` seconds (atomic
  tmp-then-rename), for long emulator runs where scraping is impractical.
  Gated on ``metrics_snapshot_s`` / ``metrics_snapshot_path``.

Everything here is pull-side only: the hot path never knows the server
exists (gauge callbacks are evaluated at scrape time by the registry). A
scrape reads host-side ledgers and counters only: it launches no kernel,
synchronizes no device and makes no CUDA tensor (``/device``'s resident
bytes are the residency ledger's own counts).
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from wukong_tpu_torch.config import Global
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.utils.logger import log_info, log_warn

_lock = threading.Lock()
_server: "ThreadingHTTPServer | None" = None  # guarded by: _lock
# named readiness probes registered by subsystem owners; each fn returns a
# truthy payload when degraded, falsy when healthy
_health_sources: dict = {}  # guarded by: _lock


def register_health_source(name: str, fn) -> None:
    """Register a readiness probe for /healthz (idempotent by name)."""
    with _lock:
        _health_sources[str(name)] = fn


def health_report() -> dict:
    """The /healthz body: liveness (the process answered) split from
    readiness (nothing degraded). Built-in probes: open circuit breakers
    (the ``wukong_breaker_open`` pull gauge, read point-wise — a
    load-balancer poll must not pay a full registry snapshot) and dead
    pool engines; registered sources add subsystem views (the proxy's
    degraded/failover shards)."""
    from wukong_tpu_torch.runtime.scheduler import dead_engine_count

    degraded: dict = {}
    fam = get_registry().gauge(
        "wukong_breaker_open", "Breaker keys not in the closed state",
        labels=("name",))
    fam._refresh()
    open_b = sum(ch.value for _lv, ch in fam._series())
    if open_b:
        degraded["open_breakers"] = int(open_b)
    dead = dead_engine_count()
    if dead:
        degraded["dead_engines"] = int(dead)
    with _lock:
        sources = dict(_health_sources)
    for name, fn in sources.items():
        try:
            v = fn()
        except Exception as e:  # a broken probe reads as degraded, loudly
            v = f"probe failed: {e!r}"
        if v:
            degraded[name] = v
    return {"live": True, "ready": not degraded, "degraded": degraded}


class _MetricsHandler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 (stdlib handler naming)
        path, _, query = self.path.partition("?")
        status = 200
        if path in ("/metrics", "/"):
            body = get_registry().render_prometheus().encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path == "/metrics.json":
            body = json.dumps(get_registry().snapshot(), indent=1).encode()
            ctype = "application/json"
        elif path in ("/top", "/top.json", "/slo", "/slo.json",
                      "/history", "/history.json", "/events",
                      "/events.json", "/plan", "/plan.json",
                      "/cache", "/cache.json",
                      "/device", "/device.json",
                      "/admission", "/admission.json"):
            # top(1) for shards / templates / lanes (obs/profile.py), the
            # tenant SLO + overload-signal report (obs/slo.py), and the
            # observatory plane: metrics trend windows (obs/tsdb.py), the
            # cluster event journal (obs/events.py), and the observe-only
            # placement advisor (obs/placement.py); ?k=N widens or
            # narrows every section
            k = None
            for part in query.split("&"):
                if part.startswith("k="):
                    try:
                        k = max(int(part[2:]), 1)
                    except ValueError:
                        pass
            if path.startswith("/slo"):
                from wukong_tpu_torch.obs.slo import render_slo

                text, js = render_slo(k)
            elif path.startswith("/admission"):
                # the admission control plane: overload level, per-tenant
                # quota/decision table, consumed congestion signals
                # (runtime/admission.py)
                from wukong_tpu_torch.runtime.admission import render_admission

                text, js = render_admission(k)
            elif path.startswith("/cache"):
                # the serving-cache observatory: shadow hit rate, template
                # popularity + cacheability verdicts, invalidation trend
                # (obs/reuse.py — ROADMAP item 7's decision surface)
                from wukong_tpu_torch.obs.reuse import render_cache

                text, js = render_cache(k)
            elif path.startswith("/device"):
                # the device-cost observatory: per-site dispatch +
                # padding efficiency, jit variant counts, residency vs
                # budget (obs/device.py — ROADMAP item 8's decision
                # surface)
                from wukong_tpu_torch.obs.device import render_device

                text, js = render_device(k)
            elif path.startswith("/history"):
                from wukong_tpu_torch.obs.tsdb import render_history

                text, js = render_history(k)
            elif path.startswith("/events"):
                from wukong_tpu_torch.obs.events import render_events

                text, js = render_events(k)
            elif path.startswith("/plan"):
                # read-only by default: a monitoring poller must not run
                # advisory sweeps (inflating the decision counter) on
                # every scrape — ?sweep=1 opts into a fresh observe-only
                # sweep (the console `plan` verb's default)
                from wukong_tpu_torch.obs.placement import render_plan

                text, js = render_plan(
                    advise="sweep=1" in query.split("&"))
            else:
                from wukong_tpu_torch.obs.profile import render_top

                text, js = render_top(k)
            if path.endswith(".json"):
                body = json.dumps(js, indent=1, default=str).encode()
                ctype = "application/json"
            else:
                body = text.encode()
                ctype = "text/plain; charset=utf-8"
        elif path == "/healthz":
            # liveness vs readiness: the body always reports both; the
            # status degrades to 503 only when health_ready_503 opts into
            # load-balancer drain semantics
            rep = health_report()
            body = json.dumps(rep, indent=1, default=str).encode()
            ctype = "application/json"
            if not rep["ready"] and Global.health_ready_503:
                status = 503
        else:
            self.send_error(404)
            return
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # scrapes stay out of stdout
        pass


def maybe_start_metrics_http(port: int | None = None):
    """Start the scrape endpoint if configured; returns the server or None.

    ``port`` overrides ``Global.metrics_port``; 0/None means off. Starting
    is idempotent — a second call (or a second Proxy in-process) reuses the
    already-running server.
    """
    global _server
    p = Global.metrics_port if port is None else port
    if not p or p <= 0:
        return None
    with _lock:
        if _server is not None:
            return _server
        host = Global.metrics_host or "127.0.0.1"
        try:
            srv = ThreadingHTTPServer((host, int(p)), _MetricsHandler)
        except OSError as e:
            log_warn(f"metrics http endpoint failed to bind :{p}: {e}")
            return None
        srv.daemon_threads = True
        t = threading.Thread(target=srv.serve_forever, daemon=True,
                             name="metrics-http")
        t.start()
        _server = srv
        log_info(f"metrics http endpoint on :{srv.server_address[1]} "
                 "(/metrics, /metrics.json, /top, /slo, /history, "
                 "/events, /plan, /cache, /device, /admission, /healthz)")
        return srv


def stop_metrics_http() -> None:
    """Shut the endpoint down (tests / console teardown)."""
    global _server
    with _lock:
        if _server is not None:
            _server.shutdown()
            _server.server_close()
            _server = None


class MetricsSnapshotter:
    """Periodic registry-snapshot-to-file writer for long soaks."""

    def __init__(self, path: str, interval_s: float):
        self.path = path
        self.interval_s = max(float(interval_s), 0.1)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.writes = 0

    def start(self) -> "MetricsSnapshotter":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="metrics-snapshot")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.write_once()

    def write_once(self) -> None:
        try:
            tmp = f"{self.path}.tmp"
            with open(tmp, "w") as f:
                json.dump(get_registry().snapshot(), f, indent=1)
            os.replace(tmp, self.path)  # atomic: a soak reader never sees
            self.writes += 1            # a torn snapshot
        except OSError as e:
            log_warn(f"metrics snapshot write failed: {e}")

    def stop(self, final_write: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        if final_write:
            self.write_once()


def maybe_start_snapshotter() -> "MetricsSnapshotter | None":
    """A snapshotter per the ``metrics_snapshot_s`` / ``metrics_snapshot_path``
    knobs, or None when off (the default)."""
    if Global.metrics_snapshot_s <= 0 or not Global.metrics_snapshot_path:
        return None
    return MetricsSnapshotter(Global.metrics_snapshot_path,
                              Global.metrics_snapshot_s).start()
