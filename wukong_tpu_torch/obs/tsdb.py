"""Bounded in-memory metrics time-series ring: trend windows.

The port's copy of the JAX package's obs/tsdb.py. The metrics registry
answers "what is the value now"; :class:`MetricsTSDB` samples
``MetricsRegistry.snapshot()`` every ``tsdb_interval_s`` seconds into a
bounded ring (``tsdb_retention_s`` deep), turning cumulative counters into
windowed *rates* and histogram buckets into windowed *percentiles*:

- :meth:`MetricsTSDB.rate` / :meth:`rate_by_label` — counter delta over a
  trend window divided by the window's wall time (per second), optionally
  grouped by one label;
- :meth:`MetricsTSDB.quantile` — histogram percentile over the window's
  bucket deltas (not the process lifetime), linearly interpolated inside
  the winning bucket like promql ``histogram_quantile``;
- :meth:`MetricsTSDB.series` / :meth:`latest` — raw (t, value) reads.

Surfaced as the console's ``history`` verb (:func:`render_history`) and
read by the reuse observatory's trend (obs/reuse.py ``reuse_trend``). The
sampler is a daemon thread (:func:`maybe_start_tsdb`, idempotent per
process) gated on ``enable_tsdb``; one snapshot an interval is off every
hot path. Tests drive :meth:`sample_once` directly for deterministic
windows. The JAX package's HTTP endpoint and placement advisor, which also
read the ring, wait for their subsystems (ROADMAP §A, "The rest of the
observatory, and the analysis plugins").
"""

from __future__ import annotations

import math
import threading
from collections import deque

from wukong_tpu_torch.analysis.lockdep import (
    declare_leaf,
    make_lock,
    register_global_lock,
)
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.utils.logger import log_warn
from wukong_tpu_torch.utils.timer import get_usec

# the ring lock only guards deque append/iterate and dict reads of frozen
# samples — innermost by construction, like heat.shard
declare_leaf("tsdb.ring")

_M_SAMPLES = get_registry().counter(
    "wukong_tsdb_samples_total", "Registry snapshots folded into the "
    "time-series ring")


def _series_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class _Sample:
    """One flattened registry snapshot (immutable once built)."""

    __slots__ = ("t_us", "scalars", "hists")

    def __init__(self, t_us: int, snap: dict):
        self.t_us = t_us
        # (name, labelkey) -> float for counters AND gauges (rates only
        # make sense for counters; the query side decides)
        self.scalars: dict = {}  # lock-free: written only during construction; immutable once ringed
        # (name, labelkey) -> (count, sum, ((le, n), ...)) raw buckets
        self.hists: dict = {}  # lock-free: written only during construction; immutable once ringed
        for name, fam in snap.items():
            kind = fam.get("kind")
            for s in fam.get("series", []):
                key = (name, _series_key(s.get("labels", {})))
                if kind == "histogram":
                    buckets = []
                    for le, n in (s.get("buckets") or {}).items():
                        b = math.inf if le == "+Inf" else float(le)
                        buckets.append((b, int(n)))
                    buckets.sort(key=lambda x: x[0])
                    self.hists[key] = (int(s.get("count", 0)),
                                      float(s.get("sum", 0.0)),
                                      tuple(buckets))
                else:
                    self.scalars[key] = float(s.get("value", 0.0))


class MetricsTSDB:
    """Process-wide bounded time-series ring over the metrics registry."""

    def __init__(self, interval_s: float | None = None,
                 retention_s: float | None = None):
        self._interval_override = interval_s
        self._retention_override = retention_s
        self._lock = make_lock("tsdb.ring")
        self._samples: deque[_Sample] = deque()  # guarded by: _lock

    # ------------------------------------------------------------------
    @property
    def interval_s(self) -> float:
        v = (self._interval_override if self._interval_override is not None
             else Global.tsdb_interval_s)
        return max(float(v), 0.1)

    @property
    def retention_s(self) -> float:
        v = (self._retention_override
             if self._retention_override is not None
             else Global.tsdb_retention_s)
        return max(float(v), self.interval_s)

    # ------------------------------------------------------------------
    def sample_once(self, now_us: int | None = None) -> _Sample:
        """Fold one registry snapshot into the ring and evict samples
        older than the retention window. ``now_us`` is injectable so
        tests build deterministic trend windows."""
        snap = get_registry().snapshot()
        sample = _Sample(get_usec() if now_us is None else int(now_us),
                         snap)
        cut = sample.t_us - int(self.retention_s * 1e6)
        # memory is bounded two ways: by age (retention) AND by count —
        # a caller sampling faster than the interval (tests, bursts)
        # must not grow the ring past its nominal depth
        cap = max(int(self.retention_s / self.interval_s), 1) + 8
        with self._lock:
            self._samples.append(sample)
            while self._samples and self._samples[0].t_us < cut:
                self._samples.popleft()
            while len(self._samples) > cap:
                self._samples.popleft()
        _M_SAMPLES.inc()
        return sample

    def _window(self, window_s: float | None) -> list[_Sample]:
        """Samples inside the trend window (retention-wide when None),
        oldest first — a snapshot list, safe to read without the lock."""
        with self._lock:
            samples = list(self._samples)
        if not samples:
            return []
        w = self.retention_s if window_s is None else max(float(window_s),
                                                          0.001)
        cut = samples[-1].t_us - int(w * 1e6)
        return [s for s in samples if s.t_us >= cut]

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def span_s(self) -> float:
        """Wall time covered by the ring (0 with <2 samples)."""
        with self._lock:
            if len(self._samples) < 2:
                return 0.0
            return (self._samples[-1].t_us - self._samples[0].t_us) / 1e6

    def reset(self) -> None:
        """Drop the ring (tests / scenario runs start a clean window)."""
        with self._lock:
            self._samples.clear()

    # ------------------------------------------------------------------
    # range / rate / percentile queries
    # ------------------------------------------------------------------
    @staticmethod
    def _match(key: tuple, name: str, labels: dict) -> bool:
        kname, kl = key
        if kname != name:
            return False
        kd = dict(kl)
        return all(kd.get(k) == str(v) for k, v in labels.items())

    def series(self, name: str, window_s: float | None = None,
               **labels) -> list[tuple[float, float]]:
        """[(t_seconds, summed value)] per sample over the window, for
        counters and gauges (series matching the label subset are
        summed)."""
        out = []
        for s in self._window(window_s):
            vals = [v for k, v in s.scalars.items()
                    if self._match(k, name, labels)]
            if vals:
                out.append((s.t_us / 1e6, sum(vals)))
        return out

    def latest(self, name: str, **labels) -> float | None:
        """Newest sampled value of a scalar series (summed over matches),
        or None when the ring has never seen it."""
        with self._lock:
            samples = list(self._samples)
        for s in reversed(samples):
            vals = [v for k, v in s.scalars.items()
                    if self._match(k, name, labels)]
            if vals:
                return sum(vals)
        return None

    def rate(self, name: str, window_s: float | None = None,
             **labels) -> float | None:
        """Windowed rate (per second) of a cumulative counter: the delta
        between the window's first and last sample over their wall-time
        gap. None with <2 samples; clamped at 0 (a registry ``reset()``
        mid-window must not read as a negative rate)."""
        pts = self.series(name, window_s, **labels)
        if len(pts) < 2:
            return None
        (t0, v0), (t1, v1) = pts[0], pts[-1]
        if t1 <= t0:
            return None
        return max(v1 - v0, 0.0) / (t1 - t0)

    def rate_by_label(self, name: str, label: str,
                      window_s: float | None = None) -> dict[str, float]:
        """{label value: windowed rate} for one counter family, summing
        over every OTHER label (e.g. per-shard fetch rates summed over
        the ``kind`` label)."""
        win = self._window(window_s)
        if len(win) < 2:
            return {}
        first, last = win[0], win[-1]
        dt = (last.t_us - first.t_us) / 1e6
        if dt <= 0:
            return {}
        acc: dict[str, float] = {}
        for key, v1 in last.scalars.items():
            kname, kl = key
            if kname != name:
                continue
            lv = dict(kl).get(label)
            if lv is None:
                continue
            delta = max(v1 - first.scalars.get(key, 0.0), 0.0)
            acc[lv] = acc.get(lv, 0.0) + delta
        return {k: v / dt for k, v in acc.items()}

    def quantile(self, name: str, q: float,
                 window_s: float | None = None, **labels) -> float | None:
        """Histogram quantile over the WINDOW's observations: bucket-count
        deltas between the window's first and last sample, linearly
        interpolated inside the winning bucket (promql
        ``histogram_quantile`` semantics; the +Inf bucket answers with the
        highest finite bound). None when the window saw no observation."""
        return self._quantile(name, q, window_s, labels)

    def _quantile(self, name: str, q: float, window_s: float | None,
                  labels: dict) -> float | None:
        # labels as a plain dict: a series whose label KEY is literally
        # "name"/"q" (lockdep's per-lock histograms) must not collide
        # with the public keyword signature
        win = self._window(window_s)
        if len(win) < 2:
            return None
        deltas = self._bucket_deltas(win[0], win[-1], name, labels)
        return self._quantile_of(deltas, q)

    @classmethod
    def _bucket_deltas(cls, first, last, name: str,
                       labels: dict) -> dict[float, float]:
        """Windowed per-bucket observation counts for the matching
        series: bucket-count deltas between the window's first and last
        sample, summed across matching label sets."""
        deltas: dict[float, float] = {}
        for key, (_c, _s, buckets) in last.hists.items():
            if not cls._match(key, name, labels):
                continue
            prev = dict(first.hists.get(key, (0, 0.0, ()))[2])
            for le, n in buckets:
                deltas[le] = deltas.get(le, 0.0) + max(n - prev.get(le, 0),
                                                       0)
        return deltas

    @staticmethod
    def _quantile_of(deltas: dict[float, float], q: float) -> float | None:
        total = sum(deltas.values())
        if total <= 0:
            return None
        rank = max(min(float(q), 1.0), 0.0) * total
        cum = 0.0
        lo = 0.0
        finite = [le for le in sorted(deltas) if le != math.inf]
        for le in sorted(deltas):
            cum += deltas[le]
            if cum >= rank:
                if le == math.inf:
                    return finite[-1] if finite else None
                frac = (rank - (cum - deltas[le])) / max(deltas[le], 1e-12)
                return lo + (le - lo) * frac
            if le != math.inf:
                lo = le
        return finite[-1] if finite else None

    # ------------------------------------------------------------------
    def report(self, k: int | None = None,
               window_s: float | None = None) -> dict:
        """The history report: ring stats + the top-k counters by windowed
        rate, top-k histograms by windowed observation count (with
        p50/p99), and the latest gauge values."""
        kk = k if k is not None else max(int(Global.top_k), 1)
        win = self._window(window_s)
        out = {"samples": len(self), "interval_s": self.interval_s,
               "retention_s": self.retention_s,
               "window_s": ((win[-1].t_us - win[0].t_us) / 1e6
                            if len(win) >= 2 else 0.0),
               "counters": [], "histograms": [], "gauges": []}
        if len(win) < 2:
            return out
        first, last = win[0], win[-1]
        dt = max((last.t_us - first.t_us) / 1e6, 1e-9)
        kinds = self._family_kinds()
        counters = []
        gauges = []
        for key, v1 in last.scalars.items():
            name, kl = key
            kind = kinds.get(name)
            if kind == "counter":
                d = max(v1 - first.scalars.get(key, 0.0), 0.0)
                if d > 0:
                    counters.append({"name": name, "labels": dict(kl),
                                     "delta": round(d, 3),
                                     "rate_per_s": round(d / dt, 3)})
            elif kind == "gauge":
                gauges.append({"name": name, "labels": dict(kl),
                               "value": round(v1, 3)})
        counters.sort(key=lambda r: -r["rate_per_s"])
        gauges.sort(key=lambda r: -abs(r["value"]))
        hists = []
        for key, (c1, s1, _b) in last.hists.items():
            name, kl = key
            c0, s0, _b0 = first.hists.get(key, (0, 0.0, ()))
            dc = max(c1 - c0, 0)
            if dc <= 0:
                continue
            hists.append({
                "name": name, "labels": dict(kl), "count": dc,
                "mean": round(max(s1 - s0, 0.0) / dc, 1),
            })
        hists.sort(key=lambda r: -r["count"])
        hists = hists[:kk]
        # quantiles only for the survivors, computed from the first/last
        # samples already in hand: one delta pass per row, no re-snapshot
        # of the ring per percentile — scrape cost must not scale with
        # label cardinality or window depth
        for r in hists:
            deltas = self._bucket_deltas(first, last, r["name"],
                                         r["labels"])
            r["p50"] = self._quantile_of(deltas, 0.5)
            r["p99"] = self._quantile_of(deltas, 0.99)
        out["counters"] = counters[:kk]
        out["histograms"] = hists
        out["gauges"] = gauges[:kk]
        return out

    @staticmethod
    def _family_kinds() -> dict[str, str]:
        snap_families = get_registry()._families()
        return {m.name: m.kind for m in snap_families}


class TSDBSampler:
    """Daemon thread sampling the registry into the ring on the interval."""

    def __init__(self, tsdb: "MetricsTSDB"):
        self.tsdb = tsdb
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None  # lock-free: start/stop are operator-thread only

    def start(self) -> "TSDBSampler":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tsdb-sampler")
        self._thread.start()
        return self

    def _run(self) -> None:
        while True:
            # read the RAW knob: <=0 means "sampler off" at runtime —
            # interval_s clamps to 0.1s for ring math, which would turn
            # the off state into a 10 Hz full-registry sampling loop here
            raw = (self.tsdb._interval_override
                   if self.tsdb._interval_override is not None
                   else Global.tsdb_interval_s)
            enabled = Global.enable_tsdb and float(raw) > 0
            if self._stop.wait(self.tsdb.interval_s if enabled else 1.0):
                return
            if not enabled:
                continue  # knob flipped off at runtime: idle, keep the ring
            try:
                self.tsdb.sample_once()
            except Exception as e:  # the sampler must never die silently
                log_warn(f"tsdb sample failed: {e!r}")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)


# process-wide ring (the sampler, the history verb and the reuse trend
# share it)
_tsdb = MetricsTSDB()
# checked mode (lockdep.install) rebuilds the process-wide ledgers' locks
register_global_lock(_tsdb, "_lock", "tsdb.ring")
_sampler_lock = threading.Lock()  # plain: guards one-shot sampler start only
_sampler: "TSDBSampler | None" = None  # guarded by: _sampler_lock


def get_tsdb() -> MetricsTSDB:
    return _tsdb


def maybe_start_tsdb() -> "TSDBSampler | None":
    """Start the background sampler if ``enable_tsdb`` asks for one;
    idempotent per process (a second Proxy reuses the running sampler)."""
    global _sampler
    if not Global.enable_tsdb or Global.tsdb_interval_s <= 0:
        return None
    with _sampler_lock:
        if _sampler is None:
            _sampler = TSDBSampler(_tsdb).start()
        return _sampler


def stop_tsdb() -> None:
    """Stop the background sampler (tests / console teardown)."""
    global _sampler
    with _sampler_lock:
        if _sampler is not None:
            _sampler.stop()
            _sampler = None


# ---------------------------------------------------------------------------
# the history report (the console verb)
# ---------------------------------------------------------------------------

def render_history(k: int | None = None,
                   window_s: float | None = None) -> tuple[str, dict]:
    """(plain-text table, JSON dict) for the ``history`` console verb:
    windowed counter rates, histogram
    percentiles, and gauge values from the time-series ring."""
    rep = _tsdb.report(k, window_s)
    lines = [
        "wukong-history  (metrics trend window)",
        "",
        f"samples {rep['samples']}  interval {rep['interval_s']:g}s  "
        f"retention {rep['retention_s']:g}s  window "
        f"{rep['window_s']:.1f}s",
    ]
    if rep["samples"] < 2:
        lines.append("  (need >=2 samples — enable_tsdb on and the "
                     "sampler running, or call sample_once())")
        return "\n".join(lines) + "\n", rep
    lines.append("")
    lines.append("COUNTER RATES over window")
    lines.append(f"{'metric':<44} {'labels':<28} {'rate/s':>10} "
                 f"{'delta':>10}")
    for r in rep["counters"]:
        lbl = ",".join(f"{k2}={v}" for k2, v in sorted(r["labels"].items()))
        lines.append(f"{r['name']:<44.44} {lbl:<28.28} "
                     f"{r['rate_per_s']:>10,.2f} {r['delta']:>10,.0f}")
    if not rep["counters"]:
        lines.append("  (no counter moved inside the window)")
    lines.append("")
    lines.append("HISTOGRAMS over window")
    lines.append(f"{'metric':<44} {'labels':<28} {'count':>8} {'mean':>10} "
                 f"{'p50':>10} {'p99':>10}")
    for r in rep["histograms"]:
        lbl = ",".join(f"{k2}={v}" for k2, v in sorted(r["labels"].items()))
        p50 = "-" if r["p50"] is None else f"{r['p50']:,.0f}"
        p99 = "-" if r["p99"] is None else f"{r['p99']:,.0f}"
        lines.append(f"{r['name']:<44.44} {lbl:<28.28} {r['count']:>8,} "
                     f"{r['mean']:>10,.1f} {p50:>10} {p99:>10}")
    if not rep["histograms"]:
        lines.append("  (no histogram observed inside the window)")
    lines.append("")
    lines.append("GAUGES (latest sample)")
    for r in rep["gauges"]:
        lbl = ",".join(f"{k2}={v}" for k2, v in sorted(r["labels"].items()))
        lines.append(f"  {r['name']}{{{lbl}}} {r['value']:,.2f}")
    if not rep["gauges"]:
        lines.append("  (no gauges sampled)")
    return "\n".join(lines) + "\n", rep
