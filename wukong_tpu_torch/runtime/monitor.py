"""Latency/throughput monitor (reference: core/monitor.hpp:36-233).

The port's copy of the JAX package's runtime/monitor.py: per-query-class
latency vectors aggregated into a CDF, and rolling throughput reports — the
measurements the reference's proxy prints during ``sparql -n N`` and
``sparql-emu`` runs — and the heavy lane's rolling line, read from the
metrics registry (``lane_lines``). The JAX package's lines for subsystems
the port does not have yet (circuit breakers, stream epochs, heat, SLO,
admission, events, placement, migration, caches, device observatory) and
its latency histogram are left out.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from wukong_tpu_torch.obs.metrics import (
    get_registry,
    snapshot_histogram_mean,
    snapshot_labeled_value,
)
from wukong_tpu_torch.utils.logger import log_info
from wukong_tpu_torch.utils.timer import get_usec


def _cdf(vals, points=(0.5, 0.9, 0.95, 0.99, 1.0)) -> dict[float, float]:
    """Percentile dict over a sample list (monitor.hpp print_cdf
    indexing)."""
    if not vals:
        return {}
    arr = np.sort(np.asarray(vals, dtype=np.float64))
    return {p: float(arr[min(int(p * len(arr)), len(arr) - 1)])
            for p in points}


class Monitor:
    def __init__(self):
        self.latencies: dict[int, list] = defaultdict(list)  # type -> usecs
        self.cnt = 0
        self._t0 = None
        self._last_print = None
        self._last_cnt = 0

    def add_latency(self, usec: float, qtype: int = 0, count: int = 1) -> None:
        """Record an aggregate measurement (batched execution: ``count``
        queries of ``usec`` each)."""
        self.latencies[qtype].extend([usec] * count)
        self.cnt += count

    # -- open-loop throughput (monitor.hpp timely print) -------------------
    def start_thpt(self) -> None:
        self._t0 = self._last_print = get_usec()
        self._last_cnt = self.cnt = 0
        self.latencies.clear()

    def maybe_print_thpt(self, interval_usec: int = 500_000) -> None:
        now = get_usec()
        if self._last_print is not None and now - self._last_print > interval_usec:
            d = now - self._last_print
            log_info(f"Throughput: {(self.cnt - self._last_cnt) / (d / 1e6):,.0f} q/s")
            self._last_print = now
            self._last_cnt = self.cnt

    def thpt(self) -> float:
        if self._t0 is None:
            return 0.0
        dt = get_usec() - self._t0
        return self.cnt / (dt / 1e6) if dt else 0.0

    # -- CDF (monitor.hpp print_cdf) ---------------------------------------
    def cdf(self, qtype: int | None = None,
            points=(0.5, 0.9, 0.95, 0.99, 1.0)) -> dict[float, float]:
        vals: list = []
        if qtype is None:
            for v in self.latencies.values():
                vals.extend(v)
        else:
            vals = list(self.latencies.get(qtype, []))
        return _cdf(vals, points)

    def print_cdf(self, labels: dict[int, str] | None = None) -> None:
        """Per-class latency CDF. ``labels`` marks how a class was measured:
        device-batch classes report batch_time/B, a different quantity from
        a pool round-trip."""
        for qtype in sorted(self.latencies):
            c = self.cdf(qtype)
            line = "  ".join(f"p{int(p * 100)}={v:,.0f}us" for p, v in c.items())
            tag = f" [{labels[qtype]}]" if labels and qtype in labels else ""
            log_info(f"Q{qtype + 1}{tag} latency CDF "
                     f"({len(self.latencies[qtype])} samples): {line}")

    def lane_lines(self) -> list[str]:
        """Rolling-report line for the heavy lane: queue depth, fused
        dispatches, and mean group occupancy — only once the lane has seen
        traffic (quiet on light-only runs)."""
        snap = get_registry().snapshot()
        heavy_sub = int(snapshot_labeled_value(
            snap, "wukong_pool_submitted_total", lane="heavy"))
        disp = sum(int(s.get("value", 0)) for s in (
            snap.get("wukong_batch_heavy_dispatch_total") or {}).get(
            "series", []))
        if not heavy_sub and not disp:
            return []
        depth = int(snapshot_labeled_value(
            snap, "wukong_pool_lane_depth", lane="heavy"))
        mean = snapshot_histogram_mean(
            snap, "wukong_batch_heavy_occupancy") or 0.0
        return [f"HeavyLane: depth {depth}, {disp} fused dispatches "
                f"({heavy_sub} lane submits), mean group {mean:.1f}"]
