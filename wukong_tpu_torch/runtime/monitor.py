"""Latency/throughput monitor (reference: core/monitor.hpp:36-233).

The port's copy of the JAX package's runtime/monitor.py: per-query-class
latency vectors aggregated into a CDF, and rolling throughput reports — the
measurements the reference's proxy prints during ``sparql -n N`` and
``sparql-emu`` runs — with every latency also observed into the registry's
``wukong_query_latency_us{qtype}`` histogram, and the rolling lines read
back from the observability plane: the heavy lane (``lane_lines``), the
tenant SLOs (``slo_lines``), the admission plane (``admission_lines``),
the event journal (``events_lines``), the device observatory
(``device_lines``) and the serving caches (``cache_lines``); stream epochs
land in :class:`StreamStats` (``record_stream_epoch``, ``stream_stats``),
which the emulator's per-run monitor adopts (``share_observability``). The
JAX package's lines for subsystems the port does not have yet
(circuit-breaker registry, heat, placement, migration) are left out.
"""

from __future__ import annotations

from collections import defaultdict, deque

import numpy as np

from wukong_tpu_torch.obs.metrics import (
    get_registry,
    snapshot_histogram_mean,
    snapshot_labeled_value,
)
from wukong_tpu_torch.utils.logger import log_info
from wukong_tpu_torch.utils.timer import get_usec

_M_LATENCY = get_registry().histogram(
    "wukong_query_latency_us", "Per-query latency by class (usec)",
    labels=("qtype",))


# per-epoch latency samples kept for the stream CDF (bounds memory on
# long-running ingest loops; the totals keep counting past it)
STREAM_WINDOW = 4096


def _cdf(vals, points=(0.5, 0.9, 0.95, 0.99, 1.0)) -> dict[float, float]:
    """Percentile dict over a sample list (monitor.hpp print_cdf
    indexing — shared by the query and stream CDFs)."""
    if not vals:
        return {}
    arr = np.sort(np.asarray(vals, dtype=np.float64))
    return {p: float(arr[min(int(p * len(arr)), len(arr) - 1)])
            for p in points}


class StreamStats:
    """Streaming counters + latency windows, shareable between monitors
    (the emulator's per-run Monitor adopts the proxy monitor's instance so
    its report sees epochs committed on the proxy side)."""

    __slots__ = ("epochs", "triples", "lag_us", "eval_us", "ingest_us")

    def __init__(self):
        self.epochs = 0
        self.triples = 0
        self.lag_us: deque = deque(maxlen=STREAM_WINDOW)
        self.eval_us: deque = deque(maxlen=STREAM_WINDOW)
        self.ingest_us: deque = deque(maxlen=STREAM_WINDOW)


class Monitor:
    def __init__(self):
        self.latencies: dict[int, list] = defaultdict(list)  # type -> usecs
        self.cnt = 0
        self._t0 = None
        self._last_print = None
        self._last_cnt = 0
        # streaming (stream/ingest.py feeds record_stream_epoch)
        self.stream = StreamStats()
        self._last_stream_epochs = 0
        self._last_stream_triples = 0

    def share_observability(self, other: "Monitor") -> None:
        """Adopt ``other``'s stream stats by reference, keeping per-query
        counters private (the JAX monitor also adopts its breaker
        registry, which waits for the distributed engine)."""
        self.stream = other.stream
        # epochs committed before this monitor existed must not read as
        # rate in its first report window
        self._last_stream_epochs = other.stream.epochs
        self._last_stream_triples = other.stream.triples

    def add_latency(self, usec: float, qtype: int = 0, count: int = 1) -> None:
        """Record an aggregate measurement (batched execution: ``count``
        queries of ``usec`` each)."""
        self.latencies[qtype].extend([usec] * count)
        self.cnt += count
        _M_LATENCY.labels(qtype=qtype).observe(usec, count=count)

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
            if self.stream.epochs > self._last_stream_epochs:
                de = self.stream.epochs - self._last_stream_epochs
                dt = self.stream.triples - self._last_stream_triples
                lag = self.stream_lag_cdf()
                lag_str = (f", lag p50={lag[0.5]:,.0f}us "
                           f"p99={lag[0.99]:,.0f}us" if lag else "")
                log_info(f"Stream: {de / (d / 1e6):,.1f} epochs/s, "
                         f"{dt / (d / 1e6):,.0f} triples/s{lag_str}")
            self._last_stream_epochs = self.stream.epochs
            self._last_stream_triples = self.stream.triples
            for line in self.cache_lines():
                log_info(line)
            self._last_print = now
            self._last_cnt = self.cnt

    def thpt(self) -> float:
        if self._t0 is None:
            return 0.0
        dt = get_usec() - self._t0
        return self.cnt / (dt / 1e6) if dt else 0.0

    # -- streaming metrics (no reference analogue; Wukong+S-style lag) -----
    def record_stream_epoch(self, n_triples: int, ingest_us: int,
                            eval_us: int, lag_us: int) -> None:
        """One committed epoch: batch size, insert time, standing-query
        evaluation time, and commit-to-results lag."""
        self.stream.epochs += 1
        self.stream.triples += int(n_triples)
        self.stream.ingest_us.append(int(ingest_us))
        self.stream.eval_us.append(int(eval_us))
        self.stream.lag_us.append(int(lag_us))

    def stream_lag_cdf(self, points=(0.5, 0.9, 0.95, 0.99, 1.0)):
        return _cdf(self.stream.lag_us, points)

    def stream_stats(self) -> dict:
        """Aggregate streaming view."""
        return {
            "epochs": self.stream.epochs,
            "triples": self.stream.triples,
            "ingest_us_cdf": _cdf(self.stream.ingest_us),
            "eval_us_cdf": _cdf(self.stream.eval_us),
            "lag_us_cdf": self.stream_lag_cdf(),
        }

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

    def slo_lines(self, k: int = 3) -> list[str]:
        """Rolling-report lines for the tenant SLO plane (obs/slo.py): the
        k worst-burning spec'd tenants' compliance, remaining error budget
        and burn rates; quiet when no spec'd tenant replied."""
        from wukong_tpu_torch.obs.slo import get_slo

        rows = [r for r in get_slo().report()["tenants"]
                if r["spec"] is not None]
        if not rows:
            return []
        parts = []
        for r in rows[:k]:
            burn = r.get("burn") or {}
            parts.append(
                f"{r['tenant']}: compl "
                + ("-" if r["compliance"] is None
                   else f"{r['compliance']:.1%}")
                + f" budget {r.get('error_budget_remaining', 0):.0%}"
                + f" burn {burn.get('fast', 0):.1f}/{burn.get('slow', 0):.1f}"
                + (f" alerts {r['alerts']}" if r["alerts"] else ""))
        return ["SLO[" + "  ".join(parts) + "]"]

    def admission_lines(self, k: int = 3) -> list[str]:
        """Rolling-report line for the admission plane
        (runtime/admission.py): the overload level and the k busiest
        tenants' non-admit decision counts; quiet while the plane is off or
        has decided nothing."""
        from wukong_tpu_torch.config import Global

        if not Global.enable_admission:
            return []
        from wukong_tpu_torch.runtime.admission import get_admission

        rep = get_admission().report()
        decisions = rep["decisions"]
        if not decisions:
            return []
        shed = {kt: n for kt, n in decisions.items()
                if not kt.startswith("admit/")}
        top = sorted(shed.items(), key=lambda kv: -kv[1])[:k]
        parts = [f"{kt}:{n}" for kt, n in top]
        total = sum(decisions.values())
        return ["Admission[level " + str(rep["level"])
                + f" {total:,} decisions"
                + ("  " + "  ".join(parts) if parts else "") + "]"]

    def device_lines(self) -> list[str]:
        """Rolling-report line for the device observatory: dispatch count
        + cold/warm split + padding efficiency + resident bytes vs the
        budget — quiet until any dispatch or residency fill has been
        charged."""
        from wukong_tpu_torch.obs.device import get_device_obs

        obs = get_device_obs()
        d = obs.dispatch_ledger.dispatch_counts()
        res = obs.residency.stats()
        if d["count"] == 0 and res["total_bytes"] == 0:
            return []
        eff = obs.dispatch_ledger.padding_efficiency()
        return [f"Device[{d['count']:,} dispatches "
                f"({d['cold']:,} cold / {d['warm']:,} warm), pad_eff "
                + ("-" if eff is None else f"{eff:.1%}")
                + f", resident {res['total_bytes'] / 2**20:.1f}"
                f"/{res['budget_bytes'] / 2**20:.0f} MiB"
                f" (hw {res['high_water_bytes'] / 2**20:.1f})"
                + (", OVER BUDGET" if res["over_budget"] else "") + "]"]

    def events_lines(self, k: int = 4) -> list[str]:
        """Rolling-report line for the event journal (obs/events.py): the
        total, the k most frequent kinds and the newest event; quiet while
        nothing was journaled."""
        from wukong_tpu_torch.obs.events import get_journal

        j = get_journal()
        counts = j.counts()
        if not counts:
            return []
        top = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
        newest = j.last(1)
        tail = ""
        if newest:
            e = newest[0]
            tail = (f"; last {e.event_id} {e.kind}"
                    + (f" shard={e.shard}" if e.shard is not None else ""))
        return ["Events[" + "  ".join(f"{kd}:{n}" for kd, n in top)
                + f"] ({sum(counts.values())} total{tail})"]

    def cache_lines(self) -> list[str]:
        """Rolling-report lines for the serving cache: the real result
        cache + view registry (serve/) when it is on and probed, then the
        observatory's shadow line (obs/reuse.py) — quiet until any reply
        has been observed."""
        from wukong_tpu_torch.config import Global
        from wukong_tpu_torch.obs.reuse import get_reuse

        lines = []
        if Global.enable_result_cache:
            from wukong_tpu_torch.serve import get_serve
            from wukong_tpu_torch.serve.result_cache import divergence_total

            rc = get_serve().cache.stats()
            if rc["hits"] + rc["misses"]:
                hr = rc["hit_rate"]
                lines.append(
                    "Cache[real "
                    + ("-" if hr is None else f"{hr:.1%}")
                    + f" over {rc['hits'] + rc['misses']:,} probes, "
                    f"{rc['entries']} entries, "
                    f"{rc['bytes_held'] / 2**20:.1f} MiB held, "
                    f"{get_serve().views.count()} views, "
                    f"{rc['collapsed']:,} collapsed, "
                    f"diverged {divergence_total():,}]")
        obs = get_reuse()
        sh = obs.shadow.stats()
        if sh["hits"] + sh["misses"] == 0:
            return lines
        pop = obs.ledger.report(k=1)
        hot = ""
        if pop["ranked"]:
            r = pop["ranked"][0]
            hot = (f", top {r['template']} {r['share']:.0%} "
                   f"@{r['rate_qps']:,.0f}q/s")
        hr = sh["hit_rate"]
        lines.append(f"Cache[shadow "
                     + ("-" if hr is None else f"{hr:.1%}")
                     + f" over {sh['hits'] + sh['misses']:,} probes, "
                     f"{sh['keys']} keys, {sh['killed']:,} killed, "
                     f"saved {sh['bytes_saved'] / 2**20:.1f} MiB"
                     f"{hot}]")
        return lines
