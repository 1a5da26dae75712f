"""Per-shard heat accounting: the measurement substrate for shard placement.

The port's copy of the JAX package's obs/heat.py. Every charge lands in one
:class:`ShardHeatAccountant`: fetch count by kind, rows, bytes, a latency
EWMA + histogram, and recent arrival timestamps per shard. The accountant
aggregates them into per-shard load CDFs and a top-K hot-shard report
(:meth:`ShardHeatAccountant.report`), surfaced three ways:

- the ``wukong_shard_heat_*`` metrics in the MetricsRegistry (Prometheus /
  JSON scrape),
- the ``/top`` endpoint on obs/httpd.py and the ``top`` console verb
  (rendered by obs/profile.py ``render_top``),
- ``Monitor.heat_report()`` lines in the rolling throughput report.

Two producers: each k-NN scan (vector/knn.py ``scan_topk`` and
``sliced_topk``) charges its store's shard, kind ``vector``, with the rows
it scanned, once a scan; the sharded store's host fetches
(parallel/sharded_store.py) charge every fetch outcome through
``maybe_charge`` (kinds ``primary``, ``failover``, ``rotation``,
``degraded``). ``PLACEMENT_INPUTS`` declares
which report fields back placement decisions and which registered metric
carries each; the ``heat-telemetry`` analysis gate keeps that map honest.
"""

from __future__ import annotations

from collections import deque

from wukong_tpu_torch.analysis.lockdep import (
    declare_leaf,
    make_lock,
    register_global_lock,
)
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.utils.timer import get_usec

# every placement-relevant input the heat report exposes, mapped to the
# registered metric that backs it (scrape-able truth for each number the
# migration planner will consume). The heat-telemetry analysis gate
# verifies each named metric is actually registered somewhere in code.
PLACEMENT_INPUTS = {
    "fetches": "wukong_shard_heat_fetches_total",
    "rows": "wukong_shard_heat_rows_total",
    "bytes": "wukong_shard_heat_bytes_total",
    "latency_cdf": "wukong_shard_heat_latency_us",
    "ewma_us": "wukong_shard_heat_ewma_us",
}

#: fetch outcome kinds a charge may carry (sharded_store._fetch_shard_impl;
#: "rotation" = a migrated shard's read served by its demoted donor copy;
#: "vector" = a k-NN embedding scan charged by vector/knn.py — the heat
#: planner sees hybrid traffic the same way it sees graph fetches)
FETCH_KINDS = ("primary", "failover", "degraded", "rotation", "vector")

EWMA_ALPHA = 0.2

# the accountant lock only guards deque/dict/float updates — innermost by
# construction, like trace.spans (charges fire outside the breaker lock)
declare_leaf("heat.shard")

_M_FETCHES = get_registry().counter(
    "wukong_shard_heat_fetches_total",
    "Sharded-store fetches by shard and outcome kind",
    labels=("shard", "kind"))
_M_ROWS = get_registry().counter(
    "wukong_shard_heat_rows_total",
    "Rows read from each shard by host-side fetches", labels=("shard",))
_M_BYTES = get_registry().counter(
    "wukong_shard_heat_bytes_total",
    "Bytes read from each shard by host-side fetches", labels=("shard",))
_M_LAT = get_registry().histogram(
    "wukong_shard_heat_latency_us",
    "Per-shard host fetch latency (usec)", labels=("shard",))


def _cdf(vals, points=(0.5, 0.9, 0.95, 0.99, 1.0)) -> dict[float, float]:
    """Percentile dict over a sample deque (monitor.hpp print_cdf indexing;
    tiny local copy — runtime.monitor importing obs is one-way)."""
    if not vals:
        return {}
    arr = sorted(float(v) for v in vals)
    return {p: arr[min(int(p * len(arr)), len(arr) - 1)] for p in points}


def _rate_cdf(arrivals, points=(0.5, 0.9, 0.95, 0.99, 1.0)) -> dict:
    """Instantaneous access rates (fetches/s) from an arrival-timestamp
    list, as a percentile dict."""
    rates = [1e6 / max(b - a, 1) for a, b in zip(arrivals, arrivals[1:])]
    return _cdf(rates, points)


class _ShardHeat:
    """One shard's heat counters (mutated only under the accountant lock)."""

    __slots__ = ("fetches", "by_kind", "rows", "bytes", "ewma_us",
                 "lat_us", "arrivals_us")

    def __init__(self, window: int):
        self.fetches = 0
        self.by_kind = {k: 0 for k in FETCH_KINDS}  # caller holds: heat.shard (the accountant lock)
        self.rows = 0
        self.bytes = 0
        self.ewma_us = 0.0
        self.lat_us: deque = deque(maxlen=window)  # caller holds: heat.shard (the accountant lock)
        self.arrivals_us: deque = deque(maxlen=window)  # caller holds: heat.shard (the accountant lock)


class ShardHeatAccountant:
    """Process-wide per-shard heat counters + the hot-shard report."""

    def __init__(self, window: int | None = None):
        self._window = window
        self._lock = make_lock("heat.shard")
        self._shards: dict[int, _ShardHeat] = {}  # guarded by: _lock

    # ------------------------------------------------------------------
    def charge(self, shard: int, kind: str, rows: int, nbytes: int,
               dur_us: int) -> None:
        """Account one host-side fetch against ``shard``. ``kind`` is the
        outcome (primary / failover / degraded); rows/bytes describe the
        fetched payload. One call per shard staging — never per row."""
        shard = int(shard)
        win = self._window or max(int(Global.heat_window), 16)
        now = get_usec()
        with self._lock:
            h = self._shards.get(shard)
            if h is None:
                h = self._shards[shard] = _ShardHeat(win)
            h.fetches += 1
            h.by_kind[kind] = h.by_kind.get(kind, 0) + 1
            h.rows += int(rows)
            h.bytes += int(nbytes)
            h.ewma_us = (dur_us if h.fetches == 1
                         else EWMA_ALPHA * dur_us
                         + (1 - EWMA_ALPHA) * h.ewma_us)
            h.lat_us.append(int(dur_us))
            h.arrivals_us.append(now)
        _M_FETCHES.labels(shard=shard, kind=kind).inc()
        _M_ROWS.labels(shard=shard).inc(int(rows))
        _M_BYTES.labels(shard=shard).inc(int(nbytes))
        _M_LAT.labels(shard=shard).observe(dur_us)

    # ------------------------------------------------------------------
    def ewma_series(self) -> dict:
        """Pull-gauge feed: {(shard,): ewma_us} for the registry callback."""
        with self._lock:
            return {(str(s),): h.ewma_us for s, h in self._shards.items()}

    def load_rate_cdf(self, shard: int,
                      points=(0.5, 0.9, 0.95, 0.99, 1.0)) -> dict:
        """CDF of the shard's instantaneous access rate (1/gap between
        consecutive fetch arrivals, in fetches/s) — the load distribution
        that separates a hot shard from a cold one even when individual
        fetch latencies look alike."""
        with self._lock:
            h = self._shards.get(int(shard))
            arr = list(h.arrivals_us) if h is not None else []
        return _rate_cdf(arr, points)

    def report(self, k: int | None = None) -> dict:
        """The heat report: per-shard stats + a top-K ranking by fetch
        count (the access-heat histogram migration decisions start from).
        Every field named in PLACEMENT_INPUTS appears per shard. ONE lock
        acquisition snapshots everything — each row's counters and its
        rate CDF come from the same instant."""
        with self._lock:
            snap = {s: (h.fetches, dict(h.by_kind), h.rows, h.bytes,
                        h.ewma_us, list(h.lat_us), list(h.arrivals_us))
                    for s, h in self._shards.items()}
        total = sum(f for (f, *_rest) in snap.values()) or 1
        shards = {}
        for s, (fetches, by_kind, rows, nbytes, ewma, lats,
                arrivals) in snap.items():
            shards[s] = {
                "fetches": fetches,
                "by_kind": by_kind,
                "rows": rows,
                "bytes": nbytes,
                "ewma_us": round(ewma, 1),
                "share": round(fetches / total, 4),
                "latency_cdf": _cdf(lats),
                "load_rate_cdf": _rate_cdf(arrivals),
            }
        ranked = sorted(shards, key=lambda s: (-shards[s]["fetches"], s))
        kk = k if k is not None else max(int(Global.top_k), 1)
        return {"total_fetches": total if snap else 0,
                "shards": shards,
                "ranked": [{"shard": s, **shards[s]} for s in ranked[:kk]]}

    def reset(self) -> None:
        """Drop accountant-local state (tests / scenario runs). Registry
        counters are cumulative and stay — the report reads only from
        here, so a scenario's ranking starts clean."""
        with self._lock:
            self._shards.clear()


# process-wide accountant (the sharded store and /top share it)
_accountant = ShardHeatAccountant()
# checked mode (lockdep.install) rebuilds the process-wide ledgers' locks
register_global_lock(_accountant, "_lock", "heat.shard")

get_registry().gauge(
    "wukong_shard_heat_ewma_us",
    "Per-shard fetch-latency EWMA (usec)",
    labels=("shard",)).set_function(_accountant.ewma_series)


def get_heat() -> ShardHeatAccountant:
    return _accountant


def payload_size(out) -> tuple[int, int]:
    """(rows, bytes) of a fetched payload: tuples/lists of numpy arrays
    (the CSR fetch forms) count the first element's length as rows and the
    summed nbytes as bytes; bare arrays likewise; everything else is 0/0.
    Pure shape inspection — never touches array contents."""
    arrs = out if isinstance(out, (tuple, list)) else (out,)
    rows = 0
    nbytes = 0
    first = True
    for a in arrs:
        n = getattr(a, "nbytes", None)
        if n is None:
            continue
        nbytes += int(n)
        if first and hasattr(a, "__len__"):
            rows = len(a)
            first = False
    return rows, nbytes


def maybe_charge(shard: int, kind: str, payload, dur_us: int) -> None:
    """The sharded store's charge hook: one knob check when heat is off."""
    if not Global.enable_heat:
        return
    rows, nbytes = payload_size(payload)
    _accountant.charge(shard, kind, rows, nbytes, dur_us)
