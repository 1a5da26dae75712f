"""EXPLAIN / EXPLAIN ANALYZE + latency attribution over the trace plane.

The port's copy of the JAX package's obs/profile.py:

- :func:`explain_query` — EXPLAIN renders the planned pattern list with
  the planner's per-step cost/cardinality estimates
  (``Planner.explain_steps``); EXPLAIN ANALYZE also executes the query
  under a forced (unsampled) :class:`QueryTrace` and joins each host
  step's actual rows in and out, wall time and fetch count against the
  estimates, keyed on step index. A device chain's steps run fused in one
  chain with one sync, so they carry no per-step actuals (the ``gpu.chain``
  span carries the chain's rows); only host steps (``gpu.host_step``,
  ``cpu.step``) do, as in the JAX package. The report is structured JSON
  plus a rendered table (console verbs ``explain`` / ``analyze``,
  ``Proxy.explain_query()``).
- :func:`decompose` — one trace's end-to-end latency split into
  queue / parse / plan / execute / fetch components (+ the uncovered
  "other"). A batched member, whose execution ran on its fused group's
  trace, is attributed through the ``batch.settled`` event the group
  stamps on every member.
- :class:`LatencyAttributor` — the regression sentinel: rolling
  per-template baselines of component shares and total latency; a query
  whose component share moves by ``attribution_share_drift_pct`` points or
  whose total passes the baseline p95 by ``attribution_p95_drift_pct``
  percent counts ``wukong_latency_regressions_total`` and dumps its trace
  (reason ``LATENCY_REGRESSION``).

The report carries the execution strategy, the route line (a wcoj query's
level route, ``template-compiled`` for a query its compiled template
served), the WCOJ per-level table (``wcoj_levels``) and the device table
(``device_steps``: one row per charged device dispatch — a chain step, a
merge step, a WCOJ probe group, a template program) and the ``knn`` section
of a hybrid query (its mode, route and scan size), as in the JAX package.
:func:`render_top` is top(1) for shards (the heat plane), templates (the
attributor) and the pool's lanes: the ``top`` verb and ``GET /top``.
"""

from __future__ import annotations

import os
from collections import deque

from wukong_tpu_torch.analysis.lockdep import (
    declare_leaf,
    make_lock,
    register_global_lock,
)
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.obs.heat import get_heat
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.obs.recorder import get_recorder
from wukong_tpu_torch.obs.trace import QueryTrace, activate
from wukong_tpu_torch.types import IN
from wukong_tpu_torch.utils.timer import get_usec

#: latency components decompose() attributes (everything else is "other")
COMPONENTS = ("queue", "parse", "plan", "execute", "fetch")

#: top-level engine execution spans (one per engine family)
EXECUTE_SPANS = frozenset({"cpu.execute", "gpu.execute", "wcoj.execute"})

#: per-BGP-step spans carrying step index + rows in/out attributes
STEP_SPANS = frozenset({"cpu.step", "gpu.host_step"})

#: span events that count as retries/degradations in the ANALYZE report
_EVENT_COUNTS = ("retry", "fault.injected", "breaker.trip", "shard.failover",
                 "proxy.fallback")

_M_REGRESS = get_registry().counter(
    "wukong_latency_regressions_total",
    "Regression-sentinel trips by template", labels=("template",))
_M_SAMPLES = get_registry().counter(
    "wukong_attribution_samples_total",
    "Traced queries folded into per-template latency baselines")

declare_leaf("profile.templates")


# ---------------------------------------------------------------------------
# latency decomposition
# ---------------------------------------------------------------------------

def decompose(trace: QueryTrace) -> dict:
    """Split one finished trace's wall time into COMPONENTS + other.

    ``shard.fetch`` spans nest inside the engine execute span, so their
    time is subtracted from ``execute``, and an execute span nested in
    another (a UNION branch, an OPTIONAL child) is not counted again, so
    each usec lands in exactly one component. A batched member carries no
    execute span of its own: its fused group stamped a ``batch.settled``
    event whose ``dispatch_us`` is the group dispatch's host time, and that
    becomes the member's execute share.
    """
    comp = {k: 0 for k in COMPONENTS}
    batch_us = 0

    def _note_event(name: str, attrs: dict) -> None:
        nonlocal batch_us
        if name == "batch.settled":
            batch_us += int(attrs.get("dispatch_us", 0))

    outer: dict[int, list] = {}  # tid -> execute spans counted so far
    for sp in trace.spans:
        if sp.name == "pool.queue":
            comp["queue"] += sp.dur_us
        elif sp.name == "proxy.parse":
            comp["parse"] += sp.dur_us
        elif sp.name == "proxy.plan":
            comp["plan"] += sp.dur_us
        elif sp.name in EXECUTE_SPANS:
            # a UNION branch or OPTIONAL child runs through the engine's
            # execute again, inside its parent's span: count the outermost
            # only (the JAX decompose adds both, so its components can pass
            # the total)
            end = sp.t0_us + sp.dur_us
            mine = outer.setdefault(sp.tid, [])
            if not any(a <= sp.t0_us and end <= b for a, b in mine):
                mine.append((sp.t0_us, end))
                comp["execute"] += sp.dur_us
        elif sp.name == "shard.fetch":
            comp["fetch"] += sp.dur_us
        elif sp.name == "batch.settled":
            # a member settled with no open span gets a synthetic
            # zero-length span instead of an event (QueryTrace.event)
            _note_event(sp.name, sp.attrs)
        for (_t, name, attrs) in sp.events:
            _note_event(name, attrs)
    if batch_us and comp["execute"] == 0:
        comp["execute"] = batch_us
    comp["execute"] = max(comp["execute"] - comp["fetch"], 0)
    total = trace.dur_us
    covered = sum(comp.values())
    return {"total_us": int(total), "components": comp,
            "other_us": int(max(total - covered, 0)),
            "covered_frac": round(min(covered / total, 1.0), 4)
            if total > 0 else 1.0}


def render_decomposition(d: dict) -> str:
    total = max(d["total_us"], 1)
    parts = [f"{k} {v:,}us ({100.0 * v / total:.1f}%)"
             for k, v in d["components"].items()]
    parts.append(f"other {d['other_us']:,}us")
    return ("latency: " + " | ".join(parts)
            + f"  [components cover {100.0 * d['covered_frac']:.1f}%"
            + f" of {d['total_us']:,}us]")


# ---------------------------------------------------------------------------
# EXPLAIN / EXPLAIN ANALYZE
# ---------------------------------------------------------------------------

def _fmt_pattern(p) -> str:
    d = "OUT" if p.direction != IN else "IN"
    s = f"({p.subject} {p.predicate} {d} {p.object})"
    return s if p.pred_type == 0 else s[:-1] + f" attr:{p.pred_type})"


def capture_estimates(planner, q) -> list | None:
    """Per-step estimates for a PLANNED query, or None (no planner / shape
    the chain walk cannot estimate — UNION/OPTIONAL plan recursively)."""
    if planner is None or not Global.enable_planner:
        return None
    pg = q.pattern_group
    if pg.unions or pg.optional or not pg.patterns:
        return None
    try:
        return planner.explain_steps(pg.patterns)
    except Exception:
        return None


def _join_actuals(q, trace: QueryTrace, steps: list[dict]) -> dict:
    """Fold the executed trace's per-step spans + events into the step
    records (keyed on step index) and return the query-level counters."""
    step_spans = [sp for sp in trace.spans if sp.name in STEP_SPANS]
    fetch_spans = [sp for sp in trace.spans if sp.name == "shard.fetch"]
    for sp in step_spans:
        k = sp.attrs.get("step")
        if k is None or not (0 <= int(k) < len(steps)):
            continue
        rec = steps[int(k)]
        rec["rows_in"] = sp.attrs.get("rows_in")
        rec["rows_out"] = sp.attrs.get("rows_out")
        rec["time_us"] = sp.dur_us
        end = sp.t1_us if sp.t1_us is not None else sp.t0_us
        rec["fetches"] = sum(1 for f in fetch_spans
                             if sp.t0_us <= f.t0_us <= end)
    events: dict[str, int] = {}
    batch = None
    for sp in trace.spans:
        pairs = [(sp.name, sp.attrs)] if not sp.events else \
            [(sp.name, sp.attrs)] + [(n, a) for (_t, n, a) in sp.events]
        for name, attrs in pairs:
            if name in _EVENT_COUNTS:
                events[name] = events.get(name, 0) + 1
            elif name == "batch.dispatch" and "group" in attrs:
                batch = {"group": attrs.get("group"),
                         "size": attrs.get("size"),
                         "reason": attrs.get("reason")}
    return {"fetch_spans": len(fetch_spans), "events": events,
            "fused_group": batch}


def explain_query(proxy, text: str, analyze: bool = False,
                  device: str | None = None, plan_text: str | None = None,
                  blind: bool = True) -> dict:
    """EXPLAIN (parse + plan + estimates) or EXPLAIN ANALYZE (additionally
    execute under a forced trace and join actuals). Returns the structured
    report; ``report["rendered"]`` is the human table."""
    if not analyze:
        q = proxy._parse_text(text)
        proxy._plan_prepared(q, blind, plan_text)
        est = capture_estimates(proxy.planner, q)
        return _build_report(q, est, trace=None, extras=None, text=text)

    # ANALYZE: a forced trace (independent of the enable_tracing sampling
    # knobs — asking for a profile IS the sampling decision), activated on
    # this thread so parse/plan/fetch spans land on it like a sampled query
    trace = QueryTrace(kind="query", text=text)
    with activate(trace):
        with trace.span("proxy.parse"):
            q = proxy._parse_text(text)
        q.trace = trace
        q.qid = trace.qid
        with trace.span("proxy.plan"):
            proxy._plan_prepared(q, blind, plan_text)
            est = capture_estimates(proxy.planner, q)
        eng = proxy._engine_for(device)
        proxy._serve_execute(q, eng, pinned=device is not None)
    trace.finish(q.result.status_code.name)
    get_recorder().on_complete(trace, q.result.status_code)
    return _build_report(q, est, trace=trace, extras=None, text=text)


def _build_report(q, est: list | None, trace: QueryTrace | None,
                  extras, text: str) -> dict:
    pats = q.pattern_group.patterns
    steps: list[dict] = []
    for k, p in enumerate(pats):
        rec = {"step": k, "pattern": _fmt_pattern(p)}
        if est is not None and k < len(est):
            rec.update(est[k])
        steps.append(rec)
    report: dict = {
        "mode": "EXPLAIN ANALYZE" if trace is not None else "EXPLAIN",
        "query": " ".join(text.split())[:200],
        "planner": ("cost-based" if est is not None else "heuristic/none"),
        "planner_empty": bool(getattr(q, "planner_empty", False)),
        "strategy": getattr(q, "join_strategy", "walk"),
        "steps": steps,
        "unions": len(q.pattern_group.unions),
        "optional": len(q.pattern_group.optional),
    }
    # tensor-join execution: per-level intersection stats recorded by the
    # WCOJ executor (variable order, candidate/emitted rows, probe counts,
    # and which route probed each level)
    join_stats = getattr(q, "join_stats", None)
    if join_stats:
        report["wcoj_levels"] = join_stats
    if report["strategy"] == "wcoj":
        report["route"] = getattr(q, "join_route", "host")
        dist = getattr(q, "join_dist", None)
        if dist:
            report["join_dist"] = dist
    elif getattr(q, "_template_compiled", False):
        # the walk-strategy plan was served as ONE fused whole-plan device
        # program (engine/template_compile.py) — its dispatch record
        # rides the device table below like any other device step
        report["route"] = "template-compiled"
    # hybrid graph+vector: the knn scan's planned shape (vector/)
    # — est rows = live embeddings the brute-force scan reads, est bytes =
    # their float32 block, route/mode as stamped by the proxy at plan time
    knn = getattr(q, "knn", None)
    if knn is not None:
        live = int(getattr(q, "_knn_live", 0))
        dim = int(getattr(q, "_knn_dim", 0))
        report["knn"] = {
            "var": int(knn.var), "k": int(knn.k),
            "metric": knn.metric or "(knob default)",
            "mode": getattr(q, "knn_mode", "") or knn.mode,
            "route": getattr(q, "knn_route", "host"),
            "est_rows": live,
            "est_bytes": live * dim * 4,
        }
    # device observatory: the per-step dispatch records the engine seams
    # stamped onto the query (obs/device.py maybe_device_dispatch) — one
    # row per fused chain step / wcoj device level, carrying padding
    # efficiency and the cold/warm compile split
    dev_steps = getattr(q, "device_steps", None)
    if dev_steps:
        report["device_steps"] = dev_steps
    if est is not None:
        report["est_total_cost"] = round(est[-1]["est_cost_cum"], 1)
    if trace is not None:
        extra = _join_actuals(q, trace, steps)
        d = decompose(trace)
        report.update({
            "trace_id": trace.trace_id,
            "status": q.result.status_code.name,
            "complete": bool(q.result.complete),
            "rows": int(q.result.nrows),
            "total_us": int(trace.dur_us),
            "decomposition": d,
            **extra,
        })
    report["rendered"] = _render(report)
    return report


def _render(report: dict) -> str:
    analyze = report["mode"] == "EXPLAIN ANALYZE"
    lines = [report["mode"]]
    head = f"{'step':>4}  {'pattern':<40} {'est_rows':>10} {'est_cost':>10}"
    if analyze:
        head += f" {'rows_in':>8} {'rows_out':>9} {'time_us':>9} {'fetch':>5}"
    lines.append(head)

    def _n(v, fmt="{:,}"):
        return "-" if v is None else fmt.format(v)

    for rec in report["steps"]:
        row = (f"{rec['step']:>4}  {rec['pattern']:<40} "
               f"{_n(rec.get('est_rows'), '{:,.1f}'):>10} "
               f"{_n(rec.get('est_cost'), '{:,.1f}'):>10}")
        if analyze:
            row += (f" {_n(rec.get('rows_in')):>8}"
                    f" {_n(rec.get('rows_out')):>9}"
                    f" {_n(rec.get('time_us')):>9}"
                    f" {_n(rec.get('fetches')):>5}")
        lines.append(row)
    tail = f"planner: {report['planner']}, strategy: {report['strategy']}"
    if "est_total_cost" in report:
        tail += f", est total cost {report['est_total_cost']:,}"
    if report["planner_empty"]:
        tail += ", proven empty"
    if report["unions"] or report["optional"]:
        tail += (f" (+{report['unions']} union / "
                 f"{report['optional']} optional group(s), planned "
                 "recursively — not estimated here)")
    lines.append(tail)
    if report.get("knn"):
        kn = report["knn"]
        lines.append(
            f"knn: var={kn['var']} k={kn['k']} metric={kn['metric']} "
            f"mode={kn['mode']} route={kn['route']} "
            f"est_rows={kn['est_rows']:,} est_bytes={kn['est_bytes']:,}")
    if report.get("route") is not None:
        # the level-route line: host kernels vs the device path
        # (+ the distributed fan-out width when the join was sharded)
        route_line = f"route: {report['route']}"
        if report.get("join_dist"):
            route_line += f" (dist slices={report['join_dist']['slices']})"
        lines.append(route_line)
    if report.get("wcoj_levels"):
        lines.append(f"{'lvl':>4}  {'var':>6} {'rows_in':>9} "
                     f"{'candidates':>11} {'rows_out':>9} {'probes':>6} "
                     f"{'route':>7} {'time_us':>9}")
        for lv in report["wcoj_levels"]:
            lines.append(f"{lv['level']:>4}  {lv['var']:>6} "
                         f"{lv['rows_in']:>9,} {lv['candidates']:>11,} "
                         f"{lv['rows_out']:>9,} {lv['probes']:>6} "
                         f"{lv.get('route', 'host'):>7} "
                         f"{lv.get('time_us', 0):>9,}")
    if report.get("device_steps"):
        recs = report["device_steps"]
        cold = sum(1 for r in recs if r.get("temp") == "cold")
        live = sum(r.get("live", 0) for r in recs)
        padded = sum(r.get("capacity", 0) * r.get("dispatches", 1)
                     for r in recs)
        eff = f"{live / padded:.1%}" if padded else "-"
        lines.append(f"device: dispatches={len(recs)} cold={cold} "
                     f"warm={len(recs) - cold} pad_eff={eff}")
        lines.append(f"{'step':>4}  {'site':<16} {'template':<10} "
                     f"{'capacity':>9} {'live':>9} {'eff':>6} "
                     f"{'temp':>5} {'time_us':>9}")
        for r in recs:
            e = r.get("padding_efficiency")
            lines.append(
                f"{r.get('step', 0):>4}  {r['site']:<16.16} "
                f"{r.get('template', ''):<10.10} "
                f"{r.get('capacity', 0):>9,} {r.get('live', 0):>9,} "
                f"{'-' if e is None else format(e, '.0%'):>6} "
                f"{r.get('temp', '-'):>5} {r.get('wall_us', 0):>9,}")
        xprof = str(Global.xprof_dir) or os.environ.get("WUKONG_XPROF_DIR")
        if xprof:
            lines.append(f"device trace: {xprof} (xprof_dir — "
                         "torch.profiler capture of these dispatches)")
    if analyze:
        lines.append(f"status: {report['status']} rows={report['rows']:,} "
                     f"complete={report['complete']} "
                     f"trace={report['trace_id']}")
        if report.get("events"):
            lines.append("events: " + " ".join(
                f"{k}={v}" for k, v in sorted(report["events"].items())))
        if report.get("fused_group"):
            fg = report["fused_group"]
            lines.append(f"fused: group={fg['group']} size={fg['size']} "
                         f"reason={fg['reason']}")
        lines.append(render_decomposition(report["decomposition"]))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# latency attribution + regression sentinel
# ---------------------------------------------------------------------------

class _TemplateStats:
    """One template's rolling baseline (mutated under the attributor lock)."""

    __slots__ = ("totals", "shares", "count", "example", "trips",
                 "last_trip_us")

    def __init__(self, window: int):
        self.totals: deque = deque(maxlen=window)
        self.shares: deque = deque(maxlen=window)  # dicts of component share
        self.count = 0
        self.example = ""
        self.trips = 0
        self.last_trip_us = 0  # sentinel cooldown cursor

    def baseline(self) -> tuple[float, dict]:
        """(p95 total, mean component shares) over the current window."""
        arr = sorted(self.totals)
        p95 = arr[min(int(0.95 * len(arr)), len(arr) - 1)] if arr else 0.0
        mean = {k: 0.0 for k in COMPONENTS}
        for s in self.shares:
            for k in COMPONENTS:
                mean[k] += s[k]
        n = len(self.shares) or 1
        return p95, {k: v / n for k, v in mean.items()}


class LatencyAttributor:
    """Rolling per-template latency baselines + the regression sentinel."""

    def __init__(self, window: int | None = None):
        self._window = window
        self._lock = make_lock("profile.templates")
        self._templates: dict[str, _TemplateStats] = {}  # guarded by: _lock

    # ------------------------------------------------------------------
    def observe(self, trace: QueryTrace | None, template: str,
                example: str = "") -> dict | None:
        """Fold one finished trace into its template's baseline; returns
        the regression verdict when the sentinel trips, else None. The
        tripped trace auto-dumps through the flight recorder."""
        if trace is None:
            return None
        d = decompose(trace)
        total = d["total_us"]
        shares = {k: (v / total if total else 0.0)
                  for k, v in d["components"].items()}
        win = self._window or max(int(Global.attribution_window), 4)
        verdict = None
        with self._lock:
            st = self._templates.get(template)
            if st is None:
                st = self._templates[template] = _TemplateStats(win)
            if example and not st.example:
                st.example = example
            armed = (get_usec() - st.last_trip_us
                     >= Global.attribution_cooldown_s * 1_000_000)
            if armed and len(st.totals) >= max(
                    int(Global.attribution_min_samples), 2):
                p95, base_shares = st.baseline()
                drifts = {k: (shares[k] - base_shares[k]) * 100.0
                          for k in COMPONENTS}
                worst = max(drifts, key=lambda k: abs(drifts[k]))
                share_trip = (abs(drifts[worst])
                              > float(Global.attribution_share_drift_pct))
                p95_trip = (p95 > 0 and total > p95 *
                            (1.0 + Global.attribution_p95_drift_pct / 100.0))
                if share_trip or p95_trip:
                    st.trips += 1
                    st.last_trip_us = get_usec()
                    verdict = {
                        "template": template,
                        # tenant-attributable without replaying the trace
                        "tenant": getattr(trace, "tenant", "default"),
                        "total_us": total,
                        "baseline_p95_us": int(p95),
                        "component": worst,
                        "share_drift_pts": round(drifts[worst], 1),
                        "reason": ("COMPONENT_SHIFT" if share_trip
                                   else "P95_DRIFT"),
                    }
            st.totals.append(total)
            st.shares.append(shares)
            st.count += 1
        _M_SAMPLES.inc()
        if verdict is not None:
            _M_REGRESS.labels(template=template).inc()
            # journal first so the dump references its triggering event
            from wukong_tpu_torch.obs.events import emit_event

            eid = emit_event("latency.regression",
                             tenant=verdict["tenant"], template=template,
                             reason=verdict["reason"],
                             total_us=verdict["total_us"])
            verdict["event_id"] = eid
            get_recorder().dump(trace, "LATENCY_REGRESSION", event_id=eid)
        return verdict

    # ------------------------------------------------------------------
    def report(self, k: int | None = None) -> list[dict]:
        """Hot templates for /top: ranked by total attributed time."""
        with self._lock:
            snap = [(t, list(st.totals), st.count, st.example, st.trips,
                     st.baseline())
                    for t, st in self._templates.items()]
        out = []
        for t, totals, count, example, trips, (p95, shares) in snap:
            arr = sorted(totals)
            p50 = arr[len(arr) // 2] if arr else 0
            top_comp = max(shares, key=shares.get) if any(
                shares.values()) else "-"
            out.append({"template": t, "count": count,
                        "p50_us": int(p50), "p95_us": int(p95),
                        "top_component": top_comp,
                        "top_share": round(shares.get(top_comp, 0.0), 3),
                        "trips": trips,
                        "total_time_us": int(sum(totals)),
                        "example": example})
        out.sort(key=lambda r: -r["total_time_us"])
        kk = k if k is not None else max(int(Global.top_k), 1)
        return out[:kk]

    def reset(self) -> None:
        with self._lock:
            self._templates.clear()


_attributor = LatencyAttributor()
# checked mode (lockdep.install) rebuilds the process-wide ledgers' locks
register_global_lock(_attributor, "_lock", "profile.templates")


def get_attributor() -> LatencyAttributor:
    return _attributor


def template_key(q, text: str) -> str:
    """A stable per-template key: the batcher's template signature when the
    shape supports one (constants abstracted — instances of one template
    share a baseline), else the whitespace-collapsed text."""
    from wukong_tpu_torch.runtime.batcher import template_signature

    sig = template_signature(q)
    if sig is None:
        return " ".join(text.split())[:120]
    # a process-stable digest: builtin hash() is salted per process, which
    # would mint a fresh metrics label series for every template on every
    # restart and break cross-run regression correlation
    import zlib

    return f"sig:{zlib.crc32(repr(sig).encode()):08x}"


# ---------------------------------------------------------------------------
# the /top report (shards / templates / lanes)
# ---------------------------------------------------------------------------

def render_top(k: int | None = None) -> tuple[str, dict]:
    """(plain-text table, JSON dict) for the /top endpoint and the ``top``
    console verb — top(1) for shards, templates, and scheduler lanes."""
    from wukong_tpu_torch.obs.reuse import cache_hit_rates

    kk = k if k is not None else max(int(Global.top_k), 1)
    heat = get_heat().report(kk)
    templates = get_attributor().report(kk)
    lanes = _lane_depths()
    caches = cache_hit_rates()
    js = {"shards": heat, "templates": templates, "lanes": lanes,
          "caches": caches}

    lines = [f"wukong-top  (top {kk} per section)", ""]
    lines.append("SHARDS by fetches "
                 f"(total {heat['total_fetches']:,})")
    lines.append(f"{'shard':>6} {'fetches':>8} {'share':>6} {'rows':>10} "
                 f"{'bytes':>12} {'ewma_us':>9} {'p50_us':>8} {'p99_us':>8} "
                 f"{'rate50/s':>9} {'failover':>8} {'degraded':>8}")
    for r in heat["ranked"]:
        lat = r["latency_cdf"]
        rate = r["load_rate_cdf"]
        lines.append(
            f"{r['shard']:>6} {r['fetches']:>8,} {r['share']:>6.1%} "
            f"{r['rows']:>10,} {r['bytes']:>12,} {r['ewma_us']:>9,.0f} "
            f"{lat.get(0.5, 0):>8,.0f} {lat.get(0.99, 0):>8,.0f} "
            f"{rate.get(0.5, 0):>9,.1f} "
            f"{r['by_kind'].get('failover', 0):>8,} "
            f"{r['by_kind'].get('degraded', 0):>8,}")
    if not heat["ranked"]:
        lines.append("  (no shard fetches charged — enable_heat off or "
                     "no distributed store)")
    lines.append("")
    lines.append("TEMPLATES by attributed time")
    lines.append(f"{'template':<16} {'count':>7} {'p50_us':>8} {'p95_us':>8} "
                 f"{'top_component':>14} {'share':>6} {'trips':>5}")
    for t in templates:
        lines.append(f"{t['template']:<16.16} {t['count']:>7,} "
                     f"{t['p50_us']:>8,} {t['p95_us']:>8,} "
                     f"{t['top_component']:>14} {t['top_share']:>6.1%} "
                     f"{t['trips']:>5}")
    if not templates:
        lines.append("  (no attributed samples — enable_attribution + "
                     "enable_tracing to populate)")

    def _rate(c):
        return ("-" if c["hit_rate"] is None
                else format(c["hit_rate"], ".1%"))

    shadow_hr = caches["shadow"]["hit_rate"]
    lines.append(
        f"  caches: parse {_rate(caches['parse'])} "
        f"({caches['parse']['total']:,})  plan {_rate(caches['plan'])} "
        f"({caches['plan']['total']:,})  shadow "
        + ("-" if shadow_hr is None else format(shadow_hr, ".1%")
           ) + "  (GET /cache for the full observatory)")
    lines.append("")
    lines.append("LANES")
    for name, v in lanes.items():
        lines.append(f"  {name:<24} {v:,}")
    return "\n".join(lines) + "\n", js


def _lane_depths() -> dict:
    """Lane activity from the registry: current pool queue depth (total
    and per lane), cumulative submissions per lane, and the heavy lane's
    fused-group occupancy (mean members per flush)."""
    snap = get_registry().snapshot()
    out: dict = {}
    g = snap.get("wukong_pool_queue_depth")
    if g and g["series"]:
        out["queue_depth"] = int(g["series"][0].get("value", 0))
    d = snap.get("wukong_pool_lane_depth")
    for s in (d or {}).get("series", []):
        lane = s.get("labels", {}).get("lane", "default") or "default"
        out[f"depth[{lane}]"] = int(s.get("value", 0))
    c = snap.get("wukong_pool_submitted_total")
    for s in (c or {}).get("series", []):
        lane = s.get("labels", {}).get("lane", "default") or "default"
        out[f"submitted[{lane}]"] = int(s.get("value", 0))
    from wukong_tpu_torch.obs.metrics import snapshot_histogram_mean

    occ = snapshot_histogram_mean(snap, "wukong_batch_heavy_occupancy")
    if occ is not None:
        out["heavy_occupancy_mean"] = round(occ, 2)
    return out
