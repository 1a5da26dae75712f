"""Open-loop throughput emulator — `sparql-emu` (reference: proxy.hpp:391-545).

The port's copy of the JAX package's runtime/emulator.py (``MixConfig``,
``load_mix_config`` and ``Emulator.run``). It parses a mix config (N light
templates + M heavy queries with integer weights, console format
``<path> <weight>`` after an "<nlights> <nheavies>" header), fills template
candidates from the store's indexes, then drives an open loop for a
duration, reporting throughput and a per-class latency CDF.

Three execution paths:
- device batches: B = ``device_batch`` instances of one light template in
  one chain (``GPUEngine.execute_batch``); once a class has run a batch,
  windows of W <= 8 batches drawn across the warm light classes by mix
  weight run in one flight with one read (``execute_batch_mixed``);
- heavy (index-origin) classes in replicate batches of
  ``heavy_index_batch``'s B (``execute_batch_index``), then windows of up
  to 4 (``execute_batch_index_many``);
- the host engine pool for everything else, and for a class whose device
  batch failed (logged).

The pool path honours the ``query_deadline_ms`` / ``query_budget_rows``
knobs per instance: queue-expired queries are shed by the pool, mid-query
expiry yields a partial result. Device batches are all-or-nothing
dispatches and carry no per-query deadline.

With tracing on, each device flight runs under a sampled
``batch.dispatch`` trace of kind ``device_batch`` (``_traced_flight``),
recorded by the flight recorder; ``WUKONG_TRACE_CHROME=<path>`` writes every
recorded trace as a Chrome trace at the end of a run.

``Emulator.run_serving`` is the other throughput measure: closed-loop
client threads sending query TEXTS through ``Proxy.serve_query`` (live
traffic, coalesced by the batcher when ``enable_batching`` is on).
``Emulator.run_tenants`` is the multi-tenant scenario: tenant classes with
conflicting SLOs send closed-loop traffic through
``serve_query(text, tenant=...)``, optionally under injected faults
(``chaos``) or at a multiple of their client counts (``overload_x``, the
admission drill). ``Emulator.run_graphrag`` is the GraphRAG mix: pure
graph texts and a knn()-seeded hybrid template over Zipf-popular anchors.
``Emulator.run_readmostly`` is the Zipfian read-mostly drill of the serving
caches: observe-only (the shadow cache's predicted hit rate by write rate),
or with the result cache and views on (every measured reply held against
an uncached one). The JAX emulator's other scenario runners (drills, hot
spots, rebalancing) and its metrics snapshotter wait for the subsystems
they drive.
"""

from __future__ import annotations

import copy
import os
import threading
import time

import numpy as np

from wukong_tpu_torch.config import Global
from wukong_tpu_torch.obs import (
    activate,
    get_recorder,
    maybe_start_trace,
    write_chrome_trace,
)
from wukong_tpu_torch.planner.heuristic import heuristic_plan
from wukong_tpu_torch.runtime.monitor import Monitor
from wukong_tpu_torch.runtime.resilience import Deadline
from wukong_tpu_torch.sparql.parser import Parser
from wukong_tpu_torch.utils.errors import (
    BudgetExceeded,
    ErrorCode,
    QueryTimeout,
    WukongError,
)
from wukong_tpu_torch.utils.logger import log_info, log_warn
from wukong_tpu_torch.utils.timer import get_usec

# a failed device batch degrades its class to the pool only on a
# query-scoped refusal (WukongError, e.g. a start past the capacity ceiling),
# as the JAX emulator degrades on CAPACITY_EXCEEDED. Nothing else is caught:
# a kernel that fails to build or launch, or the card running out of
# memory, fails the run.


def _replies_identical(qa, qb) -> bool:
    """Byte-level reply equality for the cached read-mostly drill: a
    cache-served reply must be indistinguishable from the uncached
    execution — status, row/column counts, the table's bytes, and the
    projection map all compare."""
    ra, rb = qa.result, qb.result
    return (ra.status_code == rb.status_code
            and bool(ra.complete) == bool(rb.complete)
            and int(ra.nrows) == int(rb.nrows)
            and int(ra.col_num) == int(rb.col_num)
            and ra.v2c_map == rb.v2c_map
            and np.array_equal(np.asarray(ra.table), np.asarray(rb.table)))


class MixConfig:
    def __init__(self, templates, heavies, weights):
        self.templates = templates  # list[SPARQLTemplate]
        self.heavies = heavies  # list[str] query texts
        self.weights = np.asarray(weights, dtype=np.float64)


def load_mix_config(path: str, str_server) -> MixConfig:
    """Read a mix file: "<nlights> <nheavies>", then one "<path> <weight>"
    line per class, lights first. Query paths are relative to the mix
    file's directory or its parent (the reference's scripts directory)."""
    base = os.path.dirname(os.path.dirname(path.rstrip("/")))
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    nlights, nheavies = (int(x) for x in lines[0].split())
    entries = []
    for ln in lines[1:1 + nlights + nheavies]:
        parts = ln.split()
        entries.append((parts[0], int(parts[1])))
    templates, heavies, weights = [], [], []
    for i, (qpath, w) in enumerate(entries):
        for root in (os.path.dirname(path), base, ""):
            cand = os.path.join(root, qpath) if root else qpath
            if os.path.exists(cand):
                qpath = cand
                break
        with open(qpath) as f:
            text = f.read()
        if i < nlights:
            templates.append(Parser(str_server).parse_template(text))
        else:
            heavies.append(text)
        weights.append(w)
    return MixConfig(templates, heavies, weights)


class Emulator:
    # consecutive mixed-flight (W > 1 cross-class) failures a class may
    # cause before it is pinned to W = 1: de-warming alone lets a class
    # re-warm through its single-class batch and rejoin the mix, so a
    # persistently failing W-fold footprint would oscillate forever
    MIXED_FAIL_LIMIT = 3

    def __init__(self, proxy):
        self.proxy = proxy
        self.monitor = Monitor()
        # per-run latency counters stay private, but stream epochs live on
        # the proxy monitor: adopt them so the rolling report shows them
        # (a stand-in proxy without a monitor keeps its own)
        if getattr(proxy, "monitor", None) is not None:
            self.monitor.share_observability(proxy.monitor)

    # ------------------------------------------------------------------
    def run(self, mix: MixConfig, duration_s: float = 5.0, warmup_s: float = 1.0,
            batch: int | None = None, seed: int = 0,
            parallel: int | None = None) -> dict:
        """Open loop for ``duration_s`` keeping up to ``parallel`` queries in
        flight across the host engine pool (the reference's ``-p`` cap,
        proxy.hpp:477-525); returns throughput, each class's route
        (``class_mode``) and latency CDF.

        Device-batchable classes run as synchronous batches (the batch
        dimension is the pipeline there): light templates through
        execute_batch, index-origin heavies through execute_batch_index."""
        gpu = self.proxy.gpu
        for tmpl in mix.templates:
            self.proxy.fill_template(tmpl)
        rng = np.random.default_rng(seed)
        probs = mix.weights / mix.weights.sum()
        nclasses = len(mix.templates) + len(mix.heavies)
        use_gpu = gpu is not None and Global.enable_tpu
        B = batch or Global.device_batch
        p_cap = max(parallel or Global.num_engines, 1)
        self._p_cap = p_cap
        pool = self.proxy.engine_pool()

        # pre-plan one query per class (remembering the instantiated
        # placeholder value so _batchable can confirm the plan starts from it)
        planned = []
        for tmpl in mix.templates:
            q = tmpl.instantiate(rng)
            inst_const = getattr(q.pattern_group.patterns[tmpl.pos[0][0]],
                                 tmpl.pos[0][1]) if tmpl.pos else None
            self._plan(q)
            q._inst_const = inst_const
            planned.append(("light", tmpl, q))
        for text in mix.heavies:
            q = Parser(self.proxy.str_server).parse(text)
            self._plan(q)
            planned.append(("heavy", None, q))

        self._planned = planned
        self._probs = probs
        self._mixed_fail: dict[int, int] = {}
        # per-class heavy routing: "device" rides the batch path with the
        # plan cache's slice count, "pool" is the recorded decision after a
        # device failure
        self._heavy_route: dict[int, str] = {}
        self._served = 0

        # run every device-batchable light class once BEFORE the measured
        # window: the first batch learns the class's capacity classes
        t_wall0 = get_usec()
        precompiled = 0
        if use_gpu:
            for kind, tmpl, q0 in planned:
                if kind != "light" or not self._batchable(tmpl, q0):
                    continue
                try:
                    gpu.execute_batch(q0, self._draw_consts(tmpl, rng, B))
                    q0._many_warm = True
                    precompiled += 1
                except WukongError as e:
                    q0._inst_const = None  # pool-only, with correct blame
                    log_info(f"sparql-emu: warm-up degraded a class "
                             f"to the pool ({e!r:.120})")
            if precompiled:
                log_info(f"sparql-emu: warmed {precompiled} device "
                         f"classes in {(get_usec() - t_wall0) / 1e6:.1f}s")
        self.monitor.start_thpt()
        t_end = get_usec() + int((duration_s + warmup_s) * 1e6)
        t_measure = get_usec() + int(warmup_s * 1e6)
        warm = True
        inflight: dict[int, tuple] = {}
        # how each class is measured: device-batch latencies are
        # batch_time/B, not pool round trips — label them
        self.class_mode: dict[int, str] = {}
        errors = shed = 0
        first_error: Exception | None = None
        while get_usec() < t_end or inflight:
            if warm and get_usec() >= t_measure:
                self.monitor.start_thpt()
                warm = False
            submitted = False
            while len(inflight) < p_cap and get_usec() < t_end:
                cls = int(rng.choice(nclasses, p=probs))
                kind, tmpl, q0 = planned[cls]
                if use_gpu and self._device_batch(kind, tmpl, q0, rng, B, cls):
                    self.class_mode[cls] = "device-batch"
                    submitted = True
                    break  # a sync batch ran — let the outer loop poll/print
                if tmpl is not None:
                    q = tmpl.instantiate(rng)
                    self._plan(q)
                else:
                    q = copy.deepcopy(q0)  # heavy classes reuse the plan
                q.result.blind = True
                # per-instance deadline/budget from the resilience knobs; a
                # deadline is wall-clock state that starts at submit time
                q.deadline = Deadline.from_config()
                prev = self.class_mode.get(cls)
                # a class that device-batched earlier and now rides the
                # pool has mixed samples — the label says so
                self.class_mode[cls] = ("pool" if prev in (None, "pool")
                                        else "mixed")
                inflight[pool.submit(q)] = (cls, get_usec())
                submitted = True
            done = pool.poll()
            for qid, out in done:
                info = inflight.pop(qid, None)
                if info is None:  # stale completion from an earlier run
                    continue
                cls, t0 = info
                if isinstance(out, Exception):
                    if isinstance(out, (QueryTimeout, BudgetExceeded)):
                        # deadline/budget load shedding is the resilience
                        # knobs working as intended, not an engine crash
                        shed += 1
                        continue
                    errors += 1
                    first_error = first_error or out
                    continue
                self._served += 1
                self.monitor.add_latency(get_usec() - t0, qtype=cls)
            if not submitted and not done:
                time.sleep(0.0002)  # open loop idle tick
            self.monitor.maybe_print_thpt()

        thpt = self.monitor.thpt()
        if shed:
            log_warn(f"sparql-emu: {shed} queries shed by deadline/budget")
        if errors:
            log_warn(f"sparql-emu: {errors} queries crashed "
                     f"(first: {first_error!r})")
            if thpt == 0:
                raise RuntimeError(
                    f"sparql-emu: every query failed: {first_error!r}")
        # thpt_qps is the steady-state number (measured window only, every
        # device class warmed before it); wall_qps divides every served
        # query by the whole wall, warm-up included
        wall_s = (get_usec() - t_wall0) / 1e6
        wall_qps = self._served / wall_s if wall_s > 0 else 0.0
        log_info(f"sparql-emu: {thpt:,.0f} q/s steady over {duration_s}s "
                 f"(wall {wall_qps:,.0f} q/s incl. "
                 f"{precompiled}-class warm-up; "
                 f"{'GPU batch + ' if use_gpu else ''}pool p={p_cap})")
        self.monitor.print_cdf(labels=self.class_mode)
        chrome = os.environ.get("WUKONG_TRACE_CHROME")
        if chrome:
            # every trace the flight recorder holds (this run's sampled
            # flights), Perfetto-loadable
            log_info("sparql-emu: Chrome trace written to "
                     f"{write_chrome_trace(chrome, get_recorder().last())}")
        return {"thpt_qps": thpt, "wall_qps": round(wall_qps, 1),
                "precompiled_classes": precompiled, "errors": errors,
                "shed": shed, "class_mode": dict(self.class_mode),
                "cdf": {c: self.monitor.cdf(c) for c in range(nclasses)}}

    def run_serving(self, texts: list, duration_s: float = 5.0,
                    warmup_s: float = 0.5, clients: int = 4,
                    seed: int = 0, weights=None, classes=None) -> dict:
        """Serving-path throughput: ``clients`` closed-loop threads each
        send one query TEXT at a time through ``Proxy.serve_query(text,
        blind=True)`` (parse cache -> plan cache -> batcher or direct ->
        engine) and wait for the reply. Batching follows
        ``Global.enable_batching``; the pool is not started here — fused
        groups ride its lanes when the caller started it, else they run on
        the batcher's flusher thread.

        ``weights`` (aligned with ``texts``) draws a weighted mix instead of
        a uniform one; ``classes`` (aligned ints, e.g. 0 light, 1 heavy)
        adds a per-class qps/p50/p99 breakdown (``by_class``). Latencies
        are host-clock microseconds from send to reply; replies that come
        back after the warm-up count."""
        stop = threading.Event()
        served = [0] * clients
        errors = [0] * clients
        lat: list[list] = [[] for _ in range(clients)]
        t_measure = [0.0]
        p = None
        if weights is not None:
            p = np.asarray(weights, dtype=np.float64)
            p = p / p.sum()

        def client(k: int) -> None:
            rng = np.random.default_rng(seed + k)
            while not stop.is_set():
                i = (int(rng.choice(len(texts), p=p)) if p is not None
                     else int(rng.integers(0, len(texts))))
                t0 = get_usec()
                try:
                    q = self.proxy.serve_query(texts[i], blind=True)
                except Exception:  # a client survives a failed request
                    errors[k] += 1
                    continue
                if q.result.status_code != ErrorCode.SUCCESS:
                    errors[k] += 1
                    continue
                if time.monotonic() >= t_measure[0]:
                    served[k] += 1
                    lat[k].append((i, get_usec() - t0))

        threads = [threading.Thread(target=client, args=(k,), daemon=True,
                                    name=f"serve-client-{k}")
                   for k in range(clients)]
        t_measure[0] = time.monotonic() + warmup_s
        for t in threads:
            t.start()
        time.sleep(warmup_s + duration_s)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        stuck = sum(t.is_alive() for t in threads)
        if stuck:
            raise RuntimeError(f"run_serving: {stuck} clients still "
                               "waiting 60 s after the run ended")
        n = sum(served)
        all_lat = sorted(dt for xs in lat for (_i, dt) in xs)
        qps = n / duration_s if duration_s > 0 else 0.0
        p50 = all_lat[len(all_lat) // 2] if all_lat else 0
        p99 = all_lat[int(len(all_lat) * 0.99)] if all_lat else 0
        log_info(f"serve: {qps:,.0f} q/s over {duration_s}s "
                 f"({clients} clients, batching="
                 f"{'on' if Global.enable_batching else 'off'}, "
                 f"p50 {p50:,}us, p99 {p99:,}us, "
                 f"{sum(errors)} errors)")
        out = {"qps": round(qps, 1), "served": n, "errors": sum(errors),
               "clients": clients, "duration_s": duration_s,
               "batching": bool(Global.enable_batching),
               "p50_us": int(p50), "p99_us": int(p99)}
        if classes is not None:
            by_class: dict[int, list] = {}
            for xs in lat:
                for i, dt in xs:
                    by_class.setdefault(int(classes[i]), []).append(dt)
            out["by_class"] = {}
            for c, vals in sorted(by_class.items()):
                vals.sort()
                out["by_class"][c] = {
                    "served": len(vals),
                    "qps": round(len(vals) / duration_s, 1),
                    "p50_us": int(vals[len(vals) // 2]),
                    "p99_us": int(vals[int(len(vals) * 0.99)]),
                }
        return out

    # ------------------------------------------------------------------
    # the multi-tenant SLO scenario
    # ------------------------------------------------------------------
    def run_tenants(self, texts: list, duration_s: float = 3.0,
                    warmup_s: float = 0.3, tenants: list | None = None,
                    chaos: bool = False, chaos_p: float = 0.25,
                    overload_x: float = 1.0, seed: int = 0) -> dict:
        """Tenant classes with conflicting SLOs drive closed-loop clients
        through the real serving entry (``serve_query(text, blind=True,
        tenant=...)``), so per-tenant compliance, remaining error budget
        and burn rates land in the SLO tracker and the rolling report.

        The default cast is three classes: ``gold`` (2 clients; p95 within
        50 ms, three nines — almost no error budget), ``silver`` (2
        clients; p95 within 500 ms, 0.99) and ``bulk`` (4 clients; 0.9, no
        latency target). ``chaos=True`` injects transient failures at the
        ``proxy.serve`` boundary with the same probability ``chaos_p`` for
        every tenant, with tracing forced on at sample 1: only tenants
        whose budget cannot absorb the fault rate trip the burn sentinel,
        each with one dumped trace per cooldown. A class entry may carry
        its own ``texts``; otherwise every class draws from ``texts``.
        ``overload_x`` multiplies every class's client count (the admission
        drill: with ``enable_admission`` on, the per-tenant ``partial`` and
        ``rejected`` counts and the ``admission`` report show the ladder
        shedding lowest weight first). As in the JAX fixture, a client
        whose request is rejected sends its next one at once."""
        from wukong_tpu_torch.obs.slo import (
            SLOSpec,
            get_overload,
            get_slo,
            render_slo,
            reset_labels,
        )
        from wukong_tpu_torch.runtime import faults
        from wukong_tpu_torch.runtime.faults import FaultPlan, FaultSpec

        classes = tenants if tenants is not None else [
            {"tenant": "gold", "clients": 2,
             "slo": SLOSpec("gold", 0.95, 50.0, 0.999)},
            {"tenant": "silver", "clients": 2,
             "slo": SLOSpec("silver", 0.95, 500.0, 0.99)},
            {"tenant": "bulk", "clients": 4,
             "slo": SLOSpec("bulk", 0.95, 0.0, 0.9)},
        ]
        tracker, signals = get_slo(), get_overload()
        tracker.reset()  # the scenario's report starts from a clean slate
        signals.reset()
        reset_labels()
        get_recorder().clear()
        for c in classes:
            if c.get("slo") is not None:
                tracker.register(c["slo"])

        prev_plan = faults.active()
        prev_tracing = (Global.enable_tracing, Global.trace_sample_every)
        if chaos:
            # a burn dump must carry an attributable trace
            Global.enable_tracing = True
            Global.trace_sample_every = 1
            faults.install(FaultPlan(
                [FaultSpec("proxy.serve", "transient", p=chaos_p)],
                seed=seed))

        stop = threading.Event()
        t_measure = [time.monotonic() + warmup_s]
        stats = [{"served": 0, "errors": 0, "partial": 0, "rejected": 0,
                  "lat": []} for _ in classes]

        def client(ti: int, k: int) -> None:
            c = classes[ti]
            pool = c.get("texts") or texts
            name = c["tenant"]
            rng = np.random.default_rng(seed * 1009 + ti * 31 + k)
            while not stop.is_set():
                text = pool[int(rng.integers(0, len(pool)))]
                t0 = get_usec()
                partial = rejected = False
                try:
                    q = self.proxy.serve_query(text, blind=True,
                                               tenant=name)
                    ok = q.result.status_code == ErrorCode.SUCCESS
                    # the ladder's rung 2: a truncated reply
                    # (mark_partial) counts as neither served nor error
                    partial = not q.result.complete
                except WukongError as e:
                    ok = False
                    rejected = e.code == ErrorCode.CAPACITY_EXCEEDED
                except Exception:
                    ok = False
                dt = get_usec() - t0
                if time.monotonic() >= t_measure[0]:
                    st = stats[ti]
                    if rejected:
                        st["rejected"] += 1
                    elif partial:
                        st["partial"] += 1
                    elif ok:
                        st["served"] += 1
                        st["lat"].append(dt)
                    else:
                        st["errors"] += 1
                    self.monitor.add_latency(dt, qtype=ti)

        nclients = {c["tenant"]: max(int(round(
            int(c.get("clients", 1)) * max(float(overload_x), 0.1))), 1)
            for c in classes}
        threads = [threading.Thread(target=client, args=(ti, k),
                                    daemon=True,
                                    name=f"tenant-{c['tenant']}-{k}")
                   for ti, c in enumerate(classes)
                   for k in range(nclients[c["tenant"]])]
        try:
            for t in threads:
                t.start()
            t_end = time.monotonic() + warmup_s + duration_s
            started = False
            while time.monotonic() < t_end:
                if not started and time.monotonic() >= t_measure[0]:
                    self.monitor.start_thpt()
                    started = True
                self.monitor.maybe_print_thpt()
                time.sleep(0.05)
            stop.set()
            for t in threads:
                t.join(timeout=60)
        finally:
            stop.set()
            faults.install(prev_plan)
            Global.enable_tracing, Global.trace_sample_every = prev_tracing
        stuck = sum(t.is_alive() for t in threads)
        if stuck:
            raise RuntimeError(f"run_tenants: {stuck} clients still "
                               "waiting 60 s after the run ended")

        out_tenants: dict = {}
        total = 0
        for ti, c in enumerate(classes):
            name = c["tenant"]
            st = stats[ti]
            lat = sorted(st["lat"])
            total += st["served"]
            out_tenants[name] = {
                "clients": nclients[name],
                "served": st["served"],
                "errors": st["errors"],
                "partial": st["partial"],
                "rejected": st["rejected"],
                "qps": round(st["served"] / duration_s, 1),
                "p50_us": int(lat[len(lat) // 2]) if lat else 0,
                "p99_us": int(lat[int(len(lat) * 0.99)]) if lat else 0,
                "slo": tracker.compliance(name),
            }
        burn_dumps = [(r, tr) for (r, tr) in list(get_recorder().dumps)
                      if r == "SLO_BURN"]
        out = {
            "duration_s": duration_s,
            "chaos": bool(chaos),
            "chaos_p": chaos_p if chaos else 0.0,
            "overload_x": float(overload_x),
            "qps": round(total / duration_s, 1),
            "tenant_qps": round(total / duration_s, 1),
            "tenants": out_tenants,
            "alerts": {n: (d["slo"] or {}).get("alerts", 0)
                       for n, d in out_tenants.items()},
            "burn_dumps": [{"tenant": tr.tenant, "trace": tr.trace_id}
                           for (_r, tr) in burn_dumps],
            "slo_report": tracker.report(),
            "signals": signals.report(),
        }
        if Global.enable_admission:
            from wukong_tpu_torch.runtime.admission import get_admission

            out["admission"] = get_admission().report()
        for line in self.monitor.slo_lines(k=len(classes)):
            log_info(line)
        log_info(f"run_tenants: {out['qps']:,.0f} q/s over {duration_s}s"
                 f" ({len(classes)} classes, chaos={chaos}); alerts "
                 + " ".join(f"{n}:{a}" for n, a in out["alerts"].items()))
        if chaos and not burn_dumps:
            log_warn("run_tenants: chaos ran but no burn dump landed "
                     "(thresholds/budgets absorb the fault rate?)")
        _text, js = render_slo()
        out["slo_json"] = js
        return out

    def _plan(self, q) -> None:
        """The proxy's planner when enabled, else the greedy heuristic."""
        if self.proxy.planner is not None and Global.enable_planner:
            if self.proxy.planner.generate_plan(q):
                return
        heuristic_plan(q)

    @staticmethod
    def _traced_flight(fn, **attrs):
        """One device flight under a sampled ``batch.dispatch`` span (its
        attributes host scalars: the drawn classes as one str); the
        untraced path is one knob check + ``fn()``."""
        ftr = maybe_start_trace(kind="device_batch")
        if ftr is None:
            return fn()
        with activate(ftr):
            sp = ftr.start_span("batch.dispatch", **attrs)
            try:
                out = fn()
            except Exception:
                ftr.end_span(sp, status="ERROR")
                get_recorder().on_complete(ftr, "ERROR")
                raise
            ftr.end_span(sp)
        get_recorder().on_complete(ftr, ErrorCode.SUCCESS)
        return out

    def _device_batch(self, kind, tmpl, q0, rng, B: int, cls: int) -> bool:
        """Try the synchronous batch path; True when it ran."""
        gpu = self.proxy.gpu
        if kind == "light" and self._batchable(tmpl, q0):
            # once the class's first batch has learned its capacities, ride
            # the in-flight window: W batches in one flight, drawn from all
            # warm batchable light classes by mix weight, so one read serves
            # the mix (the device path's honouring of the -p cap)
            W = 1
            if getattr(q0, "_many_warm", False) and self._p_cap > 1 \
                    and self._mixed_fail.get(cls, 0) < self.MIXED_FAIL_LIMIT:
                W = min(self._p_cap, 8)  # bound live batch tables
            t0 = get_usec()
            if W > 1:
                pool_cls = [c for c, (k2, t2, p2) in
                            enumerate(self._planned)
                            if k2 == "light"
                            and getattr(p2, "_many_warm", False)
                            and self._batchable(t2, p2)
                            and gpu.merge.supports(p2)
                            and self._mixed_fail.get(c, 0)
                            < self.MIXED_FAIL_LIMIT]
                if cls not in pool_cls:
                    pool_cls = [cls]
                w = self._probs[pool_cls] / self._probs[pool_cls].sum()
                draws = [int(c) for c in rng.choice(pool_cls, size=W, p=w)]
                if cls not in draws:
                    draws[0] = cls  # the chosen class always rides
                jobs = [(self._planned[c][2],
                         self._draw_consts(self._planned[c][1], rng, B))
                        for c in draws]
                try:
                    self._traced_flight(
                        lambda: gpu.execute_batch_mixed(jobs),
                        mode="mixed", W=W, B=B,
                        classes=",".join(map(str, sorted(set(draws)))))
                except WukongError:
                    # the failure could come from any drawn class's chain:
                    # de-warm them all (each re-warms through its own
                    # single-class batch, where a bad class fails alone),
                    # and count the failure against every participant
                    for c in set(draws):
                        self._mixed_fail[c] = self._mixed_fail.get(c, 0) + 1
                        self._planned[c][2]._many_warm = False
                    return False
                for c in set(draws):
                    self._mixed_fail[c] = 0
                dt_q = (get_usec() - t0) / (B * W)
                self._served += B * W
                for c in set(draws):
                    self.monitor.add_latency(
                        dt_q, qtype=c, count=B * draws.count(c))
                    self.class_mode[c] = "device-batch"
                return True
            try:
                self._traced_flight(
                    lambda: gpu.execute_batch(
                        q0, self._draw_consts(tmpl, rng, B)),
                    mode="const", W=1, B=B, classes=str(cls))
                q0._many_warm = True
                if self._mixed_fail.get(cls, 0) >= self.MIXED_FAIL_LIMIT:
                    # parole after a clean single-class batch: one credit,
                    # so an innocent class co-drawn with a culprit rejoins
                    # the mix, while a true culprit re-pins after one more
                    # failure
                    self._mixed_fail[cls] = self.MIXED_FAIL_LIMIT - 1
            except WukongError as e:
                q0._inst_const = None  # disables _batchable next rounds
                log_warn(f"sparql-emu: class {cls} degraded to the pool "
                         f"({e!r:.120})")
                return False
            self._served += B
            self.monitor.add_latency((get_usec() - t0) / B, qtype=cls,
                                     count=B)
            return True
        if kind == "heavy" and q0.start_from_index() \
                and self._heavy_route.get(cls, "device") == "device":
            bh = self.proxy.heavy_index_batch(q0)
            W = 1
            if getattr(q0, "_many_warm", False) and self._p_cap > 1:
                W = min(self._p_cap, 4)  # heavy tables are large
            t0 = get_usec()
            try:
                if W > 1:
                    self._traced_flight(
                        lambda: gpu.execute_batch_index_many(q0, bh, W),
                        mode="index", W=W, B=bh, classes=str(cls))
                else:
                    self._traced_flight(
                        lambda: gpu.execute_batch_index(q0, bh),
                        mode="index", W=1, B=bh, classes=str(cls))
                    q0._many_warm = True
            except WukongError as e:
                # this class rides the pool from now on
                self._heavy_route[cls] = "pool"
                log_warn(f"sparql-emu: heavy class {cls} routed to the pool "
                         f"({e!r:.120})")
                return False
            self._served += bh * W
            self.monitor.add_latency((get_usec() - t0) / (bh * W), qtype=cls,
                                     count=bh * W)
            return True
        return False

    # ------------------------------------------------------------------
    @staticmethod
    def _batchable(tmpl, q_planned) -> bool:
        """One %placeholder, and the plan's start constant IS that
        placeholder (otherwise batching would substitute candidates into
        the wrong slot)."""
        if tmpl is None or len(tmpl.pos) != 1:
            return False
        pats = q_planned.pattern_group.patterns
        return (bool(pats) and pats[0].subject > 0 and pats[0].predicate > 0
                and pats[0].subject == getattr(q_planned, "_inst_const", None))

    def run_readmostly(self, texts: list, reads: int = 600,
                       warmup_reads: int = 200,
                       write_rates=(0.0, 0.02, 0.08),
                       zipf_a: float = 1.1, seed: int = 0,
                       write_batch=None, batch_rows: int = 48,
                       tenants: list | None = None,
                       cached: bool = False, views: bool = False) -> dict:
        """The Zipfian read-mostly closed loop: template+const reads drawn
        Zipf(``zipf_a``) over ``texts`` through the REAL serving entry
        (``serve_query``), replayed once per ``write_rates`` phase with
        that many writes interleaved per read (0.02 = one dynamic insert
        batch per 50 reads). Every reply charges the serving-cache
        observatory, so each phase's shadow-cache hit rate is what a
        version-keyed result cache (key = plan signature + consts + store
        version) would have achieved under that write pressure.

        Three proofs ride along (the ``run_hotspot`` posture):

        - the zero-write phase's hit rate is ``predicted_hit_rate`` (the
          headline; the skewed mix must clear the cache's economic bar),
        - the store content digest is bit-identical across that phase —
          the ledger + shadow simulation read everything and touch
          nothing,
        - hit rate degrades monotonically as the write rate rises (every
          insert bumps the version the keys carry; ``degrades`` is the
          ordered-phase check), with the write-side ``cache.invalidate``
          events on the same timeline as the reads.

        ``write_batch`` is an [N,3] triple pool writes sample from
        (``batch_rows`` rows per insert, appended non-dedup so every
        batch is a real version edge); phases with a positive write rate
        require it. ``tenants`` rotates reply attribution across the
        given tenant names (default single-tenant).

        ``cached=True`` flips the drill from observe-only to the
        ACTUATOR (wukong_tpu/serve/): the real result cache fronts every
        serve, and every reply is compared byte-for-byte against an
        uncached oracle execution of the same text (status, rows,
        columns, table bytes, projection map) — one mismatch fails the
        ``identical`` verdict. Write phases verify inline, each reply
        against the store state it saw; pure-read phases verify in a
        sweep AFTER the timed window (one oracle per distinct text
        served — re-serving returns the same resident entry, so the
        comparison witnesses exactly the measured bytes without the
        oracle's executions polluting the throughput number).
        ``views=True`` additionally arms rung ii, so hot templates
        promote to materialized views and their hit rates survive the
        write phases. Cached q/s is measured over the cached serves
        alone; ``uncached_qps`` reports the oracle's rate for the
        in-run speedup.
        """
        from wukong_tpu_torch.obs.reuse import get_reuse, reuse_trend
        from wukong_tpu_torch.obs.tsdb import get_tsdb
        from wukong_tpu_torch.store.dynamic import insert_batch_into
        from wukong_tpu_torch.store.persist import gstore_digest

        if any(w > 0 for w in write_rates) and write_batch is None:
            raise WukongError(ErrorCode.SYNTAX_ERROR,
                              "write_rates > 0 need a write_batch pool")
        obs = get_reuse()
        obs.reset()
        tsdb = get_tsdb()
        tsdb.reset()
        tsdb.sample_once()  # trend-window start marker
        rng = np.random.default_rng(seed)
        n = len(texts)
        w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), zipf_a)
        w /= w.sum()
        tens = tenants or ["default"]
        g = self.proxy.g

        rc = vr = None
        knobs0 = (Global.enable_result_cache, Global.enable_views)
        if cached:
            from wukong_tpu_torch.serve import get_serve

            plane = get_serve()
            plane.reset()
            plane.attach(g, self.proxy.str_server,
                         device=self.proxy._device)
            Global.enable_result_cache = True
            Global.enable_views = bool(views)
            rc = plane.cache
            vr = plane.views
        cached_us = [0]
        oracle_us = [0]
        oracle_n = [0]
        mismatches = [0]
        deferred: list = []  # zero-write phases: texts to verify after

        def serve_one(k: int, measured: bool = True,
                      verify_inline: bool = True) -> bool:
            text = texts[int(rng.choice(n, p=w))]
            try:
                t0 = get_usec()
                q = self.proxy.serve_query(text, blind=True,
                                           tenant=tens[k % len(tens)])
                cached_us[0] += get_usec() - t0
                ok = q.result.status_code == ErrorCode.SUCCESS
            except Exception:
                return False
            if cached and measured:
                if verify_inline:
                    t1 = get_usec()
                    oq = self._readmostly_oracle(text)
                    oracle_us[0] += get_usec() - t1
                    oracle_n[0] += 1
                    if not _replies_identical(q, oq):
                        mismatches[0] += 1
                else:
                    deferred.append(text)
            return ok

        def verify_deferred() -> None:
            """Zero-write phases: verify AFTER the timed window, once
            per distinct (text, version) served — re-serving returns the
            same resident entry the measured pass handed out, so the
            oracle comparison witnesses exactly the measured bytes
            without polluting the throughput measurement."""
            for text in dict.fromkeys(deferred):
                try:
                    q = self.proxy.serve_query(text, blind=True,
                                               tenant=tens[0])
                    t1 = get_usec()
                    oq = self._readmostly_oracle(text)
                    oracle_us[0] += get_usec() - t1
                    oracle_n[0] += 1
                    if not _replies_identical(q, oq):
                        mismatches[0] += 1
                except Exception:
                    mismatches[0] += 1
            deferred.clear()

        try:
            phases = []
            store_untouched = None
            for write_rate in write_rates:
                every = (int(round(1.0 / write_rate))
                         if write_rate > 0 else 0)
                if write_rate == 0 and store_untouched is None:
                    # the observe-only proof brackets THIS phase (warmup
                    # + measurement are both pure reads), wherever it
                    # sits in the write_rates ordering
                    digest0 = gstore_digest(g)
                    version0 = int(getattr(g, "version", 0))
                # warm the shadow population for THIS phase's steady
                # state (uncounted — the hit rate models a long-running
                # cache, not its cold start)
                for k in range(warmup_reads):
                    serve_one(k, measured=False)
                s0 = obs.shadow.stats()
                r0 = rc.stats() if rc is not None else None
                c0, o0 = cached_us[0], oracle_us[0]
                on0 = oracle_n[0]
                served = errors = writes = 0
                t0 = get_usec()
                for k in range(reads):
                    # write phases verify inline (each reply against the
                    # store state IT saw); pure-read phases defer the
                    # sweep past the timed window — the oracle's own
                    # executions must not pollute the throughput number
                    if serve_one(k, verify_inline=every > 0):
                        served += 1
                    else:
                        errors += 1
                    if every and (k + 1) % every == 0:
                        rows = write_batch[rng.integers(
                            0, len(write_batch), batch_rows)]
                        insert_batch_into(self.proxy._insert_targets(),
                                          rows, dedup=False)
                        writes += 1
                dur_s = max((get_usec() - t0) / 1e6, 1e-9)
                s1 = obs.shadow.stats()
                probes = (s1["hits"] + s1["misses"]
                          - s0["hits"] - s0["misses"])
                hits = s1["hits"] - s0["hits"]
                phase = {
                    "write_rate": float(write_rate),
                    "reads": reads, "served": served, "errors": errors,
                    "writes": writes,
                    "qps": round(reads / dur_s, 1),
                    "probes": probes, "hits": hits,
                    "hit_rate": (round(hits / probes, 4)
                                 if probes else None),
                    "keys_killed": s1["killed"] - s0["killed"],
                }
                if rc is not None:
                    r1 = rc.stats()
                    rp = (r1["hits"] + r1["misses"]
                          - r0["hits"] - r0["misses"])
                    rh = r1["hits"] - r0["hits"]
                    cs = max((cached_us[0] - c0) / 1e6, 1e-9)
                    phase.update({
                        "real_probes": rp, "real_hits": rh,
                        "real_hit_rate": (round(rh / rp, 4)
                                          if rp else None),
                        "real_killed": r1["killed"] - r0["killed"],
                        "cached_qps": round(reads / cs, 1),
                    })
                    verify_deferred()  # outside the throughput window
                    on = oracle_n[0] - on0
                    os_ = max((oracle_us[0] - o0) / 1e6, 1e-9)
                    phase["uncached_qps"] = (round(on / os_, 1)
                                             if on else None)
                phases.append(phase)
                if write_rate == 0 and store_untouched is None:
                    # the observe-only proof: a full read phase (ledger +
                    # shadow probes — and, cached, real fills — on every
                    # reply) left the store bit-identical
                    store_untouched = (
                        gstore_digest(g) == digest0
                        and int(getattr(g, "version", 0)) == version0)
        finally:
            Global.enable_result_cache, Global.enable_views = knobs0
        tsdb.sample_once()  # trend-window end marker
        # monotone degradation within a small jitter tolerance: compared
        # in WRITE-RATE order (not tuple order — a caller may interleave
        # phases), more write pressure must never serve a better hit rate
        rates = [p["hit_rate"]
                 for p in sorted(phases, key=lambda p: p["write_rate"])
                 if p["hit_rate"] is not None]
        degrades = all(b <= a + 0.05 for a, b in zip(rates, rates[1:]))
        predicted = next((p["hit_rate"] for p in phases
                          if p["write_rate"] == 0), None)
        rep = obs.report(k=8)
        out = {
            "predicted_hit_rate": predicted,
            "phases": phases,
            "degrades": bool(degrades),
            "store_untouched": bool(store_untouched)
            if store_untouched is not None else None,
            "zipf_alpha": rep["popularity"]["zipf_alpha"],
            "bytes_saved": rep["shadow"]["bytes_saved"],
            "uncacheable_by_reason": rep["uncacheable_by_reason"],
            "trend": reuse_trend(),
            "report": rep,
        }
        if rc is not None:
            # the actuator verdicts: real-vs-shadow parity on the
            # zero-write phase, byte-identity against the oracle on
            # EVERY measured reply, the in-run speedup, and (views) the
            # flat-curve check — rung ii's whole point
            zero = next((p for p in phases if p["write_rate"] == 0), None)
            real_zero = zero.get("real_hit_rate") if zero else None
            by_rate = sorted((p for p in phases
                              if p.get("real_hit_rate") is not None),
                             key=lambda p: p["write_rate"])
            flat_pts = None
            if (real_zero is not None and by_rate
                    and by_rate[-1]["write_rate"] > 0):
                flat_pts = round(
                    (real_zero - by_rate[-1]["real_hit_rate"]) * 100, 1)
            from wukong_tpu_torch.serve.result_cache import divergence_total

            out["real"] = {
                "identical": mismatches[0] == 0,
                "mismatches": mismatches[0],
                "hit_rate": real_zero,
                "shadow_predicted": predicted,
                "beats_shadow": (real_zero is not None
                                 and predicted is not None
                                 and real_zero >= predicted - 1e-9),
                "readmostly_qps": zero.get("cached_qps") if zero else None,
                "uncached_qps": zero.get("uncached_qps") if zero else None,
                "speedup_vs_uncached": (
                    round(zero["cached_qps"] / zero["uncached_qps"], 2)
                    if zero and zero.get("uncached_qps") else None),
                "hit_rate_drop_pts": flat_pts,
                "views_enabled": bool(views),
                "divergence": divergence_total(),
                "cache": rc.stats(),
                "views": vr.stats() if vr is not None else None,
            }
        log_info(
            "readmostly: predicted hit rate "
            + ("-" if predicted is None else f"{predicted:.1%}")
            + f" on Zipf({zipf_a}) x{n} templates; phases "
            + " ".join(f"w={p['write_rate']:g}:"
                       + ("-" if p["hit_rate"] is None
                          else f"{p['hit_rate']:.0%}")
                       + ("" if p.get("real_hit_rate") is None
                          else f"/real:{p['real_hit_rate']:.0%}")
                       for p in phases)
            + f"; degrades={degrades}, store untouched={store_untouched}"
            + (f"; cached identical={out['real']['identical']} "
               f"qps={out['real']['readmostly_qps']} "
               f"(x{out['real']['speedup_vs_uncached']}), "
               f"drop={out['real']['hit_rate_drop_pts']}pts"
               if rc is not None else ""))
        return out

    def _readmostly_oracle(self, text: str):
        """Uncached oracle execution for the cached drill's byte-identity
        proof: the same parse/plan/execute path ``serve_query`` takes,
        minus the admission/SLO/reuse reply hooks (they would double-
        charge the observatory) and minus the result cache."""
        q = self.proxy._parse_text(text)
        self.proxy._plan_prepared(q, True, None, tenant="oracle")
        eng = self.proxy._engine_for(None)
        eng.execute(q)
        return q

    def run_graphrag(self, graph_texts: list, hybrid_template: str,
                     anchors: list, duration_s: float = 3.0,
                     warmup_s: float = 0.5, clients: int = 4,
                     seed: int = 0, zipf_a: float = 1.2,
                     hybrid_frac: float = 0.5) -> dict:
        """GraphRAG mixed-workload drive: closed-loop clients submit a
        blend of pure graph queries and hybrid graph+vector queries
        through the live serving path. Each hybrid query instantiates
        ``hybrid_template`` (``{anchor}`` placeholder) with a Zipfian-
        popular anchor — the retrieval-augmented access pattern, where a
        few hot entities anchor most similarity lookups, so the result
        cache and knn route memos see realistic skew instead of uniform
        mush. Returns overall + per-kind q/s and latency percentiles
        (`bench.py --graphrag`'s hybrid_qps headline)."""
        import threading

        stop = threading.Event()
        served: list[list] = [[] for _ in range(clients)]  # (kind, dt)
        errors = [0] * clients
        t_measure = [0.0]
        # Zipf anchor popularity: rank r drawn with p ∝ 1/r^a, capped to
        # the anchor list (np.random zipf is unbounded — resample by mod)
        ranks = np.arange(1, len(anchors) + 1, dtype=np.float64)
        pz = ranks ** -float(zipf_a)
        pz /= pz.sum()

        def client(k: int) -> None:
            rng = np.random.default_rng(seed + k)
            while not stop.is_set():
                hybrid = bool(rng.random() < hybrid_frac)
                if hybrid:
                    a = anchors[int(rng.choice(len(anchors), p=pz))]
                    # plain token replace — SPARQL's own braces would
                    # trip str.format's field parser
                    text = hybrid_template.replace("{anchor}", a)
                else:
                    text = graph_texts[int(rng.integers(0,
                                                        len(graph_texts)))]
                t0 = get_usec()
                try:
                    q = self.proxy.serve_query(text, blind=True)
                    if q.result.status_code != ErrorCode.SUCCESS:
                        errors[k] += 1
                        continue
                except Exception:
                    errors[k] += 1
                    continue
                if time.monotonic() >= t_measure[0]:
                    served[k].append((hybrid, get_usec() - t0))

        threads = [threading.Thread(target=client, args=(k,), daemon=True,
                                    name=f"graphrag-client-{k}")
                   for k in range(clients)]
        t_measure[0] = time.monotonic() + warmup_s
        for t in threads:
            t.start()
        time.sleep(warmup_s + duration_s)
        stop.set()
        for t in threads:
            t.join(timeout=10)

        def _pct(vals: list) -> dict:
            vals = sorted(vals)
            return {"served": len(vals),
                    "qps": round(len(vals) / duration_s, 1)
                    if duration_s > 0 else 0.0,
                    "p50_us": int(vals[len(vals) // 2]) if vals else 0,
                    "p99_us": int(vals[int(len(vals) * 0.99)])
                    if vals else 0}

        flat = [x for xs in served for x in xs]
        hybrid_lat = [dt for h, dt in flat if h]
        graph_lat = [dt for h, dt in flat if not h]
        out = {"qps": round(len(flat) / duration_s, 1)
               if duration_s > 0 else 0.0,
               "served": len(flat), "errors": sum(errors),
               "clients": clients, "duration_s": duration_s,
               "zipf_a": zipf_a, "hybrid_frac": hybrid_frac,
               "anchors": len(anchors),
               "hybrid": _pct(hybrid_lat), "graph": _pct(graph_lat)}
        log_info(f"graphrag: {out['qps']:,.0f} q/s mixed "
                 f"(hybrid {out['hybrid']['qps']:,.0f} q/s "
                 f"p99 {out['hybrid']['p99_us']:,}us, graph "
                 f"{out['graph']['qps']:,.0f} q/s, "
                 f"{sum(errors)} errors)")
        return out

    @staticmethod
    def _draw_consts(tmpl, rng, B: int) -> np.ndarray:
        cand = tmpl.candidates[0]
        return np.asarray(cand[rng.integers(0, len(cand), B)], dtype=np.int64)
