"""Proxy: the client-facing frontend (reference: core/proxy.hpp).

The port's copy of the JAX package's runtime/proxy.py on one partition. It
glues parser -> planner -> engine:

- ``run_single_query``: parse (cached), plan (cached, or a user plan),
  execute with repeats, log the average latency, print rows — the console's
  ``sparql`` verb (proxy.hpp:298-385);
- ``serve_query``: the same path without repeats or printing, for callers
  in Python (live traffic: ``Emulator.run_serving``'s clients);
- one execution loop for both, ``_run_repeats``: each run goes through
  ``_serve_execute`` — with ``Global.enable_batching`` the batcher
  (runtime/batcher.py) coalesces concurrent same-template queries into
  fused dispatches, else (and for every bypass) the engine runs the query
  alone; a reply of CAPACITY_EXCEEDED (a device capacity ceiling, not a
  property of the query) is answered again by the host ``CPUEngine``,
  which has no capacity classes, and logged; a deadline or budget expiry
  ends the repeats;
- ``classify_lane``: the plan-time light/heavy routing the batcher reads;
- ``engine_pool``: N host engines with work stealing (runtime/scheduler.py)
  for the emulator's pool path and the batcher's lanes; ``fill_template``
  and ``heavy_index_batch`` feed the engine's batched entry points
  (``sparql-emu``, runtime/emulator.py, and the heavy lane).

Plans come from the cost-based planner when the proxy has one
(``Global.enable_planner``), else from a user plan's text, else from the
greedy heuristic, in the JAX proxy's order.

Multi-tenant serving, as in the JAX proxy: both entry points take a
``tenant``. A query's trace starts at receipt (sampled by the tracing
knobs; ``proxy.parse`` and ``proxy.plan`` spans, then activated around the
execution), ``_admit`` bounds the tenant label and notes the arrival on the
overload bus, ``_consult_admission`` asks the admission controller
(runtime/admission.py; rung 1 sleeps here, rung 2 stamps a tighter
deadline and row budget on the prepared query, rung 3 raises
CAPACITY_EXCEEDED before any engine runs), and every exit, the error path
included, counts ``wukong_queries_total{status,tenant}``, hands the trace to
the flight recorder, and folds the reply into the tenant's SLO window
(``_observe_slo``, where the burn sentinel fires). With ``xprof_dir`` set,
``run_single_query``'s execution runs inside a torch.profiler capture
(obs/export.py). ``explain_query`` is EXPLAIN / EXPLAIN ANALYZE
(obs/profile.py).

Execution strategies, as in the JAX proxy: at plan time
``classify_join_strategy`` routes a query ``walk`` or ``wcoj`` (the
worst-case-optimal join, join/wcoj.py), ``classify_join_route`` picks a
wcoj query's level route (host kernels or the device level probe), and
``classify_template_route`` picks a walk query's compiled-template route
(engine/template_compile.py: the whole plan as one device program). Each
decision is memoized per template signature and store version in the plan
cache, and measured feedback after an execution may demote it
(``_record_wcoj_feedback``, ``_record_route_feedback``,
``_record_template_feedback``). ``_serve_execute`` runs a ``wcoj`` query on
the tensor join and a template-routed one on its compiled program first;
either degrades to the walk below on the causes the JAX proxy names (a
structured WukongError, an int32 range refusal, a template overflow or
unsupported shape, an injected fault), counted under the JAX metric labels.
Unlike the JAX proxy, it does not catch any other exception there: an
error from building or launching a CUDA kernel, or a CUDA runtime error,
reaches the caller of ``serve_query`` instead of being answered by the walk.

Data in and durability, as in the JAX proxy on one partition:
``dynamic_load_data`` (the console's ``load -d <dir> [-c]``; an ``hdfs://``
directory is staged locally first) inserts through store/dynamic.py, whose
version bump makes the device store, the WCOJ table cache and the template
programs restage on their next use, and clears the plan cache;
``recovery()`` is the checkpoint/recovery manager (runtime/recovery.py)
behind ``checkpoint`` and ``recover``; ``gstore_check`` is ``gsck``.

The hybrid graph+vector plane, as in the JAX proxy: a query with a knn()
clause is refused (ATTR_DISABLE) while ``enable_vectors`` is off; else
``_prepare_knn`` stamps its composition mode and scan route (host or
device, memoized per template and store version, demoted by the measured
feedback of the drill), and a wide scan-side scan goes down the heavy lane,
sliced across the engine pool (``_maybe_presolve_knn``). knn queries walk:
no tensor join, no compiled template, no coalescing.

The serving caches and streams, as in the JAX proxy: the constructor
binds the serving plane (serve/: the result cache and the views) to this
proxy's partition and starts the metrics time-series sampler; with
``enable_result_cache`` on, ``_serve_execute`` is fronted by the cache's
lease (a hit installs the cached reply, a miss may make this thread the
key's collapsing leader, which fills the cache when it settles), and
``serve_query`` first tries the zero-parse fast path
(``_serve_fast_hit``), which answers a repeated text from its resident
entry without parsing or planning. A hit's table is host NumPy, so it
launches no kernel and makes no device sync. Every reply, the fast path's
included, folds into the reuse observatory (``_observe_reuse``) against
its plan-time store version (``q._rver``). The stream verbs
(``stream_register``, ``stream_unregister``, ``stream_poll``,
``stream_prune``, ``stream_feed``) drive a ``StreamContext`` over the
partition (``stream_context``; the epoch frontier runs on the proxy's
device), and ``recovery()`` checkpoints its registry.

The distributed engine, as in the JAX proxy: ``dist_engine`` (a
``parallel.DistEngine`` over the same world's partitions) serves
``device="dist"`` (the console's ``-d dist``); a shape it refuses up
front (UNSUPPORTED_SHAPE) runs again on the host engine. Its sharded store
is attached to the migration actuator (runtime/migration.py), the placement
advisor and ``/healthz`` (a ``shards`` probe, through a weakref), its
per-shard breaker to the monitor; ``load -d``, stream epochs and restores
reach every shard (and replica), and drop the engine's learned chain
capacities. With ``replication_factor`` > 1 the recovery manager's heal
watcher starts with the proxy: a primary served by its replica is rebuilt
and promoted on the engine pool's ``rebuild`` lane. ``wcoj_dist()`` is the
distributed join over the shards.
"""

from __future__ import annotations

import pickle
import time

import numpy as np

from wukong_tpu_torch.analysis.lockdep import declare_leaf, make_lock
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.engine.cpu import CPUEngine
from wukong_tpu_torch.engine.tpu import GPUEngine
from wukong_tpu_torch.obs import (
    activate,
    get_recorder,
    get_registry,
    maybe_device_trace,
    maybe_start_trace,
)
from wukong_tpu_torch.obs.device import note_feedback
from wukong_tpu_torch.obs.reuse import maybe_observe_reuse
from wukong_tpu_torch.obs.slo import get_overload, get_slo, tenant_label
from wukong_tpu_torch.planner.heuristic import heuristic_plan
from wukong_tpu_torch.planner.plan_file import set_plan
from wukong_tpu_torch.runtime import faults
from wukong_tpu_torch.runtime.admission import maybe_admission
from wukong_tpu_torch.runtime.batcher import (
    _M_PARSE_CACHE,
    PlanCache,
    QueryBatcher,
    snapshot_patterns,
    template_signature,
)
from wukong_tpu_torch.runtime.monitor import Monitor
from wukong_tpu_torch.runtime.resilience import Deadline
from wukong_tpu_torch.sparql.ir import SPARQLQuery, SPARQLTemplate
from wukong_tpu_torch.sparql.parser import Parser
from wukong_tpu_torch.types import IN, OUT, is_tpid
from wukong_tpu_torch.join.kernels import DeviceRangeError
from wukong_tpu_torch.utils.device import resolve_device
from wukong_tpu_torch.utils.errors import ErrorCode, WukongError
from wukong_tpu_torch.utils.logger import log_error, log_info
from wukong_tpu_torch.utils.lru import LRUCache
from wukong_tpu_torch.utils.timer import get_usec

# ceiling on how long a serving thread waits for a coalesced dispatch to
# settle — a wedged batcher surfaces as an error, never as a hung client
BATCH_WAIT_TIMEOUT_S = 600.0

# a rung-3 rejection holds its caller, with the GIL released, after its
# reply-side accounting (a held caller holds no in-flight slot) and before
# it raises: at least REJECT_YIELD_S, and until its tenant's next
# rejection slot, REJECT_SPACING_S after the one before, but never past
# the retry-after that the reply names. A caller that retries rejections
# at once (a closed-loop client in this process) would otherwise keep
# threads runnable on the GIL, and each hand-off on an admitted query's
# path (the batcher's flusher, a pool thread, the wake after the chain's
# sync) waits behind them; a cheaper rejection only makes the loop spin
# faster. A fixed hold lets the loop's cost grow with the rejected
# tenant's clients: in the overload drill of bench.py --tenants (8 bulk
# clients) a 5 ms hold cost the admitted tenants about half of their rate
# on an H100 host and gold its SLO on the slower ones. Spacing bounds a
# tenant's rejections to 1 / REJECT_SPACING_S a second however many
# clients it has. A deviation: the JAX proxy raises at once.
REJECT_YIELD_S = 5e-3
REJECT_SPACING_S = 2e-2
# the pacing lock guards one dict and calls nothing while held
declare_leaf("proxy.reject_pace")


class _Rejected(WukongError):
    """A rung-3 admission rejection (CAPACITY_EXCEEDED) and how long its
    caller is held before it is raised to them."""

    def __init__(self, detail: str, hold_s: float):
        super().__init__(ErrorCode.CAPACITY_EXCEEDED, detail)
        self.hold_s = hold_s


def _batch_wait_timeout(q) -> float:
    dl = getattr(q, "deadline", None)
    if dl is not None:
        rem = dl.remaining_s()
        if rem is not None:
            return min(rem + 60.0, BATCH_WAIT_TIMEOUT_S)
    return BATCH_WAIT_TIMEOUT_S


class Proxy:
    """Serves SPARQL over one partition through a host ``CPUEngine`` (the
    GPU engine's own when there is one) and, with ``Global.enable_tpu``, a
    ``GPUEngine`` on ``device`` (the card by
    default; ``device="cpu"`` runs the plain PyTorch version of every
    kernel). ``planner`` (an optimizer ``Planner``) plans every query when
    ``Global.enable_planner``; its statistics also size the GPU engine's
    capacities, as a JAX deployment passes one ``Stats`` to both."""

    def __init__(self, gstore, str_server, device="cuda",
                 budget_bytes: int | None = None, planner=None,
                 dist_engine=None):
        self.g = gstore
        self.str_server = str_server
        self.dist = dist_engine
        self.planner = planner  # cost-based optimizer (optional)
        self._device = device  # where the strategies' device routes run
        self.gpu = (GPUEngine(gstore, str_server, device=device,
                              budget_bytes=budget_bytes,
                              stats=planner.stats if planner is not None
                              else None)
                    if Global.enable_tpu else None)
        # the host engine holds no state of its own between queries, so the
        # GPU engine's (which runs its host stages) serves the proxy too
        self.cpu = (self.gpu.cpu if self.gpu is not None
                    else CPUEngine(gstore, str_server))
        self.monitor = Monitor()
        # observability: the flight recorder and the metrics registry
        # (console verbs `trace` / `slo` read these back)
        self.recorder = get_recorder()
        self.metrics = get_registry()
        self._m_queries = self.metrics.counter(
            "wukong_queries_total", "Proxy queries by reply status and tenant",
            labels=("status", "tenant"))
        self._m_lane = self.metrics.counter(
            "wukong_lane_routed_total",
            "Plan-time light/heavy lane routing decisions", labels=("lane",))
        # tensor-join strategy routing (join/): per-query strategy
        # decisions and wcoj-to-walk degradations
        self._m_join = self.metrics.counter(
            "wukong_join_queries_total",
            "Plan-time execution-strategy decisions", labels=("strategy",))
        self._m_join_fallback = self.metrics.counter(
            "wukong_join_fallback_total",
            "WCOJ executions degraded to the walk", labels=("reason",))
        self._m_join_demoted = self.metrics.counter(
            "wukong_join_demotions_total",
            "Templates demoted wcoj->walk by measured-blowup feedback")
        # device-route plumbing (join_device knob): plan-time host/device
        # decisions and the measured-candidate demotions back to host
        self._m_join_route = self.metrics.counter(
            "wukong_join_route_total",
            "Plan-time wcoj level-route decisions", labels=("route",))
        self._m_route_demoted = self.metrics.counter(
            "wukong_join_route_demotions_total",
            "Templates demoted device->host by measured-candidate feedback")
        # compiled-template routing (engine/template_compile.py): plan-
        # time route decisions and compiled executions degraded to the
        # host walk (the demotion latch itself counts inside the engine)
        self._m_template_route = self.metrics.counter(
            "wukong_template_route_total",
            "Plan-time compiled-template route decisions",
            labels=("route",))
        self._m_template_fallback = self.metrics.counter(
            "wukong_template_fallback_total",
            "Compiled-template executions degraded to the host walk",
            labels=("reason",))
        # hybrid graph+vector serving (vector/): per-mode knn query counts,
        # plan-time scan-route decisions, and the measured demotions back to
        # the host scan
        self._m_vec_queries = self.metrics.counter(
            "wukong_vector_queries_total",
            "knn() queries by composition mode", labels=("mode",))
        self._m_vec_route = self.metrics.counter(
            "wukong_vector_route_total",
            "Plan-time knn scan route decisions", labels=("route",))
        self._m_vec_demoted = self.metrics.counter(
            "wukong_vector_route_demotions_total",
            "knn templates demoted device->host by measured feedback")
        if self.gpu is None:
            # no GPU engine: the proxy's device decides where a knn
            # device-route scan runs (resolved at the first such scan)
            self.cpu.knn_device = device
        self._wcoj = None  # guarded by: _batcher_init_lock
        self._wcoj_dist = None  # guarded by: _batcher_init_lock
        self._template = None  # guarded by: _batcher_init_lock
        self._pool = None
        self._batcher = None  # the request coalescer, started on first use
        self._batcher_init_lock = make_lock("proxy.batcher_init")
        # serving fast path: parse cache (query text -> pickled parsed
        # query) and plan cache (template signature + store version -> plan
        # recipe)
        self._parse_cache = LRUCache(Global.parse_cache_size)
        self._plan_cache = PlanCache(Global.plan_cache_size)
        # the checkpoint/recovery manager, built on first use; the periodic
        # checkpointer starts here when the knobs ask for it
        self._recovery = None
        self._recovery_init_lock = make_lock("proxy.recovery_init")
        # tenant -> monotonic time of its latest rejection slot
        self._reject_slots: dict = {}  # guarded by: _reject_lock
        self._reject_lock = make_lock("proxy.reject_pace")
        self._stream = None  # the StreamContext, built on first use
        # the recovery manager (checkpoint/restore + shard healing) starts
        # its threads only when the knobs ask for them: the periodic
        # checkpointer, and the heal watcher over a dist engine's replicas
        if (Global.checkpoint_interval_s > 0 and Global.checkpoint_dir) or (
                dist_engine is not None
                and dist_engine.sstore.replication_factor > 1):
            self.recovery().start()
        # the metrics scrape endpoint (metrics_port; no-op when 0) and the
        # metrics time-series sampler (enable_tsdb); both idempotent per
        # process
        from wukong_tpu_torch.obs.httpd import maybe_start_metrics_http
        from wukong_tpu_torch.obs.tsdb import maybe_start_tsdb

        maybe_start_metrics_http()
        maybe_start_tsdb()
        if dist_engine is not None:
            self._attach_sharded(dist_engine.sstore)
        # the serving plane (serve/): bind the result cache + view registry
        # to THIS proxy's partition — a re-attach (a new world in-process)
        # purges entries and drops old-world view registrations
        from wukong_tpu_torch.serve import get_serve

        get_serve().attach(self.g, self.str_server, device=device)

    def _attach_sharded(self, sstore) -> None:
        """Attach the sharded store to the control and observability
        planes: the migration actuator (attached either way, so the
        ``migrate`` verb works on demand; when its loop runs —
        migration_enable and placement_interval_s — it sweeps the advisor
        itself, so the observe-only loop is skipped: one sweeper, not
        two), else the placement advisor, the /healthz ``shards`` probe,
        and the monitor's breaker line."""
        import weakref

        from wukong_tpu_torch.obs.httpd import register_health_source
        from wukong_tpu_torch.obs.placement import maybe_start_advisor
        from wukong_tpu_torch.runtime.migration import maybe_start_migration

        if maybe_start_migration(sstore, owner=self) is None:
            maybe_start_advisor(sstore)
        # the probe holds the store through a weakref: the registry is
        # process-global, and a strong capture would keep a retired
        # world's degraded set driving readiness after its store died
        ss_ref = weakref.ref(sstore)

        def _shard_probe():
            ss = ss_ref()
            if ss is None or not (ss.degraded_shards or ss.failover_shards):
                return None
            return {"degraded": sorted(ss.degraded_shards),
                    "failover": sorted(ss.failover_shards)}

        register_health_source("shards", _shard_probe)
        self.monitor.attach_breaker("dist.shard", sstore.breaker)

    def engine_pool(self):
        """The host engine pool, started on first use (N CPU engines with
        stealing — wukong.cpp:202-225 spawns these at boot)."""
        if self._pool is None:
            from wukong_tpu_torch.runtime.scheduler import EnginePool

            self._pool = EnginePool(
                make_engine=lambda tid: CPUEngine(self.g, self.str_server))
            self._pool.start()
        return self._pool

    # ------------------------------------------------------------------
    def _parse_text(self, text: str) -> SPARQLQuery:
        """Parse with the bounded-LRU parse cache: a repeated text skips the
        parser. Entries are pickled: loads() is cheaper than deepcopy, and
        every hit gets a pristine query (no execution state leaks)."""
        blob = self._parse_cache.get(text)
        if blob is not None:
            _M_PARSE_CACHE.labels(result="hit").inc()
            q = pickle.loads(blob)
            q._qtext = text  # view promotion re-registers from the text
            return q
        _M_PARSE_CACHE.labels(result="miss").inc()
        q = Parser(self.str_server).parse(text)
        self._parse_cache.put(
            text, pickle.dumps(q, protocol=pickle.HIGHEST_PROTOCOL))
        q._qtext = text
        return q

    def _plan_version(self):
        """The plan-cache version key: the store version and whether the
        cost planner is active."""
        return (getattr(self.g, "version", 0),
                self.planner is not None and Global.enable_planner)

    def parse(self, text: str, plan_text: str | None = None) -> SPARQLQuery:
        """Parse and plan one query text."""
        q = self._parse_text(text)
        self._plan(q, plan_text)
        return q

    def _plan(self, q: SPARQLQuery, plan_text: str | None = None) -> None:
        """The JAX proxy's order: the cost-based planner when enabled (a
        user plan is then ignored), else the user plan, else the greedy
        heuristic. A query whose template signature was planned before at
        the same store version replays that plan (the plan cache)."""
        if plan_text is not None:
            if Global.enable_planner:
                log_info("user plan ignored: planner is enabled (config)")
            elif not set_plan(q.pattern_group, plan_text):
                raise WukongError(ErrorCode.UNKNOWN_PLAN, "bad plan file")
            else:
                return
        sig = template_signature(q)
        # the PRE-PLAN signature: the template route's demotion latch keys
        # on it (the planner reorders the patterns below)
        q._tsig = sig
        version = self._plan_version()
        q._rver = version[0]
        if getattr(q.knn, "mode", "") == "rank_then_pattern":
            # a seeded chain executes in TEXTUAL order outward from the
            # knn seeds: a planner reorder would re-root the chain away
            # from the seeded variable and flip the query's semantics
            return
        if self._plan_cache.lookup(q, sig, version):
            return
        parsed = snapshot_patterns(q) if sig is not None else None
        if self.planner is not None and Global.enable_planner:
            if self.planner.generate_plan(q):
                self._plan_cache.record(parsed, q, sig, version)
                return
        heuristic_plan(q)
        self._plan_cache.record(parsed, q, sig, version)

    def _plan_prepared(self, q: SPARQLQuery, blind, plan_text,
                       tenant: str = "default") -> None:
        """The prepare tail shared by both entry points: tenant stamp,
        blind mode, the resilience knobs' deadline, planning, plan-time
        lane routing."""
        q.tenant = tenant
        q.mt_factor = 1
        q.result.blind = Global.silent if blind is None else blind
        # per-query deadline + work budget (None when both knobs are off)
        q.deadline = Deadline.from_config()
        self._plan(q, plan_text)
        if q.knn is not None:
            self._prepare_knn(q)
        q.lane = self.classify_lane(q)
        self._m_lane.labels(lane=q.lane).inc()
        q.join_strategy = self.classify_join_strategy(q)
        self._m_join.labels(strategy=q.join_strategy).inc()
        if q.join_strategy == "wcoj":
            q.join_route = self.classify_join_route(q)
            self._m_join_route.labels(route=q.join_route).inc()
        elif q.knn is None:
            # walk-strategy shapes may compile the WHOLE plan into one
            # device program (engine/template_compile.py)
            q.template_route = self.classify_template_route(q)
            self._m_template_route.labels(route=q.template_route).inc()

    def _engine_for(self, device: str | None):
        """``device`` "cpu" | "gpu" | "dist" | None (the GPU engine when
        ``Global.enable_tpu``, else the host engine)."""
        if device == "cpu":
            return self.cpu
        if device == "dist":
            if self.dist is None:
                raise WukongError(ErrorCode.UNSUPPORTED_SHAPE,
                                  "no distributed engine: start with --dist")
            return self.dist
        if device == "gpu" or (device is None and Global.enable_tpu):
            if self.gpu is None:
                raise WukongError(ErrorCode.UNSUPPORTED_SHAPE,
                                  "no GPU engine: enable_tpu was off at boot")
            return self.gpu
        if device is not None:
            raise WukongError(ErrorCode.UNSUPPORTED_SHAPE,
                              f"unknown engine {device!r} (cpu, gpu or "
                              "dist)")
        return self.cpu

    # ------------------------------------------------------------------
    def run_single_query(self, text: str, repeats: int = 1,
                         plan_text: str | None = None, mt_factor: int = 1,
                         device: str | None = None, blind: bool | None = None,
                         print_results: int = 0,
                         tenant: str = "default") -> SPARQLQuery:
        """sparql -f <file> [-n repeats] [-p plan] [-m mt] [-N] [-v N]
        [-d cpu|gpu] [-t tenant] (console.hpp:141-153). ``blind`` None
        follows ``Global.silent``."""
        if mt_factor > 1:
            # the reference fans an index scan out to mt_factor threads
            # (sparql.hpp:1064-1088); one device chain scans the whole index
            log_info("-m (mt_factor) is vectorized away on this engine; "
                     "running the full index scan")
        if repeats < 1:
            # validated before admission: a raise past _admit would leak
            # the tenant's in-flight slot
            raise WukongError(ErrorCode.SYNTAX_ERROR, "repeats must be >= 1")
        # the query's trace, started at receipt (None with tracing off)
        trace = maybe_start_trace(kind="query", text=text)
        t0_us = get_usec()
        ten = self._admit(tenant)
        if trace is not None:
            trace.tenant = ten
        adm_d = None

        def prepare():
            return self._prepare(text, blind, plan_text, ten, trace, adm_d)

        try:
            adm_d = self._consult_admission(ten)
            # the trace is ambient on this thread too (parse, plan and
            # fallback decisions), and with xprof_dir set the execution
            # runs inside a device capture
            with activate(trace), maybe_device_trace():
                q, total_us = self._run_repeats(prepare, repeats, device,
                                                trace)
        except Exception as e:
            self._reply_failed(e, ten, t0_us, trace)
            raise
        self._reply(q, ten, t0_us, trace, text)
        if trace is not None:
            log_info(f"trace {trace.trace_id} (qid {trace.qid}) recorded: "
                     f"{len(trace.spans)} spans, {trace.dur_us:,}us")
        if q.result.status_code != ErrorCode.SUCCESS:
            if not q.result.complete:
                # a structured partial reply: the rows produced before the
                # deadline/budget expiry are still in the table
                log_error(
                    f"query degraded: {q.result.status_code.name} — partial "
                    f"result ({q.result.nrows} rows, "
                    f"{len(q.result.dropped_patterns)} pattern(s) dropped)")
            else:
                log_error(f"query failed: {q.result.status_code.name}")
            return q
        log_info(f"(last) result rows: {q.result.nrows}, "
                 f"avg latency: {total_us / repeats:,.0f} usec ({repeats} runs)")
        if print_results and not q.result.blind:
            self.print_result(q, min(print_results, q.result.nrows))
        return q

    def serve_query(self, text: str, blind: bool = False,
                    device: str | None = None,
                    tenant: str = "default") -> SPARQLQuery:
        """Run one query through the same execution loop as
        run_single_query; the reply is ``q.result`` (the table, or only the
        row count when ``blind``; ``attr_table`` for attribute variables).
        A shape no engine can run ends on ``q.result.status_code``; an
        admission rejection raises CAPACITY_EXCEEDED. ``tenant`` is the
        caller's identity, stamped on the query, its trace and every
        reply-side metric. Unlike the JAX proxy's, ``blind`` defaults to
        False (the table), as the port's callers in Python read it, and a
        traced reply carries ``proxy.parse`` and ``proxy.plan`` spans as
        run_single_query's does.

        With ``enable_result_cache`` on, a repeated text whose key is
        resident at the current store version serves on the zero-parse
        fast path (``_serve_fast_hit``): no parse, no plan, no engine —
        the reply-side accounting (tenant admission, SLO, reuse
        observatory, the ``proxy.serve`` fault site) still runs in
        full."""
        if Global.enable_result_cache and device is None \
                and not Global.enable_tracing:
            q = self._serve_fast_hit(text, blind, tenant)
            if q is not None:
                return q
        trace = maybe_start_trace(kind="query", text=text)
        t0_us = get_usec()
        ten = self._admit(tenant)
        if trace is not None:
            trace.tenant = ten
        adm_d = None

        def prepare():
            return self._prepare(text, blind, None, ten, trace, adm_d)

        try:
            adm_d = self._consult_admission(ten)
            with activate(trace):
                q, _us = self._run_repeats(prepare, 1, device, trace)
        except Exception as e:
            self._reply_failed(e, ten, t0_us, trace)
            raise
        self._reply(q, ten, t0_us, trace, text)
        return q

    def _prepare(self, text: str, blind, plan_text, ten: str, trace,
                 adm_d) -> SPARQLQuery:
        """Parse and plan one query for an entry point, under the trace's
        ``proxy.parse`` and ``proxy.plan`` spans when it has one, with a
        rung-2 admission's deadline and row budget stamped on it."""
        if trace is None:
            q = self._parse_text(text)
            self._plan_prepared(q, blind, plan_text, tenant=ten)
        else:
            with trace.span("proxy.parse"):
                q = self._parse_text(text)
            q.trace = trace
            q.qid = trace.qid
            with trace.span("proxy.plan"):
                self._plan_prepared(q, blind, plan_text, tenant=ten)
        if adm_d is not None:
            adm_d.apply(q)
        return q

    def _reply(self, q: SPARQLQuery, ten: str, t0_us: int, trace,
               text: str) -> None:
        """Reply-side observability: the status counter, the flight
        recorder (dumping on timeout/budget/slow), latency attribution,
        then the SLO window — after the trace is finished, so a burn dump
        serializes a completed trace — and the row-budget accounting."""
        status = q.result.status_code
        self._m_queries.labels(status=status.name, tenant=ten).inc()
        if trace is not None:
            self.recorder.on_complete(trace, status)
            self._attribute(trace, q, text)
        self._observe_slo(ten, get_usec() - t0_us,
                          ok=status == ErrorCode.SUCCESS, status=status,
                          trace=trace)
        self._note_admission_reply(ten, q)
        self._observe_reuse(q, ten, text)

    def _serve_fast_hit(self, text: str, blind, tenant: str):
        """The zero-parse cached-serving path: resolve the text to its
        cache key via the fill-time memo and, on a fresh-version hit,
        reply from the cached entry without parsing or planning. Returns
        None on any miss — the caller falls through to the full path
        (which probes the same key again, with collapsing). Skipped under
        tracing (a traced reply keeps its parse/plan spans) and for
        pinned-device requests."""
        from wukong_tpu_torch.serve import get_serve

        eff_blind = Global.silent if blind is None else bool(blind)
        rc = get_serve().cache
        found = rc.fast_probe(text, eff_blind,
                              int(getattr(self.g, "version", 0)))
        if found is None:
            return None
        key, ent = found
        t0_us = get_usec()
        ten = self._admit(tenant)
        try:
            # cached hits consume no engine capacity: only the q/s and
            # in-flight quotas apply (cached=True skips the ladder); the
            # serving boundary's fault site fires as for executed traffic
            self._consult_admission(ten, cached=True)
            faults.site("proxy.serve")
        except Exception as e:
            self._reply_failed(e, ten, t0_us, None)
            raise
        q = rc.build_reply(key, ent)
        q.tenant = ten
        self._m_queries.labels(status="SUCCESS", tenant=ten).inc()
        self._observe_slo(ten, get_usec() - t0_us, ok=True,
                          status=ErrorCode.SUCCESS, trace=None)
        self._observe_reuse(q, ten, text)
        return q

    def _observe_reuse(self, q, tenant: str, text: str) -> None:
        """Reply-side reuse-observatory hook: the shadow key carries the
        PLAN-time store version (``_rver``), so a write landing between
        plan and reply cannot file the key under a version the read never
        saw; a query that skipped the plan path (a user plan file) falls
        back to the current version. With the result cache on, the
        shadow's verdict for this reply is compared against the real
        probe's (stamped in ``_serve_execute``): a disagreement counts
        toward ``wukong_cache_divergence_total``."""
        shadow_hit = maybe_observe_reuse(
            q, tenant,
            q.__dict__.get("_rver", getattr(self.g, "version", 0)),
            text=text)
        if Global.enable_result_cache:
            from wukong_tpu_torch.serve.result_cache import (
                note_shadow_outcome,
            )

            note_shadow_outcome(q, shadow_hit)

    def _reply_failed(self, e: Exception, ten: str, t0_us: int,
                      trace) -> None:
        """A parse, plan or admission failure raises before any reply
        exists; it still reaches the reply-side observability. A rung-3
        rejection then holds its caller for its hold."""
        code = e.code if isinstance(e, WukongError) else "ERROR"
        self._m_queries.labels(
            status=code.name if isinstance(code, ErrorCode) else str(code),
            tenant=ten).inc()
        if trace is not None:
            self.recorder.on_complete(trace, code)
        self._observe_slo(ten, get_usec() - t0_us, ok=False, status=code,
                          trace=trace)
        if isinstance(e, _Rejected):
            # after the accounting: a held caller holds no in-flight slot
            time.sleep(e.hold_s)

    def _run_repeats(self, prepare, repeats: int, device, trace=None):
        """The repeat and capacity-fallback execution loop; returns (last
        query, total execution usec). A batched member that ends
        CAPACITY_EXCEEDED (its fused group failed and re-ran it alone on
        the GPU engine) degrades here like a direct one."""
        q = None
        total_us = 0
        for _ in range(repeats):
            q = prepare()
            eng = self._engine_for(device)
            t0 = get_usec()
            self._serve_execute(q, eng, pinned=device is not None)
            total_us += get_usec() - t0
            if (q.result.status_code == ErrorCode.UNSUPPORTED_SHAPE
                    and eng is self.dist):
                # the distributed engine refuses some shapes up front;
                # the host engine (the GPU engine when enable_tpu) answers
                # them. Capacity failures keep their status: falling back
                # would materialize the oversized table on one host
                log_info("distributed engine rejected the plan shape; "
                         "falling back to the host engine")
                if trace is not None:
                    trace.event("proxy.fallback", reason="shape", to="host")
                q = prepare()
                t0 = get_usec()
                self._engine_for(None).execute(q)
                total_us += get_usec() - t0
            elif (q.result.status_code == ErrorCode.CAPACITY_EXCEEDED
                    and eng is self.gpu):
                # graceful degradation: the capacity ceiling is the card's,
                # not the query's — the host engine has no capacity
                # classes, so the query runs again there
                log_info("device capacity exceeded; degrading to the "
                         "host engine")
                if trace is not None:
                    trace.event("proxy.fallback", reason="capacity",
                                to="cpu")
                q = prepare()
                t0 = get_usec()
                self.cpu.execute(q)
                total_us += get_usec() - t0
            if q.result.status_code in (ErrorCode.QUERY_TIMEOUT,
                                        ErrorCode.BUDGET_EXCEEDED):
                break  # deadline/budget spent: repeats are pointless
        return q, total_us

    # ------------------------------------------------------------------
    # tenants: admission, the SLO plane, attribution
    # ------------------------------------------------------------------
    def _admit(self, tenant) -> str:
        """The bounded metric-label form of the tenant id, plus the
        overload bus's in-flight/arrival note. With accounting off, one
        knob check and the raw id."""
        if not Global.enable_tenant_accounting:
            return str(tenant) if tenant else "default"
        ten = tenant_label(tenant)
        get_overload().note_admit(ten)
        return ten

    def _consult_admission(self, ten: str, cached: bool = False):
        """The admission plane's consult point, after ``_admit`` (so the
        in-flight signal includes this query) and inside the caller's
        reply-accounting try (a rejection releases the in-flight slot
        through ``_observe_slo``). One knob check when the plane is off.
        Rung 1 sleeps here on the serving thread; rung 3 raises the
        structured CAPACITY_EXCEEDED rejection with its retry-after hint
        (``_reply_failed`` holds its caller, ``_reject_hold_s``), so a
        rejected query reaches no engine and no host fallback; the
        returned Decision stamps a rung-2 partial budget onto the prepared
        query."""
        adm = maybe_admission()
        if adm is None:
            return None
        d = adm.admit(ten, cached=cached)
        if d.action == "reject":
            raise _Rejected(
                f"admission shed: tenant {ten!r} ({d.reason or 'overload'})"
                f" — retry after {d.retry_after_s:.1f}s",
                self._reject_hold_s(ten, d.retry_after_s))
        if d.action == "defer" and d.wait_s > 0:
            time.sleep(min(d.wait_s, 5.0))
        return d

    def _reject_hold_s(self, ten: str, retry_after_s: float) -> float:
        """How long a rung-3 rejection of ``ten`` holds its caller: until
        the tenant's next rejection slot (``REJECT_SPACING_S`` after its
        latest, ``REJECT_YIELD_S`` from now at the earliest), capped at
        the reply's retry-after."""
        now = time.monotonic()
        with self._reject_lock:
            slot = max(now + REJECT_YIELD_S,
                       self._reject_slots.get(ten, now - REJECT_SPACING_S)
                       + REJECT_SPACING_S)
            slot = min(slot, now + max(retry_after_s, REJECT_YIELD_S))
            self._reject_slots[ten] = slot
        return slot - now

    def _note_admission_reply(self, ten: str, q) -> None:
        """Reply-side aggregate-row accounting for the row-budget quota
        (one knob check when the plane is off)."""
        adm = maybe_admission()
        if adm is not None:
            adm.note_reply(ten, int(getattr(q.result, "nrows", 0)))

    def _observe_slo(self, tenant: str, dur_us: int, ok: bool, status,
                     trace) -> None:
        """Reply-side SLO accounting: release the in-flight slot, count
        reply-side sheds, and fold the reply into the tenant's SLO window
        (the burn-rate sentinel fires from here). One knob check when
        accounting is off."""
        if not Global.enable_tenant_accounting:
            return
        sig = get_overload()
        sig.note_done(tenant)
        if status == ErrorCode.QUERY_TIMEOUT:
            sig.note_shed("reply_timeout", tenant)
        elif status == ErrorCode.BUDGET_EXCEEDED:
            sig.note_shed("reply_budget", tenant)
        get_slo().observe(tenant, int(dur_us), ok, trace=trace)

    def explain_query(self, text: str, analyze: bool = False,
                      device: str | None = None,
                      plan_text: str | None = None) -> dict:
        """EXPLAIN: parse + plan and render the planned patterns with the
        planner's per-step estimates. EXPLAIN ANALYZE: also execute under
        a forced trace and join the host steps' actual rows and times
        against the estimates, plus the latency decomposition. Returns the
        structured report; ``rendered`` holds the table (console verbs
        ``explain`` / ``analyze``)."""
        from wukong_tpu_torch.obs.profile import explain_query

        return explain_query(self, text, analyze=analyze, device=device,
                             plan_text=plan_text)

    def _attribute(self, trace, q: SPARQLQuery, text: str) -> None:
        """Reply-side latency attribution: fold the finished trace into its
        template's rolling baseline; the sentinel dumps the trace on a
        regression. One knob check when attribution is off."""
        if not Global.enable_attribution:
            return
        from wukong_tpu_torch.obs.profile import get_attributor, template_key

        verdict = get_attributor().observe(
            trace, template_key(q, text),
            example=" ".join(text.split())[:120])
        if verdict is not None:
            log_error(
                f"latency regression ({verdict['reason']}): template "
                f"{verdict['template']} {verdict['total_us']:,}us vs "
                f"baseline p95 {verdict['baseline_p95_us']:,}us, worst "
                f"component {verdict['component']} "
                f"{verdict['share_drift_pts']:+.1f}pts — trace "
                f"{trace.trace_id} dumped")

    # ------------------------------------------------------------------
    # serving-path micro-batching (runtime/batcher.py)
    # ------------------------------------------------------------------
    def batcher(self) -> QueryBatcher:
        """The request coalescer, started on first use. Groups ride the
        engine pool's batch and heavy lanes when the pool is running, else
        they run inline on the batcher's flusher thread."""
        if self._batcher is None:
            with self._batcher_init_lock:  # concurrent first dispatches
                if self._batcher is None:  # must share ONE coalescer
                    self._batcher = QueryBatcher(
                        self.cpu, self.gpu, pool=lambda: self._pool,
                        suggest_heavy_b=self.heavy_index_batch)
        return self._batcher

    def _serve_execute(self, q: SPARQLQuery, eng,
                       pinned: bool = False) -> SPARQLQuery:
        """One serving-path dispatch. A query the planner routed ``wcoj``
        runs on the tensor join first, and a template-routed one on its
        compiled program; either degrades to the walk below on the causes
        the JAX proxy names (the module docstring lists them), and any
        other error raises. Then, with ``enable_batching`` on, compatible
        queries coalesce into fused dispatches; the default (off) and
        every bypass go straight to the engine. ``pinned`` (an explicit
        device= request) bypasses the strategies and the batcher: the
        batcher picks its own engine, which would override the caller's
        pin.

        With ``enable_result_cache`` on, the dispatch is fronted by the
        version-keyed result cache: a hit installs the cached reply and
        skips execution; a miss may elect this thread the key's
        collapsing leader, whose settlement (in the ``finally``) fills the
        cache and wakes the followers, whichever path produced the
        reply."""
        # the serving-boundary fault site: an injected failure reaches the
        # caller before any engine runs — before the cache probe, so
        # cached traffic burns error budgets too
        faults.site("proxy.serve")
        lease = None
        if Global.enable_result_cache:
            from wukong_tpu_torch.serve import get_serve

            served, lease = get_serve().cache.acquire(q)
            if served:
                return q
        try:
            return self._dispatch(q, eng, pinned)
        finally:
            if lease is not None:
                # leader settlement: fill on SUCCESS+admission, and wake
                # the followers either way (a failed leader must never
                # strand its collapsed waiters)
                lease.settle(q)

    def _dispatch(self, q: SPARQLQuery, eng, pinned: bool) -> SPARQLQuery:
        """``_serve_execute``'s execution, behind the fault site and the
        result cache."""
        if getattr(q, "join_strategy", "walk") == "wcoj" and not pinned:
            try:
                # a sharded store routes the distributed join (a heavy-lane
                # fan-out over the partitions)
                if eng is self.dist and self.dist is not None:
                    self.wcoj_dist().try_execute(q)
                else:
                    self.wcoj().try_execute(q)
                self._record_wcoj_feedback(q)
                self._record_route_feedback(q)
                return q
            except (WukongError, DeviceRangeError, *faults.INJECTED) as e:
                reason = (e.code.name if isinstance(e, WukongError)
                          else type(e).__name__)
                self._m_join_fallback.labels(reason=reason).inc()
                tr = getattr(q, "trace", None)
                if tr is not None:
                    tr.event("join.fallback", reason=reason)
                log_info(f"wcoj degraded to the walk ({reason})")
        if getattr(q, "template_route", "host") == "device" and not pinned \
                and eng is not self.dist and q.knn is None:
            # whole-plan compiled execution: one device program serves the
            # query byte-identically, or the plan shape is refused (False)
            # and the walk below owns it; a compile/dispatch failure
            # latches a per-template demotion so same-template queries stop
            # re-paying the failed device attempt until a store mutation
            from wukong_tpu_torch.engine.template_compile import (
                TemplateOverflow,
                TemplateUnsupported,
                latch_demotion,
            )

            try:
                if self.template_engine().try_execute(q):
                    self._record_template_feedback(q)
                    return q
            except (WukongError, DeviceRangeError, TemplateOverflow,
                    TemplateUnsupported, *faults.INJECTED) as e:
                reason = (e.code.name if isinstance(e, WukongError)
                          else type(e).__name__)
                latch_demotion(getattr(q, "_tsig", None), reason,
                               getattr(self.g, "version", 0))
                self._m_template_fallback.labels(reason=reason).inc()
                tr = getattr(q, "trace", None)
                if tr is not None:
                    tr.event("template.fallback", reason=reason)
                log_info(f"compiled template degraded to the walk "
                         f"({reason})")
        if Global.enable_batching and not pinned and eng is not None \
                and eng is not self.dist and q.knn is None:
            # knn queries bypass the coalescer: their scan is the batch
            pend = self.batcher().offer(q)
            if pend is not None:
                timeout = _batch_wait_timeout(q)
                try:
                    pend.wait(timeout)
                except TimeoutError:
                    log_error(f"batched dispatch not settled in "
                              f"{timeout:.0f}s; batcher wedged?")
                    raise
                return q
        if q.knn is not None:
            self._maybe_presolve_knn(q)
        eng.execute(q)  # batcher bypass: direct dispatch
        self._record_knn_feedback(q)
        return q

    # ------------------------------------------------------------------
    # hybrid graph+vector routing (vector/)
    # ------------------------------------------------------------------
    def _prepare_knn(self, q: SPARQLQuery) -> None:
        """Plan-time knn stamps: refuse when the plane is off (never
        silently degrade a vector query to a graph query), classify the
        composition mode and scan route, and flag wide scans so lane
        routing sends them down the heavy lane."""
        from wukong_tpu_torch.vector import knn as vknn

        if not Global.enable_vectors:
            raise WukongError(ErrorCode.ATTR_DISABLE,
                              "knn() requires enable_vectors")
        q.knn_mode = vknn.classify_knn_mode(q)
        self._m_vec_queries.labels(mode=q.knn_mode).inc()
        vs = getattr(self.g, "vstore", None)
        n = int(vs.live_count()) if vs is not None else 0
        # EXPLAIN inputs (obs/profile.py): scan size = every live
        # embedding, scan bytes = the float32 block the kernel reads
        q._knn_live = n
        q._knn_dim = int(vs.dim) if vs is not None else 0
        # a wide scan-side composition (pure scan / rank-then-pattern)
        # is heavy-lane work: slice-range split across the engine pool
        q._knn_wide = (q.knn_mode != "pattern_then_rank"
                       and n >= max(int(Global.knn_split_threshold), 1))
        q.knn_route = self.classify_knn_route(q, n)
        self._m_vec_route.labels(route=q.knn_route).inc()

    def classify_knn_route(self, q: SPARQLQuery, live: int) -> str:
        """Plan-time host/device route for the knn scan, memoized per
        template signature + store version under ``knn_device auto``
        (vector upserts bump the store version, so the volume-driven
        decision re-arms on every embedding mutation). Overwritten by
        ``_record_knn_feedback`` when the drill demoted a device scan."""
        knob = str(Global.knn_device).strip().lower()
        if knob in ("host", "device"):
            return knob
        thr = max(int(Global.knn_split_threshold), 1)

        def compute() -> str:
            # device when the scan volume amortizes the dispatch: the
            # split threshold doubles as the auto-device floor
            return "device" if live >= thr else "host"

        sig = template_signature(q)
        if sig is None:
            return compute()  # pure scans: unmemoized, computed per query
        return self._plan_cache.aux("knn_route", sig,
                                    self._knn_route_memo_key(), compute)

    def _knn_route_memo_key(self):
        return (*self._plan_version(), "auto",
                int(Global.knn_split_threshold))

    def _record_knn_feedback(self, q: SPARQLQuery) -> None:
        """Measured-feedback demotion for the knn device route: the drill
        latched a device demotion onto the query (``knn_demoted``) — under
        ``knn_device auto``, demote the template's memoized route to host
        so same-template queries stop re-paying the failed device attempt.
        A store mutation or knob flip re-arms the volume-driven decision."""
        if q.knn is None:
            return
        demoted = getattr(q, "knn_demoted", None)
        if demoted is None:
            return
        if str(Global.knn_device).strip().lower() == "auto":
            sig = template_signature(q)
            if sig is not None:
                self._plan_cache.put_aux("knn_route", sig,
                                         self._knn_route_memo_key(), "host")
        self._m_vec_demoted.inc()
        note_feedback("knn", "demote_host")
        log_info(f"knn device route: demoted to host ({demoted})")

    def _maybe_presolve_knn(self, q: SPARQLQuery) -> None:
        """Wide scan-side knn: run the slice-range split across the
        engine pool's heavy lane HERE (the proxy owns the pool), stamping
        the ranked seeds onto the query so the engine's ``_knn_pre``
        consumes them instead of scanning inline. A gather-barrier timeout
        or an injected fault falls back to the engine's single-threaded
        scan; any other failure (a CUDA error among them) raises."""
        if not getattr(q, "_knn_wide", False) \
                or getattr(q, "knn_seeds", None) is not None:
            return
        vs = getattr(self.g, "vstore", None)
        if vs is None:
            return  # the engine raises the structured error
        from wukong_tpu_torch.vector import knn as vknn

        try:
            anchor = vknn.resolve_anchor(vs, q.knn)
        except WukongError:
            return  # the engine surfaces it with proper status plumbing
        metric = q.knn.metric or Global.knn_metric
        thr = max(int(Global.knn_split_threshold), 1)
        n = int(vs.live_count())
        parts = max(min(n // thr + 1, 8), 1)
        if parts <= 1:
            return
        # the heavy-split decision: this scan fans out across the pool
        note_feedback("knn", "heavy_split")
        try:
            seeds, _scores, demoted = vknn.sliced_topk(
                self.engine_pool(), vs, anchor, q.knn.k, metric,
                getattr(q, "knn_route", "host"), parts,
                device=self.cpu.knn_device)
        except (WukongError, *faults.INJECTED) as e:
            reason = (e.code.name if isinstance(e, WukongError)
                      else type(e).__name__)
            log_info(f"knn sliced scan failed ({reason}); the engine "
                     "scans inline")
            return
        q.knn_seeds = seeds
        if demoted:
            q.knn_demoted = demoted

    # ------------------------------------------------------------------
    # tensor-join strategy routing (join/)
    # ------------------------------------------------------------------
    def _strategy_device(self):
        """The device of the strategies' device routes: the GPU engine's,
        else the proxy's ``device`` argument (resolved at first use: a CUDA
        request with no card raises then, not at construction)."""
        if self.gpu is not None:
            return self.gpu.device
        return resolve_device(self._device)

    def classify_join_strategy(self, q: SPARQLQuery) -> str:
        """Plan-time walk/wcoj strategy for a PLANNED query, memoized per
        template signature + store version through the plan cache (the
        ``lane`` pattern). The mutable knobs join the memo key so a
        runtime ``join_strategy``/``wcoj_ratio`` change applies
        immediately."""
        pg = q.pattern_group
        if (pg.unions or pg.optional or q.planner_empty
                or not pg.patterns or q.knn is not None):
            # knn composition lives in the walk engine's pre/post hooks;
            # the tensor-join executors have no vector seam
            return "walk"
        knob = str(Global.join_strategy).strip().lower()
        if knob == "walk":
            return "walk"
        if self.planner is None or not Global.enable_planner:
            # no cost model: only the forced knob may route wcoj
            if knob != "wcoj":
                return "walk"
            from wukong_tpu_torch.join.qgraph import analyze

            return "wcoj" if analyze(pg.patterns).supported else "walk"
        sig = template_signature(q)
        pats = list(pg.patterns)
        key_extra = (knob, int(Global.wcoj_ratio),
                     int(Global.wcoj_min_rows))
        return self._plan_cache.aux(
            "strategy", sig, (*self._plan_version(), *key_extra),
            lambda: self.planner.choose_strategy(pats))

    def classify_join_route(self, q: SPARQLQuery) -> str:
        """Plan-time host/device level route for a wcoj-routed query,
        memoized like the strategy decision (the knobs join the key).
        Overwritten by ``_record_route_feedback`` when the measured
        candidate volume says the estimate over-predicted."""
        knob = str(Global.join_device).strip().lower()
        if knob in ("host", "device"):
            return "device" if knob == "device" else "host"
        if self.planner is None or not Global.enable_planner:
            return "host"  # no cost model to amortize the dispatch against
        sig = template_signature(q)
        pats = list(q.pattern_group.patterns)
        key_extra = (knob, int(Global.join_device_min_candidates))
        return self._plan_cache.aux(
            "route", sig, (*self._plan_version(), *key_extra),
            lambda: self.planner.choose_join_route(pats))

    def _route_memo_key(self):
        return (*self._plan_version(), "auto",
                int(Global.join_device_min_candidates))

    def _record_route_feedback(self, q: SPARQLQuery) -> None:
        """Device-route feedback: after a successful wcoj execution that
        ROUTED device under ``join_device auto``, compare the MEASURED
        candidate volume (summed per-level candidates from
        ``q.join_stats``) against the dispatch-amortization threshold and
        demote the memoized route to host when the estimate over-predicted.
        The memo key mirrors ``classify_join_route``'s exactly, so the
        demotion takes effect on the very next same-template query, and a
        knob flip or store mutation re-arms the estimate-driven decision."""
        stats = getattr(q, "join_stats", None)
        if (not stats or q.result.status_code != ErrorCode.SUCCESS
                or getattr(q, "join_route", "host") != "device"
                or str(Global.join_device).strip().lower() != "auto"
                or self.planner is None or not Global.enable_planner):
            return
        sig = template_signature(q)
        if sig is None:
            return
        if getattr(q, "_join_device_broken", False):
            # the executor latched host mid-query (an int32 range refusal,
            # an injected fault): a deterministic failure would re-pay the
            # failed device attempt on every same-template query
            self._plan_cache.put_aux("route", sig, self._route_memo_key(),
                                     "host")
            self._m_route_demoted.inc()
            note_feedback("join_route", "latched_host")
            log_info("wcoj device route: template demoted to host "
                     "(device path failed and latched host)")
            return
        measured = sum(int(lv.get("candidates", 0)) for lv in stats)
        if measured < max(int(Global.join_device_min_candidates), 1):
            self._plan_cache.put_aux("route", sig, self._route_memo_key(),
                                     "host")
            self._m_route_demoted.inc()
            note_feedback("join_route", "demote_host")
            log_info(f"wcoj device route: template demoted to host "
                     f"(measured candidates {measured:,} < "
                     f"join_device_min_candidates "
                     f"{Global.join_device_min_candidates:,})")

    def _record_wcoj_feedback(self, q: SPARQLQuery) -> None:
        """WCOJ auto-routing feedback: after a successful wcoj execution,
        record the MEASURED materialized-prefix blowup (peak per-level
        ``rows_out`` over the final fragment) and demote the template's
        memoized ``auto`` strategy to the walk when wcoj did NOT keep
        intermediates near the fragment (measured > ``wcoj_ratio``). The
        closing level's CANDIDATE count is deliberately excluded: bounding
        candidates while materializing few rows is exactly the leapfrog
        win. The memo key mirrors ``classify_join_strategy``'s exactly."""
        stats = getattr(q, "join_stats", None)
        if (not stats or q.result.status_code != ErrorCode.SUCCESS
                or str(Global.join_strategy).strip().lower() != "auto"
                or self.planner is None or not Global.enable_planner):
            return
        sig = template_signature(q)
        if sig is None:
            return
        final = max(int(stats[-1]["rows_out"]), 1)
        peak = max(int(lv["rows_out"]) for lv in stats)
        measured = peak / final
        key = (*self._plan_version(), "auto", int(Global.wcoj_ratio),
               int(Global.wcoj_min_rows))
        self._plan_cache.put_aux("wcoj_measured", sig, key,
                                 round(measured, 2))
        # STRICTLY above the ratio: a prefix that stays at ~final rows
        # measures exactly 1.0, and a forced wcoj_ratio of 1 must not
        # demote the shapes wcoj is winning on
        if measured > max(float(Global.wcoj_ratio), 1.0):
            self._plan_cache.put_aux("strategy", sig, key, "walk")
            self._m_join_demoted.inc()
            note_feedback("strategy", "demote_walk")
            log_info(f"wcoj auto-routing: template demoted to the walk "
                     f"(measured prefix blowup {measured:.1f}x > "
                     f"wcoj_ratio {Global.wcoj_ratio} — wcoj did not keep "
                     "intermediates near the fragment)")

    def wcoj(self):
        """The WCOJ executor over the host partition, built at first use
        (its sorted edge tables are cached per store version); its device
        route runs on the proxy's device."""
        if self._wcoj is None:  # unguarded: double-checked lazy init; the second check runs under the lock, and a reference read is atomic
            with self._batcher_init_lock:
                if self._wcoj is None:
                    from wukong_tpu_torch.join.wcoj import WCOJExecutor

                    self._wcoj = WCOJExecutor(
                        self.g, self.str_server,
                        stats=getattr(self.planner, "stats", None),
                        device=self._strategy_device())
        return self._wcoj  # unguarded: set once under the lock above and never rebound

    def wcoj_dist(self):
        """The distributed WCOJ executor over the sharded store's host
        partitions, built at first use: it hash-partitions the first
        eliminated variable and fans the per-partition joins out on the
        heavy lane (join/dist.py); each slice's device levels run on the
        proxy's device. The pool resolves lazily — slices run inline until
        the host engine pool exists."""
        if self._wcoj_dist is None:  # unguarded: double-checked lazy init, as wcoj()
            with self._batcher_init_lock:
                if self._wcoj_dist is None:
                    from wukong_tpu_torch.join.dist import (
                        DistributedWCOJExecutor,
                    )

                    self._wcoj_dist = DistributedWCOJExecutor(
                        self.dist.sstore.stores, self.str_server,
                        stats=getattr(self.planner, "stats", None),
                        pool=lambda: self._pool,
                        device=self._strategy_device())
        return self._wcoj_dist  # unguarded: set once under the lock above and never rebound

    # ------------------------------------------------------------------
    # whole-plan compiled-template routing (engine/template_compile.py)
    # ------------------------------------------------------------------
    def classify_template_route(self, q: SPARQLQuery) -> str:
        """Plan-time host/device route for a walk-strategy query through
        the whole-plan compiled engine. Only the planner's peak-rows
        ESTIMATE is memoized — the route itself is chosen live by
        ``choose_template_route`` so the per-template demotion latch and
        the measured padding-efficiency feedback apply on the very next
        query."""
        from wukong_tpu_torch.engine.template_compile import \
            choose_template_route

        # the PRE-PLAN signature (stamped in _plan): the demotion latch
        # keys on q._tsig at failure time
        sig = getattr(q, "_tsig", None)
        if sig is None:
            sig = template_signature(q)
        if sig is None:
            return "host"  # recursive shapes: no template to compile
        est = None
        if self.planner is not None and Global.enable_planner:
            pats = list(q.pattern_group.patterns)

            def compute():
                try:
                    return self.planner.estimate_peak_rows(pats)
                except Exception:  # an unestimable chain: no estimate
                    return None

            est = self._plan_cache.aux("template_est", sig,
                                       self._plan_version(), compute)
        q._template_est_rows = est
        return choose_template_route(sig, est,
                                     getattr(self.g, "version", 0))

    def template_engine(self):
        """The whole-plan compiled engine over the host partition, built at
        first use, on the proxy's device (its staged operands are cached
        per store version)."""
        if self._template is None:  # unguarded: double-checked lazy init; the second check runs under the lock, and a reference read is atomic
            with self._batcher_init_lock:
                if self._template is None:
                    from wukong_tpu_torch.engine.template_compile import \
                        TemplateCompiledEngine

                    self._template = TemplateCompiledEngine(
                        self.g, self.str_server,
                        device=self._strategy_device())
        return self._template  # unguarded: set once under the lock above and never rebound

    def _record_template_feedback(self, q: SPARQLQuery) -> None:
        """Measured feedback for the compiled-template route: after a
        successful compiled execution under ``template_device auto``, a
        measured live-row count below ``template_min_rows`` means the
        estimate over-predicted — latch the template back to the host walk
        (a store mutation re-arms the estimate-driven decision)."""
        if str(Global.template_device).strip().lower() != "auto":
            return
        recs = [r for r in (getattr(q, "device_steps", None) or [])
                if r.get("site") == "template.plan"]
        if not recs:
            return
        live = int(recs[-1].get("live", 0))
        if live < max(int(Global.template_min_rows), 1):
            from wukong_tpu_torch.engine.template_compile import \
                latch_demotion

            latch_demotion(getattr(q, "_tsig", None), "small_measured",
                           getattr(self.g, "version", 0))
            log_info(f"compiled template demoted to the host walk "
                     f"(measured live rows {live:,} < template_min_rows "
                     f"{Global.template_min_rows:,})")

    # ------------------------------------------------------------------
    def classify_lane(self, q: SPARQLQuery) -> str:
        """Plan-time light/heavy routing: index-origin starts are heavy
        (wide scans); other shapes are heavy when the optimizer's
        ``estimate_chain`` peak reaches ``heavy_rows_threshold``. Memoized
        per template signature + store version through the plan cache."""
        if getattr(q, "_knn_wide", False):
            # a wide knn scan is index-origin-shaped work: a full-store
            # pass, slice-range split across the pool
            return "heavy"
        try:
            if q.start_from_index():
                return "heavy"
        except WukongError:
            return "light"
        if self.planner is None or not Global.enable_planner:
            return "light"
        sig = template_signature(q)
        if sig is None:
            return "light"  # recursive shapes: unestimated, route light
        pats = list(q.pattern_group.patterns)
        threshold = max(int(Global.heavy_rows_threshold), 1)

        def compute() -> str:
            try:
                ests = self.planner.estimate_chain(pats)
            except Exception:  # an unestimable chain routes light
                ests = None
            return "heavy" if ests and max(ests) >= threshold else "light"

        # the threshold is runtime-mutable: it joins the memo key
        return self._plan_cache.aux(
            "lane", sig, (*self._plan_version(), threshold), compute)

    def serve_batch_index(self, text: str, B: int) -> np.ndarray:
        """B replicate instances of an index-origin query in one chain;
        returns the per-instance result row counts."""
        return self.gpu.execute_batch_index(self.parse(text), B)

    def heavy_index_batch(self, q: SPARQLQuery) -> int:
        """The slice count of an index-origin query's batch:
        ``suggest_index_batch`` capped by ``Global.heavy_batch_max``,
        memoized on template signature + store version + cap."""
        if self.gpu is None:
            return 1
        cap = max(int(Global.heavy_batch_max), 1)
        return int(self._plan_cache.aux(
            "heavy_b", template_signature(q), (*self._plan_version(), cap),
            lambda: max(min(self.gpu.suggest_index_batch(q, cap=cap), cap),
                        1)))

    def print_result(self, q: SPARQLQuery, rows: int) -> None:
        """Render rows through the string server (proxy.hpp:247-294)."""
        for i in range(rows):
            vals = []
            for v in q.result.required_vars:
                col = q.result.v2c_map.get(v)
                if col is None:
                    vals.append("?")
                    continue
                vid = int(q.result.table[i, col])
                vals.append(self.str_server.id2str(vid)
                            if self.str_server.exist_id(vid) else str(vid))
            log_info(f"  {i + 1}: " + "\t".join(vals))

    def fill_template(self, tmpl: SPARQLTemplate) -> None:
        """Collect candidate constants per %placeholder by running the
        type/predicate index (proxy.hpp:69-129)."""
        tmpl.candidates = []
        for tid, (pi, fld) in zip(tmpl.ptypes, tmpl.pos):
            if tid == "fromPredicate":
                # %<fromPredicate> (proxy.hpp:76-99): candidates are the
                # pattern's predicate index — subject slots draw its
                # subjects (IN side), object slots its objects (OUT side)
                pat = tmpl.query.pattern_group.patterns[pi]
                d = IN if fld == "subject" else OUT
                cands = np.asarray(self.g.get_index(pat.predicate, d))
                if len(cands) == 0:
                    raise WukongError(
                        ErrorCode.UNKNOWN_SUB,
                        f"no candidates for predicate {pat.predicate}")
                tmpl.candidates.append(cands)
                continue
            if not is_tpid(tid):
                raise WukongError(ErrorCode.SYNTAX_ERROR,
                                  f"placeholder type {tid} is not an index id")
            cands = np.asarray(self.g.get_index(tid, IN))
            if len(cands) == 0:
                raise WukongError(ErrorCode.UNKNOWN_SUB,
                                  f"no instances for placeholder type {tid}")
            tmpl.candidates.append(cands)

    # ------------------------------------------------------------------
    # data in and durability (store/dynamic.py, runtime/recovery.py)
    # ------------------------------------------------------------------
    def dynamic_load_data(self, dirname: str, check_dup: bool = False) -> int:
        """`load -d <dir> [-c]` (proxy.hpp:548 -> RDFEngine -> DynamicLoader).

        -c (check_dup) opts into duplicate dropping, like the reference's
        dedup-on-insert option. The store's version bump restages every
        device cache on its next use. Returns the new subject-side edges.
        """
        from wukong_tpu_torch.loader.hdfs import resolve_dataset_dir
        from wukong_tpu_torch.store.dynamic import load_dir_into

        dirname = resolve_dataset_dir(dirname)  # hdfs:// paths stage locally
        n = load_dir_into(self._insert_targets(), dirname, dedup=check_dup)
        self._dist_check_version()
        # plan recipes are version-keyed (stale ones can never apply), but
        # an insert obsoletes every cached plan's cost basis — free them
        self._plan_cache.clear()
        log_info(f"dynamic load: {n:,} new subject-side edges from {dirname}")
        return n

    # ------------------------------------------------------------------
    # streaming verbs (the Wukong+S surface; stream/)
    # ------------------------------------------------------------------
    def stream_context(self, use_pool: bool = False):
        """The StreamContext over this proxy's store, built on first call.

        Delta evaluation runs on the host partition; the epoch frontier
        runs on the proxy's device. With ``use_pool`` the delta queries
        ride the engine pool's stream lane, interleaving with one-shot
        queries. The flag only matters on first call — the context is
        built once."""
        if self._stream is None:
            from wukong_tpu_torch.stream import StreamContext

            self._stream = StreamContext(
                self._insert_targets(), self.str_server,
                pool=self.engine_pool() if use_pool else None,
                monitor=self.monitor, device=self._device)
        return self._stream

    def stream_register(self, text: str, window=None, base_triples=None,
                        callback=None) -> int:
        """Register a standing SPARQL query; returns its stream qid.
        ``callback`` is the push-mode sink: invoked per committed
        ResultDelta next to the pull poll() surface (exceptions contained
        and surfaced as the stream-callback-error metric)."""
        return self.stream_context().register(text, window=window,
                                              base_triples=base_triples,
                                              callback=callback)

    def stream_unregister(self, qid: int) -> None:
        self.stream_context().unregister(qid)

    def stream_poll(self, qid: int, since_epoch: int = -1) -> list:
        """Read a standing query's append-only result deltas."""
        return self.stream_context().poll(qid, since_epoch)

    def stream_prune(self, qid: int, upto_epoch: int) -> int:
        """Free a standing query's consumed sink history behind a cursor."""
        return self.stream_context().prune(qid, upto_epoch)

    def stream_feed(self, triples, ts=None):
        """Commit one triple batch as the next stream epoch; standing
        queries are incrementally evaluated before this returns. Device
        caches restage lazily via the store version bump, and cached plans
        are freed as by ``load -d``."""
        rec = self.stream_context().feed(triples, ts=ts)
        self._dist_check_version()
        self._plan_cache.clear()  # stream commit: same contract as load -d
        return rec

    def _dist_check_version(self) -> None:
        """After a mutation: the distributed engine drops its stagings,
        learned chain capacities and in-place memos when any shard's
        version moved (the JAX proxy re-specializes its compiled chains
        here)."""
        if self.dist is not None:
            self.dist.check_version()

    def _insert_targets(self) -> list:
        """Every store online inserts must reach: the host partition first,
        then the distributed shards (the `load -d` fan-out), then any
        shard replicas — a mirror that missed a write would serve stale
        data on failover."""
        targets = [self.g]
        if self.dist is not None:
            targets += [g for g in self.dist.sstore.stores if g is not self.g]
            targets += self.dist.sstore.replica_stores()
        return targets

    def _checkpoint_targets(self) -> list:
        """The checkpointed primaries (no replicas: they are re-cloned
        from the restored primaries, not persisted twice)."""
        targets = [self.g]
        if self.dist is not None:
            targets += [g for g in self.dist.sstore.stores if g is not self.g]
        return targets

    def recovery(self):
        """Lazily-assembled RecoveryManager over this proxy's stores,
        stream context, sharded store and engine pool (whose rebuild lane
        heals shards in the background)."""
        if self._recovery is None:  # unguarded: double-checked fast path — an atomic reference read; construction is serialized below
            with self._recovery_init_lock:
                if self._recovery is None:
                    from wukong_tpu_torch.runtime.recovery import (
                        RecoveryManager,
                    )

                    self._recovery = RecoveryManager(
                        self._checkpoint_targets,
                        stream=self.stream_context(),
                        sstore=getattr(self.dist, "sstore", None),
                        pool=lambda: self._pool,
                        on_change=self._on_store_change)
        return self._recovery  # unguarded: write-once reference, non-None past init

    def _on_store_change(self) -> None:
        """Restore, rebuild and cutover invalidation: exactly the
        dynamic-insert contract — cached plans must re-derive (the device
        caches follow the store version, which a restore bumps; a rebuild
        or a cutover drops the sharded store's stagings itself)."""
        self._dist_check_version()
        self._plan_cache.clear()

    def checkpoint(self) -> str:
        """Console `checkpoint` verb: write one atomic checkpoint bundle
        (the partition + the stream registry) and truncate the covered
        WAL."""
        return self.recovery().checkpoint()

    def recover(self) -> dict:
        """Console `recover` verb: restore the newest checkpoint and
        replay the WAL tail (boot-time crash recovery)."""
        return self.recovery().recover()

    def gstore_check(self, index_check: bool = True,
                     normal_check: bool = True) -> int:
        """Console `gsck`: the store consistency checker; returns the
        violation count."""
        from wukong_tpu_torch.store.checker import check_partition

        errors = check_partition(self.g, index_check, normal_check)
        for e in errors[:20]:
            log_error(f"gsck: {e}")
        log_info(f"gsck: {'PASS' if not errors else f'{len(errors)} violations'}")
        return len(errors)
