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
greedy heuristic, in the JAX proxy's order. The JAX proxy's hooks into
subsystems the port does not have yet (tracing, SLOs, admission, the result
cache and views, the distributed engine, streams, vectors, tensor joins,
compiled templates, recovery) are left out; ROADMAP
§A lists each. ``_serve_execute`` keeps the fault site, the batching branch
and the direct dispatch of the JAX one; its result-cache lease and its
``wcoj``, template and knn branches wait for their subsystems (§A 4-8).
"""

from __future__ import annotations

import pickle

import numpy as np

from wukong_tpu_torch.analysis.lockdep import make_lock
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.engine.cpu import CPUEngine
from wukong_tpu_torch.engine.tpu import GPUEngine
from wukong_tpu_torch.planner.heuristic import heuristic_plan
from wukong_tpu_torch.planner.plan_file import set_plan
from wukong_tpu_torch.runtime import faults
from wukong_tpu_torch.runtime.batcher import (
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
from wukong_tpu_torch.utils.errors import ErrorCode, WukongError
from wukong_tpu_torch.utils.logger import log_error, log_info
from wukong_tpu_torch.utils.lru import LRUCache
from wukong_tpu_torch.utils.timer import get_usec

# ceiling on how long a serving thread waits for a coalesced dispatch to
# settle — a wedged batcher surfaces as an error, never as a hung client
BATCH_WAIT_TIMEOUT_S = 600.0


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
                 budget_bytes: int | None = None, planner=None):
        self.g = gstore
        self.str_server = str_server
        self.planner = planner  # cost-based optimizer (optional)
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
        self._pool = None
        self._batcher = None  # the request coalescer, started on first use
        self._batcher_init_lock = make_lock("proxy.batcher_init")
        # serving fast path: parse cache (query text -> pickled parsed
        # query) and plan cache (template signature + store version -> plan
        # recipe)
        self._parse_cache = LRUCache(Global.parse_cache_size)
        self._plan_cache = PlanCache(Global.plan_cache_size)

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
            return pickle.loads(blob)
        q = Parser(self.str_server).parse(text)
        self._parse_cache.put(
            text, pickle.dumps(q, protocol=pickle.HIGHEST_PROTOCOL))
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
        version = self._plan_version()
        if self._plan_cache.lookup(q, sig, version):
            return
        parsed = snapshot_patterns(q) if sig is not None else None
        if self.planner is not None and Global.enable_planner:
            if self.planner.generate_plan(q):
                self._plan_cache.record(parsed, q, sig, version)
                return
        heuristic_plan(q)
        self._plan_cache.record(parsed, q, sig, version)

    def _plan_prepared(self, q: SPARQLQuery, blind, plan_text) -> None:
        """The prepare tail shared by both entry points: blind mode, the
        resilience knobs' deadline, planning, plan-time lane routing."""
        q.mt_factor = 1
        q.result.blind = Global.silent if blind is None else blind
        # per-query deadline + work budget (None when both knobs are off)
        q.deadline = Deadline.from_config()
        self._plan(q, plan_text)
        q.lane = self.classify_lane(q)

    def _engine_for(self, device: str | None):
        """``device`` "cpu" | "gpu" | None (the GPU engine when
        ``Global.enable_tpu``, else the host engine)."""
        if device == "cpu":
            return self.cpu
        if device == "gpu" or (device is None and Global.enable_tpu):
            if self.gpu is None:
                raise WukongError(ErrorCode.UNSUPPORTED_SHAPE,
                                  "no GPU engine: enable_tpu was off at boot")
            return self.gpu
        if device is not None:
            raise WukongError(ErrorCode.UNSUPPORTED_SHAPE,
                              f"unknown engine {device!r} (cpu or gpu)")
        return self.cpu

    # ------------------------------------------------------------------
    def run_single_query(self, text: str, repeats: int = 1,
                         plan_text: str | None = None, mt_factor: int = 1,
                         device: str | None = None, blind: bool | None = None,
                         print_results: int = 0) -> SPARQLQuery:
        """sparql -f <file> [-n repeats] [-p plan] [-m mt] [-N] [-v N]
        [-d cpu|gpu] (console.hpp:141-153). ``blind`` None follows
        ``Global.silent``."""
        if mt_factor > 1:
            # the reference fans an index scan out to mt_factor threads
            # (sparql.hpp:1064-1088); one device chain scans the whole index
            log_info("-m (mt_factor) is vectorized away on this engine; "
                     "running the full index scan")
        if repeats < 1:
            raise WukongError(ErrorCode.SYNTAX_ERROR, "repeats must be >= 1")

        def prepare():
            qq = self._parse_text(text)
            self._plan_prepared(qq, blind, plan_text)
            return qq

        q, total_us = self._run_repeats(prepare, repeats, device)
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
                    device: str | None = None) -> SPARQLQuery:
        """Run one query through the same execution loop as
        run_single_query; the reply is ``q.result`` (the table, or only the
        row count when ``blind``; ``attr_table`` for attribute variables).
        A shape no engine can run ends on ``q.result.status_code``. Unlike
        the JAX proxy's, ``blind`` defaults to False (the table), as the
        port's callers in Python read it."""

        def prepare():
            qq = self._parse_text(text)
            self._plan_prepared(qq, blind, None)
            return qq

        return self._run_repeats(prepare, 1, device)[0]

    def _run_repeats(self, prepare, repeats: int, device):
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
            if (q.result.status_code == ErrorCode.CAPACITY_EXCEEDED
                    and eng is self.gpu):
                # graceful degradation: the capacity ceiling is the card's,
                # not the query's — the host engine has no capacity
                # classes, so the query runs again there
                log_info("device capacity exceeded; degrading to the "
                         "host engine")
                q = prepare()
                t0 = get_usec()
                self.cpu.execute(q)
                total_us += get_usec() - t0
            if q.result.status_code in (ErrorCode.QUERY_TIMEOUT,
                                        ErrorCode.BUDGET_EXCEEDED):
                break  # deadline/budget spent: repeats are pointless
        return q, total_us

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
        """One serving-path dispatch: with ``enable_batching`` on,
        compatible queries coalesce into fused dispatches; the default
        (off) and every bypass go straight to the engine. ``pinned`` (an
        explicit device= request) always bypasses: the batcher picks its
        own engine, which would override the caller's pin."""
        # the serving-boundary fault site: an injected failure reaches the
        # caller before any engine runs
        faults.site("proxy.serve")
        if Global.enable_batching and not pinned and eng is not None:
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
        eng.execute(q)  # batcher bypass: direct dispatch
        return q

    def classify_lane(self, q: SPARQLQuery) -> str:
        """Plan-time light/heavy routing: index-origin starts are heavy
        (wide scans); other shapes are heavy when the optimizer's
        ``estimate_chain`` peak reaches ``heavy_rows_threshold``. Memoized
        per template signature + store version through the plan cache."""
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
