"""Distributed query execution: sharded chains with all-to-all row exchange.

The port's copy of the JAX package's parallel/dist_engine.py, over the
port's shard-slot mesh (parallel/mesh.py: D slots on one device). It
replaces the reference's distributed machinery as the JAX engine does:

- graph partitioned by hash(vid) % D over the shard slots
  (base_loader.hpp:172-173)
- one-sided RDMA reads + fork-join sub-queries (sparql.hpp:746-814,
  rmap.hpp) become a capacity-padded all-to-all of binding-table rows keyed
  by the anchor column's owner (``_exchange``)
- index-origin starts run on every shard over its local index slice
  (= dispatch to all servers x mt_factor, sparql.hpp:1064-1088)
- mid-chain type-membership expansion all-gathers rows and expands against
  each shard's local type index (= the reference's dispatch-to-all for
  ``p == TYPE_ID && d == IN``, sparql.hpp:1139-1152)

Where the JAX engine compiles a chain into one ``shard_map`` program, the
port runs the chain step by step: step i on every shard, then step i + 1,
because an exchange reads every shard's send buffer. A shard's table is row
``[d]`` of the chain's stacked [D, W, C] state, and each expansion or
membership step calls the port's kernel functions on it and on the shard's
row view of the stacked segment, so K1 (``probe_kernel``) launches once per
shard per probing step. The exchange and the all-gather are XLA collectives
in the JAX engine, not Pallas kernels; here they are torch ops over the
stacked tensors on the one device (receiver r reads ``send[:, r]``). Zero
mid-chain host syncs: one read at the end for row counts and overflow
totals (+ the tables when not blind). Capacity overflow anywhere (expansion
or exchange) retries the whole chain at exact capacities, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from wukong_tpu_torch.config import Global
from wukong_tpu_torch.engine import tpu_kernels as K
from wukong_tpu_torch.parallel.sharded_store import ShardedDeviceStore
from wukong_tpu_torch.sparql.ir import NO_RESULT, PGType, SPARQLQuery
from wukong_tpu_torch.types import IN, OUT, PREDICATE_ID, TYPE_ID, AttrType
from wukong_tpu_torch.utils.errors import (
    BudgetExceeded,
    CapacityExceeded,
    ErrorCode,
    QueryTimeout,
    WukongError,
    assert_ec,
)

I32 = torch.int32
INT32_MAX = 2**31 - 1


@dataclass
class _Step:
    kind: str  # init_index | init_const | init_rows | expand
    #           | expand_type_all | expand_versatile | member
    pid: int = 0
    dir: int = 0
    col: int = -1  # anchor column
    vals_col: int = -1  # member: end column (-1 => const)
    const: int = 0  # member const / init const vid
    cap: int = 0  # output capacity class (expansion / exchange target)
    exch_cap: int = 0  # per-destination exchange capacity (0 = no exchange)
    new_col: bool = False
    width: int = 0  # init_rows: seed table width


@dataclass
class _Plan:
    steps: list = field(default_factory=list)
    width: int = 0
    v2c: dict = field(default_factory=dict)

    def signature(self):
        return tuple(
            (s.kind, s.pid, s.dir, s.col, s.vals_col, s.const, s.cap,
             s.exch_cap, s.width)
            for s in self.steps)


class DistEngine:
    """Executes device-supported SPARQL plans across a device mesh."""

    def __init__(self, stores: list, str_server=None, mesh=None,
                 axis: str = "x", device=None):
        from wukong_tpu_torch.parallel.mesh import make_mesh

        # the default mesh is on the card: with no GPU this raises unless
        # device="cpu" is passed
        self.mesh = mesh or make_mesh(len(stores), device=device)
        self.axis = axis
        self.D = len(stores)
        self.device = self.mesh.device
        self.sstore = ShardedDeviceStore(stores, self.mesh, axis)
        self.str_server = str_server
        self.cap_min = Global.table_capacity_min
        self.cap_max = Global.table_capacity_max
        # per-chain observability: set by the last successful
        # _run_device_bgp — per-step row/exchange loads against their
        # capacity classes, and how many whole-chain retries were paid
        self.last_chain_stats: dict | None = None  # lock-free: one reference store per chain
        self._last_plan: _Plan | None = None  # lock-free: one reference store per chain
        # one-shot hook: seed the NEXT chain's capacity overrides (e.g. an
        # undersized class) to exercise the overflow retry
        # deterministically; consumed and cleared by _run_device_bgp
        self.force_cap_override: dict | None = None
        # learned capacity classes per pattern-chain key: estimate-driven
        # first runs over-pad (the skew bound is conservative by design),
        # so a successful run records the exact classes and the chain's
        # next run sizes its tables and send buffers by them; an undersized
        # class corrects itself through the overflow retry
        self._learned_caps: dict = {}  # lock-free: whole-entry dict get/set, atomic

    # ------------------------------------------------------------------
    def execute(self, q: SPARQLQuery, from_proxy: bool = True) -> SPARQLQuery:
        from wukong_tpu_torch.obs.trace import traced_execute

        # the ambient activation makes shard fetches / retries / breaker
        # trips land on this query's trace (see traced_execute)
        return traced_execute(
            q, "dist.execute", lambda: self._execute_impl(q, from_proxy),
            lambda: {"rows": q.result.nrows,
                     "status": q.result.status_code.name,
                     "complete": q.result.complete})

    def check_version(self) -> bool:
        """After a dynamic insert into any shard (dynamic_gstore.hpp lease
        invalidation): the stagings are gone, the learned capacity classes
        measured the old data, and the in-place engine's shard-segment and
        global-index memos point at old arrays. Returns True when a version
        moved."""
        if not self.sstore.check_version():
            return False
        self._learned_caps.clear()
        self.__dict__.pop("_inplace_eng", None)
        return True

    def _execute_impl(self, q: SPARQLQuery,
                      from_proxy: bool = True) -> SPARQLQuery:
        self.check_version()
        # degraded stagings are never cached, so a query served entirely
        # from cache is complete by construction — judge incompleteness only
        # by fetch failures during THIS query, not a prior query's outage
        self.sstore.degraded_shards.clear()
        try:
            self._execute_sm(q, from_proxy)
        except (QueryTimeout, BudgetExceeded) as e:
            from wukong_tpu_torch.runtime.resilience import mark_partial

            mark_partial(q, e)
        except WukongError as e:
            q.result.status_code = e.code
        if self.sstore.degraded_shards and q.result.status_code in (
                ErrorCode.SUCCESS, ErrorCode.QUERY_TIMEOUT,
                ErrorCode.BUDGET_EXCEEDED):
            # a down shard's partition contributed nothing to this chain:
            # the reply is well-formed but incomplete — tag it so clients
            # can distinguish "empty" from "missing a shard" (no crash)
            q.result.complete = False
            for s in sorted(self.sstore.degraded_shards):
                tag = f"shard:{s}"
                if tag not in q.result.dropped_patterns:
                    q.result.dropped_patterns.append(tag)
        return q

    def _execute_sm(self, q: SPARQLQuery, from_proxy: bool) -> None:
        """The distributed state machine: PATTERN -> UNION -> OPTIONAL ->
        FILTER -> FINAL (sparql.hpp:1564-1673). BGPs run as sharded
        chains; UNION branches and OPTIONAL groups run as seeded
        distributed children; FILTER/FINAL run host-side on the gathered
        table (they touch strings and projections, not the graph)."""
        if q.planner_empty and Global.enable_empty_shortcircuit:
            # planner-proved empty: no sharded chain, no collectives
            self._host().short_circuit_empty(q)
            if from_proxy:
                self._host()._final_process(q)
            return
        # silent-mode parity (reference Global::silent works for ANY shape —
        # it executes fully and simply never ships the table, query.hpp
        # shrink 619-630): shapes whose children need the gathered table
        # run non-blind internally and drop the table at reply time
        blind_deferred = bool(
            q.result.blind and (q.pattern_group.filters
                                or q.pattern_group.unions
                                or q.pattern_group.optional))
        if blind_deferred:
            q.result.blind = False
        if q.has_pattern and not q.done_patterns():
            self._execute_bgp(q)
        if q.pattern_group.unions and not q.union_done:
            self._execute_unions_dist(q)
        while q.optional_step < len(q.pattern_group.optional):
            self._execute_optional_dist(q)
        if q.pattern_group.filters or (from_proxy and q.orders):
            assert_ec(self.str_server is not None, ErrorCode.UNKNOWN_FILTER,
                      "FILTER/ORDER BY needs a string server")
        if q.pattern_group.filters:
            self._host()._execute_filters(q)
        if from_proxy:
            self._host()._final_process(q)
        if blind_deferred:
            # drop the table at reply time; the count survives (shrink)
            res = q.result
            res.blind = True
            nrows = res.nrows
            res.table = np.empty((0, res.col_num), dtype=np.int64)
            res.attr_table = np.empty((0, res.attr_col_num), np.float64)
            res.nrows = nrows

    def _host(self):
        from wukong_tpu_torch.engine.cpu import CPUEngine

        if not hasattr(self, "_host_engine"):
            self._host_engine = CPUEngine(None, self.str_server)
        return self._host_engine

    def _attr_host(self):
        """Host engine over the sharded attribute segments: an attr lookup
        routes to the subject owner's partition — the reference executes attr
        patterns CPU-side too (gpu_engine.hpp:267-333 unsupported on GPU)."""
        from wukong_tpu_torch.engine.cpu import CPUEngine

        if not hasattr(self, "_attr_engine"):
            self._attr_engine = CPUEngine(_ShardedAttrGraph(self.sstore.stores),
                                          self.str_server)
        return self._attr_engine

    # ------------------------------------------------------------------
    def _execute_bgp(self, q: SPARQLQuery) -> None:
        """Device-supported prefix as one distributed chain; a trailing run of
        attribute patterns executes host-side over the sharded attr stores."""
        pats = q.pattern_group.patterns
        split = q.pattern_step
        while split < len(pats) and \
                pats[split].pred_type == int(AttrType.SID_t):
            split += 1
        for pat in pats[split:]:  # the tail must be all-attr
            assert_ec(pat.pred_type != int(AttrType.SID_t),
                      ErrorCode.UNSUPPORTED_SHAPE,
                      "SID patterns after attr patterns are unsupported "
                      "in the distributed engine")
        first = pats[q.pattern_step] if split > q.pattern_step else None
        if first is not None \
                and self._try_inplace(q, n_steps=split - q.pattern_step):
            first = None  # the whole SID prefix ran in place
        if first is not None and q.result.col_num == 0 \
                and first.predicate < 0 and first.subject > 0:
            # versatile const start (CONST ?p ?y / CONST1 ?p CONST2): the
            # const's combined adjacency is one CSR walk on its owner
            # partition — done host-side, the rest of the chain runs as a
            # seeded distributed child (like the single-chip engine)
            self._versatile_const_start(q, first)
        if split > q.pattern_step:
            seed = None
            if q.result.col_num > 0:  # seeded child (UNION branch on a table)
                seed = (q.result.table, dict(q.result.v2c_map))
            tr = getattr(q, "trace", None)
            if tr is None:
                self._run_device_bgp(q, n_steps=split - q.pattern_step,
                                     seed=seed)
            else:
                sp = tr.start_span("dist.chain",
                                   steps=split - q.pattern_step,
                                   rows_in=q.result.nrows)
                try:
                    self._run_device_bgp(q, n_steps=split - q.pattern_step,
                                         seed=seed)
                finally:
                    st = getattr(self, "last_chain_stats", None) or {}
                    tr.end_span(sp, rows_out=q.result.nrows,
                                **{k: st[k] for k in
                                   ("mode", "retries", "exchanges")
                                   if k in st})
        while not q.done_patterns():  # attr tail (or attr-only query)
            self._attr_host()._execute_one_pattern(q)

    def _try_inplace(self, q: SPARQLQuery, n_steps: int) -> bool:
        """Owner-routed in-place fast path for small-table chains (reference
        need_fork_join, sparql.hpp:802-814; proxy owner routing,
        proxy.hpp:201-219): light queries run the whole SID prefix host-side
        against the federated partition view — no exchange, no device
        chain — and retreat to the collective chain the moment the live
        table outgrows Global.dist_inplace_rows. Returns True when the
        prefix completed in place (pattern_step advanced past it)."""
        if not Global.enable_dist_inplace or n_steps <= 0:
            return False
        from wukong_tpu_torch.parallel.inplace import InplaceOverflow

        thr = max(int(Global.dist_inplace_rows), 1)
        pats = q.pattern_group.patterns[q.pattern_step:q.pattern_step
                                        + n_steps]
        first = pats[0]
        eng = self._inplace_engine()
        if q.result.col_num == 0:
            # fresh starts: const-anchored only — index origins scan whole
            # index lists (the heavies) and belong to the sharded chain
            if first.subject <= 0 or _is_index_pattern(first):
                return False
            if first.predicate > 0:
                # exact first fan-out, one owner CSR lookup — the entry
                # check (the reference sizes the same decision on fetch
                # length vs global_rdma_threshold)
                fan = len(eng.g.get_triples(
                    first.subject, first.predicate, first.direction))
                if fan > thr:
                    return False
            # versatile starts (p < 0): no cheap exact bound; the dynamic
            # abort below still caps the walk
        elif q.result.nrows > thr:
            return False  # seeded (UNION/OPTIONAL) child with a big table
        import copy

        snap_step = q.pattern_step
        snap_res = copy.deepcopy(q.result)
        target = q.pattern_step + n_steps
        from wukong_tpu_torch.runtime.resilience import charge_query, check_query

        tr = getattr(q, "trace", None)
        sp = (tr.start_span("dist.inplace", steps=n_steps,
                            rows_in=q.result.nrows)
              if tr is not None else None)
        try:
            while q.pattern_step < target:
                check_query(q, f"dist.inplace step {q.pattern_step}")
                eng._execute_one_pattern(q)
                charge_query(q, q.result.nrows,
                             f"dist.inplace step {q.pattern_step - 1}")
                if q.result.nrows > thr:
                    raise InplaceOverflow()
        except InplaceOverflow:
            q.pattern_step = snap_step
            q.result = snap_res
            if sp is not None:  # aborted to the collective chain
                tr.end_span(sp, ok=False, overflow=True)
            return False
        except BaseException:
            if sp is not None:
                tr.end_span(sp, ok=False, raised=True)
            raise
        if sp is not None:
            tr.end_span(sp, ok=True, rows_out=int(q.result.nrows))
        if q.result.blind and q.done_patterns():
            # blind parity with the collective chain (which never gathers
            # the table): count survives, rows are dropped. A pending attr
            # tail keeps the table — it still anchors the attr kernels.
            res = q.result
            nrows = res.nrows
            res.table = np.empty((0, res.col_num), dtype=np.int64)
            res.nrows = nrows
        self.last_chain_stats = {"mode": "inplace", "retries": 0,
                                 "exchanges": 0, "steps": n_steps,
                                 "rows": int(q.result.nrows)}
        self._last_plan = None  # bytes_model: no collective chain to model
        return True

    def _inplace_engine(self):
        from wukong_tpu_torch.parallel.inplace import InplaceEngine

        if not hasattr(self, "_inplace_eng"):
            self._inplace_eng = InplaceEngine(self.sstore.stores,
                                              self.str_server)
        return self._inplace_eng

    def _versatile_const_start(self, q: SPARQLQuery, pat) -> None:
        """Delegate to a CPU engine over the const's owner partition — the
        owner holds the full combined adjacency (vertices are placed by
        hash on both subject and object), and the CPU kernels carry the
        exact const_unknown_* semantics (incl. start_from_index rejection
        of malformed tpid starts)."""
        from wukong_tpu_torch.engine.cpu import CPUEngine
        from wukong_tpu_torch.utils.mathutil import hash_mod

        owner = int(hash_mod(int(np.int32(pat.subject)), self.D))
        if not hasattr(self, "_owner_hosts"):
            self._owner_hosts: dict = {}
        if owner not in self._owner_hosts:
            self._owner_hosts[owner] = CPUEngine(self.sstore.stores[owner],
                                                 self.str_server)
        self._owner_hosts[owner]._execute_one_pattern(q)

    def _execute_unions_dist(self, q: SPARQLQuery) -> None:
        """Each UNION branch is a distributed child seeded with the parent's
        result table (query.hpp:702-711 inherit_union); children recurse
        through the full state machine, so nested UNION/OPTIONAL work."""
        from wukong_tpu_torch.sparql.ir import Result

        assert_ec(q.result.attr_col_num == 0, ErrorCode.UNSUPPORT_UNION)
        q.union_done = True
        merged = None
        host = self._host()
        for sub_pg in q.pattern_group.unions:
            child = SPARQLQuery()
            child.pqid = q.qid
            child.pg_type = PGType.UNION
            child.pattern_group = sub_pg
            child.deadline = q.deadline  # children share the parent's budget
            # children rebind result state rather than mutate it, so the
            # parent table is shared by reference (no deepcopy of rows)
            child.result = Result(q.result.nvars)
            child.result.v2c_map = dict(q.result.v2c_map)
            child.result.col_num = q.result.col_num
            child.result.table = q.result.table
            child.result.nrows = q.result.nrows
            child.result.blind = False
            self._execute_sm(child, from_proxy=False)
            if child.result.status_code != ErrorCode.SUCCESS:
                raise WukongError(child.result.status_code,
                                  "union child failed")
            merged = host._merge_union(merged, child.result, q.result.nvars)
        q.result.v2c_map = merged.v2c_map
        q.result.col_num = merged.col_num
        q.result.set_table(merged.table)

    def _execute_optional_dist(self, q: SPARQLQuery) -> None:
        """OPTIONAL as a dedup-seeded distributed child + host left join
        (the shared engine-agnostic formulation, engine/optional_join.py)."""
        from wukong_tpu_torch.engine.optional_join import execute_optional_leftjoin

        execute_optional_leftjoin(
            q, self._host(),
            run_child=lambda c: self._execute_sm(c, from_proxy=False),
            str_server=self.str_server)

    # ------------------------------------------------------------------
    def load_cap_memo(self, path: str) -> None:
        """Load learned capacity classes persisted by a previous process:
        a cold process then runs each chain at its exact classes at once
        instead of an estimate class and an overflow retry."""
        import json as _json

        try:
            with open(path) as f:
                for ent in _json.load(f):
                    key = tuple(tuple(p) for p in ent["pats"])
                    caps = {}
                    for ck, v in ent["caps"].items():
                        kind, i = ck.split(":")
                        caps[(kind, int(i))] = int(v)
                    self._learned_caps.setdefault(key, caps)
        except FileNotFoundError:
            pass
        except Exception as e:
            from wukong_tpu_torch.utils.logger import log_warn

            log_warn(f"dist cap memo load failed: {e}")

    def save_cap_memo(self, path: str) -> None:
        import json as _json
        import os as _os

        try:
            data = [{"pats": [list(p) for p in key],
                     "caps": {f"{k}:{i}": int(v)
                              for (k, i), v in caps.items()}}
                    for key, caps in self._learned_caps.items()]
            tmp = path + ".tmp"
            _os.makedirs(_os.path.dirname(path) or ".", exist_ok=True)
            with open(tmp, "w") as f:
                _json.dump(data, f)
            _os.replace(tmp, path)
        except Exception as e:
            from wukong_tpu_torch.utils.logger import log_warn

            log_warn(f"dist cap memo save failed: {e}")

    def _run_device_bgp(self, q: SPARQLQuery, n_steps: int, seed=None) -> None:
        pats_key = tuple(
            (p.subject, p.predicate, int(p.direction), p.object)
            for p in q.pattern_group.patterns[
                q.pattern_step:q.pattern_step + n_steps])
        # learned caps apply only to unseeded chains, symmetric with the
        # write below: a seeded plan prepends init_rows (shifting every
        # step index) and carries a different parent table's cardinalities
        cap_override: dict = (dict(self._learned_caps.get(pats_key, {}))
                              if seed is None else {})
        if self.force_cap_override:
            cap_override.update(self.force_cap_override)
        self.force_cap_override = None
        from wukong_tpu_torch.runtime import faults
        from wukong_tpu_torch.runtime.resilience import (
            charge_query,
            check_query,
            retry_call,
        )

        seed_cache: dict = {}  # seed shards are retry-invariant; upload once
        for _attempt in range(8):
            check_query(q, f"dist.chain attempt {_attempt}")
            plan = self._build_plan(q, cap_override, n_steps, seed)
            args = self._chain_args(plan, seed, seed_cache)

            def _dispatch():
                # transient dispatch failures (injected chaos) retry with
                # backoff; the inputs are immutable, so a re-dispatch is
                # safe. Routed through the transport seam, the object the
                # fetch path routes through too
                faults.site("dist.chain_dispatch")
                return self.sstore.transport.dispatch(self._run_chain, plan,
                                                      args)

            out = retry_call(_dispatch, site="dist.chain_dispatch",
                             retry_on=(faults.TransientFault,),
                             deadline=getattr(q, "deadline", None))
            # the chain's one host read: counts and totals together
            host = torch.cat([out["n"].reshape(-1, 1).long(),
                              out["totals"].long()], 1).cpu().numpy()
            ns, totals = host[:, 0], host[:, 1:]  # totals [D, 2 * nsteps]
            S = len(plan.steps)
            over = False
            for i, s in enumerate(plan.steps):
                t = int(totals[:, i].max())
                if t > s.cap:
                    if t > self.cap_max:
                        raise CapacityExceeded(
                            f"intermediate result ({t:,} rows/shard) exceeds "
                            f"table_capacity_max ({self.cap_max:,})")
                    cap_override[("cap", i)] = K.next_capacity(
                        t, self.cap_min, self.cap_max)
                    over = True
                if s.exch_cap:
                    em = int(totals[:, S + i].max())
                    if em > s.exch_cap:
                        if em > self.cap_max:
                            raise CapacityExceeded(
                                f"exchange destination load ({em:,} rows) "
                                f"exceeds table_capacity_max ({self.cap_max:,})")
                        cap_override[("exch", i)] = K.next_capacity(
                            em, self.cap_min, self.cap_max)
                        over = True
            if not over:
                break
        else:
            raise WukongError(ErrorCode.UNKNOWN_PATTERN,
                              "distributed capacity retry limit exceeded")

        # chain observability: per step, the peak per-shard row load and
        # the peak per-destination exchange load against their classes
        S = len(plan.steps)
        step_stats = []
        for i, s in enumerate(plan.steps):
            st = {"kind": s.kind, "cap": s.cap,
                  "rows_peak_shard": int(totals[:, i].max()),
                  "rows_all_shards": int(totals[:, i].sum())}
            if s.exch_cap:
                st["exch_cap"] = s.exch_cap
                st["exch_peak_dest"] = int(totals[:, S + i].max())
            step_stats.append(st)
        self.last_chain_stats = {"retries": int(_attempt),
                                 "exchanges": sum(1 for s in plan.steps
                                                  if s.exch_cap),
                                 "steps": step_stats}
        self._last_plan = plan
        # learn EXACT classes for the next run of this chain (tighter
        # where the estimate over-padded, already-exact where it retried)
        learned = {}
        for i, s in enumerate(plan.steps):
            learned[("cap", i)] = K.next_capacity(
                max(int(totals[:, i].max()), 1), self.cap_min, self.cap_max)
            if s.exch_cap:
                learned[("exch", i)] = K.next_capacity(
                    max(int(totals[:, S + i].max()), 1),
                    self.cap_min, self.cap_max)
        if len(self._learned_caps) > 1024:
            self._learned_caps.clear()
        if seed is None:
            # seeded children sharing a pats key can carry very different
            # parent tables; learning from one would mis-size the next
            self._learned_caps[pats_key] = learned

        n_total = int(np.sum(ns))
        charge_query(q, n_total, "dist.chain")
        res = q.result
        res.v2c_map = dict(plan.v2c)
        res.col_num = plan.width
        if q.result.blind:
            res.nrows = n_total
        else:
            table = out["table"]
            parts = [table[d, :, : int(ns[d])] for d in range(self.D)]
            tab = (torch.cat(parts, 1).T.cpu().numpy() if parts
                   else np.empty((0, plan.width), np.int32))
            # device tables are int32; BLANK_ID must round-trip to its
            # uint32 host value (types.py BLANK_ID_I32)
            res.set_table(tab.astype(np.int64) & 0xFFFFFFFF)
        q.pattern_step += n_steps

    # ------------------------------------------------------------------
    def bytes_model(self) -> dict | None:
        """Host-side traffic model of the LAST executed chain: staged
        segment arrays read, sharded table state written at the capacity
        classes, and the capacity-PADDED exchange traffic (the all-to-all
        moves [D, W, exch_cap] per shard whatever the real row counts;
        expand_type_all gathers the whole table). Each array counted once;
        a lower bound on the real traffic of the chain."""
        plan = self._last_plan
        if plan is None:
            return None
        W = 4  # int32 device arrays
        D = self.D
        seg_b = tab_b = exch_b = 0
        width = 0
        cap_prev = 0
        for s in plan.steps:
            w_in = width
            if s.kind == "init_rows":
                width = s.width
                cap_prev = s.cap
                tab_b += W * D * width * s.cap
                continue
            if s.kind == "init_index":
                idx = self.sstore.index_list(s.pid, s.dir)
                seg_b += int(idx.edges.numel()) * W
                width = 1
                cap_prev = s.cap
                tab_b += W * D * s.cap
                continue
            if s.kind == "init_const":
                seg = self.sstore.segment(s.pid, s.dir)
                seg_b += int(seg.nbytes) if seg is not None else 0
                width = 1
                cap_prev = s.cap
                tab_b += W * D * s.cap
                continue
            if s.exch_cap:
                exch_b += W * D * D * w_in * s.exch_cap
            if s.kind == "expand_type_all":
                # allgather replication of the whole table to every shard
                exch_b += W * D * D * w_in * cap_prev
            if s.kind == "member_index":
                idx = self.sstore.index_list(s.pid, s.dir)
                seg_b += int(idx.edges.numel()) * W
            elif s.kind in ("expand_versatile", "expand_versatile_const"):
                vseg = self.sstore.versatile_segment(s.dir)
                seg_b += int(vseg.nbytes) if vseg is not None else 0
            else:
                seg = self.sstore.segment(s.pid, s.dir)
                seg_b += int(seg.nbytes) if seg is not None else 0
            if s.new_col:
                width += 2 if s.kind == "expand_versatile" else 1
            tab_b += W * D * (w_in * cap_prev + width * s.cap)
            cap_prev = s.cap
        return {"segment_bytes": int(seg_b), "table_bytes": int(tab_b),
                "exchange_bytes": int(exch_b),
                "total_bytes": int(seg_b + tab_b + exch_b)}

    # ------------------------------------------------------------------
    # plan building (host): pattern list -> step descriptors with capacities
    # ------------------------------------------------------------------
    def _build_plan(self, q: SPARQLQuery, cap_override: dict,
                    n_steps: int | None = None, seed=None) -> _Plan:
        plan = _Plan()
        v2c: dict[int, int] = {}
        width = 0
        aligned_col = None  # column rows are currently partitioned by
        est_rows = 1
        # upper bound on how many rows can share one value per column —
        # exchanges route equal values to one destination, so the hot-dest
        # load is bounded by est/D + the anchor column's multiplicity (the
        # University0-hub skew the reference absorbs via work stealing,
        # engine.hpp:186-207). Index/const starts yield unique values
        # (bound 1); expansions multiply every column's bound by the
        # segment's max degree, and the new column's bound is the REVERSE
        # segment's max degree times the anchor's. Unknown columns (seeds)
        # stay untracked -> the generic 4x-slack estimate.
        col_mult: dict[int, int] = {}
        MULT_CAP = 1 << 31

        def cap_for(i, est):
            return cap_override.get(("cap", i)) or K.next_capacity(
                max(int(est), self.cap_min), self.cap_min, self.cap_max)

        def exch_cap_for(i, col):
            got = cap_override.get(("exch", i))
            if got:
                return got
            base = max(est_rows // self.D * 4, self.cap_min)
            hot = col_mult.get(col)
            if hot is not None:
                base = max(base, min(int(hot), int(est_rows))
                           + est_rows // self.D * 2)
            return K.next_capacity(min(base, self.cap_max),
                                   self.cap_min, self.cap_max)

        patterns = q.pattern_group.patterns[
            q.pattern_step:(None if n_steps is None
                            else q.pattern_step + n_steps)]
        if seed is not None:
            seed_table, seed_v2c = seed
            v2c.update(seed_v2c)
            width = seed_table.shape[1]
            first = patterns[0]
            if first.subject < 0:
                anchor = v2c.get(first.subject, NO_RESULT)
            else:
                # index membership or c2k on a bound (seeded) object column
                anchor = v2c.get(first.object, NO_RESULT)
            assert_ec(anchor != NO_RESULT,
                      ErrorCode.UNSUPPORTED_SHAPE,
                      "seeded distributed chains must start from a pattern "
                      "anchored on a seeded column")
            est_rows = max(len(seed_table) // self.D, 1) * 2
            plan.steps.append(_Step(
                kind="init_rows", col=anchor, width=width,
                cap=self._seed_cap(seed_table, anchor)))
            aligned_col = anchor  # seed rows are sharded by the anchor owner
        for pat in patterns:
            i = len(plan.steps)  # step index (seeded chains prepend init_rows)
            s, p, d, o = pat.subject, pat.predicate, pat.direction, pat.object
            assert_ec(pat.pred_type == int(AttrType.SID_t),
                      ErrorCode.UNSUPPORTED_SHAPE,
                      "attr patterns are host-side in the distributed engine")
            if p < 0:
                # VERSATILE known_unknown_unknown (?x ?p ?y, x bound) and
                # known_unknown_const (?x ?p CONST): each shard expands
                # against its combined adjacency; a const object folds to an
                # equality filter inside the same program (beyond the
                # reference — its accelerator refuses every versatile
                # shape). A bound predicate or bound object stays host-side
                # (the CPU engine rejects those too).
                col = v2c.get(s, NO_RESULT) if s < 0 else NO_RESULT
                assert_ec(width > 0 and col != NO_RESULT and p not in v2c
                          and (o > 0 or o not in v2c),
                          ErrorCode.UNSUPPORTED_SHAPE,
                          "distributed versatile supports ?x ?p ?y / "
                          "?x ?p CONST with x bound and p fresh")
                exch_cap = 0
                if aligned_col != col:
                    exch_cap = exch_cap_for(i, col)
                vseg = self.sstore.versatile_segment(d)
                avg = vseg.avg_deg if vseg else 0.0
                est_rows = int(max(est_rows * max(avg, 0.1) * 2, 1))
                kind = "expand_versatile" if o < 0 else "expand_versatile_const"
                plan.steps.append(_Step(
                    kind=kind, pid=0, dir=d, col=col,
                    const=(o if o > 0 else 0),
                    cap=min(cap_for(i, est_rows), self.cap_max),
                    exch_cap=exch_cap, new_col=True))
                fwd_max = vseg.max_deg if vseg else 1
                for c in list(col_mult):
                    col_mult[c] = min(col_mult[c] * fwd_max, MULT_CAP)
                # the fresh columns' multiplicity bounds are unknown
                # (reverse combined degrees aren't tracked) — leave untracked
                v2c[p] = width
                width += 1
                if o < 0:
                    v2c[o] = width
                    width += 1
                aligned_col = col
                continue
            if i == 0 and seed is None and q.pattern_step == 0 \
                    and pat is patterns[0] and q.start_from_index():
                idx = self.sstore.index_list(s, d)
                est_rows = max(idx.total // self.D, 1) * 2
                step = _Step(kind="init_index", pid=s, dir=d,
                             cap=cap_for(i, est_rows))
                v2c[o] = 0
                width = 1
                col_mult[0] = 1  # index members are globally unique
                aligned_col = 0  # index lists are owner-local by construction
                plan.steps.append(step)
                continue
            if width > 0 and _is_index_pattern(pat):
                # mid-chain index membership (index_to_known,
                # sparql.hpp:138-163): keep rows whose bound object is in
                # the owner shard's local index list
                ocol = v2c.get(o, NO_RESULT)
                assert_ec(ocol != NO_RESULT, ErrorCode.VERTEX_INVALID,
                          "index pattern needs a bound object mid-chain")
                exch_cap = 0
                if aligned_col != ocol:
                    exch_cap = exch_cap_for(i, ocol)
                self.sstore.index_list(s, d)  # ensure staged
                plan.steps.append(_Step(
                    kind="member_index", pid=s, dir=d, col=ocol,
                    cap=cap_for(i, est_rows), exch_cap=exch_cap))
                aligned_col = ocol
                continue
            if width == 0:
                assert_ec(s > 0, ErrorCode.FIRST_PATTERN_ERROR)
                seg = self.sstore.segment(p, d)
                est_rows = int((seg.avg_deg if seg else 1) * 2)
                step = _Step(kind="init_const", pid=p, dir=d, const=s,
                             cap=cap_for(i, est_rows))
                v2c[o] = 0
                width = 1
                col_mult[0] = 1  # one const's neighbor list: unique values
                aligned_col = None  # rows sit on the const's owner, not col 0's
                plan.steps.append(step)
                continue

            if s > 0:
                # const_to_known mid-chain (sparql.hpp:138-163's c2k): the
                # membership "bound ?o in adj(const, p, d)" is exactly
                # "const in adj(?o, p, flip(d))" — a member step against the
                # reverse segment anchored on the bound object column
                ocol = v2c.get(o, NO_RESULT) if o < 0 else NO_RESULT
                assert_ec(ocol != NO_RESULT, ErrorCode.UNSUPPORTED_SHAPE,
                          "const subject mid-chain needs a bound object")
                fd = OUT if d == IN else IN
                exch_cap = 0
                if aligned_col != ocol:
                    exch_cap = exch_cap_for(i, ocol)
                self.sstore.segment(p, fd)  # ensure staged
                plan.steps.append(_Step(
                    kind="member", pid=p, dir=fd, col=ocol, vals_col=-1,
                    const=s, cap=cap_for(i, est_rows), exch_cap=exch_cap))
                aligned_col = ocol
                continue
            col = v2c.get(s, NO_RESULT)
            assert_ec(col != NO_RESULT, ErrorCode.UNSUPPORTED_SHAPE,
                      "distributed steps must anchor on a KNOWN subject")
            o_col = v2c.get(o, NO_RESULT) if o < 0 else NO_RESULT
            o_known = o < 0 and o_col != NO_RESULT

            type_all = (p == TYPE_ID and d == IN and o < 0 and not o_known)
            exch_cap = 0
            if not type_all and aligned_col != col:
                exch_cap = exch_cap_for(i, col)

            seg = self.sstore.segment(p, d)
            avg = seg.avg_deg if seg else 0.0
            if o < 0 and not o_known:  # expansion
                est_rows = int(max(est_rows * max(avg, 0.1) * 2, 1))
                kind = "expand_type_all" if type_all else "expand"
                step = _Step(kind=kind, pid=p, dir=d, col=col,
                             cap=min(cap_for(i, est_rows), self.cap_max),
                             exch_cap=exch_cap, new_col=True)
                if type_all:
                    col_mult.clear()  # allgather replication: bounds unknown
                else:
                    fwd_max = seg.max_deg if seg else 1
                    # host metadata only — staging the reverse segment to
                    # device for one scalar would waste HBM
                    rev_max = self.sstore.host_max_deg(p, OUT if d == IN else IN)
                    anchor_mult = col_mult.get(col)
                    for c in list(col_mult):
                        col_mult[c] = min(col_mult[c] * fwd_max, MULT_CAP)
                    if anchor_mult is not None:
                        col_mult[width] = min(anchor_mult * rev_max, MULT_CAP)
                v2c[o] = width
                width += 1
                aligned_col = width - 1 if type_all else col
            else:  # member filter
                step = _Step(kind="member", pid=p, dir=d, col=col,
                             vals_col=(o_col if o_known else -1),
                             const=(0 if o_known else o),
                             cap=cap_for(i, est_rows), exch_cap=exch_cap)
                aligned_col = col
            plan.steps.append(step)

        plan.width = width
        plan.v2c = v2c
        return plan

    # ------------------------------------------------------------------
    # the chain on the shard slots
    # ------------------------------------------------------------------
    def _chain_args(self, plan: _Plan, seed, seed_cache: dict) -> list:
        """Per step, what it reads: the seed's stacked (table, counts), a
        StackedIndex, or a StackedSegment (None when absent). Each
        segment's own probe bound and search depth travel with it, so a
        restaged segment (dynamic insert) is probed at its new bounds."""
        args = []
        for s in plan.steps:
            if s.kind == "init_rows":
                key = (s.col, s.cap)
                if key not in seed_cache:
                    seed_cache[key] = self._shard_seed(seed[0], s.col, s.cap)
                args.append(seed_cache[key])
            elif s.kind in ("init_index", "member_index"):
                args.append(self.sstore.index_list(s.pid, s.dir))
            elif s.kind in ("expand_versatile", "expand_versatile_const"):
                # the combined segment's OWN probe bound — segment(pid=0)
                # would resolve to nothing and truncate probes on a
                # hash-skewed versatile table
                args.append(self.sstore.versatile_segment(s.dir))
            else:
                args.append(self.sstore.segment(s.pid, s.dir))
        return args

    def _seed_cap(self, seed_table: np.ndarray, anchor: int) -> int:
        """Exact per-shard capacity for a seed table (host knows the counts)."""
        from wukong_tpu_torch.utils.mathutil import hash_mod

        if len(seed_table) == 0:
            return self.cap_min
        dest = hash_mod(seed_table[:, anchor].astype(np.int32), self.D)
        peak = int(np.bincount(dest, minlength=self.D).max())
        return K.next_capacity(max(peak, 1), self.cap_min, self.cap_max)

    def _shard_seed(self, seed_table: np.ndarray, anchor: int, cap: int):
        """[N, W] host rows -> ([D, W, cap] int32, [D] counts) on the mesh's
        device. Rows go to hash(anchor) % D, computed on the int32 view so
        host placement matches the exchange's ``remainder(table[col], D)``
        (BLANK_ID wraps to -1 on both sides)."""
        from wukong_tpu_torch.utils.mathutil import hash_mod

        W = seed_table.shape[1]
        t32 = seed_table.astype(np.int32)  # ids < 2^31; BLANK wraps to -1
        dest = hash_mod(t32[:, anchor], self.D)
        out = np.zeros((self.D, W, cap), dtype=np.int32)
        counts = np.zeros(self.D, dtype=np.int32)
        for d in range(self.D):
            rows = t32[dest == d]
            counts[d] = len(rows)
            out[d, :, : len(rows)] = rows.T
        return (K.upload(out, self.device), K.upload(counts, self.device))

    def _run_chain(self, plan: _Plan, args: list) -> dict:
        """Run every step of ``plan`` on every shard slot: step i on all
        shards before step i + 1. Returns the stacked state — "table"
        [D, W, C], "n" [D], "totals" [D, 2 * nsteps] (per step, the shard's
        expansion or received-row total, then its exchange's largest
        per-destination load) — with no host read."""
        D = self.D
        dev = self.device
        zeros = torch.zeros(D, dtype=I32, device=dev)
        table = None
        n = zeros
        totals = [zeros] * len(plan.steps)
        exch_totals = [zeros] * len(plan.steps)

        def per_shard(fn):
            """fn(d) -> (table, n[, total]) for every shard, stacked."""
            outs = [fn(d) for d in range(D)]
            return tuple(torch.stack([o[k] for o in outs])
                         for k in range(len(outs[0])))

        for i, s in enumerate(plan.steps):
            arg = args[i]
            if s.kind == "init_rows":
                table, n = arg
                totals[i] = n
                continue
            if s.kind == "init_index":
                lens = arg.real_lens
                table, n = per_shard(lambda d: K.init_from_list(
                    arg.edges[d], int(lens[d]), s.cap))
                totals[i] = torch.as_tensor(
                    np.minimum(lens, INT32_MAX).astype(np.int32), device=dev)
                continue
            if s.kind == "init_const":
                if arg is None:
                    table = torch.zeros((D, 1, s.cap), dtype=I32, device=dev)
                    n = zeros
                    continue
                const_tab = torch.full((1, 1), s.const, dtype=I32,
                                       device=dev)
                one = K.as_count(1, dev)
                table, n, tot = per_shard(lambda d: K.expand(
                    const_tab, one, *arg.shard(d), col=0, cap_out=s.cap,
                    max_probe=arg.max_probe))
                table = table[:, 1:, :]  # drop the const row
                totals[i] = tot
                continue

            if s.exch_cap:
                table, n, em, tot_recv = _exchange(table, n, s.col,
                                                   s.exch_cap, s.cap, D)
                exch_totals[i] = em
                totals[i] = torch.maximum(totals[i], tot_recv)

            if s.kind == "member_index":
                lens = arg.real_lens
                table, n = per_shard(lambda d: K.compact(
                    table[d], K.member_mask_list(table[d], n[d], s.col,
                                                 arg.edges[d], int(lens[d]))))
                continue

            if s.kind in ("expand_versatile", "expand_versatile_const"):
                fold = s.kind == "expand_versatile_const"
                if arg is None:
                    table = torch.cat([table, torch.zeros(
                        (D, 1 if fold else 2, table.shape[2]), dtype=I32,
                        device=dev)], 1)
                    n = zeros
                    continue

                def vers(d):
                    bline, bhi, edges, edges2 = arg.shard(d)
                    t, m, tot = K.expand2(table[d], n[d], bline, bhi, edges2,
                                          edges, col=s.col, cap_out=s.cap,
                                          max_probe=arg.max_probe)
                    if fold:
                        # known_unknown_const: keep value == const rows and
                        # drop the value row — the surviving table binds
                        # only the predicate column
                        keep = (torch.arange(s.cap, dtype=I32, device=dev)
                                < m) & (t[-1] == s.const)
                        t, m = K.compact(t, keep)
                        t = t[:-1]
                    return t, m, tot
                table, n, tot = per_shard(vers)
                totals[i] = torch.maximum(totals[i], tot)
            elif s.kind in ("expand", "expand_type_all"):
                if s.kind == "expand_type_all":
                    # every shard expands the same gathered table
                    g, gn = _allgather_rows(table, n)
                    table = g.expand(D, *g.shape)
                    n = gn.expand(D)
                if arg is None:
                    table = torch.cat([table, torch.zeros(
                        (D, 1, table.shape[2]), dtype=I32, device=dev)], 1)
                    n = zeros
                    continue
                table, n, tot = per_shard(lambda d: K.expand(
                    table[d], n[d], *arg.shard(d), col=s.col, cap_out=s.cap,
                    max_probe=arg.max_probe))
                totals[i] = torch.maximum(totals[i], tot)
            elif s.kind == "member":
                def member(d):
                    t = table[d]
                    if arg is None:
                        keep = torch.zeros(t.shape[1], dtype=torch.bool,
                                           device=dev)
                    else:
                        vals = (t[s.vals_col] if s.vals_col >= 0 else
                                torch.full((t.shape[1],), s.const, dtype=I32,
                                           device=dev))
                        keep = K.member_mask_known(
                            t, n[d], vals, *arg.shard(d), col=s.col,
                            max_probe=arg.max_probe, depth=arg.max_deg_log2)
                    return K.compact(t, keep)
                table, n = per_shard(member)

        return {"table": table, "n": n,
                "totals": torch.stack(totals + exch_totals, 1)}


def _is_index_pattern(pat) -> bool:
    """Type/predicate index pattern: tpid subject under rdf:type or
    __PREDICATE__ with a variable object."""
    from wukong_tpu_torch.types import is_tpid

    return (pat.subject > 0 and is_tpid(pat.subject)
            and pat.predicate in (PREDICATE_ID, TYPE_ID) and pat.object < 0)


class _ShardedAttrGraph:
    """Attribute lookups routed to the subject owner's partition — the same
    hash_mod placement build_partition uses for attr segments."""

    def __init__(self, stores: list):
        self.stores = stores
        self.D = len(stores)

    def get_attr(self, vid: int, aid: int, d: int = OUT):
        from wukong_tpu_torch.utils.mathutil import hash_mod

        return self.stores[int(hash_mod(int(vid), self.D))].get_attr(
            vid, aid, d)


# ---------------------------------------------------------------------------
# the collectives, over the shard slots' stacked tensors on one device
# ---------------------------------------------------------------------------


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along the last axis, int64."""
    c = torch.cumsum(x, -1, dtype=torch.int64)
    return c - x.long()


def _exchange(table, n, col: int, exch_cap: int, cap_new: int, D: int):
    """Repartition every shard's rows to the hash owners of ``col`` — the
    fork-join replacement (JAX ``_exchange`` under ``shard_map``).

    table: [D, W, C] (shard d's table is row d), n: [D]. Each shard builds
    its capacity-padded send buffer [D, W, exch_cap] (rows grouped by
    destination in a stable order, each destination's first exch_cap rows
    kept) and its per-destination counts; receiver r reads ``send[:, r]``
    and the counts sent to it, and compacts the live rows in sender order.
    Returns (table [D, W, cap_new], n [D], each sender's largest
    per-destination count [D], each receiver's total received [D]) — a
    total past cap_new, or a count past exch_cap, makes the host retry at
    exact capacities."""
    W, C = table.shape[1:]
    dev = table.device
    rows = torch.arange(C, dtype=torch.int64, device=dev)
    live = rows[None, :] < n[:, None]
    # torch.remainder is floored like jnp's %: BLANK_ID (-1) goes to D - 1
    dest = torch.where(live, torch.remainder(table[:, col], D), D).long()
    sd, order = torch.sort(dest, dim=1, stable=True)
    st = torch.gather(table, 2, order[:, None, :].expand(D, W, C))
    counts = torch.zeros((D, D + 1), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, dest, torch.ones_like(dest))
    counts = counts[:, :D]  # [src, dst]
    cumx = _excl_cumsum(counts)
    within = rows[None, :] - torch.gather(cumx, 1, sd.clamp(0, D - 1))
    ok = (sd < D) & (within < exch_cap)
    slot = torch.where(ok, sd * exch_cap + within,
                       D * exch_cap + (rows[None, :] & (K.DUMP - 1)))
    send = torch.zeros((D, W, D * exch_cap + K.DUMP), dtype=I32, device=dev)
    send.scatter_(2, slot[:, None, :].expand(D, W, C), st)
    send = send[:, :, : D * exch_cap].reshape(D, W, D, exch_cap)
    # the all-to-all: receiver r's block from sender s is send[s, :, r]
    recv = send.permute(2, 1, 0, 3).reshape(D, W, D * exch_cap)
    rcounts = counts.T  # [dst, src]
    cumr = _excl_cumsum(rcounts)
    r_in_blk = torch.arange(exch_cap, device=dev).repeat(D)
    blk = torch.arange(D, device=dev).repeat_interleave(exch_cap)
    valid = r_in_blk[None, :] < rcounts.clamp(max=exch_cap)[:, blk]
    pos = torch.where(valid, cumr[:, blk] + r_in_blk[None, :], cap_new)
    pos = torch.where(pos < cap_new, pos,
                      cap_new + (torch.arange(pos.shape[1], device=dev)
                                 & (K.DUMP - 1))[None, :])
    out = torch.zeros((D, W, cap_new + K.DUMP), dtype=I32, device=dev)
    out.scatter_(2, pos[:, None, :].expand(D, W, pos.shape[1]), recv)
    tot_recv = rcounts.sum(1).clamp(max=INT32_MAX)
    return (out[:, :, :cap_new], tot_recv.clamp(max=cap_new).to(I32),
            counts.max(1).values.to(I32), tot_recv.to(I32))


def _allgather_rows(table, n):
    """Replicate every shard's live rows to all shards (dispatch-to-all for
    type steps; JAX ``_allgather_rows``). table: [D, W, C], n: [D] ->
    (the gathered table [W, D*C], its row count): shards in order, each
    shard's live rows in order, zeros after."""
    D, W, C = table.shape
    dev = table.device
    flat = table.permute(1, 0, 2).reshape(W, D * C)
    blk = torch.arange(D, device=dev).repeat_interleave(C)
    r_in = torch.arange(C, device=dev).repeat(D)
    valid = r_in < n.long()[blk]
    cumn = _excl_cumsum(n.long())
    size = D * C
    pos = torch.where(valid, cumn[blk] + r_in,
                      size + (torch.arange(size, device=dev) & (K.DUMP - 1)))
    out = torch.zeros((W, size + K.DUMP), dtype=I32, device=dev)
    out.scatter_(1, pos[None, :].expand(W, size), flat)
    return out[:, :size], n.long().sum().clamp(max=INT32_MAX).to(I32)
