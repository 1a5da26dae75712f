"""Runtime knobs the port reads (a subset of the JAX package's ``Global``).

Mirrors the reference's two-tier config (core/global.hpp:29-124,
core/config.hpp:42-235) as the JAX package's config.py does: key-value
settings loaded from a config file or string, split into settings that are
immutable after boot and settings that the console's ``config -s`` reloads
at runtime (config.hpp:183-198).

Only the fields this package consults live here; each keeps the JAX
package's name and default, so one config file means the same thing to
both packages. A key the port does not have is warned about and skipped, as
the reference skips unknown items. No knob routes a CUDA tensor to a plain
PyTorch version: on the card every kernel of the path is the hand-written
one.
"""

from __future__ import annotations

from dataclasses import dataclass, fields


@dataclass
class GlobalConfig:
    # ---- immutable after boot (config.hpp:42-110) ----
    num_engines: int = 4  # host engine threads of the engine pool
    # graph partitions: one shard slot each of the distributed engine's
    # mesh (the console's -w); 1 serves one partition
    num_workers: int = 1
    # the device engine is built (the name is the JAX package's; here the
    # card is an H100)
    enable_tpu: bool = True
    # device segment-cache budget in GiB (LRU eviction above it); the name
    # is the JAX package's, the budget is the card's memory
    tpu_mem_cache_gb: int = 4

    # ---- mutable at runtime (config.hpp:112-151) ----
    enable_planner: bool = True
    # planner-proved-empty queries answer without device work
    enable_empty_shortcircuit: bool = True
    # CORUN at the planner's marked step (host engine, sparql.hpp:816-936)
    enable_corun: bool = False
    # blind mode: replies carry the row count, not the table
    silent: bool = True
    # owner-routed in-place execution for small-table distributed chains
    # (reference need_fork_join, sparql.hpp:802-814, and proxy owner
    # routing, proxy.hpp:201-219): a chain whose live table stays under
    # dist_inplace_rows rows runs host-side with per-row owner-routed reads
    # and no exchange; growing past it aborts back to the collective chain
    enable_dist_inplace: bool = True
    dist_inplace_rows: int = 16384
    # distributed generic join: the most slices a cyclic query over a
    # sharded store fans out to on the heavy lane, bounded by the shard
    # count and the pool's live engines; 1 runs one slice
    join_dist_parts: int = 4

    # ---- fault tolerance (parallel/sharded_store.py) ----
    # hosts holding each logical shard's data; 1 = no replication (a
    # failed shard fetch substitutes an empty shard and flags the reply
    # incomplete); k > 1 fails over to a replica and the proxy's heal
    # watcher rebuilds the primary. Immutable: replicas are cloned when the
    # sharded store is built
    replication_factor: int = 1
    # ---- the data plane's transport (runtime/transport.py; mutable) ----
    # "loopback" executes shard fetches in process against the local
    # store; "socket" arms the framed TCP path to registered worker peers
    # (a peerless shard is served locally)
    transport_mode: str = "loopback"
    # socket send/recv and connect timeouts: a timeout is a TransientFault
    # for retry_call and the per-(peer, shard) breaker
    transport_timeout_ms: int = 2000
    transport_connect_timeout_ms: int = 1000
    # ceiling on one wire frame, enforced on encode and decode
    transport_max_frame_mb: int = 64
    # host engine work stealing: 0 pair, 1 ring (engine.hpp:186-207)
    stealing_pattern: int = 0
    # stage every segment of a chain before its first step runs
    gpu_enable_pipeline: bool = True
    # sort-merge executor for replicate index batches (else the eager
    # probe chain with a qid column)
    enable_merge_join: bool = True
    # stream-emit kernels for dense expansions inside the merge executor
    enable_stream_expand: bool = True

    # ---- resilience knobs (runtime/resilience.py; all mutable) ----
    # per-query wall-clock deadline in ms; 0 disables. Checked at every BGP
    # step and chain attempt; expiry keeps a partial result.
    query_deadline_ms: int = 0
    # per-query intermediate-row work budget; 0 disables. Every BGP step and
    # device chain charges its output rows.
    query_budget_rows: int = 0
    # on deadline/budget expiry keep the rows produced so far and tag the
    # reply incomplete instead of clearing the table
    enable_partial_results: bool = True
    # circuit breaker (the batcher's fused dispatches): consecutive
    # failures before it opens, and how long it stays open before a
    # half-open trial
    breaker_threshold: int = 3
    breaker_cooldown_ms: int = 5000
    # retry with exponential backoff + jitter (retry_call: the HDFS
    # client's invocations)
    retry_max_attempts: int = 3
    retry_base_ms: int = 10
    retry_max_ms: int = 2000

    # ---- durability (store/wal.py, runtime/recovery.py; all mutable) ----
    # write-ahead log for mutations (dynamic inserts): "" disables (the
    # default — the mutation hook degrades to one str check). Records are
    # length-prefixed + CRC-checksummed, appended BEFORE the mutation is
    # acknowledged, rotated at wal_segment_mb, and truncated behind
    # checkpoints.
    wal_dir: str = ""
    # fsync policy: none (OS buffering), interval (at most once per
    # wal_sync_interval_s), always (every append)
    wal_sync: str = "none"
    wal_sync_interval_s: int = 1
    wal_segment_mb: int = 64
    # checkpoints (partitions with their dynamic deltas): directory ("" =
    # off) and the periodic checkpointer cadence (0 = the console's
    # `checkpoint` verb only)
    checkpoint_dir: str = ""
    checkpoint_interval_s: int = 0

    # ---- lock-order checking (analysis/lockdep.py): read when a lock is
    # created; off gives plain threading primitives ----
    debug_locks: bool = False

    # ---- serving caches: bounded-LRU sizes of the proxy's parse cache
    # (query text -> parsed query) and plan cache (template signature +
    # store version -> plan recipe) ----
    parse_cache_size: int = 512
    plan_cache_size: int = 512
    # ceiling on the slice count suggest_index_batch may pick for a heavy
    # (index-origin) query
    heavy_batch_max: int = 64

    # ---- serving-path batching (runtime/batcher.py) ----
    # coalesce live same-template queries into fused dispatches; off, the
    # serving path never reaches the batcher
    enable_batching: bool = False
    # how long the first query of a group waits for company before the
    # group flushes anyway
    batch_window_us: int = 2000
    # a group reaching this many members flushes at once
    batch_max_size: int = 64
    # a query whose deadline has less than this many windows left skips
    # the batcher
    batch_deadline_bypass_factor: int = 4
    # the heavy lane: identical index-origin blind queries coalesce into
    # one sliced execute_batch_index dispatch (with enable_batching)
    heavy_lane: bool = True
    # index lists at least this long split a fused heavy dispatch across
    # pool engines by slice range, into at most heavy_split_max parts
    heavy_split_threshold: int = 100000
    heavy_split_max: int = 4
    # at most this percent of pool engines (min 1) run heavy-lane items at
    # once, so heavy work never takes every engine from light traffic
    heavy_lane_pct: int = 50
    # plan-time lane routing: a template whose estimated peak rows reach
    # this is heavy even without an index-origin start
    heavy_rows_threshold: int = 100000

    # ---- device-engine knobs ----
    # smallest / largest binding-table capacity class (rows); the largest
    # bounds every intermediate result of one device chain
    table_capacity_min: int = 1024
    table_capacity_max: int = 1 << 25
    # const-start instances answered together by one execute_batch
    device_batch: int = 1024

    # ---- the device-cost observatory (obs/device.py; all mutable):
    # dispatch accounting, the compile ledger and the residency ledger.
    # Off, every seam is one knob check. ----
    enable_device_obs: bool = True
    # device-resident byte ceiling the residency ledger reports against
    # (telemetry only; DeviceStore's own budget keeps enforcing)
    device_budget_mb: int = 4096
    # a dispatch site minting more than this many distinct (template,
    # capacity class) variants in one window journals a
    # device.variant_storm event and dumps the trace ring
    device_variant_limit: int = 32
    # seconds between variant-storm trips per site
    device_storm_cooldown_s: float = 60.0

    # ---- execution strategies (join/, engine/template_compile.py; all
    # mutable) ----
    # auto (the planner routes wcoj on a cyclic shape whose estimated walk
    # blowup reaches wcoj_ratio), walk, or wcoj (every supported shape)
    join_strategy: str = "auto"
    # auto routes wcoj when the estimated peak rows reach this multiple of
    # the estimated final rows
    wcoj_ratio: int = 4
    # ... and the estimated peak reaches this many rows
    wcoj_min_rows: int = 8192
    # bounded cache of sorted edge tables / index lists (entries)
    join_table_cache: int = 64
    # wcoj level route: host (NumPy kernels), device (every level through
    # the level probe), auto (device when the estimated candidate volume
    # reaches join_device_min_candidates)
    join_device: str = "auto"
    # under auto, the device route's candidate floor (per plan and per
    # level); measured feedback demotes an over-estimated template
    join_device_min_candidates: int = 65536
    # whole-plan compiled template route: host (the walk), device (every
    # eligible template), auto (device when the estimated peak rows reach
    # template_min_rows, with measured-feedback demotion)
    template_device: str = "auto"
    template_min_rows: int = 4096
    # overflow regrows before a compiled run degrades to the walk
    template_capacity_retries: int = 3
    # byte budget of cached compiled programs and their staged operands
    template_budget_mb: int = 256
    # a template site whose padding efficiency falls below this after
    # warm-up is demoted to the walk
    template_demote_eff: float = 0.02

    # ---- the hybrid graph+vector plane (vector/; all mutable) ----
    # master switch: off, a query with a knn() clause is refused
    # (ATTR_DISABLE), and every other query never looks at the vector plane
    enable_vectors: bool = False
    # fixed embedding width of every attached vector store; an upsert of
    # any other width is refused
    vector_dim: int = 64
    # k-NN similarity when a clause names none: cosine | dot | l2 (l2 ranks
    # by NEGATIVE squared distance, so higher = nearer for all three)
    knn_metric: str = "cosine"
    # k-NN scan route: host (NumPy), device (the knn_scan kernel), auto
    # (device when the live vectors reach knn_split_threshold, demoted to
    # host by the measured feedback of a failed device scan)
    knn_device: str = "auto"
    # live vectors at which a scan-side knn is wide: it goes down the
    # pool's heavy lane in slices; under auto also the device route's floor
    knn_split_threshold: int = 65536

    # ---- tracing and the flight recorder (obs/trace.py, obs/recorder.py;
    # all mutable) ----
    # per-query tracing; off, every hook is one getattr or knob check
    enable_tracing: bool = False
    # sample 1 in N queries (per trace kind) while tracing is on
    trace_sample_every: int = 1
    # completed traces kept in the flight recorder's ring
    trace_ring: int = 64
    # a traced query slower than this dumps its trace (0 disables);
    # QUERY_TIMEOUT, BUDGET_EXCEEDED and SHARD_UNAVAILABLE always dump
    trace_slow_ms: int = 1000
    # directory for JSON trace dumps ("" = in memory only; the
    # WUKONG_TRACE_DIR environment variable stands for it when empty)
    trace_dump_dir: str = ""
    # keep at most this many trace_*.json files there, oldest evicted
    # first (0 = unbounded)
    trace_dump_max: int = 256
    # rows shown per section by the report verbs (slo, admission, events)
    top_k: int = 8

    # ---- latency attribution (obs/profile.py; all mutable): each traced
    # reply's latency split into queue/parse/plan/execute/fetch against a
    # rolling per-template baseline, a regression dumping its trace ----
    enable_attribution: bool = False
    attribution_window: int = 256
    attribution_min_samples: int = 32
    attribution_share_drift_pct: int = 25
    attribution_p95_drift_pct: int = 100
    attribution_cooldown_s: int = 30

    # ---- the cluster-event journal (obs/events.py; all mutable) ----
    enable_events: bool = True
    events_ring: int = 512
    # JSONL mirror of every journaled event ("" = in memory only)
    events_log_path: str = ""

    # ---- the tenant SLO plane (obs/slo.py; all mutable) ----
    # per-tenant accounting at the proxy's reply point and the overload
    # signal bus the admission controller reads
    enable_tenant_accounting: bool = True
    # distinct tenant labels before new tenants land in "__overflow__"
    max_tenants: int = 64
    # ";"-separated "<tenant>:<percentile>:<latency_ms>:<availability>"
    slo_specs: str = ""
    # per-tenant reply samples kept for compliance and percentiles
    slo_window: int = 512
    # burn-rate windows (seconds) and thresholds (x the sustainable
    # budget-consumption rate); the sentinel pages when both exceed theirs
    slo_fast_window_s: int = 300
    slo_slow_window_s: int = 3600
    slo_burn_fast_x: int = 14
    slo_burn_slow_x: int = 6
    # per-tenant sentinel re-arm delay: one burn episode, one dump
    slo_dump_cooldown_s: int = 60

    # ---- the metrics time-series ring (obs/tsdb.py; all mutable): sample
    # the registry every tsdb_interval_s seconds into a bounded ring
    # tsdb_retention_s deep (windowed rates and percentiles: the `history`
    # verb, the reuse observatory's trend). One snapshot an interval, on a
    # daemon thread. ----
    enable_tsdb: bool = True
    tsdb_interval_s: int = 5
    tsdb_retention_s: int = 900

    # ---- the heat and placement observatory and the HTTP plane
    # (obs/heat.py, obs/placement.py, obs/httpd.py; all mutable) ----
    # per-shard heat: every charge (a vector scan's rows and bytes, its
    # latency) lands in per-shard counters, the wukong_shard_heat_*
    # metrics and the /top report
    enable_heat: bool = True
    # per-shard latency / arrival samples kept for the heat CDFs
    heat_window: int = 512
    # observe-only placement advisor: read the heat plane's
    # PLACEMENT_INPUTS through the tsdb trend window (placement_window_s
    # seconds), score the max/mean host load-rate imbalance of an attached
    # sharded store, and emit a MigrationPlan when it reaches
    # placement_imbalance_x (never touching the store).
    # placement_interval_s > 0 runs the advisory loop in the background;
    # 0 advises on demand only (/plan, the `plan` verb)
    placement_interval_s: int = 0
    placement_window_s: int = 300
    placement_imbalance_x: float = 2.0
    # ---- the live shard-migration actuator (runtime/migration.py; all
    # mutable) ----
    # execute the placement advisor's MigrationPlans (clone -> catch-up ->
    # cutover -> retire). Off by default: the advisor stays observe-only
    # and both the `migrate` verb and the executor refuse to move shards.
    # On with placement_interval_s > 0 runs the actuator loop
    migration_enable: bool = False
    # on: the cutover demotes the donor copy to a read-rotation replica on
    # its old host (reads split across donor and recipient, the plan's
    # predicted-balance model); off retires the donor copy outright
    migration_rotate_reads: bool = True
    # the scrape endpoint (GET /metrics, /top, /plan, /healthz, ...): 0 =
    # off; loopback unless metrics_host widens it (the endpoint has no
    # auth)
    metrics_port: int = 0
    metrics_host: str = "127.0.0.1"
    # /healthz answers 503 while degraded (dead pool engines) instead of
    # 200 with the degraded set in its body
    health_ready_503: bool = False
    # the registry's JSON snapshot written to metrics_snapshot_path every
    # metrics_snapshot_s seconds during emulator runs (0 = off)
    metrics_snapshot_s: int = 0
    metrics_snapshot_path: str = ""

    # ---- the serving-cache observatory (obs/reuse.py; all mutable): the
    # template popularity ledger and the observe-only shadow cache charged
    # at the proxy's reply point (key = plan signature + constants + store
    # version, the result cache's key; no result is stored). Off, every
    # hook, the mutation paths' invalidation notes included, is one knob
    # check. ----
    enable_reuse: bool = True
    # per-template arrival samples kept for the windowed rate
    reuse_window: int = 512
    # distinct templates before new ones land in "__overflow__"
    reuse_templates_max: int = 256
    # shadow key ring capacity (the simulated cache's entry budget)
    shadow_cache_size: int = 4096
    # sample the shadow probe 1 in N replies (the ledger charge always runs)
    reuse_sample_every: int = 1

    # ---- the serving plane (serve/; all mutable) ----
    # the version-keyed full-result cache in the proxy's reply path. Off,
    # the serving path is unchanged; on, it admits only what the reuse
    # observatory's ledger vouches for (enable_reuse off: nothing)
    enable_result_cache: bool = False
    # result bytes held (LRU past it; one entry at most a quarter of it)
    result_cache_mb: int = 64
    # a reply is cached once its template has this many ledger reads,
    # counting the reply itself
    result_cache_min_reads: int = 1
    # promote templates that stay hot across version edges into views kept
    # by semi-naive delta evaluation, so their entries survive writes
    enable_views: bool = False
    # version-edge refills a template needs before promotion
    view_promote_edges: int = 2
    # demote a view touched on more than this percent of its edges (after
    # 8 edges)
    view_demote_touch_pct: int = 60
    # most views maintained at once
    views_max: int = 64
    # cost-aware admission and eviction (recompute us per byte held)
    result_cache_cost_model: bool = True

    # ---- the device trace (obs/export.py): a torch.profiler capture of
    # run_single_query's execution is written here as a Chrome trace
    # ("" = the WUKONG_XPROF_DIR environment variable, else no capture) ----
    xprof_dir: str = ""

    # ---- the admission control plane (runtime/admission.py; all
    # mutable; off, every hook is one knob check) ----
    enable_admission: bool = False
    # ";"-separated "<tenant>:<weight>:<qps>:<inflight>:<rows_per_s>"
    admission_quotas: str = ""
    admission_default_weight: int = 1
    # token-bucket burst, in multiples of a tenant's q/s quota
    admission_burst_x: float = 2.0
    # the worst lane queue-delay EWMA against this budget (and in-flight
    # and queued depth against the in-flight ceiling) sets the overload
    # level: each doubling past it is one rung
    admission_delay_budget_us: int = 20000
    # in-flight ceiling; 0 derives 4 x the live pool engines, or 8
    admission_max_inflight: int = 0
    # rung 1's defer; 0 derives 2 x batch_window_us
    admission_defer_ms: int = 0
    # rung 2's tightened deadline and row budget
    admission_partial_deadline_ms: int = 250
    admission_partial_budget_rows: int = 200000
    # rung 3's retry-after hint (seconds) on the CAPACITY_EXCEEDED reply
    admission_retry_after_s: float = 1.0
    # DRR credits a round per unit of tenant weight
    admission_drr_quantum: int = 1

    _IMMUTABLE = {"num_workers", "num_engines", "enable_tpu",
                  "tpu_mem_cache_gb", "replication_factor"}

    def _names(self) -> set:
        return {f.name for f in fields(self) if f.init}

    def _apply(self, key: str, value: str, runtime: bool) -> None:
        key = key.removeprefix("global_")
        if key not in self._names():
            raise KeyError(f"unknown config item: {key}")
        if runtime and key in self._IMMUTABLE:
            raise ValueError(f"config item '{key}' is immutable at runtime")
        cur = getattr(self, key)
        if isinstance(cur, bool):
            setattr(self, key,
                    value.strip().lower() in ("1", "true", "yes", "on"))
        elif isinstance(cur, int):
            setattr(self, key, int(value))
        elif isinstance(cur, float):
            setattr(self, key, float(value))
        else:
            setattr(self, key, value.strip())

    def load_str(self, text: str, runtime: bool = False) -> None:
        """Parse 'key value' lines (comments with #) — config.hpp:152-181.

        Every item is parsed and validated before any is applied, so a bad
        line leaves the config untouched; unknown keys warn and are skipped.
        """
        from wukong_tpu_torch.utils.logger import log_warn

        items: list[tuple[str, str]] = []
        for line in text.splitlines():
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split(None, 1)
            if len(parts) != 2:
                raise ValueError(f"malformed config line: {line!r}")
            items.append((parts[0], parts[1]))
        valid = self._names()
        known = [(k, v) for k, v in items if k.removeprefix("global_") in valid]
        for k, _v in items:
            if k.removeprefix("global_") not in valid:
                log_warn(f"unknown config item ignored: {k}")
        # validate before applying (immutability + int parse)
        for k, v in known:
            key = k.removeprefix("global_")
            if runtime and key in self._IMMUTABLE:
                raise ValueError(f"config item '{key}' is immutable at runtime")
            cur = getattr(self, key)
            if isinstance(cur, int) and not isinstance(cur, bool):
                int(v)  # raises ValueError on junk before anything is applied
            elif isinstance(cur, float):
                float(v)
        for k, v in known:
            self._apply(k, v, runtime)

    def load_file(self, path: str, runtime: bool = False) -> None:
        with open(path) as f:
            self.load_str(f.read(), runtime=runtime)

    def dump(self) -> str:
        return "\n".join(f"global_{f.name}\t{getattr(self, f.name)}"
                         for f in fields(self) if f.init)


# process-wide singleton, mirroring `Global::*` statics (global.hpp:29-74)
Global = GlobalConfig()


def load_config(path: str, num_workers: int | None = None) -> GlobalConfig:
    """Boot-time load of a config file and the launcher's worker count
    (config.hpp:203-218)."""
    Global.load_file(path)
    if num_workers is not None:
        Global.num_workers = num_workers
    return Global


def reload_config(text: str) -> GlobalConfig:
    """Runtime reload of mutable settings (config.hpp:183-198)."""
    Global.load_str(text, runtime=True)
    return Global
