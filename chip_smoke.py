"""Drive the PyTorch/CUDA port (wukong_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--scale 640] [--cross-scale 40] [--seed 0] [--out PATH]

Phases (any failure exits nonzero, and no result line is printed):
  1. device: the card's name and power limit; build the CUDA kernels from
     wukong_tpu_torch/csrc with nvcc and print the build time and the
     build cache's outcome (hit or miss), which the device observatory's
     boot counter (wukong_device_compile_cache_total, site boot) must
     show;
  2. kernels: each hand-written kernel (K1 probe, K2 stream emit, K3 m-hot
     stream emit) against its plain PyTorch version on the card, exactly, on
     adversarial cases; K1 also on probe stress cases (a dense frontier of
     2^21 rows all hitting, about four a bucket; keys of -1 against empty
     lanes; three and more probe rounds; ragged and misaligned frontiers; n
     at 0, 1, C - 1 and C) and K2/K3 on look-back stress cases (2^25 edges,
     ragged lengths, cap_out cuts), each run 10 times with identical bits;
     stream_expand on duplicate anchors at each multiplicity, and with
     looser bounds (2 over distinct anchors, past mdup, none, a lower
     bound past mdup), each giving the exact bound's bits; the level probe
     (csrc/level_probe.cu) against level_probe_plain bit for bit on
     level_probe_cases at about 3,000 and 1,050,000 candidates (an empty
     candidate list and all-padding groups, an empty glob and an empty
     edge table, anchors absent from the keys, degree-1 and maximum-degree
     runs and depth 1, ids at 2^31 - 1, J = 1, 2 and 3 with and without a
     glob, J = 9 past the kernel's 8 descriptors a launch; candidates in
     runs of one anchor over runs of 1, 31, 32 and 33 edges at converging
     and short depths, one anchor across warp boundaries, candidates
     sorted, reverse-sorted and shuffled, globs of 1 value and globs
     packed for the kernel's bit index or spread past it; the larger
     cases again in 2^21 slots, the tiled kernel's, with and without the
     tables' bit indices); and knn_scan
     (csrc/knn_scan.cu) against knn_scan_plain on knn_case_inputs (n = 0,
     1 and 1,000,003; every row dead; k past the live rows; k = 1, 257 and
     n; integer ties, bit for bit; extreme norms and zero rows; slot lists;
     widths on both load paths; the GraphRAG slice, m around one block's
     rows, k = 32, 33 and 256, ties across block boundaries, an all-dead
     slice) and slices merged into the single scan; and expand_rows
     (csrc/expand_rows.cu, expand's row plan and gathers after K1) against
     expand_rows_plain on expand_rows_cases (a row with no edges, the light
     flight's 1,024-row table, totals past cap_out and past 2^31, the
     one-launch tile exactly and one row past it, one row owning every slot
     of three tiles, neighbors past the edge array, a strided view, a wide
     cap_out, 2^18 rows), each three times;
  3. store: synthesize LUBM-<scale> and its attributes from the seed, build
     the partition, and stage every segment the seven LUBM shapes touch on
     the card; the build and staging must take native/'s paths (and phases
     4-5's stagings too), with the set-up times and the host CPU printed;
  4. serve: the seven LUBM shapes through Proxy.serve_query (rows, median
     latency of 5 runs) and the index-origin shapes through
     Proxy.serve_batch_index in replicate mode; every per-qid count must equal
     the single-query row count, and every kernel's launch count must rise.
     Each kernel is then held against its plain version on the largest
     input this phase gave it, and timed there (CUDA events around 25 calls
     made back to back, per call, the median of 3 such runs);
  5. extended: the extended suite (OPTIONAL, UNION, FILTER, ORDER BY,
     attributes, variable predicates) through Proxy.serve_query, each shape
     with status 0 and rows, the median of 5 runs split on the host clock
     into the device chain (the engine's device prefixes, seeded children
     included, each ending in its sync) and the host stages (StageClock);
     K1 must probe the combined (versatile) segment, which must stay
     resident on the card, and each kernel is held against its plain
     version and timed on the largest input of each class of its calls in
     this phase (K1: predicate segments, the combined segment);
  Phases 7-10 (and phase 8's q1) hold the walk's mechanisms and are pinned
  to it (join_strategy walk, template_device host; a line says so): at
  default knobs the planner's other strategies would serve q1, q2 and q6.
  7. batched serving (run after 5, on phase 3's store): Stats.generate over
     the same triples (timed) and the type-centric planner on the proxy and
     its engine; each shape's plan beside the heuristic's; the seven shapes
     single under the planner (rows as in phase 4); the light TEMPLATES
     (placeholders filled from the type index, B = Global.device_batch
     constants drawn from the seed) through execute_batch, the in-flight
     window execute_batch_many (K = 8) and one execute_batch_mixed flight,
     with queries/s, host syncs a flight, and 64 constants a template held
     against their single queries; the index-origin shapes through
     execute_batch_index in replicate mode (suggest_index_batch's B), its
     window (K = 2) and slice mode (heavy_index_batch's B and 8), replicate
     counts equal to the single rows and slice counts summing to them. K1
     must be launched by the slice batches; each kernel the phase launched
     is held against its plain version and timed on its largest input;
     every window and mixed flight must make one host sync; then every
     entry point once more, untimed, under StreamAudit (each streamed
     step against the arm the frontier's true multiplicity picks);
  8. the serving runtime (run after 7, on phase 3's proxy): with
     table_capacity_max (the GPU engine's and the knob) at FALLBACK_CAP_MAX,
     q6 and q1 answer CAPACITY_EXCEEDED on the GPU engine; Proxy.
     run_single_query answers q6 in full through the compiled-template
     route at default knobs (as the JAX proxy does), and q1, pinned to the
     walk, phase 4's rows through the host engine, logged; then the
     console's sparql-emu (5 s after 1 s of warm-up, 8 in flight) over a
     light mix (TEMPLATES) and a mixed one (and HEAVY), which must end
     with no error, every light class on device batches and every heavy
     class run, on device batches or a logged pool route, with thpt_qps,
     wall_qps, host syncs a flight and each class's p50/p99; K1 must
     launch, and each kernel is held against its plain version and timed
     on each mix's largest input; then each mix for 3 s more, untimed,
     under StreamAudit;
  9. live serving with coalescing (run after 8, on phase 3's proxy and
     planner): bench.py --serve-batched's light texts (?s advisor <a>, the
     first 512 anchors) from 16 clients through Emulator.run_serving
     (Proxy.serve_query, 5 s after 1 s of warm-up, seed 1) with
     enable_batching off and on, then --serve-mixed's workload (the same
     texts and two index-origin 3-hop heavies at 30% of arrivals, 24
     clients, the engine pool started) with the heavy lane off, on (at
     the default threshold LUBM-640's heavy dispatches split 4 ways), on
     with no split (heavy_split_max 1), and with its split forced
     (heavy_split_threshold 1, heavy_split_max 2).
     Every run: qps, p50, p99 (by class in the mixed runs), the batcher's
     counters (occupancy, flushes by reason, fused queries, bypasses,
     heavy dispatches by mode, slices); zero errors, every reply its
     text's direct row count, no fused or heavy fallback, no capacity
     degradation and no inline run after a failed lane submit; K1
     launched in each workload; batching on coalesces (fused queries,
     mean occupancy > 1), the heavy lane fuses members, the forced split
     splits. Each run ends
     with a single-client replay: host syncs per fused (or direct)
     dispatch, and 64 fused light members' rows equal to the direct path's
     as multisets, or 8 heavy members' counts. Each kernel call is classed
     as a fused light group's, a heavy slice's or a direct dispatch's, and
     each kernel is held against its plain version and timed on each
     class's largest input. Before the runs the HTTP plane (obs/httpd.py)
     starts on a free loopback port and the metrics ring samples every
     TSDB_INTERVAL_S; a scraper GETs every endpoint in ENDPOINTS in turn
     (SCRAPE_PAUSE_S between rounds) through the runs: every reply 200,
     every JSON body parsed, latencies printed; it stops before phase 10;
 10. multi-tenant serving (run after 9, on phase 3's proxy and planner,
     the engine pool started and batching on): Emulator.run_tenants over
     phase 9's light texts with the default classes (gold 2 clients, p95
     50 ms, 0.999; silver 2, 500 ms, 0.99; bulk 4, 0.9), 3 s after 1 s:
     A normal (no errors); B chaos (transient faults at proxy.serve with
     p = 0.25: gold and silver alert, bulk does not, one SLO_BURN dump
     each, each dumped trace JSON and carrying fault.injected); C the 2x
     overload drill with admission armed (TENANT_QUOTAS, in-flight
     ceiling 6: gold compliant and never partial or rejected, bulk shed);
     D as C with bulk sending the two heavy texts through the heavy lane
     (gold and silver without errors, the per-tenant heavy slots settled
     to zero). Every run: every served complete reply its text's direct
     count, no fused or heavy fallback, no capacity degradation, no inline
     run, K1 launched; the admission report printed. Then EXPLAIN ANALYZE
     of the seven shapes (phase 7's rows, the decomposition within the
     total), a single-threaded replay with tracing off and on (64 light
     texts direct and as one fused group, the heavy texts direct and as
     one heavy group: equal host syncs, 1 a direct light query and 2 a
     fused group; every trace JSON, every span attribute a host scalar;
     proxy.parse, proxy.plan, gpu.execute and gpu.chain on a direct
     trace, batch.settled on every member; median latency off and on),
     and a device trace (xprof_dir) of q6 and q2 through run_single_query
     whose Chrome trace holds CUDA kernels, K1 among q2's, with each
     query's kernels by device time. Each kernel the phase launched is
     held against its plain version and timed on its largest input;
11. the planner's other two execution strategies (run after 10, on phase
     3's proxy and phase 7's planner): (a) q1, q2 and q6 through
     Proxy.serve_query at default knobs, three calls each, every call's
     strategy, level route and template route equal to what the planner's
     rules give on the store's statistics and the feedback rules give after
     the call before, per-level candidates, rows and route, the demotion
     log lines, ms, host syncs and level_probe launches (which must rise
     where a level routes device), rows equal to phase 7's; (b) q1 and q2
     with join_strategy wcoj and join_device device, every level probed on
     the card, rows equal to the walk's; (c) the JAX bench's triangle
     (m = 2,000, and 5,600, the largest m whose walk fits the 2^25-row
     ceiling), diamond and clique4 worlds from the port's datagen: WCOJ on
     the device route against the walk (rows equal, times), and two calls
     at default knobs with wukong_join_demotions_total; (d) q1, q2 and q6
     through the compiled template (template_device device): rows equal to
     the host walk's in its order, one host sync a dispatch, the padding
     efficiency, and one forced regrow that still matches; (e) the device
     console verb and EXPLAIN ANALYZE's device table for q1. The three
     strategy fallback counters must not move; the resident bytes by kind
     are printed. Each level probe class is held against its plain version
     and timed on its largest input;
  6. cross-check: at LUBM-<cross-scale> the seven shapes and the extended
     suite through Proxy(device="cpu") (plain versions) and
     Proxy(device="cuda") must give equal row multisets and attribute
     tables, and equal row order where ORDER BY fixes it; then, both under
     the planner, equal per-qid counts from every batched entry point;
     then phase 8's console: write_dataset writes LUBM-<cross-scale> to a
     temporary directory and console.main([config, dir, "-c",
     "sparql -b <file>"]) runs the seven shapes with -n 5 on the card,
     with phase 6's rows, the average latency run_single_query logs, and
     K1 launched, the console lockdep-checked under a burst of scrapes of
     every endpoint (no lock-order cycle, no leaf inversion, and every
     render plane's ledger lock tracked); and phase
     10's EXPLAIN of the seven shapes, equal on cpu and cuda under one
     planner;
 13. the hybrid graph+vector plane (run after 11, on phase 3's proxy and
     phase 7's planner; bench.py --graphrag's mix): (a) every professor
     embedded (make_vectors, dim 64), the GraphRAG mix from 8 clients (3 s
     after 1 s) with knn_device auto, the hybrid scans sliced on the heavy
     lane: qps, p50 and p99 by kind, 0 errors, 8 replies equal to the host
     route's; (b) every other entity embedded (about 5.4 GB on the card),
     a whole-block scan for each metric at k = 10 and at k = BIG_K through
     Proxy.serve_query, ids equal to topk_host's; (c) pattern-then-rank
     (a department's members, every GraduateStudent) through the slot-list
     path, rows equal to the host route's; (d) the drill (demoted, the
     memo latched to host, the host's rows), no other demotion, and the
     2-hop micro's bands overlapping with vectors off and on; (e) the
     vector store detached, memory_allocated falling by its staged bytes.
     knn_scan must launch in (a), (b) and (c); each class of its calls is
     held against the plain version and timed. The scraper runs again
     through the phase, with the metrics snapshot written every
     SNAPSHOT_S; after it /top.json's shard 0 must hold one vector fetch a
     scan and the rows scanned, as the smoke counts scan_topk's and
     sliced_topk's calls itself (ScanCount), /device.json's trend
     dispatches, /plan.json (a fresh sweep) the advisor's no-store status,
     and the snapshot file must parse. Then, with the proxy idle,
     IDLE_ROUNDS rounds of every endpoint with no kernel launch, no host
     sync and no CUDA allocation; and python -m wukong_tpu_torch.analysis
     --json over the port's tree must report 0 violations;
 14. the serving caches and streams (run after 13, on phase 3's proxy,
     whose store its writes mutate): (a) bench.py --readmostly's drill
     (Emulator.run_readmostly: four light families, READMOSTLY_ANCHORS
     anchors each, Zipf 1.2, seed 7, write rates 0 / 2% / 8% from a
     WRITE_POOL of seeded store triples, tenants gold and bulk), shadow
     only (predicted hit rate >= 0.5, the rate falls as writes rise, the
     store's digest unchanged over the read-only phase) and then with the
     result cache and views on (every measured reply identical to an
     uncached one, the real hit rate at least the shadow's, at most 15
     points lower at 8% writes; cached and uncached q/s printed; its
     one-pattern texts are host CSR lookups and launch no kernel);
     HIT_TEXTS two-pattern texts executed once (K1 launched on their
     misses), then HIT_BURST pure hits over them with no kernel launch and
     no host sync; the cache and history verbs; (b) the
     stream: STREAM_EPOCHS epochs of STREAM_ROWS new edges among existing
     entities on the pool's stream lane, STANDING's four queries (two in
     a tumbling window, one with base triples), STREAM_CLIENTS light
     clients meanwhile (STREAM_CLIENT_GAP_S between a client's replies);
     the device frontier ran every epoch and each
     epoch's seed rows equal the host twin's; the standing results equal
     one-shots (S1, S2 on the host and on the card; S3, S4 over the live
     window). Then phase 3's proxy is dropped, and memory_allocated must
     fall to within 64 MiB of its value before phase 3 (else what holds
     the rest is printed);
 15. the distributed engine (run after 14's drop): the same triples in
     DIST_SHARDS partitions on the card, L1-L7 as the JAX bench's --dist,
     both routes, -d dist, q2's K1 launches and trace, WCOJ over the
     shards, the shard-down drill, the hot spot;
 16. live migration and shard healing (run after 15, on its world):
     (a) Emulator.run_rebalance (MIGRATE_OPS Zipf fetches, a = 1.6, seed
     7) executed through the migration actuator, rounds of the advisor's
     plan until the imbalance falls under placement_imbalance_x, L1-L7
     through -d dist with phase 4's rows after every phase; (b) a `load
     -d` batch on the donor in round 1's dual-write window, read back
     through the new primary on the card (both rotation turns) and on the
     host route, the primary's digest equal to the donor copy's; (c) a
     second shard's plan aborted after its cutover, the donor serving
     again; (d) a DistEngine with replication 2 behind a Proxy and
     Emulator.run_drill on shard HEAL_SHARD over L1-L7: complete through
     the outage, rebuilt on the pool's rebuild lane, the breaker closed,
     /healthz's shards cleared, the verify round as the baseline; (e)
     K1 on every shard of q2's chain after the cutover and after the
     heal. Then both phases' engines are dropped, with the check of 14;
 12. data in and durability (run last, each world built from the seed,
     served and dropped in turn, pinned to the walk except where a route
     is forced): (a) WatDiv-<WATDIV_SCALE> (about 10 M triples) with the
     planner's Stats, the twelve S/F templates filled by fill_template
     from the seed through Proxy.serve_query (median of 5, rows equal to
     the host CPUEngine's) and in batches of B = 1,024 constants; (b) the
     YAGO-shaped world at n_person YAGO_PERSONS, YAGO_QUERIES against the
     host engine with no capacity fallback, the index-origin ones also
     as a replicate batch of 1; (c) the DBpedia-shaped world, the five
     DBPSB_SHAPES built in the port's IR against the host engine, and
     the world written as id_*.nt files read back through native/'s
     parse_id_triples, equal; (d)
     WatDiv rebuilt from a seeded 90% of its triples, the other 10%
     written to three directories and inserted by the console's `load -d`
     under wal_sync none, interval and always (insert rate, the first
     query's ms and restaged bytes against its steady ms,
     memory_allocated after each round, bounded by the staged bytes'
     growth), rows then equal to (a)'s full store; `load -d -c` of the
     whole delta gives 0 new edges; gsck passes; WCOJ on the device and
     the compiled template forced, rows equal to the walk's; (e)
     a standing query registered, `checkpoint`, STANDING_EPOCHS stream
     epochs, one more seeded batch and a WAL-logged batch of
     VECTORS_AFTER_CKPT embeddings, the proxy dropped, a fresh one over
     the 90% base, `recover`: gstore_digest, the vector store's digest,
     a knn reply, the twelve templates' rows, and the standing query's
     registry, rows and sink equal to the dropped store's, the one vector
     record and the epochs replayed; checkpoint, WAL and
     recover costs printed. K1 and the level probe must launch, the three
     fallback counters must not move; K2/K3 launches are logged.
The line before the last is one JSON object {"kernels": [...]}, a row for
each kernel and class of its calls in phases 4 and 5, for each kernel in
phase 7, for each kernel and mix (and the console) in phase 8, and for
each kernel and class of its calls in phase 9, for each kernel in phase
10, for each kernel and class of its calls in phase 11 (the level probe
by call site and part), for each class of knn_scan's calls in phase 13,
for each kernel phase 14 launched, for each kernel and part of phases
15 and 16, and for each kernel phase 12 launched, with
that row's launches, input ("phase", "input"), bound and times; the last is
{"ok": true, "device": {...}}. The script needs the repository around it
and a CUDA GPU; it imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import weakref

# phase 8's lowered ceiling: below q6's 1,630,592 index rows and q1's
# largest table at LUBM-640
FALLBACK_CAP_MAX = 1 << 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# the kernels do integer work on the CUDA cores; the data sheet gives no
# int32 rate, so the float32 rate outside the tensor cores stands for it (an
# upper bound on the integer rate, so the time bound stays a lower bound)
CORE_OPS_PER_S = 67e12

PREFIX = """
PREFIX rdf: <http://www.w3.org/1999/02/22-rdf-syntax-ns#>
PREFIX ub: <http://swat.cse.lehigh.edu/onto/univ-bench.owl#>
"""
# the LUBM basic-suite shapes (Wukong's lubm_q1..q7)
QUERIES = {
    "lubm_q1": PREFIX + """SELECT ?X ?Y ?Z WHERE {
        ?X rdf:type ub:GraduateStudent . ?Y rdf:type ub:University .
        ?Z rdf:type ub:Department . ?X ub:memberOf ?Z .
        ?Z ub:subOrganizationOf ?Y . ?X ub:undergraduateDegreeFrom ?Y . }""",
    "lubm_q2": PREFIX + """SELECT ?X ?Y ?Z WHERE {
        ?X rdf:type ub:UndergraduateStudent . ?Y rdf:type ub:FullProfessor .
        ?Z rdf:type ub:Course . ?X ub:advisor ?Y . ?Y ub:teacherOf ?Z .
        ?X ub:takesCourse ?Z . }""",
    "lubm_q3": PREFIX + """SELECT ?X WHERE {
        ?X rdf:type ub:GraduateStudent .
        ?X ub:takesCourse
        <http://www.Department0.University0.edu/GraduateCourse0> . }""",
    "lubm_q4": PREFIX + """SELECT ?X ?Y1 ?Y2 WHERE {
        ?X ub:worksFor <http://www.Department0.University0.edu> .
        ?X rdf:type ub:FullProfessor . ?X ub:name ?Y1 .
        ?X ub:emailAddress ?Y2 . }""",
    "lubm_q5": PREFIX + """SELECT ?X WHERE {
        ?X ub:memberOf <http://www.Department0.University0.edu> . }""",
    "lubm_q6": PREFIX + """SELECT ?X WHERE {
        ?X rdf:type ub:GraduateStudent . }""",
    "lubm_q7": PREFIX + """SELECT ?X ?Y WHERE {
        ?X rdf:type ub:UndergraduateStudent . ?Y rdf:type ub:Course .
        <http://www.Department0.University0.edu/AssociateProfessor0>
        ub:teacherOf ?Y . ?X ub:takesCourse ?Y . }""",
}

DEPT0 = "<http://www.Department0.University0.edu>"
UNIV0 = "<http://www.University0.edu>"
# the extended suite: every query shape beyond the basic one that the JAX
# engine answers on one partition, modelled on Wukong's LUBM optional, union
# and attr suites (scripts/sparql_query/lubm/{optional,union,attr} upstream)
EXT_QUERIES = {
    "x_opt_light": PREFIX + f"""SELECT * WHERE {{
        ?X ub:memberOf {DEPT0} . OPTIONAL {{ ?X ub:advisor ?Y }} }}""",
    "x_opt_heavy": PREFIX + """SELECT ?S ?UG ?DOC WHERE {
        ?S ub:undergraduateDegreeFrom ?UG .
        OPTIONAL { ?S ub:doctoralDegreeFrom ?DOC } .
        FILTER (!bound(?DOC)) }""",
    "x_union": PREFIX + f"""SELECT ?X ?Z WHERE {{
        ?X ub:memberOf {DEPT0} .
        {{ ?X ub:undergraduateDegreeFrom ?Z }}
        UNION {{ ?X ub:mastersDegreeFrom ?Z }} }}""",
    "x_union_index": PREFIX + """SELECT ?X WHERE {
        { ?X rdf:type ub:FullProfessor } UNION { ?X rdf:type ub:Lecturer } }""",
    "x_filter": PREFIX + f"""SELECT ?X ?Y ?U ?D WHERE {{
        ?X ub:memberOf {DEPT0} . ?X ub:advisor ?Y .
        ?X ub:undergraduateDegreeFrom ?U . ?Y ub:doctoralDegreeFrom ?D .
        FILTER (?U != ?D) }}""",
    "x_order": PREFIX + f"""SELECT ?X ?N WHERE {{
        ?X ub:worksFor {DEPT0} . ?X ub:name ?N }}
        ORDER BY ?N LIMIT 3 OFFSET 1""",
    "x_attr": PREFIX + f"""SELECT ?X ?A WHERE {{
        ?X ub:memberOf {DEPT0} . ?X ub:age ?A . FILTER (?A > 20) }}""",
    "x_vers_kuu": PREFIX + f"""SELECT ?X ?P ?Y WHERE {{
        ?X ub:worksFor {DEPT0} . ?X ?P ?Y }}""",
    "x_vers_const": PREFIX + f"""SELECT ?P ?Y WHERE {{ {DEPT0} ?P ?Y }}""",
    "x_vers_const2": PREFIX + f"""SELECT ?P WHERE {{ {DEPT0} ?P {UNIV0} }}""",
    "x_vers_kuc": PREFIX + f"""SELECT ?X ?P WHERE {{
        ?X rdf:type ub:FullProfessor . ?X ?P {UNIV0} }}""",
    # the planner starts x_vers_kuc at its const object, so the equality
    # fold of expand2 needs a const start elsewhere in the chain
    "x_vers_kuc_fold": PREFIX + f"""SELECT ?X ?P WHERE {{
        ?X ub:worksFor {DEPT0} . ?X ?P {DEPT0} }}""",
}
ORDERED = ("x_order",)  # shapes whose row order the query fixes

# light templates: the basic suite's const-start shapes with their constant
# turned into a %placeholder, as Wukong's sparql-emu templates do
TEMPLATES = {
    "lubm_q3": PREFIX + """SELECT ?X WHERE {
        ?X rdf:type ub:GraduateStudent .
        ?X ub:takesCourse %ub:GraduateCourse . }""",
    "lubm_q4": PREFIX + """SELECT ?X ?Y1 ?Y2 WHERE {
        ?X ub:worksFor %ub:Department .
        ?X rdf:type ub:FullProfessor . ?X ub:name ?Y1 .
        ?X ub:emailAddress ?Y2 . }""",
    "lubm_q5": PREFIX + """SELECT ?X WHERE {
        ?X ub:memberOf %ub:Department . }""",
    "lubm_q7": PREFIX + """SELECT ?X ?Y WHERE {
        ?X rdf:type ub:UndergraduateStudent . ?Y rdf:type ub:Course .
        %ub:AssociateProfessor ub:teacherOf ?Y . ?X ub:takesCourse ?Y . }""",
}
HEAVY = ("lubm_q1", "lubm_q2", "lubm_q6")  # the index-origin shapes

KERNELS = {
    "probe_kernel": ("wukong_tpu_torch/csrc/probe.cu",
                     "wukong_tpu/engine/tpu_kernels.py:93"),
    "stream_emit": ("wukong_tpu_torch/csrc/stream_emit.cu",
                    "wukong_tpu/engine/tpu_stream.py:399"),
    "stream_emit_m": ("wukong_tpu_torch/csrc/stream_emit.cu",
                      "wukong_tpu/engine/tpu_stream.py:575"),
    # a hand kernel for an XLA computation (no Pallas kernel): the fused
    # jit_level_probe of the WCOJ device route, and the pair probes of the
    # JAX whole-plan template program
    "level_probe": ("wukong_tpu_torch/csrc/level_probe.cu",
                    "wukong_tpu/join/kernels.py:189"),
    # a hand kernel for the XLA k-NN scan (masked scores, then lax.top_k)
    "knn_scan": ("wukong_tpu_torch/csrc/knn_scan.cu",
                 "wukong_tpu/vector/knn.py:118"),
    # a hand kernel for the XLA row plan and gathers that follow K1 in a
    # known_to_unknown step
    "expand_rows": ("wukong_tpu_torch/csrc/expand_rows.cu",
                    "wukong_tpu/engine/tpu_kernels.py:311"),
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int = 25, warm: int = 3, runs: int = 3) -> float:
    """Device time of one fn() in ms: CUDA events around ``reps`` calls
    made back to back, over reps, the median of ``runs`` such runs. Back to
    back, the host enqueues the next call while the card runs this one, so
    the host's own time is not counted where the card's is longer."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def max_abs_diff(xs, ys) -> int:
    """Largest |x - y| over paired outputs (shapes must agree), computed on
    the first output's device."""
    worst = 0
    for x, y in zip(xs, ys):
        check(tuple(x.shape) == tuple(y.shape),
              f"shape mismatch {tuple(x.shape)} vs {tuple(y.shape)}")
        if x.numel():
            d = (x.long() - y.to(x.device).long()).abs().max().item()
            worst = max(worst, int(d))
    return worst


class Capture:
    """Wraps a kernel's module-level entry to keep, for each class of its
    main-path calls (``class_of``), the launches and the inputs of the
    largest call (by frontier or edge count). While wrapped, the kernel
    function counts its launches on the module attribute, i.e. on the
    wrapper; restore() adds them to the kernel function's own count. A
    call's launches are its thread's own (``cuda_lib.thread_launches``), so
    calls from concurrent serving threads are attributed exactly. While
    ``Capture.keep`` is off, calls are counted and no input is kept, so that
    phase 12's leak check reads a ``memory_allocated`` that holds nothing of
    the measurement's."""

    keep = True

    def __init__(self, module, attr: str, size_of, class_of=lambda a: ""):
        import threading

        from wukong_tpu_torch.engine import cuda_lib

        self.module, self.attr = module, attr
        self.orig = getattr(module, attr)
        self.best: dict = {}  # class -> (size, args, kw)
        self.launches: dict = {}  # class -> launches
        lock = threading.Lock()

        def wrapped(*args, **kw):
            cls, size = class_of(args), size_of(args)
            with lock:
                if Capture.keep and size > self.best.get(cls, (-1,))[0]:
                    self.best[cls] = (size, args, kw)
            before = cuda_lib.thread_launches()
            try:
                return self.orig(*args, **kw)
            finally:
                n = cuda_lib.thread_launches() - before
                with lock:
                    self.launches[cls] = self.launches.get(cls, 0) + n

        wrapped.launches = 0
        self.wrapped = wrapped
        setattr(module, attr, wrapped)

    def restore(self) -> None:
        setattr(self.module, self.attr, self.orig)
        self.orig.launches += self.wrapped.launches


def restore_all(captures) -> None:
    """Restore each Capture (in a function of its own: a loop variable of
    main() would keep the last one, and the inputs it holds, alive)."""
    for c in captures:
        c.restore()


def call_all(calls) -> None:
    """Make each call (the loop variable dies with this frame: the calls
    hold the proxy)."""
    for call in calls:
        call()


class StreamAudit:
    """While on, wraps tpu_stream.stream_expand and holds each call against
    the arms PR 5 chose by reading the frontier to the host: the rows of K3
    where the frontier's true multiplicity (the most live rows sharing one
    key with edges in the segment) is 2..mdup, else merge_expand's (K2's and
    the gather arm's bits); and each host bound against it (``mult`` at
    least the most, ``mult_lo`` at most the fewest). The true multiplicity
    is worked out on the card apart from stream_expand (a sort of the hit
    keys); every count stays on the card until report(). Run it outside
    timed work: it triples each streamed step's work."""

    def __init__(self, device="cuda"):
        import torch

        from wukong_tpu_torch.engine import tpu_stream as S

        self.S, self.orig = S, S.stream_expand
        self.mdup = S.stream_mdup()
        self.calls = 0
        # [host arm: K2 / K3 / gather / device choice][true: <= 1,
        # 2..mdup, > mdup]
        self.by_arm = torch.zeros(4, 3, dtype=torch.int64, device=device)
        self.unsound = torch.zeros((), dtype=torch.int64, device=device)
        self.differ = torch.zeros((), dtype=torch.int64, device=device)
        self.differ_low = torch.zeros((), dtype=torch.int64, device=device)

    @staticmethod
    def true_mult(skey, sdeg, cur, n, live):
        """(most, fewest) live rows sharing one key with edges in the
        segment, as 0-d tensors; (0, C + 1) when no key matches."""
        import torch

        C = cur.shape[0]
        idx = torch.arange(C, device=cur.device)
        pos = torch.searchsorted(skey, cur).clamp(max=skey.shape[0] - 1)
        hit = (idx < n) & live & (skey[pos] == cur) & (sdeg[pos] > 0)
        keys = torch.sort(torch.where(hit, cur.long(), -1 - idx)).values
        new_run = torch.ones(C, dtype=torch.bool, device=cur.device)
        new_run[1:] = keys[1:] != keys[:-1]
        last = torch.ones(C, dtype=torch.bool, device=cur.device)
        last[:-1] = new_run[1:]
        first = torch.cummax(torch.where(new_run, idx, 0), 0).values
        runs = idx - first + 1
        return (torch.max(torch.where(keys >= 0, runs, 0)),
                torch.min(torch.where((keys >= 0) & last, runs, C + 1)))

    def __enter__(self):
        import torch

        from wukong_tpu_torch.engine import tpu_kernels as K

        def audited(skey, sstart, sdeg, edges, cur, n, live, cap_out, mult,
                    mhot=True, mdup=self.mdup, mult_lo=1):
            args = (skey, sstart, sdeg, edges, cur, n, live)
            out = self.orig(*args, cap_out, mult, mhot=mhot, mdup=mdup,
                            mult_lo=mult_lo)
            true, fewest = self.true_mult(skey, sdeg, cur, n, live)
            k3 = self.orig(*args, cap_out, mdup, mhot=True, mdup=mdup)
            merge = K.merge_expand(*args, cap_out)
            use_k3 = (true >= 2) & (true <= mdup) & mhot
            bad = torch.stack([(got != torch.where(use_k3, a, b)).any()
                               for got, a, b in zip(out, k3, merge)]).any()
            self.differ += bad
            self.differ_low += bad & (true <= mdup)
            arm = (0 if mult is not None and mult <= 1 else
                   1 if mhot and mult is not None and mult <= mdup else
                   2 if not mhot or mult_lo > mdup else 3)
            self.by_arm[arm] += torch.stack(
                [true <= 1, (true >= 2) & (true <= mdup), true > mdup]).long()
            if mult is not None:
                self.unsound += true > mult
            self.unsound += fewest < mult_lo
            self.calls += 1
            return out

        self.S.stream_expand = audited
        return self

    def __exit__(self, *exc):
        self.S.stream_expand = self.orig

    def report(self, what: str) -> dict:
        """Reads the counts, fails on an unsound bound or on rows that
        differ from PR 5's arm, and logs the calls by arm."""
        import torch

        arms = self.by_arm.tolist()
        unsound, differ, low = (int(x) for x in torch.stack(
            [self.unsound, self.differ, self.differ_low]).tolist())
        out = {"calls": self.calls, "mdup": self.mdup,
               "k2": arms[0], "k3": arms[1], "gather": arms[2],
               "device_choice": arms[3],
               "unsound_bounds": unsound, "rows_differ": differ,
               "rows_differ_true_at_most_mdup": low}
        log(f"  stream arms, {what}: {self.calls} streamed steps; by host "
            f"arm, [true multiplicity <= 1, 2..{self.mdup}, > {self.mdup}]: "
            f"K2 {arms[0]}, K3 {arms[1]}, gather (lower bound past "
            f"{self.mdup}) {arms[2]}, device choice {arms[3]} (K3's rows up "
            f"to {self.mdup}, the gather's past it); rows other "
            f"than the true multiplicity's arm: {differ} ({low} of them "
            f"where K3's were due); bounds the true multiplicity breaks: "
            f"{unsound}")
        check(unsound == 0, f"stream arms, {what}: {unsound} host bounds "
              f"that the frontier's true multiplicity breaks")
        check(differ == 0, f"stream arms, {what}: {differ} calls' rows "
              f"differ from the arm the true multiplicity picks")
        return out


def probe_size(args) -> int:
    """K1's call size for Capture: the frontier's length C."""
    return args[2].shape[0]


def probe_class_of(proxy):
    """Capture's class of a K1 call: on a combined (versatile) segment of
    ``proxy``'s store, or on predicate segments."""
    cache = proxy.gpu.dstore._cache

    def probe_class(a) -> str:
        combined = any(k[0] == "vpv" and seg is not None
                       and seg.bline.data_ptr() == a[0].data_ptr()
                       for k, seg in list(cache.items()))
        return ", combined segment" if combined else ", predicate segments"

    return probe_class


# ---------------------------------------------------------------------------
# phase 2: adversarial kernel checks
# ---------------------------------------------------------------------------


def _lp_csr(rng, nkeys: int, maxdeg: int, idmax: int, keymax: int,
            big: bool = False, one_max: bool = False):
    """A random sorted CSR (keys, offsets, edges, depth) for the level
    probe cases: degrees 1..maxdeg (or all 1 but one run of maxdeg with
    ``one_max``), edges sorted unique within each run; ``big`` puts ids at
    2^31 - 1 and just below it in the keys and at the end of the runs."""
    import numpy as np

    top = 2**31 - 1
    keys = np.unique(rng.integers(0, keymax, 2 * nkeys))[:nkeys]
    rng.shuffle(keys)
    keys = np.sort(keys[:nkeys]).astype(np.int64)
    nkeys = len(keys)
    if big:
        keys[-2:] = (top - 1, top)
    if one_max:
        degs = np.ones(nkeys, dtype=np.int64)
        degs[nkeys // 2] = maxdeg
    else:
        degs = rng.integers(1, maxdeg + 1, nkeys)
    run = np.repeat(np.arange(nkeys), degs)
    vals = rng.integers(0, idmax, len(run))
    if big:
        vals[np.cumsum(degs) - 1] = top  # each run ends at 2^31 - 1
    order = np.lexsort((vals, run))
    run, vals = run[order], vals[order]
    keep = np.ones(len(run), dtype=bool)
    keep[1:] = (run[1:] != run[:-1]) | (vals[1:] != vals[:-1])
    run, edges = run[keep], vals[keep]
    degs = np.bincount(run, minlength=nkeys)
    offsets = np.zeros(nkeys + 1, dtype=np.int64)
    np.cumsum(degs, out=offsets[1:])
    depth = int(max(int(degs.max()) if nkeys else 1, 1)).bit_length() + 1
    return keys, offsets, edges.astype(np.int64), depth


def expand_rows_cases(seed: int = 0) -> list:
    """expand_rows' adversarial inputs, (label, table, start, deg, edges,
    cap_out) as CPU int32 tensors: a lone row with no edges, the light
    flight's 1,024-row table with a few live rows, totals past cap_out, the
    one-launch tile exactly and one row past it, several tiles with one row
    owning every slot, totals past 2^31 (saturated), neighbor indices past
    the edge array's end (clamped), a strided column view, a wide cap_out
    over a small table, and a table of 2^18 rows."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def case(label, C, W, deg, cap_out, E, start=None, table=None):
        deg = np.asarray(deg, dtype=np.int64)
        if start is None:
            start = rng.integers(0, max(E - int(deg.max(initial=0)), 1), C)
        if table is None:
            table = rng.integers(-5, 1 << 30, (W, C))
        return (label, torch.from_numpy(np.asarray(table, dtype=np.int32)),
                torch.from_numpy(np.asarray(start, dtype=np.int32)),
                torch.from_numpy(deg.astype(np.int32)),
                torch.from_numpy(rng.integers(0, 1 << 30, E)
                                 .astype(np.int32)), cap_out)

    def sparse(C, live, hi):
        d = np.zeros(C, dtype=np.int64)
        d[:live] = rng.integers(0, hi, live)
        return d

    out = [case("one row, no edges", 1, 1, [0], 1024, 16),
           case("flight: 1,024 rows, 37 live", 1024, 2, sparse(1024, 37, 4),
                1024, 5000),
           case("total past cap_out", 1024, 2, sparse(1024, 900, 7), 1024,
                8000),
           case("one tile exactly", 4096, 3, rng.integers(0, 6, 4096),
                16384, 30000),
           case("one row past the tile", 4097, 1, rng.integers(0, 3, 4097),
                1 << 13, 9000)]
    d = np.zeros(3 * 4096 + 17, dtype=np.int64)
    d[5000] = 60_000
    out.append(case("three tiles, one row owns every slot", len(d), 2, d,
                    1 << 16, 70_000))
    out.append(case("total past 2^31", 4, 2, [1 << 30, 1 << 30, 1 << 30, 5],
                    1024, 64, start=[0, 3, 60, 1]))
    out.append(case("neighbors past the edge array", 16, 1,
                    rng.integers(5, 12, 16), 1024, 20,
                    start=rng.integers(10, 20, 16)))
    wide = rng.integers(0, 1 << 20, (2, 3000))
    lbl, _t, st, dg, ed, cap = case("strided view", 1500, 2,
                                    sparse(1500, 1400, 4), 4096, 6000)
    out.append((lbl, torch.from_numpy(wide.astype(np.int32))[:, ::2], st, dg,
                ed, cap))
    out.append(case("wide cap_out", 1024, 1, sparse(1024, 1024, 3), 1 << 20,
                    4000))
    out.append(case("2^18 rows", 1 << 18, 2, rng.integers(0, 4, 1 << 18),
                    1 << 20, 1 << 20))
    return out


def expand_rows_work(args) -> tuple:
    """(bytes, operations, what) expand_rows needs: deg read over all C
    rows, the W values and the start of each row that owns a slot below
    cap_out, the edge of each filled slot, the W+1 output rows written over
    cap_out and the two counts; per row a scan add, per filled slot its
    index arithmetic and per slot a compare."""
    import torch

    table, start, deg, _edges, cap_out = args
    W, C = table.shape
    cum = torch.cumsum(deg.long(), 0)
    total = int(cum[-1])
    filled = min(total, cap_out)
    owners = int(((deg > 0) & (cum - deg < cap_out)).sum())
    nbytes = C * 4 + owners * (4 * W + 4) + filled * 4 \
        + (W + 1) * cap_out * 4 + 8
    return (nbytes, C + filled * 4 + cap_out,
            {"W": W, "C": C, "cap_out": cap_out, "total": total,
             "owner_rows": owners})


def level_probe_cases(scale: int = 1, seed: int = 0) -> list:
    """The level probe's adversarial cases, as NumPy arrays:
    [(name, valid bool [Cp], cand int32 [Cp], glob int32 | None,
    [(keys, offsets, edges, anchors [Cp], depth), ...], full_depth)].
    An empty candidate list and all-padding groups (padding slots hold
    garbage that ``valid`` must mask), an empty glob and an empty edge
    table, anchors absent from the keys, degree-1 runs beside a
    maximum-degree run searched at depth 1 (``full_depth`` False: the
    search stops short, as the kernel's must), ids at 2^31 - 1, J = 1, 2
    and 3 adjacencies with and without a glob, and J = 9 (past the kernel's
    8 descriptors a launch). Then the kernel's shared work: candidates in
    runs of one anchor (as WCOJ and a template's expand lay them out) over
    runs of exactly 1, 31, 32 and 33 edges, each at a depth that converges
    and one that stops short; one anchor whose run straddles warp
    boundaries; candidates sorted, reverse-sorted and shuffled; a glob of
    one value and globs dense enough for the kernel's bit index and too
    sparse for it, up to 2^31 - 1. ``scale`` multiplies the candidate
    counts (the card runs them at 2^20 and more, and widened to the tiled
    kernel's sizes by :func:`widen_case`). The tests hold the plain version
    against the JAX functions on the same cases."""
    import numpy as np

    rng = np.random.default_rng(seed)
    i32 = np.int32
    out = []

    def pack(name, C, adjs, glob=None, anchor_keys=True, full=True,
             Cp=None, order=None):
        from wukong_tpu_torch.join.kernels import pad_pow2

        Cp = Cp or pad_pow2(C)
        valid = np.zeros(Cp, dtype=bool)
        valid[:C] = True
        # padding slots hold garbage: valid alone must mask them
        cand = rng.integers(0, 2**31 - 1, Cp)
        probes = []
        if adjs:
            keys0, off0, e0, _d = adjs[0]
            # half the candidates are true edges of their anchor's run
            ka = rng.integers(0, max(len(keys0), 1), Cp)
            if len(keys0) and len(e0):
                lo, hi = off0[ka], off0[ka + 1]
                pick = lo + (rng.random(Cp) * (hi - lo)).astype(np.int64)
                true = rng.random(Cp) < 0.5
                cand = np.where(true, e0[np.clip(pick, 0, len(e0) - 1)],
                                cand)
        for keys, offsets, edges, depth in adjs:
            if anchor_keys and len(keys):
                anchors = keys[np.clip(ka, 0, len(keys) - 1)] \
                    if adjs[0][0] is keys else \
                    keys[rng.integers(0, len(keys), Cp)]
            else:
                anchors = rng.integers(0, 2**31 - 1, Cp)
                if len(keys):
                    anchors = np.where(np.isin(anchors, keys),
                                       anchors + 1, anchors)
            probes.append((keys.astype(i32), offsets.astype(i32),
                           edges.astype(i32), anchors.astype(i32), depth))
        if order is not None:  # permute the C live slots, anchors along
            perm = {"sorted": np.argsort(cand[:C], kind="stable"),
                    "reverse-sorted": np.argsort(cand[:C],
                                                 kind="stable")[::-1],
                    "shuffled": rng.permutation(C)}[order]
            cand[:C] = cand[:C][perm]
            for p in probes:
                p[3][:C] = p[3][:C][perm]
        g = None if glob is None else np.asarray(glob).astype(i32)
        out.append((name, valid, cand.astype(i32), g, probes, full))

    n = 3000 * scale
    base = _lp_csr(rng, 400 * scale, 12, 50_000, 100_000)
    # the same graph with a tenth of its edges dropped: a candidate true in
    # one adjacency fails another now and then
    k, o, e, d = base
    keep = rng.random(len(e)) >= 0.1
    deg = np.add.reduceat(keep.astype(np.int64), o[:-1]) if len(k) else o
    o2 = np.zeros_like(o)
    np.cumsum(deg, out=o2[1:])
    thin = (k, o2, e[keep], d)
    glob = np.unique(np.concatenate([base[2][::3],
                                     rng.integers(0, 50_000, 500)]))
    pack("empty candidate list", 0, [base])
    pack("all-padding group, glob", 0, [base, thin], glob=glob, Cp=4096)
    pack("empty glob", n, [base], glob=np.empty(0, np.int64))
    empty = (np.empty(0, np.int64), np.zeros(1, np.int64),
             np.empty(0, np.int64), 1)
    pack("empty edges", n, [empty])
    pack("empty edges beside a table", n, [base, empty], glob=glob)
    pack("anchors absent from keys", n, [base], anchor_keys=False)
    deep = _lp_csr(rng, 64, 4096, 1 << 20, 1 << 20, one_max=True)
    pack("degree-1 and max-degree runs", n, [deep])
    pack("degree-1 and max-degree runs, depth 1", n,
         [deep[:3] + (1,)], full=False)
    big = _lp_csr(rng, 300, 8, 2**31 - 1, 2**31 - 3, big=True)
    pack("ids at 2^31 - 1", n, [big], glob=np.unique(np.concatenate(
        [big[2][::2], [2**31 - 1]])))
    for J in (1, 2, 3):
        adjs = [base, thin, base][:J]
        pack(f"J={J}", n, adjs)
        pack(f"J={J}, glob", n, adjs, glob=glob)
    # past the kernel's 8 descriptors a launch: the wrapper chains a second
    # launch over the first one's mask
    pack("J=9, glob", n, [base, thin] * 4 + [thin], glob=glob)
    for order in ("sorted", "reverse-sorted", "shuffled"):
        pack(f"J=2, glob, candidates {order}", n, [base, thin], glob=glob,
             order=order)

    def runs(name, keys, offsets, edges, depths, groups, kx_of=None):
        """Candidates laid out as the WCOJ generator lays them out: groups
        of one anchor side by side (``groups`` sizes; ``kx_of`` each
        group's key index, random when None), each group's values its
        run's edges (true), those plus one (mostly false), values below
        and above the run, and garbage past C."""
        groups = np.asarray(groups, dtype=np.int64)
        C = int(groups.sum())
        Cp = pad_pow2(C)
        valid = np.zeros(Cp, dtype=bool)
        valid[:C] = True
        cand = rng.integers(0, 2**31 - 1, Cp)
        anchors = rng.integers(0, 2**31 - 1, Cp)
        if kx_of is None:
            kx_of = rng.integers(0, len(keys), len(groups))
        kx = np.repeat(np.asarray(kx_of), groups)
        lo, hi = offsets[kx], offsets[kx + 1]
        pick = lo + (rng.random(C) * (hi - lo)).astype(np.int64)
        kind = rng.integers(0, 4, C)
        vals = np.where(kind == 0, edges[pick],
                        np.where(kind == 1, edges[pick] + 1,
                                 np.where(kind == 2, edges[lo] - 1,
                                          edges[hi - 1] + 1)))
        cand[:C] = np.clip(vals, 0, 2**31 - 1)
        anchors[:C] = keys[kx]
        for depth in depths:
            conv = int(depth) >= int(
                (offsets[1:] - offsets[:-1]).max(initial=1)).bit_length()
            out.append((name + f", depth {depth}" + ("" if conv else
                                                      " (stops short)"),
                        valid, cand.astype(i32), None,
                        [(keys.astype(i32), offsets.astype(i32),
                          edges.astype(i32), anchors.astype(i32), depth)],
                        conv))

    from wukong_tpu_torch.join.kernels import pad_pow2

    for n_run in (1, 31, 32, 33):
        nk = 200 * scale  # keys dense enough for a bit index at scale 350
        keys = np.sort(rng.choice(1 << 22, nk, replace=False))
        offsets = np.arange(nk + 1, dtype=np.int64) * n_run
        e = np.sort(rng.integers(0, 1 << 20, (nk, n_run)), axis=1)
        edges = (e + np.arange(n_run)).ravel()  # strictly rising runs
        conv = n_run.bit_length()
        groups = rng.integers(1, 45, max(n // 20, 1))
        runs(f"runs of {n_run} edges", keys, offsets, edges,
             sorted({conv, max(conv - 1, 1)}, reverse=True), groups)
    # one anchor whose run of 100 edges feeds a group that starts at lane
    # 20 and spans four warps, amid runs of 3
    nk = 64
    keys = np.sort(rng.choice(1 << 24, nk, replace=False))
    degs = np.full(nk, 3)
    degs[7] = 100
    offsets = np.zeros(nk + 1, dtype=np.int64)
    np.cumsum(degs, out=offsets[1:])
    edges = np.concatenate([np.sort(rng.choice(1 << 22, dg, replace=False))
                            for dg in degs])
    kx_of = rng.integers(0, nk, 2 + 40 * scale)
    kx_of[1] = 7
    runs("one anchor across warp boundaries", keys, offsets, edges,
         (7, 4), [20, 120] + [3] * (40 * scale), kx_of)
    # globs: one value (2^31 - 1); values packed closely enough for the
    # kernel's bit index (a word a 32 ids), at the top of int32 and at its
    # bottom; values spread over all of int32 (searched); candidates on
    # members, their neighbours and garbage, sorted as a generator leaves
    # them
    top = 2**31 - 1
    for G, where in ((1, "top"), (4096, "top"), (40_000 * scale, "bottom"),
                     (40_000 * scale, "spread")):
        span = {"top": 8 * G, "bottom": 8 * G, "spread": top}[where]
        gv = np.unique(rng.integers(0, span, G + G // 8 + 8))[:G]
        gv = np.sort(top - gv) if where == "top" else gv
        if where != "bottom":
            gv[-1] = top
        C = n
        Cp = pad_pow2(C)
        valid = np.zeros(Cp, dtype=bool)
        valid[:C] = True
        kind = rng.integers(0, 4, Cp)
        member = gv[rng.integers(0, G, Cp)]
        cand = np.where(kind == 0, member, np.where(
            kind == 1, member - 1, np.where(
                kind == 2, member + 1, rng.integers(0, top, Cp))))
        cand = np.clip(cand, 0, top)
        cand[:C] = np.sort(cand[:C])  # as a generator's run order leaves it
        out.append((f"glob of {G} values, {where}", valid,
                    cand.astype(i32), gv.astype(i32), [], True))
    return out


def widen_case(case, cap: int):
    """A level probe case padded to ``cap`` slots (the template's padded
    capacities): the same live rows, garbage repeated past them."""
    import numpy as np

    name, valid, cand, glob, adj, full = case
    if cap <= len(valid):
        return case
    wide = np.zeros(cap, dtype=bool)
    wide[:len(valid)] = valid
    return (f"{name}, in {cap}", wide, np.resize(cand, cap), glob,
            [(k, o, e, np.resize(a, cap), d) for k, o, e, a, d in adj], full)


def kernel_cases(errs: dict) -> None:
    import numpy as np
    import torch

    from wukong_tpu_torch.engine import tpu_kernels as K
    from wukong_tpu_torch.engine import tpu_stream as S
    from wukong_tpu_torch.engine.device_store import (build_hash_table,
                                                      line_table)

    dev = torch.device("cuda")
    rng = np.random.default_rng(1234)

    def t(a, d=dev):
        return torch.from_numpy(np.array(a)).to(d)

    def cmp(name, kern, plain, what):
        err = max_abs_diff(kern, plain)
        errs[name] = max(errs[name], err)
        check(err == 0, f"{name} != plain on {what} (max abs err {err})")

    # K1: a random table, then a table whose keys all share one home bucket
    keys = np.sort(rng.choice(1 << 28, 300_000, replace=False)) + (1 << 17)
    offs = np.concatenate([[0], np.cumsum(rng.integers(1, 9, len(keys)))])
    tables = [build_hash_table(keys, offs)]
    cand = np.arange(1 << 17, (1 << 17) + 40_000, dtype=np.int64)
    home = (cand.astype(np.uint32) * np.uint32(2654435761)) & np.uint32(7)
    tables.append(build_hash_table(np.sort(cand[home == 0][:40]),
                                   np.arange(41, dtype=np.int64) * 2, 8))
    check(tables[1][3] >= 4, "multi-round probe case has too few rounds")
    for ti, (bkey, bstart, bdeg, max_probe) in enumerate(tables):
        tk = [t(a) for a in line_table(bkey, bstart, bdeg)]
        live = bkey[bkey >= 0]
        for C, n, mix in ((1 << 16, 1 << 16, 0.5), (1000, 1000, 0.9),
                          (4096, 0, 0.5), (8192, 8192, 0.0),
                          (1 << 16, (1 << 16) - 77, 0.7)):
            cur = np.where(rng.random(C) < mix, rng.choice(live, C),
                           rng.integers(1 << 29, 1 << 30, C)).astype(np.int32)
            cur[:3] = [-1, 0, 2**31 - 1]  # empty-slot key, zero, the pad
            ct = t(cur)
            cmp("probe_kernel", K.probe_kernel(*tk, ct, n, max_probe),
                K.probe_plain(*tk, ct, n, max_probe),
                f"table {ti}, C={C}, n={n}, hits~{mix}")

    # K2 / K3 emits on raw delta channels: disjoint runs, a run spanning
    # many tiles, random deltas with negative prefixes and wrapping
    # parents, overflow past cap_out, ragged lengths
    for E in (1, 1023, 5000, 1 << 20):
        edges = rng.integers(0, 2**31 - 1, E).astype(np.int32)
        cases = []
        starts = np.sort(rng.choice(E, max(E // 10, 1), replace=False))
        ends = np.minimum(starts + rng.integers(1, 12, len(starts)), E)
        ends = np.minimum(ends, np.append(starts[1:], E))
        dsel = np.zeros(E + 1, np.int32)
        np.add.at(dsel, starts, 1)
        np.add.at(dsel, ends, -1)
        dpar = np.zeros(E + 1, np.int32)
        dpar[starts] = np.diff(np.concatenate([[0], rng.integers(0, 1 << 20,
                                                                 len(starts))]))
        cases.append(("runs", dsel[:E], dpar[:E]))
        big = np.zeros(E, np.int32)
        big[0] = 1
        cases.append(("one run", big, rng.integers(-5, 5, E).astype(np.int32)))
        cases.append(("random deltas",
                      rng.choice([-1, 0, 0, 1], E).astype(np.int32),
                      rng.integers(-2**31, 2**31 - 1, E).astype(np.int32)))
        cases.append(("empty", np.zeros(E, np.int32), np.zeros(E, np.int32)))
        for what, ds, dp in cases:
            for cap in (1024, max(E // 3, 1), 2 * E + 1024):
                args = (t(edges), t(ds), t(dp), cap)
                cmp("stream_emit", S.stream_emit(*args),
                    S.stream_emit_plain(*args), f"{what}, E={E}, cap={cap}")
                mult = ds.copy()
                mult[::97] += rng.integers(0, 3, len(mult[::97])).astype(
                    np.int32)
                args = (t(edges), t(mult), t(dp), cap)
                cmp("stream_emit_m", S.stream_emit_m(*args),
                    S.stream_emit_m_plain(*args),
                    f"m-hot {what}, E={E}, cap={cap}")

    # stream_expand end to end: duplicate anchors at multiplicity 2..mdup go
    # through K3; past mdup K3 and the gather arm both run and the device
    # takes the gather's rows; the card must equal the CPU (plain) bit for
    # bit in every arm
    nkeys = 20_000
    skeys = np.sort(rng.choice(1 << 24, nkeys, replace=False)).astype(np.int32)
    degs = rng.integers(0, 12, nkeys)
    soffs = np.concatenate([[0], np.cumsum(degs)])
    E = int(soffs[-1])
    Kp, Ep = 1 << (nkeys - 1).bit_length(), 1 << (E - 1).bit_length()
    seg = [np.full(Kp, 2**31 - 1, np.int32), np.zeros(Kp, np.int32),
           np.zeros(Kp, np.int32), np.full(Ep, 2**31 - 1, np.int32)]
    seg[0][:nkeys], seg[1][:nkeys], seg[2][:nkeys] = skeys, soffs[:-1], degs
    seg[3][:E] = rng.integers(0, 2**31 - 1, E)
    mdup = S.stream_mdup()
    for mult in [1] + list(range(2, mdup + 2)):
        C = 1 << 15
        picks = rng.choice(skeys, C // (mult + 1), replace=False)
        anchors = np.repeat(picks, mult)
        rng.shuffle(anchors)
        cur = np.full(C, 2**31 - 1, np.int32)
        cur[:len(anchors)] = anchors
        livem = rng.random(C) < 0.95
        n = len(anchors)
        before = S.stream_emit_m.launches
        outs = {}
        for d in ("cuda", "cpu"):
            outs[d] = S.stream_expand(
                *(t(a, d) for a in seg), t(cur, d), K.as_count(n, d),
                t(livem, d), cap_out=1 << 17, mult=mult, mhot=True,
                mdup=mdup)
        arm = "stream_emit" if mult == 1 else "stream_emit_m"
        err = max_abs_diff(outs["cuda"], outs["cpu"])
        errs[arm] = max(errs[arm], err)
        check(err == 0, f"stream_expand cuda != cpu at multiplicity {mult}")
        launched = S.stream_emit_m.launches > before
        check(launched == (mult >= 2),
              f"multiplicity {mult}: K3 launched={launched}, mdup={mdup}")
        if mult > mdup:  # the device picked the gather arm: merge's bits
            err = max_abs_diff(outs["cuda"], K.merge_expand(
                *(t(a) for a in seg), t(cur), K.as_count(n, dev), t(livem),
                cap_out=1 << 17))
            check(err == 0, "stream_expand past mdup != merge_expand")
            # every row live: each matched key has exactly mult rows, a
            # lower bound that takes the gather arm with no K3 launch
            full = np.ones(C, bool)
            before = S.stream_emit_m.launches
            err = max_abs_diff(S.stream_expand(
                *(t(a) for a in seg), t(cur), K.as_count(n, dev), t(full),
                cap_out=1 << 17, mult=None, mhot=True, mdup=mdup,
                mult_lo=mult), K.merge_expand(
                *(t(a) for a in seg), t(cur), K.as_count(n, dev), t(full),
                cap_out=1 << 17))
            check(err == 0 and S.stream_emit_m.launches == before,
                  f"stream_expand with lower bound {mult}: not the gather "
                  f"arm's bits, or K3 launched")
        # looser bounds give the exact bound's bits: K3 in K2's place over
        # distinct anchors (bound 2), and the device's choice between K3
        # and the gather arm (a bound past mdup, or none)
        for loose in sorted({max(mult + 1, 2), mdup + 1}) + [None]:
            if loose is not None and loose <= mult:
                continue
            before = S.stream_emit_m.launches
            got = S.stream_expand(
                *(t(a) for a in seg), t(cur), K.as_count(n, dev),
                t(livem), cap_out=1 << 17, mult=loose, mhot=True, mdup=mdup)
            err = max_abs_diff(got, outs["cuda"])
            errs["stream_emit_m"] = max(errs["stream_emit_m"], err)
            check(err == 0, f"stream_expand at multiplicity {mult} with "
                  f"bound {loose}: bits differ from bound {mult}'s")
            check(S.stream_emit_m.launches > before,
                  f"bound {loose}: K3 was not launched")
    expand_rows_checks(errs)


def on_card(x, dev):
    """A CPU tensor's copy on ``dev`` with the same strides (a view's base
    is copied whole and viewed again)."""
    import torch

    if x.is_contiguous():
        return x.to(dev)
    return torch.as_strided(x._base.to(dev), x.shape, x.stride(),
                            x.storage_offset())


def expand_rows_checks(errs: dict, reps: int = 3) -> None:
    """expand_rows on every case of expand_rows_cases: each run the same
    bits as its plain version on the CPU copy, launch counted."""
    import torch

    from wukong_tpu_torch.engine import tpu_kernels as K

    dev = torch.device("cuda")
    for label, *args in expand_rows_cases():
        want = K.expand_rows_plain(*args)
        card = [on_card(a, dev) if isinstance(a, torch.Tensor) else a
                for a in args]
        for _ in range(reps):
            before = K.expand_rows.launches
            err = max_abs_diff(K.expand_rows(*card), want)
            errs["expand_rows"] = max(errs["expand_rows"], err)
            check(err == 0, f"expand_rows != plain on {label} ({err})")
            check(K.expand_rows.launches == before + 1,
                  f"expand_rows on {label}: launch not counted")


def hold_repeated(errs: dict, name: str, fn, plain, args, what: str,
                  reps: int) -> None:
    """Run fn(*args) ``reps`` times: every run must give the same bits, and
    those must equal plain(*args)."""
    import torch

    first = fn(*args)
    for _ in range(reps - 1):
        again = fn(*args)
        check(all(torch.equal(a, b) for a, b in zip(first, again)),
              f"{name} gave different outputs on repeated runs: {what}")
    err = max_abs_diff(first, plain(*args))
    errs[name] = max(errs[name], err)
    check(err == 0, f"{name} != plain on {what} (max abs err {err})")


def probe_stress_cases(errs: dict, reps: int = 10) -> int:
    """K1 cases aimed at the grouped probe (a thread owns several rows): a
    dense frontier of 2^21 distinct keys, all hitting, about four a bucket
    (x_opt_heavy's child); keys of -1 against buckets with empty lanes; a
    table whose keys share one home bucket (four and more probe rounds);
    frontier lengths off the row group, and a frontier that starts off the
    16 B boundary; n at 0, 1, C - 1 and C, as an int and as the 0-d device
    tensor a chain carries. Each case runs ``reps`` times: every run must
    give the same bits, and those must equal the plain version. Returns the
    number of cases."""
    import numpy as np
    import torch

    from wukong_tpu_torch.engine import tpu_kernels as K
    from wukong_tpu_torch.engine.device_store import (build_hash_table,
                                                      line_table)

    rng = np.random.default_rng(4321)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    def table(keys, offs, nb=None):
        bkey, bstart, bdeg, max_probe = build_hash_table(keys, offs, nb)
        bline, bhi = line_table(bkey, bstart, bdeg)
        return t(bline), t(bhi), max_probe

    cases = []  # (what, bline, bhi, cur, n, max_probe)
    K_dense = 1 << 21
    keys = np.sort(rng.choice(1 << 30, K_dense, replace=False))
    offs = np.concatenate([[0], np.cumsum(rng.integers(0, 9, K_dense))])
    bline, bhi, mp = table(keys, offs)
    check(bline.shape[0] * 4 == K_dense,
          "dense case is not four keys a bucket")
    check(bool((bline[:, 4:8] >= 0).any()),
          "dense case has no key in lanes 4-7")
    cur = t(keys.astype(np.int32))
    C = K_dense
    for n in (C, C - 1, 1, 0):
        cases.append((f"dense, C={C}, n={n}", bline, bhi, cur, n, mp))
    cases.append((f"dense, C={C}, n=C-1 as a device count", bline, bhi, cur,
                  K.as_count(C - 1, "cuda"), mp))
    for C in ((1 << 16) + 3, 4093):  # -1 and the INT32_MAX pad
        c = rng.choice(keys, C).astype(np.int32)
        c[rng.random(C) < 0.4] = -1
        c[rng.random(C) < 0.1] = 2**31 - 1
        cases.append((f"keys of -1, C={C}, n=C", bline, bhi, t(c), C, mp))
    cand = np.arange(1 << 17, (1 << 17) + 40_000, dtype=np.int64)
    home = (cand.astype(np.uint32) * np.uint32(2654435761)) & np.uint32(7)
    spill = np.sort(cand[home == 0][:40])
    sk, ssd, smp = table(spill, np.arange(41, dtype=np.int64) * 2, 8)
    check(smp >= 4, "multi-round probe case has too few rounds")
    c = np.concatenate([spill, spill + 1, [-1]] * 30).astype(np.int32)
    for C in (1000, 1001, 7):
        for n in (C, C - 1):
            cases.append((f"{smp} probe rounds, C={C}, n={n}", sk, ssd,
                          t(c[:C]), n, smp))
    full = t(np.where(rng.random((1 << 16) + 8) < 0.7,
                      rng.choice(keys, (1 << 16) + 8),
                      rng.integers(1 << 30, 2**31 - 1, (1 << 16) + 8)
                      ).astype(np.int32))
    for off in (1, 2, 3):  # cur starts 4, 8, 12 B past a 16 B boundary
        C = (1 << 16) + 8 - off - 1
        for n in (C, C - 5, 1):
            cases.append((f"misaligned by {4 * off} B, C={C}, n={n}", bline,
                          bhi, full[off:off + C], n, mp))
    for C in (1, 2, 3, 5, 9, 17):
        cases.append((f"tiny C={C}", bline, bhi, full[:C], C, mp))
    for what, *args in cases:
        hold_repeated(errs, "probe_kernel", K.probe_kernel, K.probe_plain,
                      args, what, reps)
    return len(cases)


def emit_stress_cases(errs: dict, reps: int = 10) -> int:
    """K2/K3 cases aimed at the single-pass look-back scan: E = 2^25 (8,192
    tiles) with one run over every tile and with multiplicities up to 16,
    edge counts off the 16 B vector and the tile, and cap_out cuts inside a
    tile and inside one edge's copies. Each case runs ``reps`` times: every
    run must give the same bits, and those must equal the plain version.
    Returns the number of cases."""
    import numpy as np
    import torch

    from wukong_tpu_torch.engine import cuda_lib
    from wukong_tpu_torch.engine import tpu_stream as S

    T = S.EMIT_TILE
    tile = cuda_lib.library("stream_emit.cu").wk_stream_tile()
    check(tile == T, f"kernel tile {tile} != EMIT_TILE {T}")
    rng = np.random.default_rng(99)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    def k3_caps(mult: np.ndarray) -> list:
        """cap_out at the total, past it, inside a tile, and (where some
        edge has two or more copies) just after the first copy of a middle
        such edge."""
        m = np.maximum(np.cumsum(mult, dtype=np.int64), 0)
        end = np.cumsum(m)
        total = int(end[-1])
        caps = [total, total + 4099, total // 2 + 1]
        multi = np.flatnonzero(m >= 2)
        if len(multi):
            e = int(multi[len(multi) // 2])
            caps.append(int(end[e] - m[e] + 1))
        return caps

    def full(E):
        return rng.integers(-2**31, 2**31 - 1, E).astype(np.int32)

    cases = []  # (what, E, K2 dsel, dpar, K2 caps, K3 dsel)
    E = 1 << 25
    one = np.zeros(E, np.int32)
    one[0] = 1
    cases.append(("one run over all tiles", E, one, full(E),
                  (E, E - 777, 5 * T + 1234, 2 * E), 3 * one))
    # a piecewise-constant level in 0..16 with random breakpoints: K2 emits
    # where it is positive, K3 that many copies
    cuts = np.sort(rng.choice(np.arange(1, E), 4095, replace=False))
    levels = rng.integers(0, 17, len(cuts) + 1).astype(np.int32)
    steps = np.zeros(E, np.int32)
    steps[0] = levels[0]
    steps[cuts] = np.diff(levels)
    cases.append(("multiplicities 0..16 over all tiles", E, steps, full(E),
                  (E // 2 + 3, 2 * E), steps))
    for E in (1, 3, 5, T - 1, T, T + 1, 3 * T + 5, 7 * T + 2):
        # random walks: negative carries, long stretches of nothing
        sparse = rng.integers(-2, 4, E).astype(np.int32) * (
            rng.random(E) < 0.05)
        cases.append((f"ragged E={E}", E,
                      rng.choice([-1, 0, 0, 1], E).astype(np.int32), full(E),
                      (1024, max(E // 3, 1), 2 * E + 1024), sparse))
    n = 0
    for what, E, ds, dp, caps, mult in cases:
        edges = t(rng.integers(0, 2**31 - 1, E).astype(np.int32))
        ds_t, dp_t, mult_t = t(ds), t(dp), t(mult)
        for cap in caps:
            hold_repeated(errs, "stream_emit", S.stream_emit,
                          S.stream_emit_plain, (edges, ds_t, dp_t, cap),
                          f"{what}, cap={cap}", reps)
            n += 1
        for cap in k3_caps(mult):
            hold_repeated(errs, "stream_emit_m", S.stream_emit_m,
                          S.stream_emit_m_plain, (edges, mult_t, dp_t, cap),
                          f"m-hot {what}, cap={cap}", reps)
            n += 1
    return n


# ---------------------------------------------------------------------------
# phase 4 timing: each kernel on its captured main-path inputs
# ---------------------------------------------------------------------------


def probe_work(args) -> tuple:
    """(bytes, operations, what) K1 needs for these inputs. Bytes: the live
    frontier rows (i < n) and n read once (rows past n are never read), the
    three outputs written once over all C rows, each distinct bucket row
    that some probe round reaches read once (32 B; a live row probes round r
    unless found before it), and start/deg of each distinct hit key.
    Operations: per live row the hash (multiply, mask), per probe round an
    add, a mask and 8 compares."""
    import torch

    from wukong_tpu_torch.engine import tpu_kernels as K

    bline, bhi, cur, n, max_probe = args
    C = cur.shape[0]
    live = torch.arange(C, device=cur.device) < K.as_count(n, cur.device)
    bmask = bline.shape[0] - 1
    hb = K._hash_bucket(cur, bmask)
    found = torch.zeros_like(live)
    reached, probes = [], 0
    for r in range(max_probe):
        active = live & ~found
        reached.append(((hb + r) & bmask)[active])
        probes += int(active.sum())
        found = K.probe_plain(bline, bhi, cur, n, r + 1)[0]
    buckets = int(torch.unique(torch.cat(reached)).numel())
    hits = int(torch.unique(cur[found]).numel())
    n_live = int(live.sum())
    nbytes = n_live * 4 + 4 + buckets * 32 + hits * 8 + C * (1 + 4 + 4)
    return (nbytes, n_live * 2 + probes * 10,
            {"C": C, "live_rows": n_live, "buckets": buckets, "hits": hits})


def emit_work(args, mhot: bool = False) -> tuple:
    """(bytes, operations, what) K2 (or K3, with mhot) needs: both delta
    channels read over all E edges (their running sums need every element),
    edges read only where an edge emits a row below cap_out, val and par
    written once over cap_out, the total; per edge two running sums and a
    select, per output row its position."""
    import torch

    from wukong_tpu_torch.engine.tpu_stream import EMIT_TILE

    edges, dsel, _dpar, cap_out = args
    E = edges.shape[0]
    csel = torch.cumsum(dsel.long(), 0)
    m = csel.clamp(min=0) if mhot else (csel > 0).long()
    pos = torch.cumsum(m, 0) - m
    read = int(((m > 0) & (pos < cap_out)).sum())
    total = int(m.sum())
    nbytes = E * 8 + read * 4 + cap_out * 8 + 8
    # rows below cap_out in each of the CUDA kernel's tiles: a tile with more
    # than EMIT_TILE of them writes them one stage at a time
    G = -(-E // EMIT_TILE)
    per = torch.zeros(G * EMIT_TILE, dtype=torch.long, device=m.device)
    per[:E] = (torch.clamp(pos + m, max=cap_out) - pos).clamp(min=0)
    per = per.view(G, EMIT_TILE).sum(1)
    return (nbytes, E * 3 + cap_out,
            {"E": E, "edges_read": read, "rows": total, "cap_out": cap_out,
             "tiles": G, "tiles_with_rows": int((per > 0).sum()),
             "tiles_over_one_stage": int((per > EMIT_TILE).sum())})


def measure(name: str, phase: str, best: tuple, launches: int, kern, plain,
            work_of, errs: dict, library=None) -> dict:
    """One row of the kernels line: the kernel held against its plain version
    on the largest call of one class of a phase's calls, timed there, with
    that input's bound and that class's launches. ``library``, where one
    PyTorch call computes the same function on these inputs, is held
    against the plain version too and timed as ``library_ms``."""
    _size, args, kw = best
    want = plain(*args, **kw)
    err = max_abs_diff(kern(*args, **kw), want)
    errs[name] = max(errs[name], err)
    check(err == 0, f"{name} != plain on its {phase} inputs ({err})")
    if library is not None:
        check(max_abs_diff(library(*args, **kw), want) == 0,
              f"{name}'s library call != plain on its {phase} inputs")
    nbytes, ops, what = work_of(args)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / CORE_OPS_PER_S * 1e3
    src, replaces = KERNELS[name]
    row = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
           "launches": launches, "max_abs_err": err,
           "ms": time_ms(lambda: kern(*args, **kw)),
           "plain_ms": time_ms(lambda: plain(*args, **kw), reps=5),
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": (None if library is None else
                          time_ms(lambda: library(*args, **kw))),
           "phase": phase, "input": what}
    log(f"  {name} [{phase}]: {launches} launches; largest input {what}  "
        f"bytes {nbytes:,}  ops {ops:,}  ms {row['ms']:.4f}  bound "
        f"{row['bound_ms']:.4f} ({row['bound_by']})  plain "
        f"{row['plain_ms']:.4f}  library {row['library_ms']}")
    return row


def captured_rows(captures: dict, phase: str, kernel_fns: dict,
                  errs: dict) -> list:
    """A kernels-line row for every class of calls each kernel made in one
    phase (a kernel the phase never launched has none)."""
    rows = []
    for name, cap in captures.items():
        fn, plain, work_of = kernel_fns[name]
        for cls, best in sorted(cap.best.items()):
            if cap.launches.get(cls, 0):
                rows.append(measure(name, phase + cls, best,
                                    cap.launches[cls], fn, plain, work_of,
                                    errs))
    return rows


# ---------------------------------------------------------------------------
# phases 3-5
# ---------------------------------------------------------------------------


def build_world(scale: int, seed: int, results: dict | None = None,
                with_attrs: bool = False):
    """LUBM-<scale> from the seed and its partition; with ``results``, the
    set-up times land there beside the host CPU's name. ``with_attrs``
    returns the attribute columns too (phase 15 partitions them again)."""
    from wukong_tpu_torch.loader.lubm import (
        VirtualLubmStrings,
        generate_lubm,
        generate_lubm_attrs,
    )
    from wukong_tpu_torch.store.gstore import build_partition

    t0 = time.perf_counter()
    triples, _ = generate_lubm(scale, seed=seed)
    attrs = generate_lubm_attrs(scale, seed=seed)
    t1 = time.perf_counter()
    g = build_partition(triples, 0, 1, attr_triples=attrs)
    t2 = time.perf_counter()
    cpu = cpu_model()
    log(f"store: LUBM-{scale} seed {seed}: {len(triples):,} triples, "
        f"{len(attrs[0]):,} attributes (synthesis {t1 - t0:.1f} s, "
        f"partition {t2 - t1:.1f} s; host CPU {cpu})")
    if results is not None:
        results["setup_s"] = {"synthesis": t1 - t0, "partition": t2 - t1,
                              "host_cpu": cpu}
    if with_attrs:
        return g, VirtualLubmStrings(scale, seed=seed), triples, attrs
    return g, VirtualLubmStrings(scale, seed=seed), triples


def cpu_model() -> str:
    """The host CPU's name, as lscpu's "Model name" (or /proc/cpuinfo's
    "model name") gives it."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        out = ""
    for line in out.splitlines():
        if line.strip().startswith("Model name:"):
            return line.split(":", 1)[1].strip()
    try:  # no lscpu: the kernel's own table
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    import platform

    return (f"{platform.machine()}, model not reported, "
            f"{os.cpu_count()} CPUs")


def check_native(where: str, names, results: dict) -> None:
    """Every call of the named host steps since the last reset took the
    native path (wukong_tpu_torch/native/), at least once each."""
    from wukong_tpu_torch import native

    counts = {n: dict(native.counts[n]) for n in names}
    results.setdefault("native", {})[where] = counts
    log(f"native: {where}: {counts}")
    for n, c in counts.items():
        check(c["native"] > 0 and c["numpy"] == 0,
              f"{where}: {n} took the numpy path ({c})")
    native.reset_counts()


def why_alive(target, limit: int = 200_000) -> list:
    """Referrer paths from ``target`` up to what keeps it alive, breadth
    first, as readable steps (the holder's type; for a dict the key, for a
    frame the function): a module's namespace, a live frame, or an object
    no Python object refers to (a running function's local variable, a
    thread-local's storage, an extension's reference)."""
    import sys
    import types

    mine = ("why_alive", "cuda_holders", "drop_check", "<listcomp>",
            "<genexpr>")
    parent = {id(target): None}
    objs = {id(target): target}
    queue = [target]
    roots = []
    while queue and len(parent) < limit and len(roots) < 3:
        o = queue.pop(0)
        refs = [r for r in gc.get_referrers(o)
                if r is not queue and r is not parent and r is not objs
                and r is not roots
                and not (isinstance(r, types.FrameType)
                         and r.f_code.co_name in mine)]
        if not refs and o is not target:
            roots.append(o)  # nothing in Python holds it
        for r in refs:
            if id(r) in parent:
                continue
            parent[id(r)] = id(o)
            objs[id(r)] = r
            if isinstance(r, (types.ModuleType, types.FrameType)) or (
                    isinstance(r, dict) and "__name__" in r
                    and r.get("__name__") in sys.modules):
                roots.append(r)
            else:
                queue.append(r)
        del refs  # the next lookup must not see this list as a holder

    def step(o, child):
        if isinstance(o, types.FrameType):
            return f"frame {o.f_code.co_name} ({o.f_code.co_filename}:" \
                   f"{o.f_lineno})"
        if isinstance(o, dict):
            keys = [k for k, v in o.items() if v is child][:2]
            name = o.get("__name__") if "__name__" in o else None
            return f"dict{' of module ' + name if name else ''} {keys}"
        if isinstance(o, types.FunctionType):
            return f"function {o.__qualname__}"
        return type(o).__qualname__

    paths = []
    for r in roots:
        chain, cur = [], id(r)
        while cur is not None:
            held = parent[cur]
            chain.append(step(objs[cur], None if held is None
                              else objs[held]))
            cur = held
        paths.append(" -> ".join(reversed(chain)))
    if not paths:
        paths.append(f"no holder found in {len(parent):,} objects")
    return paths


def cuda_holders() -> list:
    """What keeps the two largest live CUDA tensors, and any live GPU
    engine, device store or Capture, alive (``why_alive``). The targets
    are held weakly here: a list of them would itself hold them."""
    import torch

    from wukong_tpu_torch.engine.device_store import DeviceStore
    from wukong_tpu_torch.engine.tpu import GPUEngine

    objs = gc.get_objects()
    big = sorted((o for o in objs if torch.is_tensor(o) and o.is_cuda),
                 key=lambda t: -t.untyped_storage().nbytes())[:2]
    refs = [weakref.ref(o) for o in big] + [
        weakref.ref(o) for o in objs
        if isinstance(o, (GPUEngine, DeviceStore, Capture))][:6]
    del objs, big
    lines = []
    for ref in refs:
        o = ref()
        if o is not None:
            what = (f"tensor {tuple(o.shape)}" if torch.is_tensor(o)
                    else type(o).__name__)
            paths = why_alive(o)
            o = None
            lines += [f"{what} alive: {path}" for path in paths]
    return lines


def drop_check(mem_base: int, results: dict,
               what: str = "phase 3's proxy") -> None:
    """After ``what`` is dropped, raw memory_allocated falls back to within
    64 MiB of its value before phase 3; else the holders of the largest
    live CUDA tensors are printed and the run fails."""
    import torch

    gc.collect()
    torch.cuda.synchronize()
    mem = torch.cuda.memory_allocated()
    results.setdefault("drop", {})[what] = {"before_phase3": int(mem_base),
                                            "after_drop": int(mem)}
    log(f"drop: {what} dropped; memory_allocated {mem:,} B, "
        f"{mem_base:,} B before phase 3")
    if mem - mem_base > 64 * MIB:
        for line in cuda_holders():
            log(f"  held: {line}")
        check(False, f"{mem - mem_base:,} B of CUDA memory outlive {what}")


def stage_all(proxy) -> int:
    """Stage, on the card, every segment and list the seven shapes' single
    and batch chains read."""
    from wukong_tpu_torch.engine.tpu import _is_index_start

    ds = proxy.gpu.dstore
    merge = proxy.gpu.merge
    for text in QUERIES.values():
        q = proxy.parse(text)
        pats = q.pattern_group.patterns
        for k, p in enumerate(pats):
            if k == 0 and _is_index_start(p):
                ds.index_list(p.subject, p.direction)
            else:
                ds.segment(p.predicate, p.direction)
        if q.start_from_index():
            folds = merge._plan_folds(pats, index_mode=True)
            for _k, pat, kind, fold in merge.classify(pats, folds, True):
                pid, d = pat.predicate, pat.direction
                if kind == "expand" and fold is not None:
                    ds.filtered_merge_segment(pid, d, fold[0])
                    ds.filtered_segment(pid, d, fold[0])
                elif kind == "k2c":
                    ds.const_list(pid, d, pat.object)
                else:
                    ds.merge_segment(pid, d)
    import torch

    torch.cuda.synchronize()
    return ds.bytes_used


def walk_caps(proxy, q, B: int) -> list:
    """(step, kind, cap_in, cap_out) of each step of q's replicate batch of
    B, as the merge executor would size them now (learned capacities
    first)."""
    merge = proxy.gpu.merge
    pats = q.pattern_group.patterns
    folds = merge._plan_folds(pats, index_mode=True)
    return [(k, kind, ci, co) for k, _p, kind, _f, ci, co
            in merge._walk_caps(pats, folds, True, B, "rep")]


def batch_sizes(proxy, text: str, mdup: int) -> list:
    """Replicate batch sizes for one index-origin shape: 1, and the largest
    B <= mdup whose start rows and every step's learned capacity at B=1
    (a power of two at or above the step's true total), times B, stay
    within table_capacity_max."""
    eng = proxy.gpu
    q = proxy.parse(text)
    p0 = q.pattern_group.patterns[0]
    peak = max([len(proxy.g.get_index(p0.subject, p0.direction))]
               + [co for _k, _kind, _ci, co in walk_caps(proxy, q, 1)])
    return sorted({1, min(mdup, max(eng.cap_max // max(peak, 1), 1))})


def serve(proxy, heavy: tuple, mdup: int, results: dict) -> dict:
    """Phase 4's main path: the seven shapes one at a time, then the
    index-origin shapes in replicate batches (B=1 first, which also learns
    the capacities that size the larger B). Returns each shape's rows
    (sorted_table)."""
    import torch

    rows, tables = {}, {}
    for name, text in QUERIES.items():
        lat = []
        for _ in range(5):
            t0 = time.perf_counter()
            q = proxy.serve_query(text)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            check(q.result.status_code == 0,
                  f"{name}: status {q.result.status_code!r}")
        rows[name] = q.result.nrows
        tables[name] = sorted_table(q)
        results["queries"][name] = {"rows": rows[name],
                                    "median_ms": statistics.median(lat),
                                    "runs_ms": lat}
        log(f"  {name}: {rows[name]:,} rows, median {statistics.median(lat):.2f}"
            f" ms over 5 runs (first {lat[0]:.2f} ms)")
    for name in heavy:
        text = QUERIES[name]
        proxy.serve_batch_index(text, 1)
        for B in batch_sizes(proxy, text, mdup):
            lat = []
            for _ in range(3):
                t0 = time.perf_counter()
                counts = proxy.serve_batch_index(text, B)
                lat.append((time.perf_counter() - t0) * 1e3)
                check(counts.tolist() == [rows[name]] * B,
                      f"{name} B={B}: per-qid counts {counts.tolist()} != "
                      f"single-query rows {rows[name]}")
            med = statistics.median(lat)
            caps = walk_caps(proxy, proxy.parse(text), B)
            results["batches"][f"{name}@B={B}"] = {
                "median_ms": med, "runs_ms": lat,
                "queries_per_s": B / med * 1e3, "caps": caps}
            log(f"  {name} x B={B}: counts ok, median {med:.2f} ms "
                f"({B / med * 1e3:.2f} queries/s); caps {caps}")
    return tables


class StageClock:
    """Host-clock ms of one serve by stage, while in a ``with`` block.
    "device chain" is the engine's device prefixes (each chain on the card,
    seeded children included, ending in its one sync); the host stages are
    parse and plan, the host engine's pattern steps, the UNION merge, the
    OPTIONAL join, FILTER and the final stage, each net of the stages it
    runs inside it. The rest of a serve ("other": the proxy and engine
    dispatch between stages, the closing synchronize) is what the caller's
    own clock has beyond their sum."""

    STAGES = (("proxy", "parse", "parse+plan"),
              ("engine", "_run_device_prefix", "device chain"),
              ("cpu", "_execute_one_pattern", "host steps"),
              ("cpu", "_execute_unions", "union"),
              ("engine", "_execute_optional", "optional"),
              ("cpu", "_execute_filters", "filter"),
              ("cpu", "_final_process", "final"))

    def __init__(self, proxy):
        self.owners = {"proxy": proxy, "engine": proxy.gpu,
                       "cpu": proxy.gpu.cpu}
        self.ms: dict = {}
        self._nested: list = []

    def __enter__(self):
        # instance attributes shadow the class's methods until __exit__
        for owner, attr, stage in self.STAGES:
            obj = self.owners[owner]
            setattr(obj, attr, self._timed(getattr(obj, attr), stage))
        return self

    def __exit__(self, *exc) -> None:
        for owner, attr, _stage in self.STAGES:
            delattr(self.owners[owner], attr)

    def _timed(self, inner, stage: str):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            self._nested.append(0.0)
            try:
                return inner(*args, **kw)
            finally:
                dt = (time.perf_counter() - t0) * 1e3
                self.ms[stage] = self.ms.get(stage, 0.0) + dt - \
                    self._nested.pop()
                if self._nested:
                    self._nested[-1] += dt
        return timed


def serve_extended(proxy, results: dict) -> None:
    """Phase 5: the extended suite, each shape 5 times."""
    import torch

    for name, text in EXT_QUERIES.items():
        lat, stages = [], []
        for _ in range(5):
            with StageClock(proxy) as clock:
                t0 = time.perf_counter()
                q = proxy.serve_query(text)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
            run = dict(clock.ms)
            run["other"] = lat[-1] - sum(run.values())
            stages.append(run)
            check(q.result.status_code == 0,
                  f"{name}: status {q.result.status_code!r}")
        check(q.result.nrows > 0, f"{name}: no rows")
        mid = lat.index(statistics.median_low(lat))
        dev = stages[mid].get("device chain", 0.0)
        row = {"rows": q.result.nrows, "median_ms": lat[mid],
               "device_chain_ms": dev, "host_ms": lat[mid] - dev,
               "stages_ms": stages[mid], "runs_ms": lat}
        results["extended"][name] = row
        split = ", ".join(f"{k} {v:.2f}" for k, v in stages[mid].items()
                          if k != "device chain" and v >= 0.01)
        log(f"  {name}: {row['rows']:,} rows, median {row['median_ms']:.2f} "
            f"ms: device chain {dev:.2f}, host {row['host_ms']:.2f} "
            f"({split}); first run {lat[0]:.2f} ms")


# ---------------------------------------------------------------------------
# phase 7: batched serving under the planner
# ---------------------------------------------------------------------------


def sorted_table(q):
    """q's result rows sorted lexicographically: two plans' results are the
    same multiset of rows exactly when these arrays are equal (the final
    stage puts the columns in projection order)."""
    import numpy as np

    t = np.asarray(q.result.table)
    if t.ndim != 2 or not len(t):
        return t
    return t[np.lexsort(t.T[::-1])]


def plan_text(pg) -> str:
    """A pattern group's plan on one line, UNION and OPTIONAL groups
    included."""
    parts = [" ".join(repr(p) for p in pg.patterns)]
    parts += [f"UNION {{{plan_text(u)}}}" for u in pg.unions]
    parts += [f"OPTIONAL {{{plan_text(o)}}}" for o in pg.optional]
    return " ".join(x for x in parts if x)


def timed_runs(fn, runs: int) -> tuple:
    """(last result, host ms of each run): fn's results are host arrays,
    so each run ends in the engine's own host read."""
    import torch

    lat, out = [], None
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return out, lat


def count_syncs(fn) -> tuple:
    """Host syncs that fn() makes on the card (torch's sync debug mode:
    every synchronizing CUDA call, a copy to pageable host memory or a
    read of a device value among them, warns once): (count, {"file:line"
    of the Python call that synced: count})."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites: dict = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            at = f"{os.path.relpath(w.filename)}:{w.lineno}"
            sites[at] = sites.get(at, 0) + 1
    return sum(sites.values()), sites


def template_job(proxy, name: str, rng, B: int):
    """One light template: parsed, filled, instantiated and planned; with
    B x 8 constants drawn from its placeholder's candidates. None when the
    plan does not start from the placeholder's constant (the emulator's
    batchable rule), since a batch would then substitute the wrong slot."""
    import numpy as np

    from wukong_tpu_torch.sparql.parser import Parser

    tmpl = Parser(proxy.str_server).parse_template(TEMPLATES[name])
    proxy.fill_template(tmpl)
    q = tmpl.instantiate(rng)
    pi, fld = tmpl.pos[0]
    inst = getattr(q.pattern_group.patterns[pi], fld)
    proxy._plan(q)
    pats = q.pattern_group.patterns
    if not (len(tmpl.pos) == 1 and pats and pats[0].subject == inst
            and pats[0].predicate > 0):
        return None
    cand = tmpl.candidates[0]
    draws = [np.asarray(cand[rng.integers(0, len(cand), B)], dtype=np.int64)
             for _ in range(8)]
    return tmpl, q, draws


def single_rows(proxy, tmpl, const) -> int:
    """Rows of the template's query with its placeholder set to const,
    planned and served alone."""
    import copy

    q = copy.deepcopy(tmpl.query)
    pi, fld = tmpl.pos[0]
    setattr(q.pattern_group.patterns[pi], fld, int(const))
    proxy._plan(q)
    q.result.blind = True
    proxy.gpu.execute(q)
    check(q.result.status_code == 0, f"single instance: status "
          f"{q.result.status_code!r}")
    return q.result.nrows


def serve_batched(proxy, triples, phase4: dict, seed: int, entry: dict,
                  results: dict, replay: list) -> None:
    """Phase 7: statistics and the planner, the basic shapes single under
    it, light templates in const batches and their windows, heavy shapes
    in replicate and slice batches. ``entry["name"]`` names the entry point
    being driven (the class of each kernel call Capture keeps); ``replay``
    gets one call of each entry point on each input, to be run again
    outside the timed work."""
    import numpy as np

    from wukong_tpu_torch.config import Global
    from wukong_tpu_torch.planner.heuristic import heuristic_plan
    from wukong_tpu_torch.planner.optimizer import Planner
    from wukong_tpu_torch.planner.stats import Stats
    from wukong_tpu_torch.sparql.parser import Parser

    out = results["batched"]
    eng = proxy.gpu
    t0 = time.perf_counter()
    stats = Stats.generate(triples)
    out["stats_generate_s"] = time.perf_counter() - t0
    log(f"  Stats.generate over {len(triples):,} triples: "
        f"{out['stats_generate_s']:.1f} s")
    proxy.planner = Planner(stats)
    eng.stats = stats
    out["plans"] = {}
    for name, text in {**QUERIES, **EXT_QUERIES}.items():
        h = Parser(proxy.str_server).parse(text)
        heuristic_plan(h)
        o = proxy.parse(text)
        out["plans"][name] = {"planner": plan_text(o.pattern_group),
                              "heuristic": plan_text(h.pattern_group),
                              "planner_empty": o.planner_empty}
        log(f"  plan {name}: planner [{plan_text(o.pattern_group)}]"
            f"{' (planner-empty)' if o.planner_empty else ''}; heuristic "
            f"[{plan_text(h.pattern_group)}]")

    entry["name"] = "single"
    rows = {}
    out["single"] = {}
    for name, text in QUERIES.items():
        replay.append(lambda text=text: proxy.serve_query(text))
        q, lat = timed_runs(lambda: proxy.serve_query(text), 5)
        check(q.result.status_code == 0, f"{name} planned: status "
              f"{q.result.status_code!r}")
        check(np.array_equal(sorted_table(q), phase4[name]),
              f"{name} planned: rows differ from phase 4's heuristic plan")
        rows[name] = q.result.nrows
        med = statistics.median(lat)
        out["single"][name] = {"rows": rows[name], "median_ms": med,
                               "runs_ms": lat}
        log(f"  {name} planned: {rows[name]:,} rows (as phase 4), median "
            f"{med:.2f} ms over 5 runs (first {lat[0]:.2f} ms)")

    B = Global.device_batch
    rng = np.random.default_rng(seed)
    out["const"], jobs = {}, []
    # the counter's own first use, with no work: what it reports here is
    # not the engine's
    base, sites = count_syncs(lambda: None)
    out["syncs_baseline"] = {"syncs": base, "sites": sites}
    log(f"  host-sync counter with no work: {base} ({sites})")
    for name in TEMPLATES:
        job = template_job(proxy, name, rng, B)
        if job is None:
            log(f"  template {name}: the plan does not start from its "
                f"placeholder; skipped, as the emulator skips it")
            continue
        tmpl, q, draws = job
        entry["name"] = "execute_batch"
        want = eng.execute_batch(q, draws[0])  # learns the capacities
        replay.append(lambda q=q, d=draws[0]: eng.execute_batch(q, d))
        counts, lat = timed_runs(lambda: eng.execute_batch(q, draws[0]), 5)
        check(counts.tolist() == want.tolist(), f"{name}: counts moved")
        entry["name"] = "execute_batch_many"
        eng.execute_batch_many(q, draws)  # learns every draw's capacities
        replay.append(lambda q=q, d=draws: eng.execute_batch_many(q, d))
        retries0 = eng.merge.total_retries
        many, lat_many = timed_runs(lambda: eng.execute_batch_many(q, draws),
                                    3)
        retries = eng.merge.total_retries - retries0
        check(many[0].tolist() == want.tolist(),
              f"{name}: execute_batch_many counts != execute_batch's")
        # the window's yardstick: the same 8 draws as 8 execute_batch calls
        # (draws[0] alone repeats one draw's rows and warm caches)
        entry["name"] = "execute_batch"
        seq, lat_seq = timed_runs(
            lambda: [eng.execute_batch(q, d) for d in draws], 3)
        entry["name"] = "execute_batch_many"
        check([c.tolist() for c in seq] == [c.tolist() for c in many],
              f"{name}: 8 execute_batch calls != execute_batch_many's counts")
        syncs, sites = count_syncs(lambda: eng.execute_batch_many(q, draws))
        syncs_one, _ = count_syncs(lambda: eng.execute_batch(q, draws[0]))
        check(syncs == 1 and syncs_one == 1,
              f"{name}: {syncs} host syncs a window ({sites}) and "
              f"{syncs_one} a batch, not 1")
        entry["name"] = "single"
        for i, c in enumerate(draws[0][:64]):
            got = single_rows(proxy, tmpl, c)
            check(int(want[i]) == got, f"{name}: qid {i} (const {int(c)}) "
                  f"counts {int(want[i])}, served alone {got}")
        med, med_many = statistics.median(lat), statistics.median(lat_many)
        med_seq = statistics.median(lat_seq)
        out["const"][name] = {
            "plan": plan_text(q.pattern_group), "B": B,
            "rows": int(want.sum()), "median_ms": med, "runs_ms": lat,
            "queries_per_s": B / med * 1e3,
            "many_K": len(draws), "many_median_ms": med_many,
            "many_runs_ms": lat_many,
            "many_queries_per_s": B * len(draws) / med_many * 1e3,
            "syncs_per_flight": syncs, "sync_sites": sites,
            "syncs_execute_batch": syncs_one, "many_retries": retries,
            "seq_median_ms": med_seq, "seq_runs_ms": lat_seq}
        log(f"  template {name} [{plan_text(q.pattern_group)}]: B={B}, "
            f"{int(want.sum()):,} rows; execute_batch median {med:.2f} ms "
            f"({B / med * 1e3:,.0f} queries/s); execute_batch_many K=8 "
            f"median {med_many:.2f} ms ({B * 8 / med_many * 1e3:,.0f} "
            f"queries/s; {retries} chain re-runs over its 3 timed windows; "
            f"the same 8 draws as 8 execute_batch calls: median "
            f"{med_seq:.2f} ms, the window {med_seq / med_many:.2f}x as "
            f"fast); "
            f"host syncs: {syncs} a flight of 8 ({sites}), {syncs_one} a "
            f"batch; 64 constants equal their single queries")
        jobs.append((name, q, draws[0], want))
    check(jobs, "no light template was batchable")
    entry["name"] = "execute_batch_mixed"
    mixed = [(q, c) for _n, q, c, _w in jobs]
    eng.execute_batch_mixed(mixed)
    replay.append(lambda: eng.execute_batch_mixed(mixed))
    res, lat = timed_runs(lambda: eng.execute_batch_mixed(mixed), 3)
    for (name, _q, _c, want), got in zip(jobs, res):
        check(got.tolist() == want.tolist(),
              f"{name}: execute_batch_mixed counts != execute_batch's")
    med = statistics.median(lat)
    nq = B * len(jobs)
    syncs, sites = count_syncs(lambda: eng.execute_batch_mixed(mixed))
    check(syncs == 1, f"execute_batch_mixed: {syncs} host syncs a flight "
          f"({sites}), not 1")
    out["mixed"] = {"templates": [j[0] for j in jobs], "queries": nq,
                    "median_ms": med, "runs_ms": lat,
                    "queries_per_s": nq / med * 1e3,
                    "syncs_per_flight": syncs, "sync_sites": sites}
    log(f"  execute_batch_mixed over {len(jobs)} templates: {nq} queries, "
        f"median {med:.2f} ms ({nq / med * 1e3:,.0f} queries/s), {syncs} "
        f"host syncs a flight ({sites})")

    out["heavy"] = {}
    for name in HEAVY:
        q = proxy.parse(QUERIES[name])
        single = rows[name]
        runs = []
        Br = eng.suggest_index_batch(q)
        entry["name"] = "execute_batch_index (replicate)"
        eng.execute_batch_index(q, Br)
        replay.append(lambda q=q, b=Br: eng.execute_batch_index(q, b))
        counts, lat = timed_runs(lambda: eng.execute_batch_index(q, Br), 3)
        check(counts.tolist() == [single] * Br,
              f"{name} replicate B={Br}: counts != single rows {single}")
        runs.append(("replicate", Br, 1, lat))
        entry["name"] = "execute_batch_index_many"
        eng.execute_batch_index_many(q, Br, 2)
        replay.append(
            lambda q=q, b=Br: eng.execute_batch_index_many(q, b, 2))
        many, lat = timed_runs(
            lambda: eng.execute_batch_index_many(q, Br, 2), 3)
        check(all(c.tolist() == [single] * Br for c in many),
              f"{name} replicate window: counts != single rows {single}")
        runs.append(("replicate window", Br, 2, lat))
        entry["name"] = "execute_batch_index (slice)"
        for Bs in sorted({proxy.heavy_index_batch(q), 8}):
            eng.execute_batch_index(q, Bs, slice_mode=True)
            replay.append(lambda q=q, b=Bs: eng.execute_batch_index(
                q, b, slice_mode=True))
            counts, lat = timed_runs(
                lambda: eng.execute_batch_index(q, Bs, slice_mode=True), 3)
            check(int(counts.sum()) == single,
                  f"{name} slice B={Bs}: counts sum {int(counts.sum())} != "
                  f"single rows {single}")
            runs.append(("slice", Bs, 1, lat))
        out["heavy"][name] = {"caps": walk_caps(proxy, q, Br)}
        log(f"  {name} replicate B={Br} caps {out['heavy'][name]['caps']}")
        for mode, b, k, lat in runs:
            med = statistics.median(lat)
            # a slice batch answers one query; replicate answers b (x k)
            nq = 1 if mode == "slice" else b * k
            out["heavy"][name][f"{mode} B={b}"] = {
                "median_ms": med, "runs_ms": lat,
                "queries_per_s": nq / med * 1e3}
            log(f"  {name} {mode} B={b}{f' K={k}' if k > 1 else ''}: "
                f"median {med:.2f} ms ({nq / med * 1e3:,.2f} queries/s)")


# ---------------------------------------------------------------------------
# phase 8: the serving runtime (run_single_query, sparql-emu, the console)
# ---------------------------------------------------------------------------


class LogCapture:
    """The port's log lines (written to stderr) while in a ``with`` block,
    passed on to stderr as well."""

    def __enter__(self):
        import io

        self.buf, self._err = io.StringIO(), sys.stderr
        outer = self

        class Tee:
            def write(self, text):
                outer.buf.write(text)
                return outer._err.write(text)

            def flush(self):
                outer._err.flush()

            def isatty(self):
                return False

        sys.stderr = Tee()
        return self

    def __exit__(self, *exc):
        sys.stderr = self._err

    @property
    def text(self) -> str:
        return self.buf.getvalue()


def serve_fallback(proxy, phase4: dict, results: dict) -> None:
    """Phase 8 at a lowered ceiling: with table_capacity_max (the GPU
    engine's and the knob) below q6's index (1,630,592 rows at LUBM-640)
    and q1's largest table, the GPU engine answers CAPACITY_EXCEEDED for
    both. At default knobs run_single_query then answers q6 in full through
    the compiled-template route, as the JAX proxy does (ROADMAP §C 2: the
    program's start list is not held to the ceiling); q1, pinned to the
    walk, answers phase 4's rows through the CPUEngine and logs it."""
    import numpy as np
    import torch

    from wukong_tpu_torch.config import Global

    eng = proxy.gpu
    saved = eng.cap_max
    out = results["runtime"]["fallback"] = {}
    try:
        eng.cap_max = FALLBACK_CAP_MAX
        with Knobs(None, table_capacity_max=FALLBACK_CAP_MAX):
            for name in ("lubm_q6", "lubm_q1"):
                q = proxy.parse(QUERIES[name])
                q.result.blind = False
                eng.execute(q)
                check(int(q.result.status_code) == 16,
                      f"{name} at a {eng.cap_max:,}-row ceiling: GPU engine "
                      f"status {q.result.status_code!r}, not "
                      "CAPACITY_EXCEEDED")
                pin = (walk_pinned("8, q1's capacity fallback")
                       if name == "lubm_q1" else Knobs(None))
                with LogCapture() as cap, pin:
                    t0 = time.perf_counter()
                    q = proxy.run_single_query(QUERIES[name], blind=False)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3
                check(np.array_equal(sorted_table(q), phase4[name]),
                      f"{name}: rows differ from phase 4's")
                fell_back = "degrading to the host engine" in cap.text
                compiled = bool(getattr(q, "_template_compiled", False))
                if name == "lubm_q6":
                    check(q.result.status_code == 0 and compiled
                          and not fell_back,
                          f"{name}: not answered by the compiled template "
                          f"(compiled {compiled}, host fallback {fell_back})")
                    how = "the compiled-template route"
                else:
                    check(q.result.status_code == 0 and fell_back,
                          f"{name}: no logged degradation to the host "
                          "engine")
                    how = "the host engine"
                out[name] = {"rows": q.result.nrows, "ms": ms,
                             "cap_max": eng.cap_max, "route": how,
                             "knob_cap_max": Global.table_capacity_max}
                log(f"  fallback {name}: table_capacity_max {eng.cap_max:,} "
                    f"-> CAPACITY_EXCEEDED on the card, {q.result.nrows:,} "
                    f"rows (as phase 4) through {how} in {ms:.1f} ms")
    finally:
        eng.cap_max = saved


def write_mix(root: str, name: str, heavy: bool) -> str:
    """A sparql-emu mix file under root: chip_smoke.TEMPLATES (and HEAVY)
    with weight 1 each, each query in a file of its own."""
    names = sorted(TEMPLATES) + (list(HEAVY) if heavy else [])
    for n in names:
        with open(os.path.join(root, f"{name}_{n}"), "w") as f:
            f.write(TEMPLATES.get(n) or QUERIES[n])
    path = os.path.join(root, name)
    with open(path, "w") as f:
        f.write(f"{len(TEMPLATES)} {len(HEAVY) if heavy else 0}\n")
        f.writelines(f"{name}_{n} 1\n" for n in names)
    return path


def serve_emu(proxy, mixes: dict, entry: dict, results: dict) -> None:
    """Phase 8's sparql-emu at LUBM-<scale> on phase 3's proxy: a light mix
    (the four templates) and a mixed one (and the three heavy shapes),
    through the console verb, 5 s measured after 1 s of warm-up, 8 in
    flight. Every class must run, the light ones on device batches and the
    heavy ones on device batches or a logged pool route. Host syncs are
    counted over the whole run and divided by the device flights (each
    warm-up batch, each device batch or window)."""
    from wukong_tpu_torch.runtime.console import Console
    from wukong_tpu_torch.runtime.emulator import Emulator

    out = results["runtime"]["emu"] = {}
    con = Console(proxy)
    flights = {"n": 0}
    orig = Emulator._device_batch

    def counted(self, *a, **kw):
        ran = orig(self, *a, **kw)
        flights["n"] += bool(ran)
        return ran

    Emulator._device_batch = counted
    try:
        for mix, path in mixes.items():
            heavy = mix == "mixed"
            entry["name"] = mix
            flights["n"] = 0
            with LogCapture() as cap:
                syncs, sites = count_syncs(lambda: con.run_command(
                    f"sparql-emu -f {path} -d 5 -w 1 -p 8"))
            rep = con.last_emu
            check(rep is not None, f"sparql-emu {mix}: no report")
            con.last_emu = None
            names = sorted(TEMPLATES) + (list(HEAVY) if heavy else [])
            modes = {names[c]: m for c, m in rep["class_mode"].items()}
            check(rep["errors"] == 0,
                  f"sparql-emu {mix}: {rep['errors']} errors")
            for n in TEMPLATES:
                check(modes.get(n) == "device-batch",
                      f"sparql-emu {mix}: light class {n} ran as "
                      f"{modes.get(n)}, not device-batch")
            for n in HEAVY if heavy else ():
                check(modes.get(n) == "device-batch" or (
                    modes.get(n) == "pool"
                    and "routed to the pool" in cap.text),
                    f"sparql-emu {mix}: heavy class {n} ran as "
                    f"{modes.get(n)}, not device-batch or a logged pool "
                    f"route")
            nfl = flights["n"] + rep["precompiled_classes"]
            cdf = {names[c]: {"p50_us": v.get(0.5), "p99_us": v.get(0.99),
                              "mode": modes.get(names[c])}
                   for c, v in rep["cdf"].items()}
            out[mix] = {"thpt_qps": rep["thpt_qps"],
                        "wall_qps": rep["wall_qps"],
                        "errors": rep["errors"], "shed": rep["shed"],
                        "flights": nfl, "syncs": syncs,
                        "syncs_per_flight": syncs / max(nfl, 1),
                        "sync_sites": sites, "classes": cdf}
            log(f"  sparql-emu {mix}: thpt_qps {rep['thpt_qps']:,.0f}, "
                f"wall_qps {rep['wall_qps']:,.0f}, errors 0, {nfl} "
                f"device flights, {syncs} host syncs "
                f"({syncs / max(nfl, 1):.2f} a flight; {sites})")
            for n, c in cdf.items():
                if c["p50_us"] is not None:
                    log(f"    {n} [{c['mode']}]: p50 {c['p50_us']:,.1f} "
                        f"us, p99 {c['p99_us']:,.1f} us")
    finally:
        Emulator._device_batch = orig
        stop_pool(proxy)


def audit_emu(proxy, mixes: dict) -> None:
    """Phase 8's stream-arm audit: each mix again, untimed, for 3 s with
    no warm-up (the same seed, so the same first draws as the measured
    run), under a StreamAudit the caller holds."""
    from wukong_tpu_torch.runtime.console import Console

    con = Console(proxy)
    try:
        for mix, path in mixes.items():
            con.run_command(f"sparql-emu -f {path} -d 3 -w 0 -p 8")
            rep = con.last_emu
            check(rep is not None and rep["errors"] == 0,
                  f"sparql-emu {mix} (stream-arm audit): no clean report")
            con.last_emu = None
    finally:
        stop_pool(proxy)


def stop_pool(proxy) -> None:
    if proxy._pool is not None:
        proxy._pool.stop()
        proxy._pool = None


def console_drill(root: str, data: str) -> dict:
    """console.main on a --dist -w DIST_SHARDS boot with replication 2
    running `recover -d 1`: the drill's report (the reply complete through
    the outage, healed, the verify round as the baseline); the booted
    proxy's heal watcher is stopped after."""
    from wukong_tpu_torch.runtime import console
    from wukong_tpu_torch.runtime import emulator as emu_mod

    cfg = os.path.join(root, "config_rf2")
    with open(cfg, "w") as f:
        f.write("global_enable_planner true\nglobal_replication_factor 2\n")
    drills = []
    orig = emu_mod.Emulator.run_drill

    def recorded(self, *a, **kw):
        rep = orig(self, *a, **kw)
        drills.append((self.proxy, rep))
        return rep

    emu_mod.Emulator.run_drill = recorded
    t0 = time.perf_counter()
    try:
        with Knobs(None, replication_factor=1):  # restored after the boot
            rc = console.main([cfg, data, "--dist", "-w", str(DIST_SHARDS),
                               "-c", "recover -d 1"])
    finally:
        emu_mod.Emulator.run_drill = orig
        for proxy, _rep in drills:
            proxy.recovery().stop()
    sec = time.perf_counter() - t0
    check(rc == 0 and len(drills) == 1, f"console recover -d 1: rc {rc}, "
          f"{len(drills)} drills")
    rep = drills[0][1]
    check(rep["replication_factor"] == 2 and rep["outage"]["complete"]
          and rep["outage"]["failovers"] > 0 and rep["healthy"]
          and rep["recovered"] == {"complete": True, "nrows_match": True},
          f"console recover -d 1: {rep}")
    log(f"  console --dist -w {DIST_SHARDS} with replication 2: recover -d 1 "
        f"complete through the outage ({rep['outage']['failovers']} "
        f"failovers), healed, verify as the baseline ({sec:.1f} s)")
    return {"report": rep, "seconds": sec}


def console_phase(scale: int, seed: int, cross_rows: dict,
                  results: dict, port: int) -> None:
    """Phase 8's console at LUBM-<scale>: the port's write_dataset writes
    the id-format directory, and console.main([config, dir, "-c",
    "sparql -b <file>"]) on the card runs the seven basic shapes with
    -n 5 -N; rows must equal phase 6's, and each shape's average latency is
    the one run_single_query logs. The console runs lockdep-checked under a
    burst of scrapes of the HTTP plane (no pause between rounds): no lock
    order cycle and no leaf inversion, and every render plane's ledger
    lock (RENDER_LOCKS) tracked through the burst. The metrics ring's
    sampler is stopped while checked mode is switched on and off, so no
    ledger lock is held when install() rebuilds it."""
    import re

    from wukong_tpu_torch.analysis import lockdep
    from wukong_tpu_torch.loader.lubm import write_dataset
    from wukong_tpu_torch.obs import stop_tsdb
    from wukong_tpu_torch.runtime import console
    from wukong_tpu_torch.runtime import proxy as proxy_mod

    out = results["runtime"]["console"] = {"scale": scale}
    got = []
    orig = proxy_mod.Proxy.run_single_query

    def recorded(self, text, **kw):
        q = orig(self, text, **kw)
        got.append(q)
        return q

    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, f"id_lubm_{scale}")
        t0 = time.perf_counter()
        write_dataset(data, scale, seed=seed)
        out["write_s"] = time.perf_counter() - t0
        cfg = os.path.join(root, "config")
        with open(cfg, "w") as f:
            f.write("global_enable_planner true\n")
        batch = os.path.join(root, "batch")
        with open(batch, "w") as f:
            for name, text in QUERIES.items():
                with open(os.path.join(root, name), "w") as g:
                    g.write(text)
                f.write(f"sparql -f {os.path.join(root, name)} -n 5 -N\n")
        dbatch = os.path.join(root, "dist_batch")
        with open(dbatch, "w") as f:
            for name in QUERIES:
                f.write(f"sparql -f {os.path.join(root, name)} -d dist -N\n")
            f.write("migrate -s\n")  # phase 16: the actuator's status
        proxy_mod.Proxy.run_single_query = recorded
        before = lock_holds()
        stop_tsdb()
        lockdep.install(True)  # before the console builds its locks
        set_tsdb_interval(TSDB_INTERVAL_S)
        try:
            with LogCapture() as cap, Scraper(port, pause=0.0) as scraper:
                t0 = time.perf_counter()
                rc = console.main([cfg, data, "-c", f"sparql -b {batch}"])
                out["main_s"] = time.perf_counter() - t0
            locks = lockdep.report()
            held = lock_holds()
        finally:
            proxy_mod.Proxy.run_single_query = orig
            stop_tsdb()
            lockdep.install(False)
            set_tsdb_interval(TSDB_INTERVAL_S)
        # phase 15's console: --dist -w 8 one-shot over the same directory
        dist_got = []

        def dist_recorded(self, text, **kw):
            q = orig(self, text, **kw)
            dist_got.append(q)
            return q

        proxy_mod.Proxy.run_single_query = dist_recorded
        try:
            t0 = time.perf_counter()
            with LogCapture() as dcap:
                drc = console.main([cfg, data, "--dist", "-w",
                                    str(DIST_SHARDS), "-c",
                                    f"sparql -b {dbatch}"])
            dist_s = time.perf_counter() - t0
        finally:
            proxy_mod.Proxy.run_single_query = orig
        # phase 16's console: a boot with replication 2 runs the drill
        drill = console_drill(root, data)
    status = [ln for ln in dcap.buf.getvalue().splitlines()
              if "migration actuator: {" in ln]
    check(len(status) == 1 and "'in_flight': False" in status[0],
          f"console --dist: migrate -s logged {status}")
    check(drc == 0 and len(dist_got) == len(QUERIES) and all(
        q.result.status_code == 0 and rows_multiset(q) == cross_rows[name]
        for name, q in zip(QUERIES, dist_got)),
        f"console --dist -w {DIST_SHARDS}: rc {drc}, rows differ from "
        "phase 6's")
    out["dist"] = {"seconds": dist_s, "rows": {
        name: q.result.nrows for name, q in zip(QUERIES, dist_got)},
        "migrate_status": status[0], "drill": drill}
    log(f"  console --dist -w {DIST_SHARDS}: the seven shapes through "
        f"-d dist, rows as phase 6's ({dist_s:.1f} s with the partitions "
        f"and statistics)")
    out["scrapes"] = scraper.report("phase 8's console, lockdep-checked")
    check(locks["cycles"] == [] and locks["leaf_violations"] == [],
          f"console under scrapes: lock-order cycles {locks['cycles'][:2]}, "
          f"leaf inversions {locks['leaf_violations'][:2]}")
    tracked = {n: held.get(n, 0) - before.get(n, 0) for n in RENDER_LOCKS}
    check(all(c > 0 for c in tracked.values()),
          f"console under scrapes: render-plane locks never tracked by "
          f"lockdep: {sorted(n for n, c in tracked.items() if c <= 0)}")
    out["lockdep"] = {"edges": len(locks["edges"]), "cycles": 0,
                      "leaf_violations": 0, "render_lock_holds": tracked}
    log(f"  console: lockdep-checked under the scrapes: "
        f"{len(locks['edges'])} lock-order edges, no cycle, no leaf "
        f"inversion; {len(tracked)} render-plane locks tracked, "
        f"{sum(tracked.values()):,} holds")
    check(rc == 0 and len(got) == len(QUERIES),
          f"console: rc {rc}, {len(got)} of {len(QUERIES)} shapes answered")
    lat = [m.groups() for m in re.finditer(
        r"result rows: (\d+), avg latency: ([\d,]+) usec \((\d+) runs\)",
        cap.text)]
    check(len(lat) == len(QUERIES), f"console: {len(lat)} latency lines")
    out["shapes"] = {}
    for (name, _t), q, (nrows, usec, runs) in zip(QUERIES.items(), got, lat):
        check(q.result.status_code == 0 and rows_multiset(q) ==
              cross_rows[name], f"console {name}: rows differ from phase 6's")
        out["shapes"][name] = {"rows": q.result.nrows,
                               "avg_us": int(usec.replace(",", "")),
                               "runs": int(runs)}
        log(f"  console {name}: {q.result.nrows:,} rows (as phase 6), avg "
            f"latency {usec} usec over {runs} runs (run_single_query's log)")


# ---------------------------------------------------------------------------
# the observatory's HTTP plane under load (obs/httpd.py; phases 8, 9, 13)
# ---------------------------------------------------------------------------

# every endpoint of the HTTP plane, text and JSON; a scrape must answer 200
# and every JSON body must parse
ENDPOINTS = ("/metrics", "/metrics.json", "/top", "/top.json", "/slo",
             "/slo.json", "/admission", "/admission.json", "/history",
             "/history.json", "/events", "/events.json", "/plan",
             "/plan.json", "/cache", "/cache.json", "/device",
             "/device.json", "/healthz")
SCRAPE_PAUSE_S = 1.0  # between a scraper's rounds (a monitor's pace)
# the ledger locks of the planes the handler renders: process-wide
# singletons made at import, which lockdep's checked mode must rebuild to
# track (phase 8 fails if any of them saw no hold)
RENDER_LOCKS = ("admission.state", "device.compile", "device.dispatch",
                "device.residency", "events.ring", "heat.shard",
                "placement.advisor", "placement.lineage",
                "profile.templates", "reuse.ledger", "reuse.shadow",
                "slo.signals", "slo.tenants", "tsdb.ring")
IDLE_ROUNDS = 200  # rounds of every endpoint in phase 13's idle burst
TSDB_INTERVAL_S = 1  # the metrics ring's interval from phase 9 on
SNAPSHOT_S = 1  # phase 13's metrics snapshot interval


def compile_cache_boot(outcome: str) -> float:
    """The device observatory's compile-cache counter at site ``boot`` for
    the build cache's outcome."""
    from wukong_tpu_torch.obs.metrics import get_registry

    return get_registry().counter(
        "wukong_device_compile_cache_total",
        labels=("outcome", "site")).value(outcome=outcome, site="boot")


def lock_holds() -> dict:
    """Tracked lock name -> releases recorded (lockdep's hold histogram)."""
    from wukong_tpu_torch.obs.metrics import get_registry

    fam = get_registry().snapshot().get("wukong_lock_hold_us") or {}
    return {s["labels"]["name"]: s["count"] for s in fam.get("series", [])}


def set_tsdb_interval(seconds: int) -> None:
    """The metrics ring's sampler restarted at ``seconds`` (a running
    sampler would take its interval only from its next tick)."""
    from wukong_tpu_torch.config import Global
    from wukong_tpu_torch.obs import maybe_start_tsdb, stop_tsdb

    stop_tsdb()
    Global.enable_tsdb, Global.tsdb_interval_s = True, seconds
    check(maybe_start_tsdb() is not None, "the metrics ring did not start")


def start_http_plane() -> int:
    """The HTTP plane on a free loopback port and the metrics ring
    sampling every TSDB_INTERVAL_S seconds; returns the port."""
    import socket

    from wukong_tpu_torch.obs import maybe_start_metrics_http

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    check(maybe_start_metrics_http(port=port) is not None,
          f"the HTTP plane did not bind 127.0.0.1:{port}")
    set_tsdb_interval(TSDB_INTERVAL_S)
    return port


def stop_http_plane() -> None:
    """The HTTP plane down and the metrics ring back at its default
    interval, as phases 10-11 ran before the plane existed (phase 10's
    overload drill rides the host's pace): the ring's 1 s samples dropped
    and the scraper's garbage collected, so the drill's heap holds nothing
    of the scrapes (no phase 10-11 check reads the ring)."""
    from wukong_tpu_torch.config import GlobalConfig
    from wukong_tpu_torch.obs import get_tsdb, stop_metrics_http

    stop_metrics_http()
    get_tsdb().reset()
    set_tsdb_interval(GlobalConfig.tsdb_interval_s)
    gc.collect()


def scrape(port: int, path: str):
    """One GET: (status, ms, body bytes, the parsed JSON body or None)."""
    import urllib.request

    t0 = time.perf_counter()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        status, body = r.status, r.read()
    ms = (time.perf_counter() - t0) * 1e3
    doc = None
    if path.split("?")[0].endswith(".json") or path == "/healthz":
        doc = json.loads(body)
    return status, ms, len(body), doc


class Scraper:
    """A thread that GETs every endpoint in turn, SCRAPE_PAUSE_S between
    rounds, for the life of a ``with`` block; every failure (a status other
    than 200, a JSON body that does not parse, an exception) is kept."""

    def __init__(self, port: int, pause: float = SCRAPE_PAUSE_S):
        import threading

        self.port, self.pause = port, pause
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="chip-smoke-scraper")
        self.ms: dict = {path: [] for path in ENDPOINTS}
        self.errors: list = []
        self.rounds = 0

    def _run(self) -> None:
        while not self.stop.is_set():
            for path in ENDPOINTS:
                try:
                    status, ms, _n, _doc = scrape(self.port, path)
                    self.ms[path].append(ms)
                    if status != 200:
                        self.errors.append((path, status))
                except Exception as e:  # kept: the phase fails on it
                    self.errors.append((path, repr(e)))
            self.rounds += 1
            self.stop.wait(self.pause)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=60)

    def report(self, what: str) -> dict:
        check(not self.thread.is_alive(), f"{what}: the scraper hangs")
        check(self.errors == [], f"{what}: scrapes failed: "
              f"{self.errors[:4]}")
        check(self.rounds > 0, f"{what}: no round of scrapes ended")
        ms = sorted(t for ts in self.ms.values() for t in ts)
        rep = {"rounds": self.rounds, "requests": len(ms),
               "p50_ms": ms[len(ms) // 2], "p99_ms": ms[int(len(ms) * 0.99)],
               "max_ms": ms[-1],
               "p50_ms_by_path": {p: sorted(ts)[len(ts) // 2]
                                  for p, ts in self.ms.items() if ts}}
        log(f"  http: {what}: {rep['rounds']} rounds, {rep['requests']} "
            f"scrapes of {len(ENDPOINTS)} endpoints, every reply 200 and "
            f"every JSON body parsed; p50 {rep['p50_ms']:.2f} ms, p99 "
            f"{rep['p99_ms']:.2f} ms, max {rep['max_ms']:.2f} ms")
        return rep


class ScanCount:
    """The smoke's own count of k-NN scans and the rows they scan: every
    outermost call of vector/knn.py's scan_topk and sliced_topk (the heat
    plane's two producers), counted beside the plane's charge."""

    def __init__(self, knn):
        import threading

        self.knn = knn
        self.lock = threading.Lock()
        self.tls = threading.local()
        self.scans = self.rows = 0
        self.by_route: dict = {}
        self.orig = {}

    def _wrap(self, name: str):
        import inspect

        orig = self.orig[name] = getattr(self.knn, name)
        sig = inspect.signature(orig)

        def counted(*args, **kw):
            outer = not getattr(self.tls, "depth", 0)
            self.tls.depth = getattr(self.tls, "depth", 0) + 1
            try:
                out = orig(*args, **kw)
            finally:
                self.tls.depth -= 1
            if outer:
                call = sig.bind(*args, **kw)
                call.apply_defaults()
                route = call.arguments["route"]
                rows = int(len(call.arguments["vstore"].snapshot()[0]))
                with self.lock:
                    self.scans += 1
                    self.rows += rows
                    self.by_route[route] = self.by_route.get(route, 0) + 1
            return out

        setattr(self.knn, name, counted)

    def __enter__(self):
        for name in ("scan_topk", "sliced_topk"):
            self._wrap(name)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.knn, name, fn)


def kernel_launches() -> dict:
    """Every hand kernel's launch counter."""
    from wukong_tpu_torch.engine import tpu_kernels as K
    from wukong_tpu_torch.engine import tpu_stream as S
    from wukong_tpu_torch.join import kernels as JK
    from wukong_tpu_torch.vector import knn as KN

    return {"probe_kernel": K.probe_kernel.launches,
            "expand_rows": K.expand_rows.launches,
            "stream_emit": S.stream_emit.launches,
            "stream_emit_m": S.stream_emit_m.launches,
            "level_probe": JK.level_probe.launches,
            "knn_scan": KN.knn_scan.launches}


def observatory_after_hybrid(port: int, own: ScanCount, snap_path: str,
                             out: dict) -> None:
    """Phase 13's observatory checks: /top.json's shard 0 holds one vector
    fetch per scan and the rows the scans read, as the smoke counted them;
    /device.json's trend shows dispatches; /plan.json (a fresh sweep)
    renders the advisor's no-store status and the idle migration
    actuator's; the snapshot file parses."""
    _s, _ms, _n, top = scrape(port, "/top.json")
    shard = top["shards"]["shards"].get("0")
    check(shard is not None, "/top.json: no heat charged to shard 0")
    check(shard["by_kind"].get("vector") == own.scans == shard["fetches"]
          and shard["rows"] == own.rows,
          f"/top.json: shard 0 has {shard['by_kind']} fetches and "
          f"{shard['rows']:,} rows; the smoke counted {own.scans} scans of "
          f"{own.rows:,} rows")
    _s, _ms, _n, dev = scrape(port, "/device.json")
    trend = dev["trend"]
    check(trend.get("dispatches_per_s", 0) > 0,
          f"/device.json: no dispatches in the trend window ({trend})")
    _s, _ms, _n, plan = scrape(port, "/plan.json?sweep=1")
    mig = plan["migration"]
    check(plan["status"]["decision"] == "no_store" and mig is not None
          and mig["in_flight"] is False and mig["job"] is None,
          f"/plan.json: {plan['status']}, migration {mig}: not the no-store "
          f"status with an idle actuator")
    check(os.path.isfile(snap_path), "no metrics snapshot was written")
    with open(snap_path) as f:
        snapshot = json.load(f)
    check("wukong_shard_heat_fetches_total" in snapshot,
          "the metrics snapshot lacks the heat counters")
    out.update(vector_fetches=shard["fetches"], rows=shard["rows"],
               scans_by_route=dict(own.by_route), trend=trend,
               plan=plan["status"]["decision"],
               snapshot_bytes=os.path.getsize(snap_path))
    log(f"  http: /top.json shard 0: {shard['fetches']} vector fetches, "
        f"{shard['rows']:,} rows, as counted ({own.by_route} by route); "
        f"/device.json trend {trend}; /plan.json {plan['status']}; the "
        f"snapshot {out['snapshot_bytes']:,} B parsed")


def idle_burst(port: int, out: dict) -> None:
    """IDLE_ROUNDS rounds of every endpoint with the proxy idle: no kernel
    launch, no host sync and no CUDA allocation."""
    import torch

    launches0 = kernel_launches()
    alloc0 = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    ms: list = []

    def burst():
        for _ in range(IDLE_ROUNDS):
            for path in ENDPOINTS:
                status, t, _n, _doc = scrape(port, path)
                check(status == 200, f"idle burst: {path} answered {status}")
                ms.append(t)

    t0 = time.perf_counter()
    syncs, sites = count_syncs(burst)
    seconds = time.perf_counter() - t0
    alloc = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    launches = kernel_launches()
    check(launches == launches0, f"idle burst: kernels launched "
          f"({launches0} -> {launches})")
    check(syncs == 0, f"idle burst: {syncs} host syncs at {sites}")
    check(alloc == alloc0, f"idle burst: {alloc - alloc0} CUDA allocations")
    ms.sort()
    out.update(rounds=IDLE_ROUNDS, requests=len(ms), seconds=seconds,
               p50_ms=ms[len(ms) // 2], p99_ms=ms[int(len(ms) * 0.99)])
    log(f"  http: idle burst, {IDLE_ROUNDS} rounds of {len(ENDPOINTS)} "
        f"endpoints ({len(ms):,} scrapes, {seconds:.1f} s, p50 "
        f"{out['p50_ms']:.2f} ms, p99 {out['p99_ms']:.2f} ms): no kernel "
        f"launch, no host sync, no CUDA allocation")


def analysis_gates(out: dict) -> None:
    """``python -m wukong_tpu_torch.analysis --json`` over the port's tree:
    every gate clean, migration-safety among them."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "wukong_tpu_torch.analysis", "--json"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    doc = json.loads(proc.stdout) if proc.stdout.strip() else {}
    check(proc.returncode == 0 and doc.get("count") == 0
          and "migration-safety" in doc.get("gates", ()),
          f"wukong-analyze: rc {proc.returncode}, gates "
          f"{doc.get('gates')}, {doc.get('violations', proc.stderr)[:4]}")
    out.update(gates=len(doc["gates"]), count=doc["count"],
               seconds=time.perf_counter() - t0)
    log(f"  gates: python -m wukong_tpu_torch.analysis --json: "
        f"{len(doc['gates'])} gates, {doc['count']} violations "
        f"({out['seconds']:.1f} s)")


# ---------------------------------------------------------------------------
# phase 9: live serving with coalescing (runtime/batcher.py)
# ---------------------------------------------------------------------------

LIVE_ANCHORS = 512  # light texts: the first anchors of advisor's OUT index
LIVE_HEAVY_SHARE = 0.3  # heavy arrivals in the mixed workload
LIVE_DURATION_S, LIVE_WARMUP_S = 5.0, 1.0
# (workload, knobs, clients, mixed): bench.py --serve-batched's light runs,
# then --serve-mixed's heavy lane off and on (at the default
# heavy_split_threshold a LUBM-640 heavy dispatch splits, as many parts as
# heavy_split_max allows), on with no split, and the split forced to 2
LIVE_RUNS = (
    ("light, batching off", {"enable_batching": False}, 16, False),
    ("light, batching on", {"enable_batching": True}, 16, False),
    ("mixed, heavy lane off", {"enable_batching": True, "heavy_lane": False},
     24, True),
    ("mixed, heavy lane on", {"enable_batching": True, "heavy_lane": True},
     24, True),
    ("mixed, heavy lane on, no split", {"enable_batching": True,
                                        "heavy_lane": True,
                                        "heavy_split_max": 1}, 24, True),
    ("mixed, split forced", {"enable_batching": True, "heavy_lane": True,
                             "heavy_split_threshold": 1,
                             "heavy_split_max": 2}, 24, True),
)
LIVE_KNOBS = ("enable_batching", "heavy_lane", "heavy_split_threshold",
              "heavy_split_max")
# the batcher's counters a run reads (deltas over the run)
LIVE_SERIES = ("wukong_batch_flush_total", "wukong_batch_bypass_total",
               "wukong_batch_fused_queries_total",
               "wukong_batch_fallback_total",
               "wukong_batch_member_timeouts_total",
               "wukong_batch_heavy_fused_total",
               "wukong_batch_heavy_dispatch_total",
               "wukong_batch_heavy_slices_total",
               "wukong_batch_heavy_fallback_total")


def live_texts(proxy) -> tuple:
    """bench.py --serve-batched's light texts (``?s advisor <a>`` for the
    first LIVE_ANCHORS anchors) and --serve-mixed's two index-origin 3-hop
    heavy texts, written inline."""
    from wukong_tpu_torch.loader.lubm import UB

    light = family_texts(proxy, ("advisor",), LIVE_ANCHORS)
    ug = ("SELECT ?x ?y ?z WHERE { ?x "
          "<http://www.w3.org/1999/02/22-rdf-syntax-ns#type> "
          f"<{UB}UndergraduateStudent> . ?x <{UB}takesCourse> ?y . ")
    heavy = [ug + f"?x <{UB}memberOf> ?z . }}",
             ug + f"?x <{UB}advisor> ?z . }}"]
    return light, heavy


def live_prepare(proxy, results: dict) -> tuple:
    """Phase 9's set-up, before its kernel counts start: each text's direct
    (unbatched) row count, which every live reply must equal, and one
    sliced dispatch of each heavy text, whole and in two mt parts, so the
    runs find their segments and lists staged."""
    import copy

    from wukong_tpu_torch.config import Global

    light, heavy = live_texts(proxy)
    check(Global.enable_batching is False,
          "phase 9 must start with batching off")
    want = {}
    t0 = time.perf_counter()
    for text in light + heavy:
        q = proxy.serve_query(text, blind=True)
        check(q.result.status_code == 0, f"live direct count: status "
              f"{q.result.status_code!r}")
        want[text] = q.result.nrows
    check(all(want[t] > 0 for t in heavy), "a heavy text has no rows")
    check(sum(want[t] for t in light) > 0, "the light texts have no rows")
    for text in heavy:
        q = proxy._parse_text(text)
        proxy._plan_prepared(q, True, None)
        b = proxy.heavy_index_batch(q)
        for S in (1, 2):
            total = 0
            for k in range(S):
                qk = copy.deepcopy(q)
                qk.mt_factor, qk.mt_tid = S, k
                total += int(proxy.gpu.execute_batch_index(
                    qk, b, slice_mode=True).sum())
            check(total == want[text], f"heavy slice dispatch in {S} parts: "
                  f"{total} rows, direct {want[text]}")
    results["live"] = {"light_texts": len(light), "heavy_texts": heavy,
                       "light_rows": sum(want[t] for t in light),
                       "heavy_rows": [want[t] for t in heavy],
                       "prepare_s": time.perf_counter() - t0, "runs": {}}
    log(f"  live: {len(light)} light texts ({results['live']['light_rows']:,}"
        f" rows in all), heavy rows {results['live']['heavy_rows']}, "
        f"direct counts and slice warm-up in "
        f"{results['live']['prepare_s']:.1f} s")
    return light, heavy, want


class LiveClasses:
    """The class of each kernel call made while serving, kept per thread: a
    fused light group's seeded chain, a heavy slice's dispatch, or a direct
    (unbatched) dispatch. ``of`` is Capture's ``class_of``."""

    def __init__(self):
        import threading

        self.tls = threading.local()

    def of(self, _args) -> str:
        return getattr(self.tls, "cls", ", direct dispatch")

    def _tagged(self, fn, cls: str):
        tls = self.tls

        def tagged(*args, **kw):
            prev = getattr(tls, "cls", None)
            tls.cls = cls
            try:
                return fn(*args, **kw)
            finally:
                if prev is None:
                    del tls.cls
                else:
                    tls.cls = prev
        return tagged

    def __enter__(self):
        from wukong_tpu_torch.runtime.batcher import FusedGroup, HeavyGroup

        self.saved = (FusedGroup._run_fused, HeavyGroup._run_slice)
        # HeavyGroup overrides _run_fused: only light groups take this one
        FusedGroup._run_fused = self._tagged(FusedGroup._run_fused,
                                             ", fused light group")
        HeavyGroup._run_slice = self._tagged(HeavyGroup._run_slice,
                                             ", heavy slice")
        return self

    def __exit__(self, *exc):
        from wukong_tpu_torch.runtime.batcher import FusedGroup, HeavyGroup

        FusedGroup._run_fused, HeavyGroup._run_slice = self.saved


class CheckedReplies:
    """Stands for the proxy in Emulator.run_serving: passes each call on and
    keeps every reply whose row count is not its text's direct count."""

    def __init__(self, proxy, want: dict):
        import threading

        self.proxy, self.want = proxy, want
        self.bad: list = []
        self.replies = 0
        self._lock = threading.Lock()

    def serve_query(self, text, blind=True):
        q = self.proxy.serve_query(text, blind=blind)
        with self._lock:
            self.replies += 1
            if q.result.status_code == 0 \
                    and q.result.nrows != self.want[text]:
                self.bad.append((text, q.result.nrows, self.want[text]))
        return q


def batch_series() -> dict:
    """The batcher's counters and occupancy histograms, flat."""
    from wukong_tpu_torch.obs import get_registry

    snap = get_registry().snapshot()
    out = {}
    for name in LIVE_SERIES:
        for srs in snap.get(name, {}).get("series", []):
            lbl = ",".join(f"{k}={v}" for k, v in srs["labels"].items())
            out[f"{name}{{{lbl}}}" if lbl else name] = srs["value"]
    for name in ("wukong_batch_occupancy", "wukong_batch_heavy_occupancy"):
        for srs in snap.get(name, {}).get("series", []):
            out[f"{name}_sum"] = srs["sum"]
            out[f"{name}_count"] = srs["count"]
    return out


def live_replay(proxy, name: str, light: list, heavy: list,
                want: dict) -> dict:
    """A single-client replay of what run ``name`` dispatched, untimed: host
    syncs per dispatch (sync debug mode), and rows. Light: 64 texts as one
    fused group, each member's rows the direct path's as a multiset (with
    batching off, one direct query). Heavy: eight members of one heavy
    text as one heavy group (split when the run forced it), each member
    the direct count (with the heavy lane off, one direct query)."""
    from wukong_tpu_torch.config import Global
    from wukong_tpu_torch.runtime.batcher import (
        FusedGroup,
        HeavyGroup,
        _Pending,
    )

    def planned(text, blind):
        q = proxy._parse_text(text)
        proxy._plan_prepared(q, blind, None)
        return q

    out = {}
    if not Global.enable_batching:
        out["light_syncs_per_direct_query"], _ = count_syncs(
            lambda: proxy.gpu.execute(planned(light[0], True)))
        return out
    members = [_Pending(planned(t, False)) for t in light[:64]]
    group = FusedGroup(members, proxy.batcher(), engine=proxy.gpu,
                       reason="replay")
    out["light_syncs_per_fused_dispatch"], out["light_sync_sites"] = \
        count_syncs(lambda: group.run(None))
    saved = Global.enable_batching
    Global.enable_batching = False
    try:
        for m, text in zip(members, light[:64]):
            check(m.q.result.status_code == 0, f"live replay: status "
                  f"{m.q.result.status_code!r}")
            direct = proxy.serve_query(text, blind=False)
            check(rows_multiset(m.q) == rows_multiset(direct),
                  f"live replay: a fused member's rows differ from the "
                  f"direct path's ({m.q.result.nrows} against "
                  f"{direct.result.nrows})")
    finally:
        Global.enable_batching = saved
    if not heavy or not Global.heavy_lane:
        if heavy:
            out["heavy_syncs_per_direct_query"], _ = count_syncs(
                lambda: proxy.gpu.execute(planned(heavy[0], True)))
        return out
    members = [_Pending(planned(heavy[0], True)) for _ in range(8)]
    group = HeavyGroup(members, proxy.batcher(), engine=proxy.gpu,
                       reason="replay")
    out["heavy_syncs_per_fused_dispatch"], out["heavy_sync_sites"] = \
        count_syncs(lambda: group.run(None))
    out["heavy_replay_slices"] = group._split_factor(members[0].q)
    check(all(m.q.result.status_code == 0
              and m.q.result.nrows == want[heavy[0]] for m in members),
          f"live replay: heavy members {[m.q.result.nrows for m in members]}"
          f", direct {want[heavy[0]]}")
    return out


def serve_live(proxy, texts: tuple, k1, results: dict) -> None:
    """Phase 9 on phase 3's proxy (planner from phase 7): each LIVE_RUNS
    workload through Emulator.run_serving (closed-loop clients,
    serve_query(text, blind=True), LIVE_DURATION_S after LIVE_WARMUP_S,
    seed 1), mixed runs with the engine pool started. Each run: zero
    errors, every reply the direct count, no fused or heavy fallback, no
    capacity degradation, no inline run after a failed lane submit; K1
    launched in each workload; batching on: fused queries and mean
    occupancy above 1; the
    heavy lane on: heavy fused members; the split forced: split
    dispatches. Then the run's single-client replay (live_replay). ``k1``
    reads K1's launch count."""
    from wukong_tpu_torch.config import Global
    from wukong_tpu_torch.runtime.emulator import Emulator

    light, heavy, want = texts
    out = results["live"]["runs"]
    saved = {k: getattr(Global, k) for k in LIVE_KNOBS}
    mixed_w = ([(1 - LIVE_HEAVY_SHARE) / len(light)] * len(light)
               + [LIVE_HEAVY_SHARE / len(heavy)] * len(heavy))
    k1_by_workload: dict = {}
    try:
        for name, knobs, clients, mixed in LIVE_RUNS:
            for k in LIVE_KNOBS:
                setattr(Global, k, knobs.get(k, saved[k]))
            if mixed:
                proxy.engine_pool()  # the heavy lane needs the pool
            run_texts = light + heavy if mixed else light
            checker = CheckedReplies(proxy, want)
            before, k1_before = batch_series(), k1()
            with LogCapture() as cap:
                rep = Emulator(checker).run_serving(
                    run_texts, duration_s=LIVE_DURATION_S,
                    warmup_s=LIVE_WARMUP_S, clients=clients, seed=1,
                    weights=mixed_w if mixed else None,
                    classes=([0] * len(light) + [1] * len(heavy)
                             if mixed else None))
                after, k1_n = batch_series(), k1() - k1_before
                lanes = proxy.monitor.lane_lines() if mixed else []
                replay = live_replay(proxy, name, light,
                                     heavy if mixed else [], want)
            d = {k: v - before.get(k, 0) for k, v in after.items()
                 if v - before.get(k, 0)}

            def mean_occ(h):
                n = d.get(f"{h}_count", 0)
                return d.get(f"{h}_sum", 0) / n if n else None

            row = {**rep, "knobs": knobs, "replies": checker.replies,
                   "k1_launches": k1_n, "counters": d,
                   "mean_occupancy": mean_occ("wukong_batch_occupancy"),
                   "mean_heavy_occupancy": mean_occ(
                       "wukong_batch_heavy_occupancy"),
                   "lane_lines": lanes, **replay}
            out[name] = row
            log(f"  live [{name}], {clients} clients: {rep['qps']:,.1f} "
                f"queries/s, p50 {rep['p50_us']:,} us, p99 "
                f"{rep['p99_us']:,} us, errors {rep['errors']}, "
                f"{checker.replies:,} replies; mean occupancy "
                f"{row['mean_occupancy']}, heavy "
                f"{row['mean_heavy_occupancy']}; K1 {k1_n:,} launches")
            for c, v in (rep.get("by_class") or {}).items():
                log(f"    class {'heavy' if c else 'light'}: "
                    f"{v['qps']:,.1f} queries/s, p50 {v['p50_us']:,} us, "
                    f"p99 {v['p99_us']:,} us")
            log(f"    counters {d}")
            log(f"    replay {replay}; {lanes}")
            check(rep["errors"] == 0, f"live [{name}]: {rep['errors']} "
                  f"errors")
            check(rep["served"] > 0, f"live [{name}]: nothing served")
            check(not checker.bad, f"live [{name}]: {len(checker.bad)} "
                  f"replies off their direct count, e.g. {checker.bad[:2]}")
            check(not any(k.startswith(("wukong_batch_fallback_total",
                                        "wukong_batch_heavy_fallback_total"))
                          for k in d),
                  f"live [{name}]: a fused dispatch fell back: {d}")
            check("degrading to the host engine" not in cap.text,
                  f"live [{name}]: a capacity degradation was logged")
            check("running inline" not in cap.text,
                  f"live [{name}]: a lane submit failed and ran inline")
            workload = name.split(",")[0]
            k1_by_workload[workload] = k1_by_workload.get(workload, 0) + k1_n
            if knobs["enable_batching"]:
                check(d.get("wukong_batch_fused_queries_total", 0) > 0
                      and (row["mean_occupancy"] or 0) > 1,
                      f"live [{name}]: no light coalescing ({d})")
            if mixed and knobs.get("heavy_lane"):
                check(d.get("wukong_batch_heavy_fused_total", 0) > 0,
                      f"live [{name}]: no heavy fused members ({d})")
            if knobs.get("heavy_split_threshold") == 1:
                check(d.get("wukong_batch_heavy_dispatch_total{mode=split}",
                            0) > 0, f"live [{name}]: no split dispatch")
        # a direct light query is a host CSR lookup (a const start, one
        # step): K1 runs in the light workload's fused seeded chains
        for workload, n in k1_by_workload.items():
            check(n > 0, f"live, {workload} workload: K1 never launched")
        results["live"]["k1_by_workload"] = k1_by_workload
    finally:
        for k, v in saved.items():
            setattr(Global, k, v)
        stop_pool(proxy)
        if proxy._batcher is not None:
            proxy._batcher.close()
            proxy._batcher = None


# ---------------------------------------------------------------------------
# phase 10: multi-tenant serving (admission, SLOs, tracing, EXPLAIN ANALYZE)
# ---------------------------------------------------------------------------

TENANT_RUN_S, TENANT_WARMUP_S = 3.0, 1.0
# bench.py --tenants' overload drill: quotas, in-flight ceiling, clients x2
TENANT_QUOTAS = "gold:8:0:0:0;silver:4:0:0:0;bulk:1:25:4:0"
TENANT_MAX_INFLIGHT = 6
TENANT_KNOBS = ("enable_batching", "heavy_lane", "enable_admission",
                "admission_quotas", "admission_max_inflight",
                "enable_tracing", "trace_sample_every", "xprof_dir")
TENANT_REPLAY = 64  # light texts replayed with tracing off and on


class TenantReplies:
    """Stands for the proxy in Emulator.run_tenants: passes each call on
    and keeps (tenant, text, status, nrows, complete) of every reply, and
    (tenant, start, end) of every call, in perf_counter seconds."""

    def __init__(self, proxy):
        import threading

        self.proxy = proxy
        self.replies: list = []
        self.spans: list = []
        self._lock = threading.Lock()

    def serve_query(self, text, blind=True, tenant="default"):
        t0 = time.perf_counter()
        try:
            q = self.proxy.serve_query(text, blind=blind, tenant=tenant)
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.spans.append((tenant, t0, t1))
        r = q.result
        with self._lock:
            self.replies.append((tenant, text, int(r.status_code), r.nrows,
                                 bool(r.complete)))
        return q

    def late(self, tenant: str, limit_ms: float, t_base: float) -> list:
        """(end in s from t_base, ms) of the tenant's calls over
        ``limit_ms``, in order of their end."""
        return sorted((round(t1 - t_base, 3), round((t1 - t0) * 1e3, 1))
                      for ten, t0, t1 in self.spans
                      if ten == tenant and (t1 - t0) * 1e3 > limit_ms)

    def off_count(self, want: dict) -> list:
        """Served, complete replies whose row count is not the text's
        direct count."""
        return [r for r in self.replies
                if r[2] == 0 and r[4] and r[3] != want[r[1]]]


def tenant_run(proxy, name: str, texts: list, want: dict, k1, out: dict,
               **kw) -> dict:
    """One Emulator.run_tenants run through TenantReplies, with the checks
    every run of phase 10 makes: no reply off its direct count, no fused
    or heavy fallback, no capacity degradation, no inline run after a
    failed lane submit, K1 launched."""
    from wukong_tpu_torch.runtime.emulator import Emulator

    checker = TenantReplies(proxy)
    before, k1_before = batch_series(), k1()
    t_base = time.perf_counter()
    with LogCapture() as cap:
        rep = Emulator(checker).run_tenants(texts, seed=1, **kw)
    d = {k: v - before.get(k, 0) for k, v in batch_series().items()
         if v - before.get(k, 0)}
    k1_n = k1() - k1_before
    row = {"tenants": {t: {k: v for k, v in r.items() if k != "slo"}
                       for t, r in rep["tenants"].items()},
           "slo": {t: r["slo"] for t, r in rep["tenants"].items()},
           "alerts": rep["alerts"], "burn_dumps": rep["burn_dumps"],
           "qps": rep["qps"], "replies": len(checker.replies),
           "k1_launches": k1_n, "counters": d}
    if "admission" in rep:
        row["admission"] = rep["admission"]
    out[name] = row
    log(f"  tenants [{name}]: {rep['qps']:,.1f} queries/s, "
        f"{len(checker.replies):,} replies, K1 {k1_n:,} launches")
    for t, r in rep["tenants"].items():
        slo = r["slo"] or {}
        log(f"    {t}: {r['clients']} clients, {r['qps']:,.1f} queries/s, "
            f"p50 {r['p50_us']:,} us, p99 {r['p99_us']:,} us, served "
            f"{r['served']:,}, errors {r['errors']}, partial {r['partial']},"
            f" rejected {r['rejected']}; compliance {slo.get('compliance')},"
            f" budget left {slo.get('error_budget_remaining')}, latency met "
            f"{slo.get('latency_met')}, alerts {slo.get('alerts')}")
    # a finding, not a gate: when gold's late calls fall (its warm-up
    # counts toward its SLO window)
    late = checker.late("gold", 50.0, t_base)
    row["gold_late"] = late
    log(f"    gold calls over 50 ms: {len(late)} (s from the run's start, "
        f"ms): {late[:24]}")
    bad = checker.off_count(want)
    check(not bad, f"tenants [{name}]: {len(bad)} replies off their direct "
          f"count, e.g. {bad[:2]}")
    check(not any(k.startswith(("wukong_batch_fallback_total",
                                "wukong_batch_heavy_fallback_total"))
                  for k in d), f"tenants [{name}]: a fused dispatch fell "
          f"back: {d}")
    check("degrading to the host engine" not in cap.text,
          f"tenants [{name}]: a capacity degradation was logged")
    check("running inline" not in cap.text,
          f"tenants [{name}]: a lane submit failed and ran inline")
    check(k1_n > 0, f"tenants [{name}]: K1 never launched")
    return rep


def tenant_runs(proxy, light: list, heavy: list, want: dict, k1,
                entry: dict, out: dict) -> None:
    """Runs A-D of phase 10: the default classes (normal), chaos at the
    proxy.serve boundary, the 2x overload drill with admission armed, and
    the drill again with bulk sending the heavy texts through the heavy
    lane."""
    import json as _json

    from wukong_tpu_torch.config import Global
    from wukong_tpu_torch.obs import get_recorder
    from wukong_tpu_torch.obs.slo import SLOSpec
    from wukong_tpu_torch.runtime.admission import (
        get_admission,
        render_admission,
    )

    runs = out["runs"]
    entry["name"] = ", run A"
    rep = tenant_run(proxy, "A normal", light, want, k1, runs,
                     duration_s=TENANT_RUN_S, warmup_s=TENANT_WARMUP_S)
    for t, r in rep["tenants"].items():
        check(r["errors"] == 0 and r["served"] > 0,
              f"tenants [A]: {t} has {r['errors']} errors, "
              f"{r['served']} served")

    entry["name"] = ", run B"
    rep = tenant_run(proxy, "B chaos", light, want, k1, runs, chaos=True,
                     chaos_p=0.25, duration_s=TENANT_RUN_S, warmup_s=0.5)
    al = rep["alerts"]
    check(al["gold"] >= 1 and al["silver"] >= 1 and al["bulk"] == 0,
          f"tenants [B]: alerts {al} (want gold and silver >= 1, bulk 0)")
    per: dict = {}
    for d in rep["burn_dumps"]:
        per[d["tenant"]] = per.get(d["tenant"], 0) + 1
    check(per == {"gold": 1, "silver": 1},
          f"tenants [B]: SLO_BURN dumps by tenant {per} (want one each "
          f"for gold and silver)")
    for reason, tr in list(get_recorder().dumps):
        if reason != "SLO_BURN":
            continue
        _json.dumps(tr.to_dict())
        check("fault.injected" in trace_marks(tr),
              f"tenants [B]: dumped trace {tr.trace_id} carries no "
              f"fault.injected event ({trace_marks(tr)})")
    log(f"    burn dumps {rep['burn_dumps']}, each JSON and carrying a "
        f"fault.injected event")

    Global.enable_admission = True
    Global.admission_quotas = TENANT_QUOTAS
    Global.admission_max_inflight = TENANT_MAX_INFLIGHT
    for run, bulk_texts in (("C overload", None), ("D bulk heavies", heavy)):
        get_admission().reset()
        tenants = None
        if bulk_texts:
            tenants = [
                {"tenant": "gold", "clients": 2, "texts": light,
                 "slo": SLOSpec("gold", 0.95, 50.0, 0.999)},
                {"tenant": "silver", "clients": 2, "texts": light,
                 "slo": SLOSpec("silver", 0.95, 500.0, 0.99)},
                {"tenant": "bulk", "clients": 4, "texts": bulk_texts,
                 "slo": SLOSpec("bulk", 0.95, 0.0, 0.9)}]
        entry["name"] = ", run " + run[0]
        rep = tenant_run(proxy, run, light, want, k1, runs, tenants=tenants,
                         overload_x=2.0, duration_s=TENANT_RUN_S,
                         warmup_s=TENANT_WARMUP_S)
        adm = rep["admission"]
        dec = adm["decisions"]
        bulk_shed = sum(n for k, n in dec.items()
                        if k.endswith("/bulk") and not k.startswith("admit/"))
        gold = rep["tenants"]["gold"]
        gslo = gold["slo"] or {}
        text, _js = render_admission()
        log("    " + text.replace("\n", "\n    ").rstrip())
        check(bulk_shed > 0, f"tenants [{run}]: bulk was never shed ({dec})")
        if bulk_texts is None:
            check(gslo.get("latency_met") is True
                  and (gslo.get("error_budget_remaining") or 0.0) >= 0.0,
                  f"tenants [{run}]: gold not compliant ({gslo})")
            check(gold["partial"] == 0 and gold["rejected"] == 0,
                  f"tenants [{run}]: gold degraded ({gold})")
        else:
            for t in ("gold", "silver"):
                check(rep["tenants"][t]["errors"] == 0,
                      f"tenants [{run}]: {t} has errors")
            pool = proxy._pool
            check(pool is not None and not pool._heavy_by_tenant
                  and pool._heavy_inflight == 0,
                  f"tenants [{run}]: heavy slots not settled "
                  f"({pool._heavy_by_tenant}, {pool._heavy_inflight})")
            log(f"    heavy slots settled; gold compliance "
                f"{gslo.get('compliance')} (printed, not gated)")
    Global.enable_admission = False
    get_admission().reset()


def tenant_analyze(proxy, results: dict, out: dict, entry: dict) -> None:
    """EXPLAIN ANALYZE of the seven shapes under the planner at the serve
    scale: phase 7's rows, a decomposition whose components sum to at most
    the total, each rendered table printed once."""
    entry["name"] = ", analyze"
    single = results["batched"]["single"]
    out["analyze"] = {}
    for name, text in QUERIES.items():
        rep = proxy.explain_query(text, analyze=True)
        d = rep["decomposition"]
        check(rep["status"] == "SUCCESS" and rep["rows"]
              == single[name]["rows"], f"analyze {name}: {rep['status']} "
              f"{rep['rows']} rows, phase 7 {single[name]['rows']}")
        check(sum(d["components"].values()) <= d["total_us"],
              f"analyze {name}: components exceed the total ({d})")
        out["analyze"][name] = {k: v for k, v in rep.items()
                                if k != "rendered"}
        log(f"  analyze {name}:\n    "
            + rep["rendered"].replace("\n", "\n    "))


def tenant_replay(proxy, light: list, heavy: list, want: dict,
                  out: dict, entry: dict) -> None:
    """Tracing adds no sync: 64 light texts single-threaded, direct and then
    as one fused group, and the heavy texts, direct and as one heavy group,
    with enable_tracing off and then on at sample 1: equal host syncs per
    query and per group, every recorded trace JSON, the direct traces'
    spans, batch.settled on every fused member; median latency as a
    finding."""
    import json as _json

    from wukong_tpu_torch.config import Global
    from wukong_tpu_torch.obs import get_recorder, maybe_start_trace
    from wukong_tpu_torch.runtime.batcher import (
        FusedGroup,
        HeavyGroup,
        _Pending,
    )

    entry["name"] = ", replay"
    texts = light[:TENANT_REPLAY]
    res: dict = {}
    for traced in (False, True):
        Global.enable_tracing = traced
        Global.trace_sample_every = 1
        get_recorder().clear()
        Global.enable_batching = False
        lat, syncs = [], []
        direct = []
        for t in texts:
            t0 = time.perf_counter()
            n, _ = count_syncs(lambda t=t: direct.append(
                (t, proxy.serve_query(t, blind=True))))
            lat.append((time.perf_counter() - t0) * 1e6)
            syncs.append(n)
        hsyncs = []
        for t in heavy:
            n, _ = count_syncs(lambda t=t: direct.append(
                (t, proxy.serve_query(t, blind=True))))
            hsyncs.append(n)
        for t, q in direct:
            check(q.result.status_code == 0 and q.result.nrows == want[t],
                  "replay: a direct reply is off its count")

        def planned(text, blind):
            tr = maybe_start_trace(kind="query", text=text)
            return proxy._prepare(text, blind, None, "default", tr, None)

        members = [_Pending(planned(t, False)) for t in texts]
        group = FusedGroup(members, proxy.batcher(), engine=proxy.gpu,
                           reason="replay")
        gsync, gsites = count_syncs(lambda: group.run(None))
        hmembers = [_Pending(planned(heavy[0], True)) for _ in range(8)]
        hgroup = HeavyGroup(hmembers, proxy.batcher(), engine=proxy.gpu,
                            reason="replay")
        hgsync, _ = count_syncs(lambda: hgroup.run(None))
        check(all(m.q.result.status_code == 0
                  and m.q.result.nrows == want[heavy[0]] for m in hmembers),
              "replay: a heavy member is off its count")
        for m in members + hmembers:
            check(m.q.result.status_code == 0, "replay: a member failed")
            if m.trace is not None:
                get_recorder().on_complete(m.trace, m.q.result.status_code)
        res[traced] = {"direct_syncs": sorted(set(syncs)),
                       "heavy_direct_syncs": hsyncs,
                       "fused_syncs": gsync, "heavy_group_syncs": hgsync,
                       "median_us": statistics.median(lat)}
        if traced:
            recorded = get_recorder().last()
            for tr in recorded + [t for _r, t in get_recorder().dumps]:
                _json.dumps(tr.to_dict())
            for _t, q in direct:
                names = {sp.name for sp in q.trace.spans}
                check({"proxy.parse", "proxy.plan", "gpu.execute",
                       "gpu.chain"} <= names,
                      f"replay: a direct trace lacks spans ({names})")
            for m in members + hmembers:
                check("batch.settled" in trace_marks(m.trace),
                      "replay: a fused member has no batch.settled")
            check_attrs(recorded)
            res[traced]["recorded"] = len(recorded)
    Global.enable_tracing = False
    log(f"  replay: tracing off {res[False]}; on {res[True]}")
    for k in ("direct_syncs", "heavy_direct_syncs", "fused_syncs",
              "heavy_group_syncs"):
        check(res[False][k] == res[True][k],
              f"replay: {k} {res[False][k]} with tracing off, "
              f"{res[True][k]} on")
    check(res[False]["direct_syncs"] == [1] and res[False]["fused_syncs"]
          == 2, f"replay: syncs {res[False]} (want 1 a direct query, 2 a "
          f"fused group)")
    out["replay"] = {"off": res[False], "on": res[True]}


def trace_marks(tr) -> set:
    """The events of a trace: those inside a span, and those recorded
    where the thread had no open span (a zero-length span of the event's
    name, QueryTrace.event)."""
    return set(tr.event_names()) | {sp.name for sp in tr.spans
                                    if sp.t1_us == sp.t0_us}


def check_attrs(traces) -> None:
    """Every span attribute is a host scalar (no tensor, no numpy value)."""
    for tr in traces:
        for sp in tr.spans:
            for k, v in sp.attrs.items():
                check(v is None or type(v) in (int, float, str, bool),
                      f"span {sp.name} attribute {k} is {type(v)}")


def tenant_device_trace(proxy, out: dict, entry: dict) -> None:
    """q6 and q2 through run_single_query with xprof_dir set: the Chrome
    trace written there holds CUDA kernel events, K1's among them (q2), and
    each query's kernels by device time are printed."""
    from wukong_tpu_torch.config import Global
    from wukong_tpu_torch.obs import export

    entry["name"] = ", device trace"
    out["device_trace"] = {}
    Global.enable_batching = False  # the direct path's kernels
    with tempfile.TemporaryDirectory() as d:
        Global.xprof_dir = d
        try:
            for name in ("lubm_q6", "lubm_q2"):
                q = proxy.run_single_query(QUERIES[name])
                check(q.result.status_code == 0, f"device trace {name}: "
                      f"status {q.result.status_code!r}")
                path = export.last_capture
                check(path is not None and path.startswith(d),
                      f"device trace {name}: no capture written")
                kern = export.kernel_summary(path)
                check(kern, f"device trace {name}: no CUDA kernel events")
                if name == "lubm_q2":
                    check(any("probe_kernel" in k["name"] for k in kern),
                          f"device trace {name}: K1 absent "
                          f"({[k['name'] for k in kern]})")
                total = sum(k["total_us"] for k in kern)
                out["device_trace"][name] = {"kernels": kern[:12],
                                             "device_us": total,
                                             "rows": q.result.nrows}
                log(f"  device trace {name}: {q.result.nrows:,} rows, "
                    f"{len(kern)} kernels, {total:,.1f} us of device time")
                for k in kern[:8]:
                    log(f"    {k['total_us']:>10,.1f} us  {k['calls']:>4} "
                        f"calls  {k['name'][:90]}")
        finally:
            Global.xprof_dir = ""


def serve_tenants(proxy, texts: tuple, k1, entry: dict,
                  results: dict) -> None:
    """Phase 10 on phase 3's proxy (planner from phase 7), the pool started
    and batching on: runs A-D, EXPLAIN ANALYZE of the seven shapes, the
    tracing replay and the device trace."""
    from wukong_tpu_torch.config import Global

    light, heavy, want = texts
    out = results["tenants"] = {"runs": {}}
    saved = {k: getattr(Global, k) for k in TENANT_KNOBS}
    try:
        Global.enable_batching = True
        Global.heavy_lane = True
        proxy.engine_pool()
        tenant_runs(proxy, light, heavy, want, k1, entry, out)
        tenant_analyze(proxy, results, out, entry)
        tenant_replay(proxy, light, heavy, want, out, entry)
        tenant_device_trace(proxy, out, entry)
    finally:
        for k, v in saved.items():
            setattr(Global, k, v)
        stop_pool(proxy)
        if proxy._batcher is not None:
            proxy._batcher.close()
            proxy._batcher = None


def explain_parity(on_cpu, on_gpu, results: dict) -> None:
    """Phase 10's EXPLAIN half on phase 6's store: the seven shapes'
    reports under one planner's statistics equal on cpu and cuda, the
    rendered table aside (the planner is host code); each table printed."""
    out = results["tenants"]["explain"] = {}
    for name, text in QUERIES.items():
        a, b = on_cpu.explain_query(text), on_gpu.explain_query(text)
        a.pop("rendered")
        table = b.pop("rendered")
        check(a == b, f"explain {name}: cpu {a} != cuda {b}")
        out[name] = b
        log(f"  explain {name} (equal on cpu and cuda):\n    "
            + table.replace("\n", "\n    "))


def merged_rows(captures: dict, phase: str, kernel_fns: dict,
                errs: dict) -> list:
    """One kernels-line row per kernel a phase launched: held and timed on
    its largest input over every class of its calls, with the launches of
    all of them."""
    rows = []
    for name, cap in captures.items():
        n = sum(cap.launches.values())
        if n:
            fn, plain, work_of = kernel_fns[name]
            best = max(cap.best.values(), key=lambda b: b[0])
            rows.append(measure(name, phase, best, n, fn, plain, work_of,
                                errs))
    return rows


def cross_check_batched(on_cpu, on_gpu, triples, seed: int) -> None:
    """Phase 6's batched half: both proxies under one planner's statistics
    give identical per-qid counts from every batched entry point."""
    import numpy as np

    from wukong_tpu_torch.planner.optimizer import Planner
    from wukong_tpu_torch.planner.stats import Stats

    stats = Stats.generate(triples)
    for p in (on_cpu, on_gpu):
        p.planner, p.gpu.stats = Planner(stats), stats

    def same(what, a, b):
        a = [np.asarray(x).tolist() for x in a]
        b = [np.asarray(x).tolist() for x in b]
        check(a == b, f"cross-check {what}: cpu {a} != cuda {b}")

    B = 256
    jobs = {}
    for name in TEMPLATES:
        pair = [template_job(p, name, np.random.default_rng(seed), B)
                for p in (on_cpu, on_gpu)]
        if pair[0] is None or pair[1] is None:
            check(pair[0] is None and pair[1] is None,
                  f"cross-check {name}: batchable on one device only")
            continue
        (_t, qa, da), (_t2, qb, db) = pair
        check(all(np.array_equal(x, y) for x, y in zip(da, db)),
              f"cross-check {name}: draws differ")
        for p, q in ((on_cpu, qa), (on_gpu, qb)):
            jobs.setdefault(p, []).append((q, da[0]))
        ea, eb = on_cpu.gpu, on_gpu.gpu
        same(f"{name} execute_batch", [ea.execute_batch(qa, da[0])],
             [eb.execute_batch(qb, da[0])])
        same(f"{name} execute_batch_many", ea.execute_batch_many(qa, da[:2]),
             eb.execute_batch_many(qb, da[:2]))
    same("execute_batch_mixed",
         on_cpu.gpu.execute_batch_mixed(jobs[on_cpu]),
         on_gpu.gpu.execute_batch_mixed(jobs[on_gpu]))
    for name in HEAVY:
        qa, qb = on_cpu.parse(QUERIES[name]), on_gpu.parse(QUERIES[name])
        ea, eb = on_cpu.gpu, on_gpu.gpu
        same(f"{name} execute_batch_index", [ea.execute_batch_index(qa, 4)],
             [eb.execute_batch_index(qb, 4)])
        same(f"{name} execute_batch_index slice",
             [ea.execute_batch_index(qa, 8, slice_mode=True)],
             [eb.execute_batch_index(qb, 8, slice_mode=True)])
        same(f"{name} execute_batch_index_many",
             ea.execute_batch_index_many(qa, 4, 2),
             eb.execute_batch_index_many(qb, 4, 2))
    log(f"  cross-check: every batched entry point gives equal per-qid "
        f"counts on cpu and cuda ({len(jobs[on_cpu])} templates x "
        f"{B} constants, {len(HEAVY)} heavy shapes)")


def rows_multiset(q):
    rows = q.result.table.tolist()
    if q.result.attr_table.size:
        rows = [r + a for r, a in zip(rows, q.result.attr_table.tolist())]
    return sorted(map(tuple, rows))


# ---------------------------------------------------------------------------
# phase 11: the planner's other two execution strategies
# ---------------------------------------------------------------------------

STRATEGY_SHAPES = ("lubm_q1", "lubm_q2", "lubm_q6")
# the JAX bench's cyclic worlds (bench.py --cyclic), and the triangle at the
# largest m (in steps of 200) whose walk still fits the default 2^25-row
# ceiling: at m = 5,600 its wedge table has 31,812,508 rows, at 5,800 more
# than 2^25
CYCLIC_WORLDS = (
    ("triangle", {"m": 2000, "noise": 8, "seed": 0}),
    ("triangle", {"m": 5600, "noise": 8, "seed": 0}),
    ("diamond", {"m": 400, "noise": 4, "seed": 0}),
    ("clique4", {"n": 1200, "fan": 10, "ncliques": 40, "seed": 0}),
)
STRATEGY_KNOBS = ("join_strategy", "join_device", "template_device",
                  "table_capacity_min", "table_capacity_max")
FALLBACK_SERIES = ("wukong_join_fallback_total",
                   "wukong_join_device_fallback_total",
                   "wukong_template_fallback_total")


class Knobs:
    """Set Global knobs for a ``with`` block and restore them after."""

    def __init__(self, note: str | None = None, **knobs):
        self.note, self.knobs, self.saved = note, knobs, {}

    def __enter__(self):
        from wukong_tpu_torch.config import Global

        for k, v in self.knobs.items():
            self.saved[k] = getattr(Global, k)
            setattr(Global, k, v)
        if self.note:
            log(f"  {self.note}: " + ", ".join(
                f"{k} {v}" for k, v in self.knobs.items()))
        return self

    def __exit__(self, *exc):
        from wukong_tpu_torch.config import Global

        for k, v in self.saved.items():
            setattr(Global, k, v)


def walk_pinned(phase: str) -> Knobs:
    """A phase that holds the walk's mechanisms (K1 launch counts under the
    planner, the GPU engine's capacity fallback, the heavy lane) keeps q1,
    q2 and q6 off the wcoj and compiled-template routes, which would
    otherwise serve them at default knobs; phase 11 holds those routes."""
    return Knobs(f"phase {phase} pinned to the walk (phase 11 holds the "
                 "default routes)", join_strategy="walk",
                 template_device="host")


def fallback_counts() -> dict:
    """{series: total over its labels} of the three strategy fallback
    counters."""
    from wukong_tpu_torch.obs.metrics import get_registry

    snap = get_registry().snapshot()
    return {name: sum(s.get("value", 0)
                      for s in (snap.get(name) or {}).get("series", []))
            for name in FALLBACK_SERIES}


def strategy_decision(q) -> dict:
    """The routes one served query took and what its levels and template
    dispatches measured."""
    levels = [(lv["level"], lv["candidates"], lv["rows_out"], lv["route"])
              for lv in (getattr(q, "join_stats", None) or [])]
    tmpl = [r for r in (getattr(q, "device_steps", None) or [])
            if r.get("site") == "template.plan"]
    return {"strategy": getattr(q, "join_strategy", None),
            "join_route": getattr(q, "join_route", None),
            "template_route": getattr(q, "template_route", None),
            "levels": levels,
            "compiled": bool(getattr(q, "_template_compiled", False)),
            "template_live": [r["live"] for r in tmpl],
            "template_capacity": [r["capacity"] for r in tmpl]}


def first_decision(proxy, text: str) -> dict:
    """The first call's routes by the planner's own rules on this store's
    statistics (choose_strategy, choose_join_route, estimate_peak_rows
    against template_min_rows), with nothing memoized or latched yet."""
    from wukong_tpu_torch.config import Global

    q = proxy.parse(text)
    pats = list(q.pattern_group.patterns)
    pl = proxy.planner
    strategy = pl.choose_strategy(pats)
    est = pl.estimate_peak_rows(pats)
    # the template route a walk-strategy call takes (a wcoj call takes none)
    walk_template = ("device" if est is not None
                     and est >= max(int(Global.template_min_rows), 1)
                     else "host")
    out = {"strategy": strategy, "join_route": None, "template_route": None,
           "walk_template": walk_template,
           "estimates": pl.estimate_chain(pats)}
    if strategy == "wcoj":
        out["join_route"] = pl.choose_join_route(pats)
    else:
        out["template_route"] = walk_template
    return out


def next_decision(prev: dict, decided: dict) -> dict:
    """The next call's routes after ``prev`` by the feedback rules (the
    JAX proxy's _record_wcoj_feedback, _record_route_feedback and
    _record_template_feedback), restated here: a wcoj call whose peak
    level rows pass wcoj_ratio x its final rows demotes the template to the
    walk; a device-routed wcoj call whose summed candidates stay under
    join_device_min_candidates demotes its route to host; a compiled
    template whose live rows stay under template_min_rows latches host."""
    from wukong_tpu_torch.config import Global

    nxt = dict(decided)
    if prev["strategy"] == "wcoj":
        rows = [r for _l, _c, r, _rt in prev["levels"]]
        if max(rows) / max(rows[-1], 1) > max(float(Global.wcoj_ratio), 1.0):
            nxt.update(strategy="walk", join_route=None,
                       template_route=decided["walk_template"])
        elif prev["join_route"] == "device" and sum(
                c for _l, c, _r, _rt in prev["levels"]) < max(
                int(Global.join_device_min_candidates), 1):
            nxt["join_route"] = "host"
    elif prev["template_route"] == "device" and prev["compiled"] and \
            prev["template_live"][-1] < max(int(Global.template_min_rows),
                                            1):
        nxt["template_route"] = "latched_host"
    return nxt


def level_probe_work(args) -> tuple:
    """(bytes, operations, what) the level probe needs on these inputs,
    with the kernel's short-circuit order (glob first, then each adjacency
    in order, only for rows still true). Bytes: valid and the mask over
    all C rows, cand for the valid rows, each adjacency's anchors for the
    rows that reach it, and one 32 B sector for each DISTINCT sector of
    the glob, keys, offsets and edges that some binary-search step (or the
    compare after it) reads. Operations: about 6 a search step, 4 a row."""
    import torch

    valid, cand, glob, adj = args
    C = cand.shape[0]
    ok = valid.clone()
    nbytes = 2 * C + 4 * int(valid.sum())
    steps = sectors = 0

    def lower_bound(arr, vals, lo, hi, iters=None):
        """Rows' lower_bound of vals over arr[lo:hi): (final lo, sectors
        the search touched)."""
        nonlocal steps
        n = arr.shape[0]
        touched = torch.zeros(n // 8 + 1, dtype=torch.bool, device=arr.device)
        it = 0
        while True:
            active = lo < hi
            if iters is not None and it >= iters:
                break
            na = int(active.sum())
            if na == 0:
                break
            steps += na
            mid = lo + (hi - lo) // 2
            mc = mid.clamp(0, max(n - 1, 0))
            touched[(mc[active] // 8).long()] = True
            less = arr[mc] < vals
            lo = torch.where(active & less, mid + 1, lo)
            hi = torch.where(active & ~less, mid, hi)
            it += 1
        return lo, touched

    if glob is not None:
        rows = ok.nonzero().squeeze(1)
        n = glob.shape[0]
        if n and len(rows):
            v = cand[rows]
            lo, t = lower_bound(glob, v, torch.zeros_like(v),
                                torch.full_like(v, n))
            lc = lo.clamp(0, n - 1)
            t[(lc[lo < n] // 8).long()] = True
            sectors += int(t.sum())
            ok[rows] = (lo < n) & (glob[lc] == v)
        else:
            ok[:] = False
    for keys, offsets, edges, anchors, depth, *_index in adj:
        rows = ok.nonzero().squeeze(1)
        nbytes += 4 * len(rows)
        ne, nk = edges.shape[0], keys.shape[0]
        if not len(rows) or ne == 0 or nk == 0:
            ok[rows] = False
            continue
        a, v = anchors[rows], cand[rows]
        k, tk = lower_bound(keys, a, torch.zeros_like(a),
                            torch.full_like(a, nk))
        kc = k.clamp(0, nk - 1)
        tk[(kc[k < nk] // 8).long()] = True
        found = (k < nk) & (keys[kc] == a)
        to = torch.zeros(offsets.shape[0] // 8 + 1, dtype=torch.bool,
                         device=offsets.device)
        to[(kc[found] // 8).long()] = True
        to[((kc[found] + 1) // 8).long()] = True
        start = torch.where(found, offsets[kc], torch.zeros_like(a))
        end = torch.where(found, offsets[(kc + 1).clamp(max=nk)],
                          torch.zeros_like(a))
        lo, te = lower_bound(edges, v, start, end, iters=max(int(depth), 1))
        lc = lo.clamp(0, ne - 1)
        te[(lc[lo < end] // 8).long()] = True
        sectors += int(tk.sum()) + int(to.sum()) + int(te.sum())
        ok[rows] = (lo < end) & (edges[lc] == v)
    nbytes += 32 * sectors
    return (nbytes, 6 * steps + 4 * C,
            {"C": C, "valid": int(valid.sum()), "J": len(adj),
             "glob": None if glob is None else int(glob.shape[0]),
             "passed": int(ok.sum()), "search_steps": steps,
             "sectors": sectors})


def lp_captures(entry: dict) -> list:
    """Captures of the level probe's two main-path call sites (the WCOJ
    executor's probe groups and the template program's pair probes), each
    call classed by its site and ``entry["name"]``."""
    from wukong_tpu_torch.engine import template_compile as TC
    from wukong_tpu_torch.join import wcoj as WJ

    return [Capture(mod, "level_probe", lambda a: a[1].shape[0],
                    lambda a, site=site: f", {site}, {entry['name']}")
            for mod, site in ((WJ, "wcoj.probe"), (TC, "template.plan"))]


def lp_library(_valid, _cand, glob, adj):
    """The one PyTorch call that computes the level probe where it has no
    adjacency (J = 0): glob membership, ``torch.isin``. None for J > 0,
    where no single call does the bounded search in a ragged range."""
    import torch

    if adj:
        return None
    if glob is None:
        return lambda v, _c, _g, _a: (v.clone(),)
    return lambda v, c, g, _a: (v & torch.isin(c, g),)


def lp_rows(captures: list, phase: str, errs: dict) -> list:
    """A kernels-line row for each class of the level probe's calls."""
    from wukong_tpu_torch.join import kernels as JK

    rows = []
    for cap in captures:
        for cls, best in sorted(cap.best.items()):
            if cap.launches.get(cls, 0):
                rows.append(measure(
                    "level_probe", phase + cls, best, cap.launches[cls],
                    lambda *a: (JK.level_probe(*a),),
                    lambda *a: (JK.level_probe_plain(*a),),
                    level_probe_work, errs, library=lp_library(*best[1])))
    return rows


def level_probe_checks(errs: dict, scales=(1, 350),
                       caps=(1 << 21,)) -> int:
    """Phase 2: the level probe against its plain version on the card, bit
    for bit, on level_probe_cases at each scale (C about 1M at 350; the
    per-thread kernel), then on the largest scale's cases widened to each
    of ``caps`` slots (the tiled kernel: the glob's bit index built in the
    call where it fits, padding tiles skipped), each with every
    adjacency's keys index as the table cache stages it, and without."""
    import torch

    from wukong_tpu_torch.join import kernels as JK

    dev = torch.device("cuda")
    n = 0

    def t(a):
        return torch.from_numpy(a).to(dev)

    def held(name, scale, valid, cand, glob, adj):
        nonlocal n
        args = (valid, cand, glob, adj)
        got = JK.level_probe(*args)
        want = JK.level_probe_plain(*args)
        err = max_abs_diff([got], [want])
        errs["level_probe"] = max(errs["level_probe"], err)
        check(err == 0, f"level_probe != plain on {name!r} at scale "
              f"{scale} ({err} rows differ)")
        n += 1

    for scale in scales:
        cases = level_probe_cases(scale)
        for name, valid, cand, glob, adj, _full in cases:
            held(name, scale, t(valid), t(cand),
                 None if glob is None else t(glob),
                 [(t(k), t(o), t(e), t(a), d) for k, o, e, a, d in adj])
    indexed = 0
    for cap in caps:
        for case in cases:
            name, valid, cand, glob, adj, _full = widen_case(case, cap)
            tables = [(t(k), t(o), t(e), t(a), d, k) for k, o, e, a, d in adj]
            g = None if glob is None else t(glob)
            plain = [(k, o, e, a, d) for k, o, e, a, d, _h in tables]
            held(name, scales[-1], t(valid), t(cand), g, plain)
            if tables:
                staged = [(k, o, e, a, d, JK.keys_index(h, k))
                          for k, o, e, a, d, h in tables]
                indexed += sum(x[5] is not None for x in staged)
                held(name + ", keys indexed", scales[-1], t(valid),
                     t(cand), g, staged)
    check(indexed > 0, "no case of the tiled kernel had a keys index")
    return n


def serve_strategies(proxy, phase4: dict, entry: dict, results: dict) -> None:
    """Phase 11 (a), (b), (d) and (e) on phase 3's proxy with phase 7's
    planner: the default routes call after call, the forced WCOJ device
    route, the forced template route with its one sync a dispatch and a
    forced regrow, and the device report and EXPLAIN ANALYZE of q1."""
    import io
    from contextlib import redirect_stdout

    import numpy as np
    import torch

    from wukong_tpu_torch.config import Global
    from wukong_tpu_torch.join import kernels as JK
    from wukong_tpu_torch.obs.device import read_device_input
    from wukong_tpu_torch.runtime.console import Console

    out = results["strategies"] = {"default": {}, "wcoj_device": {},
                                   "template_device": {}}
    single = results["batched"]["single"]

    def serve_once(text):
        """(query, host ms, host syncs, level_probe launches, log text)."""
        got = []
        lp0 = JK.level_probe.launches
        with LogCapture() as cap:
            t0 = time.perf_counter()
            syncs, sites = count_syncs(lambda: got.append(
                proxy.serve_query(text)))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        return got[0], ms, syncs, JK.level_probe.launches - lp0, cap.text

    # (a) the default routes, three calls each
    entry["name"] = "(a) default routes"
    for name in STRATEGY_SHAPES:
        text = QUERIES[name]
        want = first_decision(proxy, text)
        log(f"  (a) {name}: the planner's rules give strategy "
            f"{want['strategy']}, level route {want['join_route']}, "
            f"template route {want['template_route']} (estimates "
            f"{[int(e) for e in want['estimates'] or []]}, wcoj_ratio "
            f"{Global.wcoj_ratio}, join_device_min_candidates "
            f"{Global.join_device_min_candidates:,}, template_min_rows "
            f"{Global.template_min_rows:,})")
        calls = []
        for call in range(3):
            q, ms, syncs, launches, text_log = serve_once(text)
            d = strategy_decision(q)
            check(q.result.status_code == 0
                  and np.array_equal(sorted_table(q), phase4[name]),
                  f"(a) {name} call {call + 1}: rows differ from phase 7's")
            got = {k: d[k] for k in ("strategy", "join_route",
                                     "template_route")}
            check(got == {k: want[k] for k in got},
                  f"(a) {name} call {call + 1}: routes {got}, the rules "
                  f"give {want}")
            if any(rt == "device" for *_x, rt in d["levels"]):
                check(launches > 0, f"(a) {name} call {call + 1}: a level "
                      "routed device and level_probe never launched")
            demoted = [ln.split("] ", 1)[-1] for ln in text_log.splitlines()
                       if "demoted" in ln or "degraded" in ln]
            log(f"  (a) {name} call {call + 1}: strategy {d['strategy']}, "
                f"level route {d['join_route']}, template route "
                f"{d['template_route']}; levels (level, candidates, rows, "
                f"route) {d['levels']}; template live/capacity "
                f"{d['template_live']}/{d['template_capacity']}; "
                f"{q.result.nrows:,} rows (as phase 7), {ms:.2f} ms, "
                f"{syncs} host syncs, {launches} level_probe launches"
                + "".join(f"\n      log: {x}" for x in demoted))
            calls.append({**d, "ms": ms, "syncs": syncs,
                          "level_probe_launches": launches,
                          "log": demoted, "rows": q.result.nrows})
            want = next_decision(d, want)
        out["default"][name] = {"calls": calls,
                                "phase7_walk_ms": single[name]["median_ms"]}

    # (b) every level on the card at full width
    with Knobs("(b) forced", join_strategy="wcoj", join_device="device"):
        for name in ("lubm_q1", "lubm_q2"):
            entry["name"] = f"(b) wcoj device {name}"
            q, ms, syncs, launches, _t = serve_once(QUERIES[name])
            d = strategy_decision(q)
            check(q.result.status_code == 0 and d["levels"]
                  and all(rt == "device" for *_x, rt in d["levels"])
                  and np.array_equal(sorted_table(q), phase4[name]),
                  f"(b) {name}: {d['levels']} or rows differ from the walk")
            check(launches > 0, f"(b) {name}: level_probe never launched")
            _q, lat = timed_runs(lambda: proxy.serve_query(QUERIES[name]), 5)
            med = statistics.median(lat)
            out["wcoj_device"][name] = {"levels": d["levels"],
                                        "first_ms": ms, "median_ms": med,
                                        "runs_ms": lat, "syncs": syncs,
                                        "level_probe_launches": launches}
            log(f"  (b) {name}: wcoj, every level on the card "
                f"{d['levels']}; rows as the walk; first call {ms:.2f} ms "
                f"({syncs} host syncs, {launches} launches), median "
                f"{med:.2f} ms over 5 (phase 7's walk "
                f"{single[name]['median_ms']:.2f} ms)")

    # (d) the compiled template on the card, against the host walk in order
    with Knobs("(d) forced", join_strategy="walk", template_device="device"):
        from wukong_tpu_torch.engine.template_compile import (
            demotion_report,
            reset_demotions,
        )

        # a latch taken in (a) (small_measured) holds under a forced
        # device knob too: (d) starts with none
        log(f"  (d) demotion latches cleared: {demotion_report()}")
        reset_demotions()
        eng = proxy.template_engine()
        for name in STRATEGY_SHAPES:
            entry["name"] = f"(d) template {name}"
            text = QUERIES[name]
            q = proxy.parse(text)
            q.result.blind = False
            t0 = time.perf_counter()
            proxy.cpu.execute(q)
            host_ms = (time.perf_counter() - t0) * 1e3
            proxy.serve_query(text)  # stages the program
            r, ms, syncs, launches, _t = serve_once(text)
            d = strategy_decision(r)
            n_disp = len(d["template_live"])
            check(d["compiled"] and r.result.table.tolist()
                  == q.result.table.tolist(),
                  f"(d) {name}: not compiled, or rows not the host walk's "
                  "in its order")
            check(syncs == n_disp == 1, f"(d) {name}: {syncs} host syncs "
                  f"for {n_disp} dispatches")
            _r, lat = timed_runs(lambda: proxy.serve_query(text), 5)
            med = statistics.median(lat)
            eff = d["template_live"][-1] / d["template_capacity"][-1]
            out["template_device"][name] = {
                "median_ms": med, "runs_ms": lat, "syncs": syncs,
                "dispatches": n_disp, "padding_efficiency": eff,
                "host_walk_ms": host_ms, "level_probe_launches": launches,
                "live": d["template_live"], "capacity": d["template_capacity"]}
            log(f"  (d) {name}: compiled, rows equal to the host walk's in "
                f"order ({r.result.nrows:,}); {syncs} host sync for "
                f"{n_disp} dispatch; padding efficiency {eff:.3f} "
                f"({d['template_live'][-1]:,} of "
                f"{d['template_capacity'][-1]:,}); {launches} level_probe "
                f"launches; median {med:.2f} ms over 5 (phase 7's walk "
                f"{single[name]['median_ms']:.2f} ms, host walk "
                f"{host_ms:.1f} ms)")
        # one forced regrow: every expand's class far too small
        from wukong_tpu_torch.engine.template_compile import extract_template

        name = "lubm_q2"
        entry["name"] = "(d) template regrow"
        q = proxy.parse(QUERIES[name])
        q.result.blind = False
        spec = extract_template(q)[0]
        caps0 = eng._initial_caps(q._tsig, spec, None)
        small = (caps0[0],) + (64,) * (len(caps0) - 1)
        with Knobs(None, table_capacity_min=64):
            with eng._lock:
                eng._good_caps[(q._tsig, eng._version())] = small
            r = proxy.serve_query(QUERIES[name])
        d = strategy_decision(r)
        check(d["compiled"] and len(d["template_live"]) >= 2
              and np.array_equal(sorted_table(r), phase4[name]),
              f"(d) regrow {name}: {d} or rows differ")
        out["template_device"]["regrow"] = {
            "from": small, "dispatches": len(d["template_live"]),
            "capacity": d["template_capacity"]}
        log(f"  (d) regrow {name}: from classes {small} (table_capacity_min "
            f"64): {len(d['template_live'])} dispatches, capacities "
            f"{d['template_capacity']}, rows as phase 7")

    # (e) the device report and EXPLAIN ANALYZE's device table for q1
    buf = io.StringIO()
    with redirect_stdout(buf):
        Console(proxy).run_command("device -k 12")
    log("  (e) device verb:\n    " + buf.getvalue().rstrip().replace(
        "\n", "\n    "))
    with Knobs(None, join_strategy="wcoj", join_device="device"):
        entry["name"] = "(e) analyze q1"
        rep = proxy.explain_query(QUERIES["lubm_q1"], analyze=True)
    check(rep["rows"] == single["lubm_q1"]["rows"] and rep.get("device_steps"),
          f"(e) analyze q1: {rep['rows']} rows, device steps "
          f"{len(rep.get('device_steps') or [])}")
    log("  (e) EXPLAIN ANALYZE q1 (wcoj, device levels):\n    "
        + rep["rendered"].replace("\n", "\n    "))
    out["resident_bytes"] = read_device_input("resident_bytes")
    out["padding_efficiency"] = {
        site: read_device_input("padding_efficiency", site)
        for site in ("wcoj.probe", "template.plan", "gpu.chain")}


def serve_cyclic(entry: dict, results: dict) -> None:
    """Phase 11 (c): the cyclic worlds of the JAX bench on the card, WCOJ on
    the device route against the walk (rows, times), and the default
    routes' first two calls with the demotions they count."""
    import numpy as np

    from wukong_tpu_torch.loader import datagen
    from wukong_tpu_torch.obs.metrics import get_registry
    from wukong_tpu_torch.planner.optimizer import Planner
    from wukong_tpu_torch.planner.stats import Stats
    from wukong_tpu_torch.runtime.proxy import Proxy
    from wukong_tpu_torch.store.gstore import build_partition

    def demotions() -> float:
        snap = get_registry().snapshot()
        return sum(s.get("value", 0) for s in (snap.get(
            "wukong_join_demotions_total") or {}).get("series", []))

    out = results["strategies"]["cyclic"] = {}
    for world, kw in CYCLIC_WORLDS:
        label = f"{world} " + ",".join(f"{k}={v}" for k, v in kw.items())
        triples, meta = getattr(datagen, f"generate_{world}")(**kw)
        g = build_partition(triples, 0, 1)
        proxy = Proxy(g, datagen.CyclicStrings(meta), device="cuda",
                      planner=Planner(Stats.generate(triples)))
        text = datagen.cyclic_query_text(meta)
        rec = {"triples": len(triples)}
        with Knobs(None, join_strategy="walk", template_device="host"):
            entry["name"] = f"(c) walk {label}"
            walk, lat = timed_runs(lambda: proxy.serve_query(text), 3)
        rec["walk_ms"] = statistics.median(lat)
        rec["walk_status"] = int(walk.result.status_code)
        with Knobs(None, join_strategy="wcoj", join_device="device"):
            entry["name"] = f"(c) wcoj device {label}"
            q, lat = timed_runs(lambda: proxy.serve_query(text), 3)
        rec["wcoj_device_ms"] = statistics.median(lat)
        rec["levels"] = strategy_decision(q)["levels"]
        check(q.result.status_code == 0 and walk.result.status_code == 0
              and np.array_equal(sorted_table(q), sorted_table(walk)),
              f"(c) {label}: wcoj {q.result.nrows} rows vs walk "
              f"{walk.result.nrows}")
        check(all(rt == "device" for *_x, rt in rec["levels"]),
              f"(c) {label}: a level off the card {rec['levels']}")
        d0 = demotions()
        entry["name"] = f"(c) default {label}"
        auto = [strategy_decision(proxy.serve_query(text))
                for _ in range(2)]
        rec["default"] = [{k: a[k] for k in ("strategy", "join_route",
                                             "template_route")}
                          for a in auto]
        rec["demotions"] = demotions() - d0
        rec["rows"] = q.result.nrows
        out[label] = rec
        log(f"  (c) {label}: {len(triples):,} triples, {rec['rows']:,} rows "
            f"equal on both; walk {rec['walk_ms']:.1f} ms, wcoj on the card "
            f"{rec['wcoj_device_ms']:.1f} ms ({rec['walk_ms'] / max(rec['wcoj_device_ms'], 1e-9):.2f}x); "
            f"levels {rec['levels']}; default routes {rec['default']}, "
            f"wukong_join_demotions_total +{rec['demotions']:g}")
        del proxy, g


# ---------------------------------------------------------------------------
# phase 12: data in and durability
# ---------------------------------------------------------------------------

# WatDiv's smallest published scale class (10 M triples: 9,988,634 at scale
# 2,750, seed 0); OSDI'16's WSDTS is 109 M, cut for the smoke's time
WATDIV_SCALE = 2750
# yago_q3's 3-hop chain at n_person 2,000,000: 20,690,384 rows, under the
# default 2^25-row ceiling (at 1,000,000: 30,950,146, the zipf targets
# collide less after dedup)
YAGO_PERSONS = 2_000_000
# the DBpedia-shaped world, about 1.1 M triples. Cut from the 1,000,000
# entities (8.9 M triples) of the first runs, and from 250,000 since phase
# 15, for the smoke's time: Stats.generate and the planner on Q4_star4 are
# about linear in the entities
GENERIC_ENTITIES = 125_000
GENERIC_KW = {"n_preds": 200, "n_types": 50, "seed": 1}  # bench.py --dbpedia
INSERT_SHARE = 0.1  # (d): the share of WatDiv's triples loaded online
WAL_SYNCS = ("none", "interval", "always")  # one insert round each
EXTRA_EDGES = 50_000  # (e): the seeded batch inserted after the checkpoint
# (e): a standing query's epochs fed after the checkpoint, and their rows
STANDING_EPOCHS, STANDING_ROWS = 2, 4096
# (e): the seeded WatDiv embeddings upserted, WAL-logged, after the checkpoint
VECTORS_AFTER_CKPT = 50_000
ID_FILES = 4  # (c): the DBpedia-shaped world written as id_*.nt files
# the reference's yago suite (scripts/sparql_query/yago/yago_q1-q4), written
# from loader/yago.py's description and the constants YagoStrings resolves
YPREFIX = "PREFIX y: <http://yago-knowledge.org/resource/>\n"
YAGO_QUERIES = {
    # const-object lookup through the <Athens> hub
    "yago_q1": YPREFIX + """SELECT ?x WHERE { ?x y:livesIn <Athens> . }""",
    # shared-object join through <Albert_Einstein>'s alma mater
    "yago_q2": YPREFIX + """SELECT ?u ?x WHERE {
        <Albert_Einstein> y:graduatedFrom ?u . ?x y:graduatedFrom ?u . }""",
    # 3-hop self-join over the internal-link relation (the heavy)
    "yago_q3": YPREFIX + """SELECT ?a ?b ?c ?d WHERE {
        ?a y:hasInternalWikipediaLinkTo ?b .
        ?b y:hasInternalWikipediaLinkTo ?c .
        ?c y:hasInternalWikipediaLinkTo ?d . }""",
    # an internal-link step between two external-link stars
    "yago_q4": YPREFIX + """SELECT ?a ?e ?b ?f WHERE {
        ?a y:hasExternalWikipediaLinkTo ?e .
        ?a y:hasInternalWikipediaLinkTo ?b .
        ?b y:hasExternalWikipediaLinkTo ?f . }""",
}
# the JAX bench's dbpsb shapes (bench.py:2145-2175), built from the
# DBpedia-shaped world's statistics by dbpsb_shapes()
DBPSB_SHAPES = ("Q1_star", "Q2_anchor", "Q3_reverse", "Q4_star4",
                "Q5_distinct")


def dbpsb_shapes(triples, meta, stats) -> dict:
    """{name: port IR query} of the five dbpsb shapes, with the JAX bench's
    data-driven anchors (bench.py:2101-2175): the six most frequent
    predicates, the four most frequent types, a typed subject with a
    predicate-0 out-edge (Q2), and a reverse 2-hop pair (Q3)."""
    from wukong_tpu_torch.sparql.ir import Pattern, SPARQLQuery
    from wukong_tpu_torch.types import OUT, TYPE_ID

    pids = sorted(stats.pred_edges, key=lambda p: -stats.pred_edges[p])
    pids = [p for p in pids if p != TYPE_ID][:6]
    types = sorted((t for t in stats.tyscount if t > 0),
                   key=lambda t: -stats.tyscount[t])[:4]

    def mk(pats, nvars):
        q = SPARQLQuery()
        q.pattern_group.patterns = [Pattern(*p) for p in pats]
        q.result.nvars = nvars
        q.result.required_vars = [-(i + 1) for i in range(nvars)]
        return q

    norm = triples[(triples[:, 1] != TYPE_ID)]
    typed_s = triples[triples[:, 1] == TYPE_ID]
    type_of = dict(zip(typed_s[::-1, 0].tolist(), typed_s[::-1, 2].tolist()))
    p0_subjects = set(norm[norm[:, 1] == pids[0]][:, 0].tolist())
    anchor = next(((s, p, o, type_of[s]) for s, p, o in norm[:5000].tolist()
                   if s in type_of and s in p0_subjects), None)
    obj_first: dict = {}
    for i, o in enumerate(norm[:50000, 2].tolist()):
        obj_first.setdefault(int(o), i)
    rev = None
    for a, pA, c_ in norm[:20000].tolist():
        j = obj_first.get(int(a))
        if j is not None and int(norm[j, 0]) in type_of:
            b = int(norm[j, 0])
            rev = (int(a), int(pA), int(c_), b, int(norm[j, 1]), type_of[b])
            break
    check(anchor is not None and rev is not None,
          "dbpsb: no witness for Q2_anchor or Q3_reverse in the scan window")
    rs, rp, ro, t_rs = anchor
    a, pA, c_, b, pB, t_b = rev
    shapes = {
        "Q1_star": mk([(-1, TYPE_ID, OUT, types[0]),
                       (-1, pids[0], OUT, -2)], 2),
        "Q2_anchor": mk([(-1, rp, OUT, ro), (-1, TYPE_ID, OUT, t_rs),
                         (-1, pids[0], OUT, -2)], 2),
        "Q3_reverse": mk([(-1, pA, OUT, c_), (-2, pB, OUT, -1),
                          (-2, TYPE_ID, OUT, t_b)], 2),
        "Q4_star4": mk([(-1, TYPE_ID, OUT, types[2]),
                        (-1, pids[0], OUT, -2), (-1, pids[1], OUT, -3),
                        (-1, pids[2], OUT, -4), (-1, pids[3], OUT, -5)], 5),
        "Q5_distinct": mk([(-1, TYPE_ID, OUT, types[3]),
                           (-1, pids[1], OUT, -2),
                           (-1, pids[2], OUT, -3)], 3),
    }
    shapes["Q5_distinct"].distinct = True
    assert tuple(shapes) == DBPSB_SHAPES
    return shapes


def collect(device) -> None:
    """After a world's proxy is deleted: free what its reference cycles
    hold (device stagings among them) before the next world is built."""
    import gc

    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def live_device_bytes(device) -> tuple:
    """(torch.cuda.memory_allocated(), bytes of the distinct storages of
    the CUDA tensors the collector can reach) after a collection, or (None,
    None) off the card: an unreachable tensor is garbage, not a leak, and
    the second number says whether a growth is held by Python objects or by
    the allocator."""
    import gc

    import torch

    if torch.device(device).type != "cuda":
        return None, None
    gc.collect()
    torch.cuda.synchronize()
    seen = {}
    for o in gc.get_objects():
        if torch.is_tensor(o) and o.is_cuda:
            st = o.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return int(torch.cuda.memory_allocated()), int(sum(seen.values()))


def staged_refs(ds) -> list:
    """Weak references to the tensors the device store's segment and index
    caches hold: after the next version's restage each must be dead."""
    import weakref

    import torch

    with ds._mu:
        stack = list(ds._cache.values()) + list(ds._index_cache.values())
    refs, seen = [], set()
    while stack:
        o = stack.pop()
        if id(o) in seen:
            continue
        seen.add(id(o))
        if torch.is_tensor(o):
            refs.append(weakref.ref(o))
        elif isinstance(o, dict):
            stack.extend(o.values())
        elif isinstance(o, (list, tuple)):
            stack.extend(o)
        elif type(o).__module__.startswith("wukong_tpu_torch"):
            stack.extend(getattr(o, "__dict__", {}).values())
            for cls in type(o).__mro__:
                stack.extend(getattr(o, a) for a in getattr(cls, "__slots__", ())
                             if hasattr(o, a))
    return refs


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def host_ms(fn, runs: int, device) -> tuple:
    """(last result, host ms of each run, each ending in a synchronize)."""
    lat, out = [], None
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        lat.append((time.perf_counter() - t0) * 1e3)
    return out, lat


def fill_text(text: str, ss, const: int) -> str:
    """A template's text with its one %placeholder set to const's string."""
    import re

    return re.sub(r"%[\w:]+", ss.id2str(int(const)), text, count=1)


def watdiv_texts(proxy, seed: int) -> dict:
    """{template: (text with its constant, template, constant)}: each of the
    twelve WatDiv templates filled by fill_template and instantiated from
    the seed, in name order."""
    import numpy as np

    from wukong_tpu_torch.loader.watdiv import TEMPLATES as WT
    from wukong_tpu_torch.sparql.parser import Parser

    rng = np.random.default_rng(seed)
    out = {}
    for name in sorted(WT):
        tmpl = Parser(proxy.str_server).parse_template(WT[name])
        proxy.fill_template(tmpl)
        q = tmpl.instantiate(rng)
        pi, fld = tmpl.pos[0]
        const = getattr(q.pattern_group.patterns[pi], fld)
        out[name] = (fill_text(WT[name], proxy.str_server, const), tmpl,
                     const)
    return out


def served_rows(proxy, texts: dict, device, runs: int = 1,
                entry=None, prefix: str = "", decisions=None) -> tuple:
    """({name: sorted rows}, {name: median host ms}) of each text through
    Proxy.serve_query, non-blind; every reply must be status 0. The routes
    each last call took go into ``decisions`` when given."""
    import numpy as np

    rows, ms = {}, {}
    for name, text in texts.items():
        if entry is not None:
            entry["name"] = f"{prefix}{name}"
        q, lat = host_ms(lambda: proxy.serve_query(text, blind=False), runs,
                         device)
        check(q.result.status_code == 0,
              f"{prefix}{name}: status {q.result.status_code!r}")
        rows[name] = sorted_table(q)
        ms[name] = float(np.median(lat))
        if decisions is not None:
            decisions[name] = strategy_decision(q)
    return rows, ms


def host_rows(proxy, text=None, q=None):
    """The host CPUEngine's rows of a text, or of an IR query planned by
    the proxy's planner (its plan is the GPU engine's: the planner is
    deterministic), sorted."""
    import copy

    if q is None:
        q = proxy.parse(text)
    else:
        q = copy.deepcopy(q)
        check(proxy.planner.generate_plan(q), "host plan failed")
    q.result.blind = False
    proxy.cpu.execute(q)
    check(q.result.status_code == 0, f"host engine: status "
          f"{q.result.status_code!r}")
    return sorted_table(q)


def same_rows(a, b) -> bool:
    import numpy as np

    return a.shape == b.shape and np.array_equal(a, b)


def watdiv_batches(proxy, texts: dict, seed: int, device, entry,
                   B: int = 1024) -> dict:
    """(a)'s batches: B constants of each template's candidates through
    GPUEngine.execute_batch where the plan starts from the placeholder's
    constant; four per-query counts held against single calls. A batch
    whose intermediate passes the capacity ceiling is halved and drawn
    again, as bench.py --watdiv does (logged)."""
    import numpy as np

    from wukong_tpu_torch.utils.errors import WukongError

    rng = np.random.default_rng(seed + 1)
    out = {}
    for name, (_text, tmpl, _c) in texts.items():
        q = tmpl.instantiate(rng)
        pi, fld = tmpl.pos[0]
        inst = getattr(q.pattern_group.patterns[pi], fld)
        proxy._plan(q)
        pats = q.pattern_group.patterns
        if not (pats and pats[0].subject == inst and pats[0].predicate > 0):
            out[name] = {"batched": False}
            continue
        cand = tmpl.candidates[0]
        bw = B
        while True:
            consts = np.asarray(cand[rng.integers(0, len(cand), bw)],
                                dtype=np.int64)
            entry["name"] = f"(a) batch {name}"
            try:
                counts, lat = host_ms(
                    lambda: proxy.gpu.execute_batch(q, consts), 3, device)
                break
            except WukongError as e:
                if bw == 1 or "exceeds" not in str(e):
                    raise
                log(f"  (a) batch {name}: B = {bw} over the ceiling ({e}); "
                    f"halved")
                bw //= 2
        for i in range(4):
            check(int(counts[i]) == single_rows(proxy, tmpl, consts[i]),
                  f"(a) batch {name}: count {i} differs from a single call")
        med = float(np.median(lat))
        out[name] = {"batched": True, "B": bw, "median_ms": med,
                     "queries_per_s": bw / med * 1e3,
                     "rows": int(np.asarray(counts).sum())}
    return out


def world_proxy(triples, ss, device, label: str, stats=None):
    """A planner-backed Proxy over one partition of triples, timed; its
    statistics made from the triples unless given."""
    from wukong_tpu_torch.planner.optimizer import Planner
    from wukong_tpu_torch.planner.stats import Stats
    from wukong_tpu_torch.runtime.proxy import Proxy
    from wukong_tpu_torch.store.gstore import build_partition

    t0 = time.perf_counter()
    g = build_partition(triples, 0, 1)
    t1 = time.perf_counter()
    made = stats is None
    if made:
        stats = Stats.generate(triples)
    t2 = time.perf_counter()
    log(f"  {label}: {len(triples):,} triples, partition {t1 - t0:.1f} s, "
        + (f"Stats.generate {t2 - t1:.1f} s" if made else "statistics given"))
    return Proxy(g, ss, device=device, planner=Planner(stats)), stats


def phase12_watdiv(out: dict, entry: dict, device, scale: int,
                   seed: int) -> tuple:
    """(a): WatDiv at scale on the card; returns (triples, full-store rows
    of the twelve templates, their texts, the planner's statistics)."""
    from wukong_tpu_torch.loader.watdiv import (
        VirtualWatdivStrings,
        generate_watdiv,
    )

    t0 = time.perf_counter()
    triples, _lay = generate_watdiv(scale, seed=seed)
    rec = out["watdiv"] = {"scale": scale, "triples": len(triples),
                           "synthesis_s": time.perf_counter() - t0}
    proxy, stats = world_proxy(triples, VirtualWatdivStrings(scale, seed),
                               device, f"(a) WatDiv-{scale}")
    texts = watdiv_texts(proxy, seed)
    plain = {n: t for n, (t, _tm, _c) in texts.items()}
    rows, ms = served_rows(proxy, plain, device, 5, entry, "(a) ")
    for name, text in plain.items():
        want = host_rows(proxy, text)
        check(same_rows(rows[name], want),
              f"(a) {name}: {len(rows[name])} rows on the card, "
              f"{len(want)} on the host engine")
    rec["single"] = {n: {"rows": int(len(rows[n])), "median_ms": ms[n],
                         "const": int(texts[n][2])} for n in texts}
    rec["batch"] = watdiv_batches(proxy, texts, seed, device, entry)
    for n in texts:
        b = rec["batch"][n]
        log(f"  (a) {n}: {len(rows[n]):,} rows equal to the host engine's, "
            f"median {ms[n]:.2f} ms over 5"
            + (f"; B = {b['B']}: {b['median_ms']:.2f} ms, "
               f"{b['queries_per_s']:,.0f} queries/s" if b["batched"]
               else "; not batchable (plan starts elsewhere)"))
    del proxy
    collect(device)
    return triples, rows, plain, stats


def phase12_yago(out: dict, entry: dict, device, n_person: int,
                 seed: int) -> None:
    """(b): the YAGO-shaped world, yago_q1-q4 on the card against the host
    engine, with no capacity fallback."""
    from wukong_tpu_torch.loader.yago import YagoStrings, generate_yago

    t0 = time.perf_counter()
    triples, _m = generate_yago(n_person, seed=seed)
    rec = out["yago"] = {"n_person": n_person, "triples": len(triples),
                         "synthesis_s": time.perf_counter() - t0}
    proxy, _stats = world_proxy(triples, YagoStrings(n_person, seed), device,
                                f"(b) YAGO n_person {n_person:,}")
    del triples
    with LogCapture() as logs:
        rows, ms = served_rows(proxy, YAGO_QUERIES, device, 3, entry, "(b) ")
    check("degrading to the host engine" not in logs.text,
          "(b) a YAGO query fell back to the host engine")
    rec["queries"] = {}
    for name, text in YAGO_QUERIES.items():
        t0 = time.perf_counter()
        want = host_rows(proxy, text)
        host_s = time.perf_counter() - t0
        check(len(want) > 0 and same_rows(rows[name], want),
              f"(b) {name}: {len(rows[name])} rows on the card, "
              f"{len(want)} on the host engine")
        rec["queries"][name] = {"rows": int(len(want)), "median_ms": ms[name],
                                "host_engine_s": host_s}
        log(f"  (b) {name}: {len(want):,} rows equal to the host engine's, "
            f"median {ms[name]:.2f} ms over 3 (host engine {host_s:.1f} s)")
        if proxy.parse(text).start_from_index():
            # the heavy lane's replicate entry point, where K2/K3 stream
            entry["name"] = f"(b) batch index {name}"
            counts, lat = host_ms(lambda: proxy.serve_batch_index(text, 1), 1,
                                  device)
            check(int(counts[0]) == len(want),
                  f"(b) {name}: replicate batch count {int(counts[0])}, "
                  f"rows {len(want)}")
            rec["queries"][name]["batch_index_ms"] = lat[0]
            log(f"  (b) {name}: replicate batch of 1, count equal, "
                f"{lat[0]:.2f} ms")
    del proxy
    collect(device)


def phase12_dbpsb(out: dict, entry: dict, device, n_entities: int) -> None:
    """(c): the DBpedia-shaped world, the five dbpsb shapes through the GPU
    engine (planned by the planner) against the host engine."""
    import copy

    import numpy as np

    from wukong_tpu_torch.loader.generic_rdf import generate_generic

    t0 = time.perf_counter()
    triples, meta = generate_generic(n_entities, **GENERIC_KW)
    rec = out["dbpsb"] = {"n_entities": n_entities, "triples": len(triples),
                          "synthesis_s": time.perf_counter() - t0,
                          "shapes": {}}
    proxy, stats = world_proxy(triples, None, device,
                               f"(c) DBpedia-shaped {n_entities:,}")
    shapes = dbpsb_shapes(triples, meta, stats)
    rec["id_files"] = id_files_round_trip(triples)
    del triples

    def run(planned):
        q = copy.deepcopy(planned)
        q.result.blind = False
        proxy.gpu.execute(q)
        return q

    for name, q0 in shapes.items():
        planned = copy.deepcopy(q0)
        t0 = time.perf_counter()
        check(proxy.planner.generate_plan(planned), "dbpsb: plan failed")
        plan_ms = (time.perf_counter() - t0) * 1e3
        entry["name"] = f"(c) {name}"
        q, lat = host_ms(lambda: run(planned), 3, device)
        check(q.result.status_code == 0, f"(c) {name}: status "
              f"{q.result.status_code!r}")
        want = host_rows(proxy, q=q0)
        got = sorted_table(q)
        check(len(want) > 0 and same_rows(got, want),
              f"(c) {name}: {len(got)} rows on the card, {len(want)} on "
              f"the host engine")
        med = float(np.median(lat))
        rec["shapes"][name] = {"rows": int(len(want)), "median_ms": med,
                               "plan_ms": plan_ms}
        log(f"  (c) {name}: {len(want):,} rows equal to the host engine's, "
            f"median {med:.2f} ms over 3 after one plan of {plan_ms:.1f} ms")
    del proxy
    collect(device)


def id_files_round_trip(triples) -> dict:
    """The world written as ID_FILES id_*.nt text files and read back by the
    loader (native/'s parse_id_triples): the triples equal, every file on
    the native path."""
    import numpy as np

    from wukong_tpu_torch import native
    from wukong_tpu_torch.loader.base import load_triples

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        for k, part in enumerate(np.array_split(triples, ID_FILES)):
            np.savetxt(os.path.join(root, f"id_{k:05d}.nt"), part,
                       fmt="%d", delimiter="\t")
        t1 = time.perf_counter()
        native.reset_counts()
        back = load_triples(root)
        t2 = time.perf_counter()
        nbytes = dir_bytes(root)
    counts = dict(native.counts["parse_id_triples"])
    check(np.array_equal(back, triples), "(c) id_*.nt files read back "
          "differ from the triples written")
    check(counts == {"native": ID_FILES, "numpy": 0},
          f"(c) id_*.nt files not all parsed natively: {counts}")
    log(f"  (c) {len(triples):,} triples written as {ID_FILES} id_*.nt files "
        f"({nbytes:,} B, {t1 - t0:.1f} s) and read back by parse_id_triples "
        f"in {t2 - t1:.2f} s, equal; {counts}")
    return {"triples": int(len(triples)), "bytes": nbytes,
            "write_s": t1 - t0, "read_s": t2 - t1, "parse": counts}


def lp_merged_row(captures: list, phase: str, errs: dict) -> list:
    """The level probe's kernels-line row of a phase: held and timed on its
    largest input over both call sites, with all their launches."""
    from wukong_tpu_torch.join import kernels as JK

    n = sum(sum(c.launches.values()) for c in captures)
    bests = [b for c in captures for b in c.best.values()]
    if not n or not bests:
        return []
    best = max(bests, key=lambda b: b[0])
    return [measure("level_probe", phase, best, n,
                    lambda *a: (JK.level_probe(*a),),
                    lambda *a: (JK.level_probe_plain(*a),),
                    level_probe_work, errs, library=lp_library(*best[1]))]


# ---------------------------------------------------------------------------
# the kNN scan kernel (phase 2 cases, phase 13's rows)
# ---------------------------------------------------------------------------

KNN_RTOL = KNN_ATOL = 1e-5  # float32 sums in another order (dim <= 128)
KNN_GAP = 1e-3  # ids compared exactly where scores are this far apart


def knn_agree(got, want, exact: bool = False) -> float:
    """Check one knn_scan result against its plain version's (the plain
    one asked for one more winner, so the boundary is visible); returns the
    largest score difference, in units of the score where its magnitude
    passes 1 (knn_scan's max_abs_err: scores of 1e13 differ by thousands
    in float32). Scores agree within KNN_RTOL/KNN_ATOL (dead
    rows at -inf on both sides); ids agree exactly at every position whose
    score is more than KNN_GAP from its neighbours, and every id whose score
    clears the k-th by KNN_GAP is among the winners. ``exact``: bit for bit
    (integer-valued inputs, where every sum is exact)."""
    import numpy as np

    gs, gi = (t.cpu().numpy() for t in got)
    ws, wi = (t.cpu().numpy() for t in want)
    kk = len(gs)
    check(len(gi) == kk and len(ws) >= kk,
          f"knn_scan returned {kk} winners, the plain version {len(ws)}")
    if exact:
        check(np.array_equal(gs, ws[:kk]) and np.array_equal(gi, wi[:kk]),
              "knn_scan != plain bit for bit on integer-valued input")
        return 0.0
    fin = np.isfinite(ws[:kk])
    check(np.array_equal(np.isfinite(gs), fin), "knn_scan: -inf rows differ")
    check(np.array_equal(gi[~fin], wi[:kk][~fin]),
          "knn_scan: dead rows out of slot order")
    w = ws[:kk][fin].astype(np.float64)
    g = gs[fin].astype(np.float64)
    err = (float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1.0)))
           if len(w) else 0.0)
    check(np.all(np.abs(g - w) <= KNN_ATOL + KNN_RTOL * np.abs(w)),
          f"knn_scan scores off the plain version's by {err} (relative)")
    s = ws.astype(np.float64)
    s = np.where(np.isfinite(s), s, -1e300)
    lo = np.concatenate([[np.inf], s[:-1] - s[1:]])[:kk]
    hi = np.concatenate([s[:-1] - s[1:], [np.inf]])[:kk]
    sep = fin & (np.minimum(lo, hi) > KNN_GAP)
    check(np.array_equal(gi[sep], wi[:kk][sep]),
          "knn_scan ids differ at well-separated positions")
    if kk:
        clear = wi[:kk][s[:kk] > s[kk - 1] + KNN_GAP]
        check(set(clear.tolist()) <= set(gi.tolist()),
              "knn_scan lost a winner that clears the k-th by 1e-3")
    return err


def knn_scale(metric: str, anchor, rows, scores):
    """The magnitude KNN_RTOL applies to for each winner: the score itself
    for dot and cosine; for l2 the sums the score is made of, q.q + 2|q.b|
    + b.b (an anchor that is itself a row scores -0 up to their rounding)."""
    import numpy as np

    scores = np.abs(np.asarray(scores, np.float64))
    if metric != "l2":
        return scores
    r = np.asarray(rows, np.float64)
    q = np.asarray(anchor, np.float64)
    return q @ q + 2 * np.abs(r @ q) + np.sum(r * r, axis=1)


KNN_BLOCK_ROWS = 128  # csrc/knn_scan.cu: kBlockBytes (32 KB) of 64-d rows


def knn_case_inputs(scale: float = 1.0):
    """(name, base, alive, anchor, k, metric, rows, slots, exact) numpy
    cases for phase 2: n = 0, 1 and 1,000,003; every row dead; k past the
    live rows; k = 1, 257 (the first on the radix path) and n; integer
    ties; extreme norms and a zero row under cosine; a slot list; widths
    on the 16-byte and the scalar path. Then the block paths' shapes: the
    GraphRAG slice (m = 65,120 at lo > 0, k = 8, cosine), m below one
    block's rows and at exact multiples of them, k = 32 (the register
    path's largest), 33 and 256 at m of about 65 K, integer ties that
    straddle block boundaries, an all-dead slice. ``scale`` multiplies the
    large row counts (the card runs scale 1; the CPU tests a fraction)."""
    import numpy as np

    rng = np.random.default_rng(7)
    cases = []

    def big(n):
        return max(int(n * scale), 1)

    def rand(n, d, dead=0.1):
        base = rng.standard_normal((n, d)).astype(np.float32)
        alive = rng.random(n) >= dead
        return base, alive, rng.standard_normal(d).astype(np.float32)

    for metric in ("dot", "cosine", "l2"):
        b, a, q = rand(big(1_000_003), 64)
        n = len(b)
        cases += [(f"n={n} k=10 {metric}", b, a, q, 10, metric, None,
                   None, False),
                  (f"n={n} k=257 {metric}", b, a, q, 257, metric, None,
                   None, False)]
        if metric == "cosine":
            cases.append((f"n={n} k=n cosine", b, a, q, len(b), metric,
                          None, None, False))
            lo, hi = big(1000), big(501_000)
            cases.append((f"n={n} rows {lo}..{hi} k=20", b, a, q, 20,
                          metric, (lo, hi), None, False))
    b, a, q = rand(1, 64)
    cases.append(("n=1 k=5", b, a, q, 5, "cosine", None, None, False))
    b, a, q = rand(0, 64)
    cases.append(("n=0", b, a, q, 5, "dot", None, None, False))
    b, a, q = rand(5000, 64)
    cases.append(("every row dead", b, np.zeros(5000, bool), q, 7, "l2",
                  None, None, False))
    cases.append(("k past the live rows", b, rng.random(5000) < 0.001, q,
                  40, "cosine", None, None, False))
    cases.append(("k=1", b, a, q, 1, "dot", None, None, False))
    cases.append(("k=n (block path)", b[:200], a[:200], q, 200, "l2", None,
                  None, False))
    for d in (3, 1, 128, 100):
        bd, ad, qd = rand(big(70_001), d)
        cases.append((f"d={d} k=16", bd, ad, qd, 16, "cosine", None, None,
                      False))
    ni = big(300_000)
    ib = rng.integers(-2, 3, size=(ni, 16)).astype(np.float32)
    ia = rng.random(ni) >= 0.2
    iq = rng.integers(-2, 3, size=16).astype(np.float32)
    for k in (1, 9, 256, 257, 5000):
        cases.append((f"integer ties k={k}", ib, ia, iq, k, "dot", None,
                      None, True))
    eb, ea, eq = rand(20_000, 64, dead=0.0)
    eb[::4] *= 1e6
    eb[1::4] *= 1e-6
    eb[2::97] = 0.0
    for metric in ("cosine", "dot", "l2"):
        cases.append((f"extreme norms and zero rows {metric}", eb, ea,
                      eq * (1e3 if metric == "dot" else 1.0), 12, metric,
                      None, None, False))
    slots = np.unique(rng.integers(0, 5000, size=3000)).astype(np.int64)
    cases.append(("slot list (np.unique of repeats)", b, a, q, 9, "cosine",
                  None, slots, False))
    cases.append(("slot list, k=300", b, a, q, 300, "l2", None, slots,
                  False))
    # the block paths' shapes: phase 13's GraphRAG slice (the second of 7
    # row ranges over 455,840 professors), then m around one block's rows
    gb, ga, gq = rand(big(455_840), 64, dead=0.01)
    step = len(gb) // 7
    cases.append((f"GraphRAG slice rows {step}..{2 * step} k=8 cosine", gb,
                  ga, gq, 8, "cosine", (step, 2 * step), None, False))
    for m in (KNN_BLOCK_ROWS - 28, KNN_BLOCK_ROWS, 3 * KNN_BLOCK_ROWS,
              509 * KNN_BLOCK_ROWS):
        m = min(m, len(gb) - 17)
        cases.append((f"m={m} rows from 17 k=8", gb, ga, gq, 8, "cosine",
                      (17, 17 + m), None, False))
    for k in (32, 33, 256):
        cases.append((f"m={2 * step} k={k} l2", gb, ga, gq, k, "l2",
                      (step, 3 * step), None, False))
    # every row but those at block boundaries scores -1; those score the
    # same top value: their order is their positions, across blocks
    tb = np.zeros((big(200_000), 64), np.float32)
    tb[:, 0] = -1.0
    at = np.arange(KNN_BLOCK_ROWS - 1, len(tb) - 1, KNN_BLOCK_ROWS)
    tb[at, :2] = (2.0, 1.0)
    tb[at + 1, :2] = (2.0, 1.0)
    ta = rng.random(len(tb)) >= 0.05
    tq = np.zeros(64, np.float32)
    tq[:2] = (1.0, 1.0)
    for k, rows in ((8, None), (32, (5, len(tb) - 3)), (100, (300, None))):
        rows = rows if rows is None or rows[1] else (rows[0], len(tb))
        cases.append((f"integer ties at block boundaries k={k} rows {rows}",
                      tb, ta, tq, k, "dot", rows, None, True))
    dead = np.ones(len(gb), bool)
    dead[step:2 * step] = False
    cases.append(("all-dead slice k=8", gb, dead, gq, 8, "cosine",
                  (step, 2 * step), None, False))
    return cases


def knn_cases(errs: dict) -> int:
    """Phase 2: knn_scan against knn_scan_plain on the card, on
    knn_case_inputs, and sliced scans whose merge equals the single scan
    (integer ties, bit for bit)."""
    import numpy as np
    import torch

    from wukong_tpu_torch.vector import knn as KN

    dev = torch.device("cuda")
    n = 0
    for name, base, alive, anchor, k, metric, rows, slots, exact \
            in knn_case_inputs():
        args = (torch.from_numpy(base).to(dev),
                torch.from_numpy(alive).to(dev),
                torch.from_numpy(anchor).to(dev), k, metric, rows,
                None if slots is None else torch.from_numpy(slots).to(dev))
        got = KN.knn_scan(*args)
        m = (len(slots) if slots is not None else
             (rows[1] - rows[0] if rows else len(base)))
        want = KN.knn_scan_plain(*args[:3], min(k, m) + 1, *args[4:])
        torch.cuda.synchronize()
        check(len(got[0]) == min(k, m), f"knn_scan {name}: {len(got[0])} "
              f"winners, want {min(k, m)}")
        err = knn_agree(got, want, exact)
        errs["knn_scan"] = max(errs["knn_scan"], err)
        n += 1
    # slices whose merge must equal the single scan
    rng = np.random.default_rng(11)
    base = torch.from_numpy(rng.integers(-3, 4, size=(400_000, 32))
                            .astype(np.float32)).to(dev)
    alive = torch.from_numpy(rng.random(400_000) >= 0.1).to(dev)
    anchor = torch.from_numpy(rng.integers(-3, 4, size=32)
                              .astype(np.float32)).to(dev)
    for k in (8, 300):
        s, i = KN.knn_scan(base, alive, anchor, k, "dot")
        bounds = np.linspace(0, 400_000, 8).astype(np.int64)
        parts = [KN.knn_scan(base, alive, anchor, k, "dot",
                             (int(lo), int(hi)))
                 for lo, hi in zip(bounds[:-1], bounds[1:])]
        ps = np.concatenate([p[0].cpu().numpy() for p in parts])
        pi = np.concatenate([p[1].cpu().numpy() + lo
                             for p, lo in zip(parts, bounds[:-1])])
        order = np.lexsort((pi, -ps))[:k]
        check(np.array_equal(ps[order], s.cpu().numpy())
              and np.array_equal(pi[order], i.cpu().numpy()),
              f"knn_scan: 7 slices merged != the single scan at k={k}")
        n += 1
    return n


def knn_size(args) -> int:
    base, _alive, _q, _k, _m, rows, slots = args
    if slots is not None:
        return int(slots.shape[0])
    return int(base.shape[0] if rows is None else rows[1] - rows[0])


def knn_class(args) -> str:
    _b, _a, _q, k, metric, rows, slots = args
    form = ("slot list" if slots is not None else
            "whole block" if rows is None else "row range")
    return f", {form}, k={k}, {metric}"


def knn_work(args) -> tuple:
    """(bytes, operations, what) knn_scan needs: the m candidate rows
    (m d 4 B), their mask bytes and, for a slot list, the slots (8 B a
    row) read once, the anchor read once, the kk winners (12 B) written
    once; 2 m d flops for dot, 4 m d for cosine and l2 (q.b and b.b)."""
    base, _alive, _q, k, metric, rows, slots = args
    d = int(base.shape[1])
    m = knn_size(args)
    kk = min(int(k), m)
    nbytes = m * d * 4 + m + (8 * m if slots is not None else 0) + 4 * d \
        + 12 * kk
    ops = (2 if metric == "dot" else 4) * m * d
    return nbytes, ops, {"m": m, "d": d, "k": int(k), "metric": metric,
                         "form": knn_class(args)[2:].split(",")[0]}


def knn_library(base, alive, anchor, k, metric, rows=None, slots=None):
    """The PyTorch yardstick: torch.topk over torch.mv of the candidates
    (with the normalisation and mask ops of the metric). Never called by
    the port."""
    import torch

    if slots is not None:
        sub, live = base.index_select(0, slots), alive.index_select(0, slots)
    else:
        lo, hi = (0, base.shape[0]) if rows is None else rows
        sub, live = base[lo:hi], alive[lo:hi]
    s = torch.mv(sub, anchor)
    if metric == "cosine":
        s = s / (torch.clamp(torch.linalg.vector_norm(anchor), min=1e-12)
                 * torch.clamp(torch.linalg.vector_norm(sub, dim=1),
                               min=1e-12))
    elif metric == "l2":
        s = -(torch.dot(anchor, anchor) - 2.0 * s
              + torch.linalg.vector_norm(sub, dim=1) ** 2)
    s = torch.where(live, s, torch.full_like(s, float("-inf")))
    return torch.topk(s, min(int(k), int(s.shape[0])))


def knn_measure(phase: str, best: tuple, launches: int, errs: dict) -> dict:
    """One kernels-line row of knn_scan: held against its plain version
    (and the library call against it) on one class's largest call, timed
    there, with that input's bound and that class's launches."""
    from wukong_tpu_torch.vector import knn as KN

    _size, args, kw = best
    base, alive, q, k, metric, rows, slots = args
    kern = KN.knn_scan
    err = knn_agree(kern(*args), KN.knn_scan_plain(base, alive, q, k + 1,
                                                   metric, rows, slots))
    errs["knn_scan"] = max(errs["knn_scan"], err)
    knn_agree(knn_library(*args), KN.knn_scan_plain(base, alive, q, k + 1,
                                                    metric, rows, slots))
    nbytes, ops, what = knn_work(args)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / CORE_OPS_PER_S * 1e3
    src, replaces = KERNELS["knn_scan"]
    row = {"name": "knn_scan", "route": "cuda", "source": src,
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "ms": time_ms(lambda: kern(*args)),
           "plain_ms": time_ms(lambda: KN.knn_scan_plain(*args), reps=5),
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": time_ms(lambda: knn_library(*args)),
           "phase": phase, "input": what}
    log(f"  knn_scan [{phase}]: {launches} launches; largest input {what}  "
        f"bytes {nbytes:,}  ops {ops:,}  ms {row['ms']:.4f}  bound "
        f"{row['bound_ms']:.4f} ({row['bound_by']})  plain "
        f"{row['plain_ms']:.4f}  library {row['library_ms']:.4f}")
    return row


def knn_rows(cap, errs: dict) -> list:
    """A kernels-line row for each main-path class of knn_scan's calls in
    phase 13 (the replays that hold replies against the host route are
    checks, not the main path, and get none)."""
    rows = []
    for cls, best in sorted(cap.best.items()):
        n = cap.launches.get(cls, 0)
        if n and "replay" not in cls:
            rows.append(knn_measure("13 hybrid plane " + cls, best, n, errs))
    return rows


# ---------------------------------------------------------------------------
# phase 13: the hybrid graph+vector plane
# ---------------------------------------------------------------------------

UBI = "http://swat.cse.lehigh.edu/onto/univ-bench.owl#"
RDF_TYPE_IRI = "<http://www.w3.org/1999/02/22-rdf-syntax-ns#type>"
# bench.py --graphrag's hybrid template and its GraphRAG mix (bench.py:
# 835-1030); the bench's 5 s is cut to 3 s for the smoke's time limit
HYBRID_TEMPLATE = ("SELECT ?p ?d WHERE { knn(?p, {anchor}, 8) . "
                   f"?p <{UBI}worksFor> ?d }}")
GRAPHRAG = {"graph_texts": 256, "anchors": 64, "zipf_a": 1.2,
            "hybrid_frac": 0.5, "clients": 8, "duration_s": 3.0,
            "warmup_s": 1.0, "dim": 64}
BIG_K = 100_000  # (b)'s large-k scan (the radix path)
KNN_SPLIT = 65_536  # (a)'s knn_split_threshold (the JAX default)
MIB = 1 << 20


def hybrid_texts(anchor: str, dept: str) -> dict:
    """Phase 13's knn() texts for one anchor IRI and one department IRI:
    (a)'s hybrid template, (b)'s ranked scans and (c)'s
    pattern-then-rank."""
    out = {"(a) hybrid": HYBRID_TEMPLATE.replace("{anchor}", anchor)}
    for metric in ("cosine", "dot", "l2"):
        out[f"(b) scan {metric}"] = (f"SELECT ?x WHERE {{ knn(?x, {anchor}, "
                                     f"10, {metric}) }}")
    out[f"(b) scan k={BIG_K}"] = (f"SELECT ?x WHERE {{ knn(?x, {anchor}, "
                                  f"{BIG_K}) }}")
    out["(c) memberOf"] = (f"SELECT ?x WHERE {{ ?x <{UBI}memberOf> {dept} . "
                           f"knn(?x, {anchor}, 10) }}")
    out["(c) GraduateStudent"] = (
        f"SELECT ?x WHERE {{ ?x {RDF_TYPE_IRI} <{UBI}GraduateStudent> . "
        f"knn(?x, {anchor}, 10) }}")
    return out


def ids_multiset(q) -> list:
    import numpy as np

    t = np.asarray(q.result.table)
    return sorted(map(tuple, t.tolist()))


def host_topk(vids, vecs, alive, anchor, k: int, metric: str):
    """topk_host over the rows NumPy's scores (its own formula) put among
    the best k + 64: the same winners as over every row, without a lexsort
    of tens of millions of rows on the host."""
    import numpy as np

    from wukong_tpu_torch.vector import knn as KN

    s = np.asarray(KN.scores(vecs, np.asarray(anchor)[None, :], metric)[0],
                   dtype=np.float32)
    s = np.where(alive, s, -np.inf)
    m = min(int(k) + 64, len(s))
    cand = np.sort(np.argpartition(-s, m - 1)[:m]) if m < len(s) \
        else np.arange(len(s))
    return KN.topk_host(vids[cand], vecs[cand], alive[cand], anchor, k,
                        metric)


def vector_demotions() -> float:
    from wukong_tpu_torch.obs.metrics import get_registry

    fam = get_registry().snapshot().get(
        "wukong_vector_route_demotions_total") or {}
    return sum(s.get("value", 0) for s in fam.get("series", []))


def serve_hybrid(proxy, results: dict, errs: dict, seed: int,
                 device="cuda") -> list:
    """Phase 13 on phase 3's proxy (phase 7's planner): (a) the GraphRAG
    mix, (b) the full-size scan, (c) pattern-then-rank, (d) the drill and
    the zero-touch check, (e) the vector plane detached (its memory check
    on the card only). Returns knn_scan's kernels-line rows."""
    import gc

    import numpy as np
    import torch

    from wukong_tpu_torch.config import Global
    from wukong_tpu_torch.loader.datagen import make_vectors
    from wukong_tpu_torch.runtime.emulator import Emulator
    from wukong_tpu_torch.types import OUT
    from wukong_tpu_torch.vector import knn as KN
    from wukong_tpu_torch.vector.vstore import upsert_batch_into

    g, ss = proxy.g, proxy.str_server
    out = results["hybrid"] = {"graphrag": dict(GRAPHRAG)}
    check(getattr(g, "vstore", None) is None, "phase 13: a vector store is "
          "already attached")
    t_phase = time.perf_counter()
    fb0, dem0 = fallback_counts(), vector_demotions()
    entry = {"name": ""}
    cap = Capture(KN, "knn_scan", knn_size,
                  lambda a: entry["name"] + knn_class(a))
    launched = {}

    def part(name):
        cap.wrapped.launches = 0  # zero just before the part's main path
        entry["name"] = name

    def done(name):
        launched[name] = cap.wrapped.launches  # read just after it
        check(launched[name] > 0, f"knn_scan never launched in {name}")

    proxy.engine_pool()
    try:
        with Knobs("phase 13", enable_vectors=True, vector_dim=64,
                   knn_device="auto", knn_split_threshold=KNN_SPLIT,
                   enable_batching=False):
            # ---- (a) the GraphRAG mix -----------------------------------
            t0 = time.perf_counter()
            pid = ss.str2id(f"<{UBI}advisor>")
            profs = np.unique(np.asarray(g.get_index(pid, OUT), np.int64))
            vecs = make_vectors(profs, GRAPHRAG["dim"], seed=0)
            t1 = time.perf_counter()
            upsert_batch_into([g], profs, vecs)
            t2 = time.perf_counter()
            graph = [f"SELECT ?s WHERE {{ ?s <{UBI}advisor> "
                     f"{ss.id2str(int(a))} . }}"
                     for a in profs[:GRAPHRAG["graph_texts"]]]
            anchors = [ss.id2str(int(a))
                       for a in profs[:GRAPHRAG["anchors"]]]
            rec = out["graphrag"]
            rec.update(vectors=int(len(profs)), make_vectors_s=t1 - t0,
                       upsert_s=t2 - t1)
            log(f"  (a) {len(profs):,} professors embedded (dim "
                f"{GRAPHRAG['dim']}): make_vectors {t1 - t0:.1f} s, upsert "
                f"{t2 - t1:.1f} s")
            part("(a) warm-up")
            for text in graph[:4]:
                proxy.serve_query(text, blind=True)
            t0 = time.perf_counter()
            q = proxy.serve_query(HYBRID_TEMPLATE.replace("{anchor}",
                                                          anchors[0]))
            rec["first_hybrid_ms"] = (time.perf_counter() - t0) * 1e3
            check(q.knn_route == "device" and q.lane == "heavy"
                  and getattr(q, "knn_seeds", None) is not None,
                  f"(a) the hybrid scan took route {q.knn_route}, lane "
                  f"{q.lane}: not the device route sliced on the heavy lane")
            part("(a) graphrag")
            mix = Emulator(proxy).run_graphrag(
                graph, HYBRID_TEMPLATE, anchors,
                duration_s=GRAPHRAG["duration_s"],
                warmup_s=GRAPHRAG["warmup_s"], clients=GRAPHRAG["clients"],
                seed=1, zipf_a=GRAPHRAG["zipf_a"],
                hybrid_frac=GRAPHRAG["hybrid_frac"])
            done("(a) graphrag")
            rec["mix"] = mix
            check(mix["errors"] == 0, f"(a) {mix['errors']} errors")
            check(mix["hybrid"]["served"] > 0 and mix["graph"]["served"] > 0,
                  "(a) a kind was never served")
            log(f"  (a) GraphRAG mix, {GRAPHRAG['clients']} clients "
                f"{GRAPHRAG['duration_s']} s after {GRAPHRAG['warmup_s']} s: "
                f"{mix['qps']} q/s; hybrid {mix['hybrid']}; graph "
                f"{mix['graph']}; errors 0; knn_scan launches "
                f"{launched['(a) graphrag']}")
            entry["name"] = "(a) replay"
            for a in anchors[:8]:
                text = HYBRID_TEMPLATE.replace("{anchor}", a)
                dq = proxy.serve_query(text)
                with Knobs(None, knn_device="host"):
                    hq = proxy.serve_query(text)
                check(dq.knn_route == "device" and hq.knn_route == "host"
                      and ids_multiset(dq) == ids_multiset(hq),
                      f"(a) {a}: device rows differ from the host route's")
            log("  (a) 8 hybrid replies equal to knn_device host's")

            # ---- (b) the full-size scan ---------------------------------
            t0 = time.perf_counter()
            others = np.setdiff1d(np.asarray(g.v_set, np.int64), profs)
            # made in bulk on the card from the seed (the host's generator
            # takes minutes at this size), then brought to the host store
            gen = torch.Generator(device=device).manual_seed(seed + 13)
            big = torch.randn((len(others), GRAPHRAG["dim"]), generator=gen,
                              device=device).cpu().numpy()
            t1 = time.perf_counter()
            upsert_batch_into([g], others, big)
            t2 = time.perf_counter()
            del big
            vs = g.vstore
            n = vs.live_count()
            brec = out["full_scan"] = {"vectors": int(n),
                                       "generate_s": t1 - t0,
                                       "upsert_s": t2 - t1}
            log(f"  (b) {len(others):,} more entities embedded ({n:,} "
                f"vectors, {n * GRAPHRAG['dim'] * 4:,} B): generated in "
                f"{t1 - t0:.1f} s, upserted in {t2 - t1:.1f} s")
            # an entity with an IRI (literals such as e-mail addresses are
            # vertices too, and embedded, but no knn() anchor)
            a_vid = next(int(v) for v in others[len(others) // 3:]
                         if ss.id2str(int(v)).startswith("<"))
            anchor_iri = ss.id2str(a_vid)
            wk = proxy.parse(f"SELECT ?d WHERE {{ {anchors[0]} "
                             f"<{UBI}worksFor> ?d }}")
            proxy.cpu.execute(wk)
            dept = ss.id2str(int(wk.result.table[0, 0]))
            texts = hybrid_texts(anchor_iri, dept)
            anchor = np.asarray(vs.get(a_vid))
            vids_s, vecs_s, alive_s, _v = vs.snapshot()
            with Knobs("(b) one scan of the whole block a query",
                       knn_device="device", knn_split_threshold=1 << 40):
                part("(b) full scan")
                ms = {}
                replies = {}
                for name in [t for t in texts if t.startswith("(b)")]:
                    t0 = time.perf_counter()
                    replies[name] = proxy.serve_query(texts[name])
                    sync(device)
                    ms[name] = (time.perf_counter() - t0) * 1e3
                done("(b) full scan")
            brec["first_query_ms"] = ms[next(iter(ms))]  # stages the block
            brec["staged_bytes"] = int(vs._knn_block.nbytes)
            brec["query_ms"] = ms
            entry["name"] = "(b) replay"
            for name, q in replies.items():
                metric = q.knn.metric or Global.knn_metric
                k = q.knn.k
                check(q.knn_route == "device" and q.knn_mode == "scan",
                      f"(b) {name}: route {q.knn_route}")
                t0 = time.perf_counter()
                hv, hs = host_topk(vids_s, vecs_s, alive_s, anchor, k,
                                   metric)
                host_s = time.perf_counter() - t0
                got = np.asarray(q.result.table)[:, 0]
                dv, dsc, _d = KN.scan_topk(vs, anchor, k, metric,
                                           route="device", device=device)
                check(np.array_equal(dv, got), f"(b) {name}: reply ids "
                      "differ from the device route's")
                s_err = float(np.max(np.abs(dsc.astype(np.float64) - hs)))
                scale = knn_scale(metric, anchor, vecs_s[
                    [vs.slot_of[int(v)] for v in hv.tolist()]], hs)
                check(np.all(np.abs(dsc.astype(np.float64) - hs)
                             <= KNN_ATOL + KNN_RTOL * scale),
                      f"(b) {name}: scores off topk_host's by {s_err}")
                if k <= 10:
                    check(np.array_equal(got, hv),
                          f"(b) {name}: ids differ from topk_host's")
                else:  # ids exact where topk_host's scores are separated
                    gap = np.diff(hs.astype(np.float64))
                    sep = np.ones(len(hs), bool)
                    sep[1:] &= -gap > KNN_GAP
                    sep[:-1] &= -gap > KNN_GAP
                    check(np.array_equal(got[sep], hv[sep])
                          and len(got) == len(hv),
                          f"(b) {name}: ids differ at separated ranks")
                log(f"  (b) {name}: {len(got):,} ids, {ms[name]:.1f} ms "
                    f"through serve_query; equal to topk_host's ({host_s:.1f}"
                    f" s on the host), scores within {s_err:.2e}")
                brec.setdefault("host_oracle_s", {})[name] = host_s

            # ---- (c) pattern-then-rank ----------------------------------
            part("(c) pattern-then-rank")
            cres = out["pattern_then_rank"] = {}
            dev_q = {}
            for name in [t for t in texts if t.startswith("(c)")]:
                t0 = time.perf_counter()
                dev_q[name] = proxy.serve_query(texts[name])
                cres[name] = {"ms": (time.perf_counter() - t0) * 1e3}
            done("(c) pattern-then-rank")
            for name, q in dev_q.items():
                with Knobs(None, knn_device="host"):
                    t0 = time.perf_counter()
                    hq = proxy.serve_query(texts[name])
                    host_ms_ = (time.perf_counter() - t0) * 1e3
                check(q.knn_mode == "pattern_then_rank"
                      and q.knn_route == "device" and q.result.nrows > 0
                      and ids_multiset(q) == ids_multiset(hq),
                      f"(c) {name}: rows differ from the host route's")
                cres[name].update(rows=int(q.result.nrows),
                                  host_route_ms=host_ms_)
                log(f"  (c) {name}: {q.result.nrows} rows equal to the host "
                    f"route's; {cres[name]['ms']:.1f} ms (host route "
                    f"{host_ms_:.1f} ms)")
            log(f"  knn_scan launches by part {launched}; by class "
                f"{dict(cap.launches)}")
            out["launches"] = dict(launched)
            kernel_rows = knn_rows(cap, errs)
            cap.best.clear()  # the measured inputs hold the staged block

            # ---- (d) the drill and the zero-touch check -----------------
            check(vector_demotions() == dem0,
                  "a knn scan was demoted before the drill")
            entry["name"] = "(d) replay"
            text = HYBRID_TEMPLATE.replace("{anchor}", anchors[5])
            want = proxy.serve_query(text)

            def boom():
                raise RuntimeError("injected device failure (phase 13 "
                                   "drill)")

            KN._DEVICE_FAIL_HOOK = boom
            try:
                dq = proxy.serve_query(text)
            finally:
                KN._DEVICE_FAIL_HOOK = None
            nq = proxy.serve_query(text)
            check(dq.knn_demoted == "RuntimeError"
                  and nq.knn_route == "host"
                  and ids_multiset(dq) == ids_multiset(want)
                  == ids_multiset(nq),
                  "(d) the drill did not demote, latch the memo to host and "
                  "answer as the host")
            check(vector_demotions() == dem0 + 1,
                  "(d) a demotion other than the drill's")
            fb = {k: v - fb0[k] for k, v in fallback_counts().items()}
            check(not any(fb.values()), f"phase 13 degraded a strategy {fb}")
            two_hop = (f"SELECT ?x ?y WHERE {{ ?x <{UBI}advisor> "
                       f"{anchors[0]} . ?x <{UBI}memberOf> ?y . }}")
            for _ in range(30):
                proxy.serve_query(two_hop, blind=True)
            lat = {"off": [], "on": []}
            for _round in range(30):
                for mode in ("off", "on"):
                    Global.enable_vectors = mode == "on"
                    for _ in range(10):
                        t0 = time.perf_counter()
                        proxy.serve_query(two_hop, blind=True)
                        lat[mode].append((time.perf_counter() - t0) * 1e6)
            Global.enable_vectors = True

            def band(xs):
                xs = sorted(xs)
                return {"p25_us": xs[len(xs) // 4],
                        "p50_us": xs[len(xs) // 2],
                        "p75_us": xs[3 * len(xs) // 4]}

            off, on = band(lat["off"]), band(lat["on"])
            out["vectors_off"] = {"off": off, "on": on}
            check(off["p25_us"] <= on["p75_us"]
                  and on["p25_us"] <= off["p75_us"],
                  f"(d) vectors off/on bands disjoint: {off} {on}")
            log(f"  (d) drill: demoted (RuntimeError), memo latched to host, "
                f"rows as the host's; other demotions and fallbacks 0; "
                f"2-hop micro off {off} on {on}: bands overlap")
    finally:
        cap.restore()
        cap.best.clear()  # the kept inputs hold the staged block
        stop_pool(proxy)

    # ---- (e) the vector plane detached ------------------------------------
    staged = vs._knn_block.nbytes if vs._knn_block is not None else 0
    check(staged > 0, "(e) no staged block to free")
    before = live_device_bytes(device)[0]
    g.vstore = None
    del vs
    after = live_device_bytes(device)[0]
    out["detach"] = {"staged_bytes": int(staged), "before": before,
                     "after": after}
    if before is not None:
        check(abs((before - after) - staged) <= 64 * MIB,
              f"(e) detaching freed {before - after:,} B of "
              f"memory_allocated, the staged block is {staged:,} B")
    else:
        before = after = 0
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  (e) vectors off, vstore detached: memory_allocated fell by "
        f"{before - after:,} B (staged {staged:,} B); phase 13 took "
        f"{out['seconds']:.1f} s")
    return kernel_rows


# ---------------------------------------------------------------------------
# phase 14: the serving caches and streams (serve/, obs/reuse.py, stream/)
# ---------------------------------------------------------------------------

# bench.py --readmostly's drill: four light families, up to 128 anchors each
READMOSTLY_FAMILIES = ("advisor", "takesCourse", "memberOf", "teacherOf")
# (reads and warm-up reads cut to half of the JAX bench's 600 / 300 for the
# smoke's time: at LUBM-640 a write and the restage after it take about
# 0.9 s, PERF.md §4)
READMOSTLY = {"reads": 300, "warmup_reads": 150,
              "write_rates": (0.0, 0.02, 0.08), "zipf_a": 1.2, "seed": 7,
              "tenants": ["gold", "bulk"]}
READMOSTLY_ANCHORS = 128
WRITE_POOL = 4096  # seeded store triples the write phases sample from
# the pure-hit burst: this many two-pattern texts (the drill's one-pattern
# texts are a host CSR lookup on a miss and launch nothing; the second
# step here is K1's) ...
HIT_TEXTS = 32
HIT_BURST = 512  # ... served this many times in all
# the stream: epochs of new edges among existing entities
STREAM_EPOCHS = 16
STREAM_ROWS = 32_768
STREAM_PREDS = ("memberOf", "worksFor", "advisor", "takesCourse")
STREAM_WINDOW = 4  # S3 and S4: a tumbling window of this many epochs
STREAM_CLIENTS = 4  # light clients sending teacherOf texts meanwhile, ...
STREAM_CLIENT_GAP_S = 0.01  # ... each pausing this long between replies
STANDING = {
    # scripts/bench_stream.py's const_type
    "S1": PREFIX + """SELECT ?X WHERE {
        ?X ub:worksFor <http://www.Department0.University0.edu> .
        ?X rdf:type ub:FullProfessor . }""",
    "S2": PREFIX + """SELECT ?X ?Y WHERE { ?X ub:advisor ?Y .
        ?Y ub:worksFor <http://www.Department0.University0.edu> . }""",
    "S3": PREFIX + "SELECT ?X ?Y WHERE { ?X ub:memberOf ?Y . }",
    # scripts/bench_stream.py's chain2
    "S4": PREFIX + """SELECT ?X ?Y ?Z WHERE {
        ?X ub:memberOf ?Y . ?Y ub:subOrganizationOf ?Z . }""",
}


def family_texts(proxy, preds, anchors: int) -> list:
    """``?s ub:<pred> <a>`` for the first ``anchors`` anchors of each
    predicate's OUT index (bench.py --readmostly's texts)."""
    import numpy as np

    from wukong_tpu_torch.loader.lubm import UB
    from wukong_tpu_torch.types import OUT

    ss, g = proxy.str_server, proxy.g
    out = []
    for pred in preds:
        pid = ss.str2id(f"<{UB}{pred}>")
        out += [f"SELECT ?s WHERE {{ ?s <{UB}{pred}> {ss.id2str(int(a))} . }}"
                for a in np.asarray(g.get_index(pid, OUT))[:anchors]]
    return out


def stream_batches(triples, ss, epochs: int, rows: int, seed: int) -> list:
    """Each epoch: ``rows`` store triples of STREAM_PREDS drawn from the
    seed, each with its object replaced by another object of the same
    predicate (new edges among existing entities)."""
    import numpy as np

    from wukong_tpu_torch.loader.lubm import UB

    rng = np.random.default_rng(seed + 14)
    pids = [ss.str2id(f"<{UB}{p}>") for p in STREAM_PREDS]
    pool = triples[np.isin(triples[:, 1], pids)]
    objs = {pid: np.unique(pool[pool[:, 1] == pid, 2]) for pid in pids}
    out = []
    for _ in range(epochs):
        b = pool[rng.integers(0, len(pool), rows)].copy()
        for pid in pids:
            sel = b[:, 1] == pid
            b[sel, 2] = objs[pid][rng.integers(0, len(objs[pid]),
                                               int(sel.sum()))]
        out.append(b)
    return out


def projected(q, required=None) -> set:
    """A reply's distinct rows over the query's projection."""
    res = q.result
    cols = [res.var2col(v) for v in (required or res.required_vars)]
    if res.nrows == 0:
        return set()
    return set(map(tuple, res.table[:, cols].tolist()))


def one_shot(store, ss, text) -> set:
    """The host CPUEngine's distinct rows of ``text`` over ``store``."""
    from wukong_tpu_torch.engine.cpu import CPUEngine
    from wukong_tpu_torch.planner.heuristic import heuristic_plan
    from wukong_tpu_torch.sparql.parser import Parser

    q = Parser(ss).parse(text)
    heuristic_plan(q)
    q.result.blind = False
    CPUEngine(store, ss).execute(q, from_proxy=False)
    check(q.result.status_code == 0, f"one-shot status {q.result.status_code}")
    return projected(q)


def verb_text(proxy, line: str) -> str:
    import contextlib
    import io

    from wukong_tpu_torch.runtime.console import Console

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        Console(proxy).run_command(line)
    return buf.getvalue().rstrip()


def seed_outcomes() -> dict:
    from wukong_tpu_torch.obs.metrics import get_registry

    fam = get_registry().snapshot().get("wukong_stream_seed_batch_total") \
        or {}
    return {x["labels"].get("outcome"): x.get("value", 0)
            for x in fam.get("series", [])}


def serve_readmostly(proxy, triples, entry: dict, out: dict,
                     reads: dict) -> None:
    """(a) bench.py --readmostly's drill through Emulator.run_readmostly on
    the card: shadow-only, then the result cache and views on, with the
    JAX bench's gates (its q/s gate is a TPU number, not the port's: the
    cached and uncached q/s are printed). Then a burst of pure hits: no
    kernel launch, no host sync."""
    import numpy as np
    import torch

    from wukong_tpu_torch.config import Global
    from wukong_tpu_torch.engine import cuda_lib
    from wukong_tpu_torch.runtime.emulator import Emulator
    from wukong_tpu_torch.serve import get_serve

    on_card = torch.device(proxy._device).type == "cuda"
    texts = family_texts(proxy, READMOSTLY_FAMILIES, READMOSTLY_ANCHORS)
    rng = np.random.default_rng(READMOSTLY["seed"])
    pool = triples[rng.integers(0, len(triples), WRITE_POOL)]
    for t in texts[::READMOSTLY_ANCHORS]:  # parse and plan caches warm
        proxy.serve_query(t, blind=True)
    emu = Emulator(proxy)
    kw = dict(READMOSTLY, **reads, write_batch=pool)
    entry["name"] = "(a) shadow only"
    t0 = time.perf_counter()
    rep = emu.run_readmostly(texts, **kw)
    shadow_s = time.perf_counter() - t0
    check(rep["predicted_hit_rate"] is not None
          and rep["predicted_hit_rate"] >= 0.5,
          f"(a) predicted hit rate {rep['predicted_hit_rate']} < 0.5")
    check(rep["degrades"], "(a) the hit rate does not fall as writes rise: "
          + str([p["hit_rate"] for p in rep["phases"]]))
    check(rep["store_untouched"], "(a) the store's digest or version moved "
          "over the read-only phase")
    entry["name"] = "(a) cached, views"
    t0 = time.perf_counter()
    with Knobs(None, view_promote_edges=1, views_max=256):
        crep = emu.run_readmostly(texts, **kw, cached=True, views=True)
    cached_s = time.perf_counter() - t0
    real = crep["real"]
    check(real["identical"], f"(a) {real['mismatches']} cached replies "
          "differ from an uncached execution")
    check(real["beats_shadow"], f"(a) real hit rate {real['hit_rate']} "
          f"under the shadow's {real['shadow_predicted']}")
    check(real["hit_rate_drop_pts"] is not None
          and real["hit_rate_drop_pts"] <= 15.0,
          f"(a) the real hit rate drops {real['hit_rate_drop_pts']} points "
          "at 8% writes")
    phases = [{k: p.get(k) for k in ("write_rate", "hit_rate", "qps",
                                     "writes", "real_hit_rate", "cached_qps",
                                     "uncached_qps")}
              for p in crep["phases"]]
    out["readmostly"] = {
        "texts": len(texts), **{k: v for k, v in kw.items()
                                if k != "write_batch"},
        "predicted_hit_rate": rep["predicted_hit_rate"],
        "shadow_phases": [{k: p[k] for k in ("write_rate", "hit_rate", "qps",
                                             "writes")}
                          for p in rep["phases"]],
        "cached_phases": phases, "zipf_alpha": rep["zipf_alpha"],
        "real": {k: real[k] for k in ("identical", "hit_rate",
                                      "shadow_predicted", "readmostly_qps",
                                      "uncached_qps", "speedup_vs_uncached",
                                      "hit_rate_drop_pts", "divergence")},
        "views": {k: real["views"][k] for k in ("registered", "promoted",
                                                "rejected", "demoted")},
        "shadow_s": shadow_s, "cached_s": cached_s}
    log(f"  (a) shadow only: predicted hit rate {rep['predicted_hit_rate']}"
        f", hit rate by write rate "
        f"{[(p['write_rate'], p['hit_rate']) for p in rep['phases']]}, "
        f"q/s {[p['qps'] for p in rep['phases']]} ({shadow_s:.1f} s)")
    log(f"  (a) cached + views: real hit rate by write rate "
        f"{[(p['write_rate'], p['real_hit_rate']) for p in phases]} (drop "
        f"{real['hit_rate_drop_pts']} points), every reply identical to an "
        f"uncached one; read-only phase {real['readmostly_qps']} q/s "
        f"cached, {real['uncached_qps']} q/s uncached (x"
        f"{real['speedup_vs_uncached']}); views {out['readmostly']['views']}"
        f" ({cached_s:.1f} s)")
    # a burst of pure hits: texts executed once on the card (K1 probes
    # their second step), then answered on the fast path
    from wukong_tpu_torch.loader.lubm import UB

    hot = [t.replace(" . }", f" . ?s <{UB}takesCourse> ?c . }}").replace(
        "SELECT ?s WHERE", "SELECT ?s ?c WHERE")
        for t in family_texts(proxy, ("advisor",), HIT_TEXTS)]
    with Knobs(None, enable_result_cache=True):
        entry["name"] = "(a) burst misses"
        n0 = cuda_lib.thread_launches()
        for t in hot:
            q = proxy.serve_query(t, blind=True)
            check(q.result.status_code == 0
                  and q.__dict__.get("_rc_probe") == "miss",
                  "(a) a burst text's first serve was not an executed miss")
        missed = cuda_lib.thread_launches() - n0
        check(missed > 0 or not on_card,
              "(a) the burst texts' misses launched no kernel")
        for t in hot:
            proxy.serve_query(t, blind=True)
        rc = get_serve().cache
        h0 = rc.stats()["hits"]
        n0 = cuda_lib.thread_launches()
        entry["name"] = "(a) hit burst"

        def burst():
            for k in range(HIT_BURST):
                q = proxy.serve_query(hot[k % len(hot)], blind=True)
                check(q.__dict__.get("_rc_probe") == "hit",
                      "(a) a burst reply was not a cache hit")

        t0 = time.perf_counter()
        if on_card:
            # the counter's own use, with no work (phase 7's baseline):
            # what it reports here is not the burst's
            base, base_sites = count_syncs(lambda: None)
            syncs, sites = count_syncs(burst)
            for at, n in base_sites.items():
                if sites.get(at, 0) <= n:
                    syncs -= sites.pop(at, 0)
        else:
            burst()
            syncs, sites, base = 0, {}, 0
        burst_s = time.perf_counter() - t0
        launched = cuda_lib.thread_launches() - n0
    check(rc.stats()["hits"] - h0 == HIT_BURST,
          f"(a) {rc.stats()['hits'] - h0} hits of {HIT_BURST}")
    check(launched == 0, f"(a) the hit burst launched {launched} kernels")
    check(syncs == 0, f"(a) the hit burst synced the host {syncs} times at "
          f"{sites}")
    out["hit_burst"] = {"replies": HIT_BURST, "texts": len(hot),
                        "miss_launches": missed,
                        "launches": launched, "syncs": syncs,
                        "counter_baseline": base,
                        "qps": HIT_BURST / burst_s}
    log(f"  (a) {len(hot)} two-pattern texts executed on their misses "
        f"({missed} kernel launches), then {HIT_BURST} pure hits over them: 0 "
        f"kernel "
        f"launches, 0 host syncs (the counter's own use, with no work: "
        f"{base}), {HIT_BURST / burst_s:,.0f} replies/s")
    log("  (a) cache verb:\n    "
        + verb_text(proxy, "cache -k 4").replace("\n", "\n    "))
    log("  (a) history verb:\n    "
        + verb_text(proxy, "history -k 6").replace("\n", "\n    "))


def serve_stream(proxy, triples, entry: dict, out: dict, epochs: int,
                 rows: int, seed: int) -> None:
    """(b) the stream: STANDING's queries on the pool's stream lane while
    STREAM_CLIENTS light clients send teacherOf texts (which the stream
    never writes); each epoch's device frontier held against the host
    twin; the standing results against one-shots at the end."""
    import threading

    import numpy as np
    import torch

    from wukong_tpu_torch.loader.lubm import UB
    from wukong_tpu_torch.store.gstore import build_partition
    from wukong_tpu_torch.stream import WindowSpec
    from wukong_tpu_torch.stream import continuous as C

    ss = proxy.str_server
    batches = stream_batches(triples, ss, epochs, rows, seed)
    sub = ss.str2id(f"<{UB}subOrganizationOf>")
    base = triples[triples[:, 1] == sub]
    ctx = proxy.stream_context(use_pool=True)
    check(ctx.continuous.pool is not None,
          "(b) the stream context was built before phase 14, without the "
          "pool's stream lane")
    win = WindowSpec.tumbling(STREAM_WINDOW)
    t0 = time.perf_counter()
    qids = {"S1": proxy.stream_register(STANDING["S1"]),
            "S2": proxy.stream_register(STANDING["S2"]),
            "S3": proxy.stream_register(STANDING["S3"], window=win),
            "S4": proxy.stream_register(STANDING["S4"], window=win,
                                        base_triples=base)}
    reg_s = time.perf_counter() - t0
    # the clients' texts and their rows (the stream never writes teacherOf)
    light = family_texts(proxy, ("teacherOf",), 64)
    want = {t: proxy.serve_query(t, blind=True).result.nrows for t in light}
    stop = threading.Event()
    errors: list = []
    served = [0] * STREAM_CLIENTS

    def client(k: int) -> None:
        rng = np.random.default_rng(seed + k)
        try:
            while not stop.is_set():
                t = light[int(rng.integers(0, len(light)))]
                q = proxy.serve_query(t, blind=True, tenant="gold")
                if q.result.status_code != 0 or q.result.nrows != want[t]:
                    errors.append((t, q.result.status_code, q.result.nrows))
                served[k] += 1
                stop.wait(STREAM_CLIENT_GAP_S)
        except Exception as e:  # a client's error fails the phase
            errors.append(repr(e))

    # every epoch's frontier as the device computed it, beside its time
    frontiers: list = []
    orig = C.device_seed_extract

    def recorded(patterns, batch, owner=None, device=None):
        t1 = time.perf_counter()
        got = orig(patterns, batch, owner=owner, device=device)
        if got is not None:
            frontiers.append((list(patterns), batch, got,
                              time.perf_counter() - t1))
        return got

    o0 = seed_outcomes()
    entry["name"] = "(b) stream clients"
    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(STREAM_CLIENTS)]
    C.device_seed_extract = recorded
    try:
        for th in threads:
            th.start()
        t0 = time.perf_counter()
        recs = []
        for k, b in enumerate(batches):
            recs.append(proxy.stream_feed(b))
            if k % 4 == 3:
                log(f"  (b) epoch {k + 1}: {time.perf_counter() - t0:.1f} s")
        feed_s = time.perf_counter() - t0
    finally:
        C.device_seed_extract = orig
        stop.set()
        for th in threads:
            th.join(60)
    check(not errors, f"(b) light clients failed: {errors[:3]}")
    fused = seed_outcomes().get("fused", 0) - o0.get("fused", 0)
    check(fused >= epochs and len(frontiers) >= epochs,
          f"(b) the device frontier ran {fused} times over {epochs} epochs")
    # each epoch's seed rows against the host twin (match_delta)
    dev_ms, host_ms = [], []
    for patterns, batch, got, dt in frontiers:
        t1 = time.perf_counter()
        host = [C.match_delta(p, batch) for p in patterns]
        host_ms.append((time.perf_counter() - t1) * 1e3)
        dev_ms.append(dt * 1e3)
        for i, (hv, hs) in enumerate(host):
            check(got[i][0] == hv and np.array_equal(got[i][1], hs),
                  f"(b) a frontier term's seed rows differ from the host "
                  f"twin's ({len(got[i][1])} rows, host {len(hs)})")
    # the standing results against one-shots
    for name in ("S1", "S2"):
        have = set(map(tuple, ctx.result_set(qids[name]).tolist()))
        host = projected(proxy.serve_query(STANDING[name], device="cpu"))
        card = projected(proxy.serve_query(STANDING[name]))
        check(have == host == card, f"(b) {name}: {len(have)} standing "
              f"rows, host one-shot {len(host)}, card {len(card)}")
    live = np.concatenate([b for _e, b in
                           ctx.continuous.queries[qids["S3"]].window.live])
    for name, extra in (("S3", None), ("S4", base)):
        store = build_partition(live if extra is None
                                else np.concatenate([extra, live]), 0, 1)
        have = set(map(tuple, ctx.result_set(qids[name]).tolist()))
        want_w = one_shot(store, ss, STANDING[name])
        check(have == want_w, f"(b) {name}: {len(have)} standing rows, the "
              f"live window's one-shot {len(want_w)}")
    st = proxy.monitor.stream_stats()
    sizes = {n: len(ctx.result_set(q)) for n, q in qids.items()}
    rec = {"epochs": epochs, "rows": rows, "register_s": reg_s,
           "feed_s": feed_s, "epochs_per_s": epochs / feed_s,
           "inserts_per_s": sum(r.n_inserted for r in recs) / feed_s,
           "eval_us": st["eval_us_cdf"], "lag_us": st["lag_us_cdf"],
           "frontier_ms": dev_ms, "host_twin_ms": host_ms,
           "frontier_calls": len(frontiers), "fused": fused,
           "client_replies": sum(served), "standing_rows": sizes,
           "retractions": sum(d.sign < 0 for q in qids.values()
                              for d in ctx.poll(q))}
    out["stream"] = rec
    log(f"  (b) {epochs} epochs of {rows:,} triples: {rec['epochs_per_s']:.2f}"
        f" epochs/s, {rec['inserts_per_s']:,.0f} inserts/s; eval p50/p99 "
        f"{st['eval_us_cdf'].get(0.5, 0) / 1e3:,.1f}/"
        f"{st['eval_us_cdf'].get(0.99, 0) / 1e3:,.1f} ms, lag p50/p99 "
        f"{st['lag_us_cdf'].get(0.5, 0) / 1e3:,.1f}/"
        f"{st['lag_us_cdf'].get(0.99, 0) / 1e3:,.1f} ms; the frontier "
        f"({len(frontiers)} calls, {len(frontiers[0][0])} terms) median "
        f"{statistics.median(dev_ms):.2f} ms on the device against "
        f"{statistics.median(host_ms):.2f} ms for the host twin, seed rows "
        f"equal; standing rows {sizes} equal to the one-shots; "
        f"{sum(served):,} client replies meanwhile, all equal")
    for q in qids.values():
        proxy.stream_unregister(q)
    del frontiers
    if torch.device(proxy._device).type == "cuda":
        torch.cuda.synchronize()


def serve_caches_streams(proxy, triples, entry: dict, results: dict,
                         seed: int = 0, reads: dict | None = None,
                         epochs: int = STREAM_EPOCHS,
                         rows: int = STREAM_ROWS) -> None:
    """Phase 14 on phase 3's proxy: (a) the read-mostly drill and the hit
    burst, (b) the stream. ``reads`` overrides READMOSTLY's read counts (a
    CPU rehearsal runs it small)."""
    out = results["caches_streams"] = {}
    t0 = time.perf_counter()
    serve_readmostly(proxy, triples, entry, out, reads or {})
    t1 = time.perf_counter()
    serve_stream(proxy, triples, entry, out, epochs, rows, seed)
    out["seconds"] = {"readmostly": t1 - t0,
                      "stream": time.perf_counter() - t1}
    # the stream lane's pool engines hold the proxy (their engine factory
    # is its method): stopped here, or the proxy outlives its drop; and the
    # serving plane lets go of phase 3's store (its views and entries hold
    # host memory only, but the store is the size of the world)
    from wukong_tpu_torch.serve import get_serve

    stop_pool(proxy)

    get_serve().reset()
    get_serve().attach(None, None)
    log(f"  phase 14 seconds: {out['seconds']}")


def dir_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        total += sum(os.path.getsize(os.path.join(root, f)) for f in files)
    return total


def write_ids(path: str, triples) -> str:
    """An id-format directory holding the triples (id_triples.npy, as the
    loaders' write_dataset writes it)."""
    import numpy as np

    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "id_triples.npy"), triples)
    return path


def phase12_online(out: dict, entry: dict, device, wt, full_rows: dict,
                   texts: dict, stats, scale: int, seed: int,
                   root: str) -> None:
    """(d) online inserts and (e) durability on the WatDiv world, planned
    with (a)'s statistics (the full store's: an estimate of the 90% base
    from them is high, never empty)."""
    import gc

    import numpy as np
    import torch

    from wukong_tpu_torch.config import Global
    from wukong_tpu_torch.loader.watdiv import P as WP
    from wukong_tpu_torch.loader.watdiv import VirtualWatdivStrings
    from wukong_tpu_torch.runtime.console import Console
    from wukong_tpu_torch.runtime.proxy import Proxy
    from wukong_tpu_torch.store.persist import clone_gstore, gstore_digest
    from wukong_tpu_torch.vector.vstore import upsert_batch_into

    on_card = torch.device(device).type == "cuda"
    rng = np.random.default_rng(seed + 2)
    keep = rng.random(len(wt)) >= INSERT_SHARE
    base, delta = wt[keep], wt[~keep]
    parts = np.array_split(delta[rng.permutation(len(delta))],
                           len(WAL_SYNCS))
    dirs = [write_ids(os.path.join(root, f"delta{k}"), p)
            for k, p in enumerate(parts)]
    whole = os.path.join(root, "delta")
    os.makedirs(whole)
    for k, p in enumerate(parts):  # the chunked form of the whole delta
        np.save(os.path.join(whole, f"id_triples_{k:05d}.npy"), p)
    rec = out["online"] = {"base_triples": len(base),
                           "delta_triples": len(delta), "rounds": []}
    ss = VirtualWatdivStrings(scale, seed)
    proxy, _stats = world_proxy(base, ss, device,
                                f"(d) WatDiv-{scale}, {1 - INSERT_SHARE:.0%}",
                                stats)
    base_copy = clone_gstore(proxy.g)  # (e)'s fresh proxy starts from it
    planner = proxy.planner
    Global.wal_dir = os.path.join(root, "wal")
    Global.checkpoint_dir = os.path.join(root, "ckpt")
    con = Console(proxy)
    first = sorted(texts)[0]
    ds = proxy.gpu.dstore
    # the rounds keep no kernel input for the kernels line: what
    # memory_allocated reads is the program's alone
    Capture.keep = False
    try:
        rows, _ms = served_rows(proxy, texts, device, 1, entry,
                                "(d) before ")
        for k, (mode, d) in enumerate(zip(WAL_SYNCS, dirs)):
            Global.wal_sync = mode
            old = staged_refs(ds)
            check(len(old) > 0, f"(d) round {k}: nothing staged to follow")
            t0 = time.perf_counter()
            con.run_command(f"load -d {d}")
            load_s = time.perf_counter() - t0
            check(proxy.g.version == k + 1, f"(d) load {k}: store version "
                  f"{proxy.g.version}")
            entry["name"] = f"(d) first query after insert {k}"
            q, lat1 = host_ms(lambda: proxy.serve_query(texts[first]), 1,
                              device)
            restaged = ds.bytes_used
            check(ds._seen_version == proxy.g.version,
                  f"(d) round {k}: the device store kept the old version")
            gc.collect()
            alive = sum(ref() is not None for ref in old)
            entry["name"] = f"(d) steady {k}"
            q, lat = host_ms(lambda: proxy.serve_query(texts[first]), 5,
                             device)
            rows, _ms = served_rows(proxy, texts, device, 1, entry,
                                    f"(d) round {k} ")
            sync(device)
            r = {"wal_sync": mode, "triples": len(parts[k]),
                 "load_s": load_s, "insert_rate": len(parts[k]) / load_s,
                 "first_query": first, "first_ms": lat1[0],
                 "first_restaged_bytes": int(restaged),
                 "steady_ms": float(np.median(lat)),
                 "staged_bytes": int(ds.bytes_used),
                 "old_staged_tensors": len(old), "old_staged_alive": alive}
            r["memory_allocated"], r["tensor_bytes"] = \
                live_device_bytes(device)
            rec["rounds"].append(r)
            log(f"  (d) load -d round {k} (wal_sync {mode}): "
                f"{len(parts[k]):,} triples in {load_s:.3f} s "
                f"({r['insert_rate']:,.0f} triples/s); {first} first "
                f"{lat1[0]:.2f} ms restaging {restaged:,} B, steady "
                f"{r['steady_ms']:.2f} ms; {alive} of the old version's "
                f"{len(old)} staged tensors alive after the restage; staged "
                f"{r['staged_bytes']:,} B, memory_allocated "
                f"{r['memory_allocated']} (reachable CUDA tensors "
                f"{r['tensor_bytes']} B)")
    finally:
        Capture.keep = True
    for name in texts:
        check(same_rows(rows[name], full_rows[name]),
              f"(d) {name}: {len(rows[name])} rows after load -d, "
              f"{len(full_rows[name])} on the full store")
    # the leak check: the old version's staged tensors are all freed by the
    # restage, and memory_allocated may grow over a round by no more than
    # the staged bytes did (the new data's share), with 16 MiB of slack for
    # the allocator's rounding; checked after (e), so that one run reports
    # everything
    leaks = [f"(d) round {k}: {r['old_staged_alive']} of the old version's "
             f"staged tensors alive after the restage"
             for k, r in enumerate(rec["rounds"]) if r["old_staged_alive"]]
    if on_card:
        mem = [r["memory_allocated"] for r in rec["rounds"]]
        st = [r["staged_bytes"] for r in rec["rounds"]]
        for k in range(1, len(mem)):
            if mem[k] - mem[k - 1] > max(st[k] - st[k - 1], 0) + (16 << 20):
                leaks.append(f"(d) memory_allocated grew "
                             f"{mem[k] - mem[k - 1]:,} B over round {k}, "
                             f"staged bytes {st[k] - st[k - 1]:,} B")
    log(f"  (d) memory_allocated over the rounds: {leaks or 'bounded'}")
    log(f"  (d) the twelve templates after three load -d rounds: rows equal "
        f"to (a)'s full store")
    n = proxy.dynamic_load_data(whole, True)
    check(n == 0, f"(d) load -d -c of the whole delta gave {n} new edges")
    t0 = time.perf_counter()
    violations = proxy.gstore_check()
    rec["gsck_s"] = time.perf_counter() - t0
    check(violations == 0, f"(d) gsck: {violations} violations")
    log(f"  (d) load -d -c again: 0 new edges; gsck PASS in "
        f"{rec['gsck_s']:.2f} s")
    routes = {}
    for label, knobs in (("wcoj device", {"join_strategy": "wcoj",
                                          "join_device": "device"}),
                         ("template", {"join_strategy": "walk",
                                       "template_device": "device"})):
        dec: dict = {}
        with Knobs(None, **knobs):
            got, ms = served_rows(proxy, texts, device, 1, entry,
                                  f"(d) {label} ", dec)
        for name in texts:
            check(same_rows(got[name], full_rows[name]),
                  f"(d) {label} {name}: {len(got[name])} rows, walk "
                  f"{len(full_rows[name])}")
            d = dec[name]
            # a level with no candidates stays on the host, as in JAX
            took = (d["strategy"] == "wcoj" and d["join_route"] == "device"
                    and all(rt == "device" for _l, c, _r, rt in d["levels"]
                            if c)
                    if label.startswith("wcoj") else d["compiled"])
            check(took, f"(d) {label} {name}: the route was not taken {d}")
        routes[label] = ms
        log(f"  (d) forced {label}: rows equal to the walk's on all twelve; "
            f"ms {ms}")
    rec["forced_routes_ms"] = routes

    # ---- (e) durability ----
    dur = out["durability"] = {}
    users = np.unique(wt[wt[:, 1] == WP["friendOf"], 0])
    # a standing WatDiv query rides the bundle: registered before the
    # checkpoint, STANDING_EPOCHS epochs fed after it (WAL epoch records)
    from wukong_tpu_torch.loader.watdiv import WSDBM

    star = int(users[0])
    stext = (f"SELECT ?x WHERE {{ ?x <{WSDBM}friendOf> "
             f"{ss.id2str(star)} . }}")
    sq = proxy.stream_register(stext)
    t0 = time.perf_counter()
    con.run_command("checkpoint")
    dur["checkpoint_s"] = time.perf_counter() - t0
    ck = proxy.recovery().newest_checkpoint()
    check(ck is not None, "(e) no checkpoint written")
    check(os.path.exists(os.path.join(ck[0], "stream.pkl")),
          "(e) the checkpoint holds no stream registry")
    dur["checkpoint_bytes"] = dir_bytes(ck[0])
    srng = np.random.default_rng(seed + 4)
    for _ in range(STANDING_EPOCHS):
        b = np.stack([users[srng.integers(0, len(users), STANDING_ROWS)],
                      np.full(STANDING_ROWS, WP["friendOf"]),
                      users[srng.integers(0, len(users), STANDING_ROWS)]], 1)
        b[::8, 2] = star  # an eighth of the epoch reaches the standing query
        proxy.stream_feed(b)
    ctx = proxy.stream_context()
    swant = ctx.result_set(sq)
    ssink = [(d.epoch, d.sign, d.rows.tolist()) for d in ctx.poll(sq)]
    sepoch = ctx.epoch
    extra = np.unique(np.stack([users[rng.integers(0, len(users),
                                                   EXTRA_EDGES)],
                                np.full(EXTRA_EDGES, WP["friendOf"]),
                                users[rng.integers(0, len(users),
                                                   EXTRA_EDGES)]], 1), axis=0)
    con.run_command(
        f"load -d {write_ids(os.path.join(root, 'extra'), extra)} -c")
    # one WAL-logged vector batch after the checkpoint: recover replays it
    vrng = np.random.default_rng(seed + 3)
    vvids = np.sort(vrng.choice(users, min(VECTORS_AFTER_CKPT, len(users)),
                                replace=False))
    vknobs = {"enable_vectors": True, "vector_dim": 64,
              "knn_device": "device"}
    ktext = (f"SELECT ?x WHERE {{ knn(?x, {ss.id2str(int(vvids[7]))}, "
             f"10) }}")
    with Knobs(None, **vknobs):
        upsert_batch_into([proxy.g], vvids, vrng.standard_normal(
            (len(vvids), 64), dtype=np.float32))
        vdigest = proxy.g.vstore.digest()
        kwant = proxy.serve_query(ktext).result.table.tolist()
    check(len(kwant) == 10, f"(e) knn reply of {len(kwant)} rows")
    replayed0 = replayed_vectors()
    want, _ms = served_rows(proxy, texts, device, 1, entry, "(e) pre-drop ")
    digest = gstore_digest(proxy.g)
    dur["wal_bytes"] = dir_bytes(Global.wal_dir)
    del con, proxy
    collect(device)
    fresh = Proxy(base_copy, ss, device=device, planner=planner)
    t0 = time.perf_counter()
    Console(fresh).run_command("recover")
    dur["recover_s"] = time.perf_counter() - t0
    check(gstore_digest(fresh.g) == digest,
          "(e) gstore_digest after recover differs from the pre-drop store's")
    check(replayed_vectors() - replayed0 == 1,
          "(e) recover did not replay the one vector record")
    with Knobs(None, **vknobs):
        check(fresh.g.vstore is not None
              and fresh.g.vstore.digest() == vdigest,
              "(e) the vector store's digest differs after recover")
        kgot = fresh.serve_query(ktext).result.table.tolist()
    check(kgot == kwant, "(e) the knn reply differs after recover")
    fctx = fresh.stream_context()
    check(sorted(fctx.continuous.queries) == [sq]
          and fctx.epoch == sepoch
          and np.array_equal(fctx.result_set(sq), swant)
          and [(d.epoch, d.sign, d.rows.tolist()) for d in fctx.poll(sq)]
          == ssink,
          f"(e) the standing query after recover: registry "
          f"{sorted(fctx.continuous.queries)}, epoch {fctx.epoch} (want "
          f"{sepoch}), {len(fctx.result_set(sq))} rows (want {len(swant)})")
    dur.update(vectors=int(len(vvids)), vstore_digest=int(vdigest),
               standing_rows=int(len(swant)), standing_epochs=sepoch)
    got, _ms = served_rows(fresh, texts, device, 1, entry, "(e) recovered ")
    for name in texts:
        check(same_rows(got[name], want[name]),
              f"(e) {name}: {len(got[name])} rows after recover, "
              f"{len(want[name])} before the drop")
    dur.update(extra_edges=int(len(extra)), digest=int(digest))
    log(f"  (e) checkpoint {dur['checkpoint_s']:.2f} s, "
        f"{dur['checkpoint_bytes']:,} B; {len(extra):,} more edges and "
        f"{len(vvids):,} vectors (vstore digest {vdigest} and a knn reply "
        f"equal after recover); "
        f"WAL {dur['wal_bytes']:,} B; recover {dur['recover_s']:.2f} s: "
        f"gstore_digest {digest} equal, the twelve templates' rows equal; "
        f"a standing query's registry, {len(swant):,} rows and sink equal "
        f"after {sepoch} epochs replayed from the WAL")
    Global.wal_dir = Global.checkpoint_dir = ""
    Global.wal_sync = "none"
    del fresh
    collect(device)
    check(not leaks, "; ".join(leaks))


def replayed_vectors() -> float:
    from wukong_tpu_torch.obs.metrics import get_registry

    fam = get_registry().snapshot().get("wukong_recovery_replayed_total") \
        or {}
    return sum(x.get("value", 0) for x in fam.get("series", [])
               if x.get("labels", {}).get("kind") == "vector")


def serve_data_in(entry: dict, results: dict, device="cuda",
                  watdiv_scale: int = WATDIV_SCALE,
                  yago_persons: int = YAGO_PERSONS,
                  generic_entities: int = GENERIC_ENTITIES,
                  seed: int = 0) -> None:
    """Phase 12 (a)-(e), each world built, served and dropped in turn."""
    out = results["data_in"] = {}
    part_s = out["part_s"] = {}
    with walk_pinned("12"):
        t0 = time.perf_counter()
        wt, full_rows, texts, stats = phase12_watdiv(out, entry, device,
                                                     watdiv_scale, seed)
        t1 = time.perf_counter()
        phase12_yago(out, entry, device, yago_persons, seed)
        t2 = time.perf_counter()
        phase12_dbpsb(out, entry, device, generic_entities)
        t3 = time.perf_counter()
        with tempfile.TemporaryDirectory() as root:
            phase12_online(out, entry, device, wt, full_rows, texts, stats,
                           watdiv_scale, seed, root)
        t4 = time.perf_counter()
    part_s.update(watdiv=t1 - t0, yago=t2 - t1, dbpsb=t3 - t2,
                  online_and_durability=t4 - t3)
    log("  phase 12 seconds by part: "
        + ", ".join(f"{k} {v:.1f}" for k, v in part_s.items()))


# ---------------------------------------------------------------------------
# phase 15: the distributed engine, D shard slots on the card
# ---------------------------------------------------------------------------

DIST_SHARDS = 8  # the JAX bench's and tests' mesh
# the extended shapes served through `-d dist`: a UNION, an OPTIONAL, a
# variable-predicate const start and an attribute query
DIST_EXT = ("x_union", "x_opt_light", "x_vers_const", "x_attr")
# the light const shapes served on both routes (in place and collective)
DIST_LIGHT = ("lubm_q3", "lubm_q4", "lubm_q5", "lubm_q7")
# the shard-down drill's text: its segment (headOf IN) is staged by no
# earlier step of the phase, so its first fetch meets the fault
DIST_DRILL = PREFIX + f"SELECT ?X WHERE {{ ?X ub:headOf {DEPT0} . }}"
DIST_HOTSPOT_OPS = 600
# the chain steps that probe each shard's segment with K1
DIST_PROBING = ("init_const", "expand", "expand_type_all", "member",
                "expand_versatile", "expand_versatile_const")


class AnnotatedCollectives:
    """While in a ``with`` block, the distributed chain's exchange and
    all-gather run inside torch.profiler ranges ("dist.exchange",
    "dist.allgather"), so a device trace attributes the kernels each one
    launches (``chain_split``)."""

    def __enter__(self):
        import torch

        from wukong_tpu_torch.parallel import dist_engine as DE

        self.DE = DE
        self.saved = (DE._exchange, DE._allgather_rows)

        def ranged(fn, label):
            def inner(*a, **kw):
                with torch.profiler.record_function(label):
                    return fn(*a, **kw)
            return inner

        DE._exchange = ranged(DE._exchange, "dist.exchange")
        DE._allgather_rows = ranged(DE._allgather_rows, "dist.allgather")
        return self

    def __exit__(self, *exc) -> None:
        self.DE._exchange, self.DE._allgather_rows = self.saved


def chain_split(path: str) -> dict:
    """A device trace of one distributed chain split by what ran: device
    us of the exchange's and the all-gather's kernels (their launches lie
    inside the "dist.*" ranges on the host), of K1 (probe_kernel) and of
    everything else, and the card's idle share over the chain's span on
    the device (first device event to the end of the last: the gaps that
    no kernel, copy or fill covers)."""
    with open(path) as f:
        js = json.load(f)
    evs = js.get("traceEvents", []) if isinstance(js, dict) else js
    ranges = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in evs
              if e.get("ph") == "X" and e.get("name") in
              ("dist.exchange", "dist.allgather")
              and str(e.get("cat", "")).lower() == "user_annotation"]
    label = {}
    for e in evs:
        if str(e.get("cat", "")).lower() in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            for lo, hi, name in ranges:
                if corr is not None and lo <= e.get("ts", -1) <= hi:
                    label[corr] = name
    dev = [e for e in evs if e.get("ph") == "X" and str(
        e.get("cat", "")).lower() in ("kernel", "gpu_memcpy", "gpu_memset")]
    split = {"dist.exchange": 0.0, "dist.allgather": 0.0, "k1": 0.0,
             "other": 0.0}
    k1_calls = 0
    for e in dev:
        dur = float(e.get("dur", 0.0))
        name = label.get((e.get("args") or {}).get("correlation"))
        if name is not None:
            split[name] += dur
        elif "probe_kernel" in str(e.get("name", "")):
            split["k1"] += dur
            k1_calls += 1
        else:
            split["other"] += dur
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in dev)
    busy, end = 0.0, None
    for lo, hi in spans:
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    span = (max(hi for _lo, hi in spans) - spans[0][0]) if spans else 0.0
    total = sum(split.values())
    return {"device_us": total, "span_us": span, "busy_us": busy,
            "idle_share": (1 - busy / span) if span else None,
            "exchange_us": split["dist.exchange"],
            "allgather_us": split["dist.allgather"], "k1_us": split["k1"],
            "k1_calls": k1_calls, "other_us": split["other"],
            "ranges": len(ranges), "device_events": len(dev)}


def dist_bench(dist, planner, ss, expected: dict, out: dict) -> None:
    """(a) L1-L7 as bench.py --dist runs them (bench.py:2950-2990): blind,
    planned by the type-centric planner, the first call and the best of
    the next 3, each chain's stats and bytes model; rows equal to the
    single-card engine's (phase 4). Then each once more with its table,
    projected: the rows of phase 4, as a multiset."""
    from wukong_tpu_torch.sparql.parser import Parser

    out["queries"] = {}
    for name, text in QUERIES.items():
        first, best = None, None
        for rep in range(4):
            q = Parser(ss).parse(text)
            planner.generate_plan(q)
            q.result.blind = True
            t0 = time.perf_counter()
            dist.execute(q, from_proxy=False)
            ms = (time.perf_counter() - t0) * 1e3
            check(q.result.status_code == 0, f"dist {name}: status "
                  f"{q.result.status_code!r}")
            if rep == 0:
                first = ms
            else:
                best = ms if best is None else min(best, ms)
        rows = q.result.nrows
        want = expected[name].shape[0]
        check(rows == want, f"dist {name}: {rows:,} rows, single card "
              f"{want:,}")
        st = dist.last_chain_stats or {}
        row = {"rows": rows, "first_ms": first, "best_ms": best,
               "mode": st.get("mode", "collective"), "chain": st,
               "bytes_model": dist.bytes_model(),
               "planner_empty": bool(q.planner_empty)}
        qt = Parser(ss).parse(text)
        planner.generate_plan(qt)
        qt.result.blind = False
        dist.execute(qt)
        check(qt.result.status_code == 0 and np_equal(
            sorted_table(qt), expected[name]),
            f"dist {name}: rows differ from phase 4's")
        out["queries"][name] = row
        bm = row["bytes_model"] or {}
        log(f"  dist {name}: {rows:,} rows (as phase 4), first "
            f"{first:,.2f} ms, best of 3 {best:,.2f} ms, {row['mode']}, "
            f"retries {st.get('retries', 0)}, exchanges "
            f"{st.get('exchanges', 0)}, modelled bytes "
            f"{bm.get('total_bytes', 0):,}")


def np_equal(a, b) -> bool:
    import numpy as np

    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


def dist_routes(dist, planner, ss, expected: dict, out: dict) -> None:
    """(b) the light const shapes on both routes: in place (owner-routed
    host walk, no exchange) and the collective chain, with equal rows,
    phase 4's."""
    from wukong_tpu_torch.sparql.parser import Parser

    out["routes"] = {}
    for name in DIST_LIGHT:
        got = {}
        for inplace in (True, False):
            with Knobs(None, enable_dist_inplace=inplace):
                q = Parser(ss).parse(QUERIES[name])
                planner.generate_plan(q)
                q.result.blind = False
                t0 = time.perf_counter()
                dist.execute(q)
                ms = (time.perf_counter() - t0) * 1e3
            mode = (dist.last_chain_stats or {}).get("mode", "collective")
            check(q.result.status_code == 0 and np_equal(
                sorted_table(q), expected[name]),
                f"dist {name} ({mode}): rows differ from phase 4's")
            got["inplace" if inplace else "collective"] = {
                "mode": mode, "ms": ms, "rows": q.result.nrows}
        out["routes"][name] = got
        log(f"  dist {name}: {got['inplace']['rows']:,} rows on both "
            f"routes: {got['inplace']['mode']} {got['inplace']['ms']:.2f} "
            f"ms, {got['collective']['mode']} "
            f"{got['collective']['ms']:.2f} ms")


def dist_extended(proxy, results: dict, out: dict) -> None:
    """(c) the extended shapes through the proxy's `-d dist` route,
    heuristically planned as in phase 5: rows as many as phase 5's
    single-card replies (the same world)."""
    out["extended"] = {}
    for name in DIST_EXT:
        t0 = time.perf_counter()
        with Knobs(None, enable_planner=False):
            q = proxy.run_single_query(EXT_QUERIES[name], device="dist",
                                       blind=False)
        ms = (time.perf_counter() - t0) * 1e3
        want = results["extended"][name]["rows"]
        check(q.result.status_code == 0 and q.result.complete
              and q.result.nrows == want,
              f"dist {name}: {q.result.nrows:,} rows, status "
              f"{q.result.status_code!r}; phase 5 {want:,}")
        out["extended"][name] = {"rows": q.result.nrows, "ms": ms}
        log(f"  dist -d {name}: {q.result.nrows:,} rows (as phase 5), "
            f"{ms:,.2f} ms")


def dist_k1_chain(dist, planner, ss, k1_launches, out: dict) -> None:
    """(d) one steady collective chain of q2: K1 must launch on every
    shard for every probing step, at least D per step."""
    from wukong_tpu_torch.sparql.parser import Parser

    q = Parser(ss).parse(QUERIES["lubm_q2"])
    planner.generate_plan(q)
    q.result.blind = True
    before = k1_launches()
    dist.execute(q, from_proxy=False)
    n = k1_launches() - before
    kinds = [s.kind for s in dist._last_plan.steps]
    probing = sum(k in DIST_PROBING for k in kinds)
    check(n >= DIST_SHARDS * probing and probing > 0,
          f"dist q2: {n} K1 launches for {probing} probing steps of "
          f"{DIST_SHARDS} shards")
    out["k1_chain"] = {"launches": n, "steps": kinds,
                       "probing_steps": probing}
    log(f"  dist q2 chain: {kinds}; K1 launched {n} times for {probing} "
        f"probing steps on {DIST_SHARDS} shards")


def dist_trace(dist, planner, ss, out: dict) -> None:
    """(e) a torch.profiler trace of one steady q2 chain: the exchange's
    and all-gather's share of device time, K1's time per shard, and the
    card's idle share between the shards' launches."""
    from wukong_tpu_torch.obs import export
    from wukong_tpu_torch.sparql.parser import Parser

    q = Parser(ss).parse(QUERIES["lubm_q2"])
    planner.generate_plan(q)
    q.result.blind = True
    with tempfile.TemporaryDirectory() as d, AnnotatedCollectives():
        t0 = time.perf_counter()
        with export.device_trace(d):
            dist.execute(q, from_proxy=False)
        host_ms = (time.perf_counter() - t0) * 1e3
        split = chain_split(export.last_capture)
    check(split["k1_calls"] > 0 and split["ranges"] > 0,
          f"dist trace: no K1 kernel or no exchange range ({split})")
    probing = sum(s.kind in DIST_PROBING for s in dist._last_plan.steps)
    split.update(host_ms=host_ms, k1_us_per_shard_step=(
        split["k1_us"] / max(probing * DIST_SHARDS, 1)))
    out["trace"] = split
    dev = split["device_us"] or 1.0
    log(f"  dist q2 trace: {dev:,.1f} us on the card over a "
        f"{split['span_us']:,.1f} us span ({host_ms:,.1f} ms on the host): "
        f"exchange {split['exchange_us'] / dev:.1%}, all-gather "
        f"{split['allgather_us'] / dev:.1%}, K1 {split['k1_us'] / dev:.1%} "
        f"({split['k1_calls']} calls, {split['k1_us_per_shard_step']:.1f} "
        f"us a shard and step), other {split['other_us'] / dev:.1%}; idle "
        f"{(split['idle_share'] or 0.0):.1%} of the span")


def dist_wcoj(proxy, expected: dict, out: dict) -> None:
    """(f) q1 forced onto proxy.wcoj_dist() with device levels, on the
    pool's heavy lane: the walk's rows (phase 4's)."""
    q = proxy.parse(QUERIES["lubm_q1"])  # planned by the proxy's planner
    q.result.blind = False
    t0 = time.perf_counter()
    with Knobs(None, join_device="device"):
        proxy.wcoj_dist().try_execute(q)
    ms = (time.perf_counter() - t0) * 1e3
    check(q.result.status_code == 0 and np_equal(
        sorted_table(q), expected["lubm_q1"]),
        f"dist wcoj q1: {q.result.nrows:,} rows differ from phase 4's")
    out["wcoj"] = {"rows": q.result.nrows, "ms": ms,
                   "slices": (getattr(q, "join_dist", None) or {}).get(
                       "slices", 1)}
    log(f"  dist wcoj q1: {q.result.nrows:,} rows (as phase 4) in "
        f"{out['wcoj']['slices']} slices, {ms:,.1f} ms")


def dist_drill(proxy, port: int, out: dict) -> None:
    """(g) a persistent `dist.shard_fetch` shard_down on shard 1 (the
    collective route, so the chain fetches): the reply is well formed,
    flagged incomplete with shard:1 dropped; the monitor's breaker line
    and /healthz's shards probe show it; once the shard is back the
    reply is complete again."""
    from wukong_tpu_torch.runtime import faults

    with Knobs(None, enable_dist_inplace=False):
        faults.install(faults.FaultPlan(
            [faults.FaultSpec("dist.shard_fetch", "shard_down", shard=1)],
            seed=7))
        try:
            q = proxy.run_single_query(DIST_DRILL, device="dist")
            breaker = proxy.monitor.breaker_report()
            status, ms, _n, doc = scrape(port, "/healthz")
        finally:
            faults.clear()
        check(q.result.status_code == 0 and not q.result.complete
              and "shard:1" in q.result.dropped_patterns,
              f"dist drill: status {q.result.status_code!r}, complete "
              f"{q.result.complete}, dropped {q.result.dropped_patterns}")
        check(any(b.startswith("Breaker[dist.shard]") for b in breaker),
              f"dist drill: no breaker line {breaker}")
        check(status == 200 and doc["degraded"].get("shards", {}).get(
            "degraded") == [1], f"dist drill: /healthz {status} {doc}")
        proxy.dist.sstore.breaker.record_success(1)
        q2 = proxy.run_single_query(DIST_DRILL, device="dist")
    check(q2.result.complete and q2.result.nrows >= q.result.nrows,
          "dist drill: the reply after the shard came back is incomplete")
    out["drill"] = {"partial_rows": q.result.nrows,
                    "rows": q2.result.nrows,
                    "dropped": list(q.result.dropped_patterns),
                    "breaker": breaker, "healthz_ms": ms,
                    "healthz": doc["degraded"]}
    log(f"  dist drill: shard 1 down: {q.result.nrows} rows flagged "
        f"incomplete, dropped {q.result.dropped_patterns}; {breaker[0]}; "
        f"/healthz {doc['degraded']} in {ms:.1f} ms; back: "
        f"{q2.result.nrows} rows, complete")


def dist_hotspot(proxy, out: dict) -> None:
    """(h) Emulator.run_hotspot over the sharded store: the advisor's plan
    names the hot shard as donor, the store untouched."""
    from wukong_tpu_torch.runtime.emulator import Emulator

    t0 = time.perf_counter()
    rep = Emulator(proxy).run_hotspot(n_ops=DIST_HOTSPOT_OPS, seed=7)
    p = rep["plan"]
    check(p is not None and rep["plan_donor_is_hot"]
          and rep["ranked"][0] == rep["hot"] and rep["store_untouched"],
          f"dist hotspot: hot {rep['hot']}, ranked {rep['ranked']}, plan "
          f"{p}, untouched {rep['store_untouched']}")
    out["hotspot"] = {"hot": rep["hot"], "ranked": rep["ranked"],
                      "separation": rep["separation"], "plan": p,
                      "seconds": time.perf_counter() - t0}
    log(f"  dist hotspot: shard {rep['hot']} hot, ranked {rep['ranked']}, "
        f"plan donor {p['donor_shard']} -> host {p['recipient_host']}, "
        f"{p['predicted_move_bytes']:,} bytes ({p['bytes_source']}), "
        f"imbalance {p['imbalance_before']} -> {p['imbalance_after']}; "
        f"store untouched ({out['hotspot']['seconds']:.1f} s)")


def serve_dist(triples, attrs, ss, stats, expected: dict, results: dict,
               entry: dict, port: int, k1_launches, card: str) -> dict:
    """Phase 15: the JAX bench's --dist at full width, LUBM-<scale> over
    DIST_SHARDS shard slots on the card (parts (a)-(h)). Returns the world
    phase 16 runs on: the engine, its proxy, the planner, the strings."""
    from wukong_tpu_torch.parallel import DistEngine, make_mesh
    from wukong_tpu_torch.planner.optimizer import Planner
    from wukong_tpu_torch.runtime.proxy import Proxy
    from wukong_tpu_torch.store.gstore import build_all_partitions

    out = results["dist"] = {"shards": DIST_SHARDS, "card": card}
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    stores = build_all_partitions(triples, DIST_SHARDS, attr_triples=attrs)
    out["partition_s"] = time.perf_counter() - t0
    log(f"  {len(triples):,} triples into {DIST_SHARDS} partitions in "
        f"{out['partition_s']:.1f} s")
    planner = Planner(stats)
    dist = DistEngine(stores, ss, make_mesh(DIST_SHARDS))
    # the proxy serves -d dist only: its host partition is shard 0, and
    # every row check holds against the single-card phases' rows
    with Knobs(None, enable_tpu=False):
        proxy = Proxy(stores[0], ss, device="cuda", planner=planner,
                      dist_engine=dist)
    try:
        for part, fn in (("(a) L1-L7", lambda: dist_bench(
                              dist, planner, ss, expected, out)),
                         ("(b) routes", lambda: dist_routes(
                             dist, planner, ss, expected, out)),
                         ("(c) extended", lambda: dist_extended(
                             proxy, results, out)),
                         ("(d) q2 chain", lambda: dist_k1_chain(
                             dist, planner, ss, k1_launches, out)),
                         ("(e) trace", lambda: dist_trace(
                             dist, planner, ss, out)),
                         ("(f) wcoj", lambda: dist_wcoj(
                             proxy, expected, out)),
                         ("(g) drill", lambda: dist_drill(proxy, port, out)),
                         ("(h) hotspot", lambda: dist_hotspot(proxy, out))):
            entry["name"] = part
            if part == "(f) wcoj":
                proxy.engine_pool()  # the slices ride its heavy lane
            t0 = time.perf_counter()
            fn()
            out.setdefault("part_s", {})[part] = time.perf_counter() - t0
    finally:
        stop_pool(proxy)
    out["staged_bytes"] = dist.sstore.bytes_used
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 15 seconds by part {out['part_s']}; {out['seconds']:.1f} "
        f"s in all; {out['staged_bytes']:,} B staged; {card}")
    return {"dist": dist, "proxy": proxy, "planner": planner, "ss": ss}


def phase15(args, world: tuple, expected: dict, results: dict, entry: dict,
            port: int, errs: dict, mem_base: int, kernel_fns: dict,
            capture_all) -> list:
    """Phase 15 with its kernel captures (K1 by part, the level probe by
    call site and part), then phase 16 on the same world, and the drop
    check of both; returns their kernels-line rows."""
    import torch

    from wukong_tpu_torch.join import kernels as JK

    triples, attrs, ss, stats = world
    kind, card = results["kind"], results["card"]
    log(f"dist: LUBM-{args.scale} over {DIST_SHARDS} shard slots on {kind}: "
        f"L1-L7, both routes, -d dist, the q2 chain's K1 launches and "
        f"trace, WCOJ over the shards, the shard-down drill, the hot spot; "
        f"{card}")
    t0 = time.perf_counter()
    fns = dict(kernel_fns, level_probe=(JK.level_probe, JK.level_probe_plain,
                                        None))
    for fn, _plain, _b in fns.values():
        fn.launches = 0
    captures = capture_all(lambda a: ", " + entry["name"],
                           lambda a: ", " + entry["name"])
    lpc = lp_captures(entry)
    try:
        world15 = serve_dist(triples, attrs, ss, stats, expected, results,
                             entry, port,
                             lambda: captures["probe_kernel"].wrapped.launches,
                             card)
    finally:
        restore_all(list(captures.values()) + lpc)
    torch.cuda.synchronize()
    dl = {name: fn.launches for name, (fn, _p, _b) in fns.items()}
    log(f"dist: kernel launches {dl}; K1 by part "
        f"{captures['probe_kernel'].launches} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(dl["probe_kernel"] > 0, "probe_kernel never launched in phase 15")
    check(dl["level_probe"] > 0,
          "level_probe never launched by phase 15's distributed WCOJ")
    results["dist"]["launches"] = {n: dict(c.launches)
                                   for n, c in captures.items()}
    results["dist"]["level_probe_launches"] = dl["level_probe"]
    rows = captured_rows(captures, "15 distributed", kernel_fns, errs)
    rows += lp_rows(lpc, "15 distributed", errs)
    del captures, lpc, world, triples, attrs
    # ---- 16. live migration and shard healing, on phase 15's world -------
    rows += phase16(args, world15, expected, results, entry, port, errs,
                    kernel_fns, capture_all)
    del world15
    drop_check(mem_base, results, "phases 15-16's distributed engines")
    return rows


# ---------------------------------------------------------------------------
# phase 16: live shard migration and shard healing, on phase 15's world
# ---------------------------------------------------------------------------

MIGRATE_OPS = 600  # phase 15's hot spot (the JAX bench's 1,500 cut for time)
# the actuator's plans, run by hand until balanced: at 8 slots and a = 1.6
# one move with read rotation leaves 2.2-2.4x the mean load on a host
MIGRATE_ROUNDS = 3
DUAL_WRITE_EDGES = 64  # the load -d batch of (b), on the donor shard
HEAL_SHARD, HEAL_ROUNDS = 1, 3
HEADS = PREFIX + "SELECT ?X ?Y WHERE { ?X ub:headOf ?Y . }"
HEAD_OF = "<http://swat.cse.lehigh.edu/onto/univ-bench.owl#headOf>"


def rss_bytes() -> int:
    """This process's resident set, from /proc/self/status (0 where the
    file is absent)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def serve_l17(proxy, expected: dict, out: dict, tag: str) -> float:
    """L1-L7 through the proxy's `-d dist` route with their tables, each
    complete and equal to phase 4's single-card rows; returns the
    seconds (a round after a swap restages every shard's segments)."""
    t0 = time.perf_counter()
    for name, text in QUERIES.items():
        q = proxy.run_single_query(text, device="dist", blind=False)
        check(q.result.status_code == 0 and q.result.complete and np_equal(
            sorted_table(q), expected[name]),
            f"{tag}: dist {name}: {q.result.nrows:,} rows, status "
            f"{q.result.status_code!r}, complete {q.result.complete}; "
            f"phase 4 {expected[name].shape[0]:,}")
    sec = time.perf_counter() - t0
    out.setdefault("l17_s", {})[tag] = sec
    log(f"  {tag}: L1-L7 through -d dist, phase 4's rows ({sec:.1f} s, "
        f"{proxy.dist.sstore.bytes_used:,} B staged)")
    return sec


def dist_rows(dist, planner, ss, text: str, inplace: bool):
    """One reply of ``text`` on the distributed engine with its table, on
    the in-place (host) route or the collective chain (the card)."""
    from wukong_tpu_torch.sparql.parser import Parser

    with Knobs(None, enable_dist_inplace=inplace,
               dist_inplace_rows=1 << 20):
        q = Parser(ss).parse(text)
        planner.generate_plan(q)
        q.result.blind = False
        dist.execute(q)
    check(q.result.status_code == 0 and q.result.complete,
          f"dist {text!r}: status {q.result.status_code!r}")
    return q, (dist.last_chain_stats or {}).get("mode", "collective")


def k1_chain_after(dist, planner, ss, k1_launches, out: dict,
                   tag: str) -> None:
    """(e) one collective q2 chain on restaged segments: K1 launches on
    every shard for every probing step, at least D a step."""
    from wukong_tpu_torch.sparql.parser import Parser

    q = Parser(ss).parse(QUERIES["lubm_q2"])
    planner.generate_plan(q)
    q.result.blind = True
    before = k1_launches()
    t0 = time.perf_counter()
    dist.execute(q, from_proxy=False)
    ms = (time.perf_counter() - t0) * 1e3
    n = k1_launches() - before
    probing = sum(s.kind in DIST_PROBING for s in dist._last_plan.steps)
    check(n >= DIST_SHARDS * probing and probing > 0
          and q.result.nrows == out["q2_rows"],
          f"{tag}: q2 {q.result.nrows:,} rows (before the move "
          f"{out['q2_rows']:,}), {n} K1 launches for {probing} probing "
          f"steps of {DIST_SHARDS} shards")
    out.setdefault("k1", {})[tag] = {"launches": n, "probing_steps": probing,
                                     "ms": ms}
    log(f"  (e) {tag}: q2's chain launched K1 {n} times for {probing} "
        f"probing steps on {DIST_SHARDS} shards ({ms:,.1f} ms)")


def dual_write_batch(proxy, dist, donor: int, ss, out: dict) -> None:
    """(b) one `load -d` batch in the migration's dual-write window:
    DUAL_WRITE_EDGES seeded ``headOf`` edges from vertices the donor shard
    owns to Department0 (no L1-L7 shape reads headOf)."""
    import numpy as np

    from wukong_tpu_torch.runtime.emulator import _probe_read
    from wukong_tpu_torch.utils.mathutil import hash_mod

    cand = np.unique(np.asarray(_probe_read(dist.sstore.stores[donor]),
                                dtype=np.int64))
    cand = cand[hash_mod(cand, DIST_SHARDS) == donor]
    subj = np.random.default_rng(7).choice(cand, DUAL_WRITE_EDGES,
                                           replace=False)
    head = ss.str2id(HEAD_OF)
    tri = np.stack([subj, np.full_like(subj, head),
                    np.full_like(subj, ss.str2id(DEPT0))], 1)
    with tempfile.TemporaryDirectory() as d:
        write_ids(d, tri)
        t0 = time.perf_counter()
        n = proxy.dynamic_load_data(d, True)
        sec = time.perf_counter() - t0
    check(n == DUAL_WRITE_EDGES, f"(b): load -d added {n} edges, not "
          f"{DUAL_WRITE_EDGES}")
    out["dual_write"] = {"donor": donor, "edges": n, "load_s": sec,
                         "subjects": [int(v) for v in subj]}
    log(f"  (b) load -d in the dual-write window: {n} headOf edges from "
        f"shard {donor}'s vertices to Department0 ({sec:.2f} s)")


def dual_write_readback(dist, planner, ss, job, before: dict,
                        out: dict) -> None:
    """(b) after the cutover: the donor's batch reads back through the new
    primary. The index-origin headOf scan on the card (two restages: the
    rotation's two turns) and the const start on the host route (the
    in-place walk) each hold the batch's rows; the new primary's content
    equals the demoted donor copy's."""
    from wukong_tpu_torch.store.persist import gstore_digest

    sstore, donor = dist.sstore, job.plan.donor_shard
    k = DUAL_WRITE_EDGES
    want = {(s, ss.str2id(DEPT0)) for s in out["dual_write"]["subjects"]}
    turns = []
    for _turn in range(2):
        sstore.invalidate_stagings()
        q, mode = dist_rows(dist, planner, ss, HEADS, inplace=False)
        got = set(map(tuple, sorted_table(q).tolist()))
        check(q.result.nrows == before["heads"] + k and want <= got,
              f"(b): headOf scan {q.result.nrows:,} rows after the cutover "
              f"({mode}), {before['heads']:,} + {k} before")
        turns.append(q.result.nrows)
    host, hmode = dist_rows(dist, planner, ss, DIST_DRILL, inplace=True)
    card, cmode = dist_rows(dist, planner, ss, DIST_DRILL, inplace=False)
    check(hmode == "inplace" and cmode != "inplace"
          and host.result.nrows == card.result.nrows
          == before["drill"] + k and np_equal(sorted_table(host),
                                              sorted_table(card)),
          f"(b): headOf Department0 host route {host.result.nrows} rows "
          f"({hmode}), card {card.result.nrows} ({cmode}), "
          f"{before['drill']} + {k} before")
    rot = [g for _h, g in sstore.rotation.get(donor, ())]
    t0 = time.perf_counter()
    same = bool(rot) and gstore_digest(sstore.stores[donor]) == \
        gstore_digest(rot[-1])
    check(same, "(b): the new primary's digest differs from the donor "
          "copy's after the dual-written batch")
    out["dual_write"].update(heads_rows=turns, drill_rows=host.result.nrows,
                             digest_s=time.perf_counter() - t0)
    log(f"  (b) read back through shard {donor}'s new primary: headOf scan "
        f"{turns} rows on the card's two turns, headOf Department0 "
        f"{host.result.nrows} rows on the host route and the card; the "
        f"primary's digest equals the donor copy's")


def migrate_rebalance(w: dict, expected: dict, entry: dict, k1_launches,
                      out: dict) -> None:
    """(a) Emulator.run_rebalance over the 8 slots, rounds of the
    advisor's plan until balanced, L1-L7 after every phase; (b) the dual
    write of round 1; (e) K1 after round 1's cutover."""
    from wukong_tpu_torch.runtime.emulator import Emulator

    dist, proxy, planner, ss = w["dist"], w["proxy"], w["planner"], w["ss"]
    before = {"heads": dist_rows(dist, planner, ss, HEADS,
                                 inplace=False)[0].result.nrows,
              "drill": dist_rows(dist, planner, ss, DIST_DRILL,
                                 inplace=True)[0].result.nrows}
    q2, _m = dist_rows(dist, planner, ss, QUERIES["lubm_q2"], inplace=False)
    out["q2_rows"] = q2.result.nrows
    emu = Emulator(proxy)
    out["rounds"] = []
    for r in range(MIGRATE_ROUNDS):
        def hook(phase, job, r=r):
            entry["name"] = "(a) rebalance"
            if r == 0 and phase == "catchup":
                entry["name"] = "(b) dual write"
                dual_write_batch(proxy, dist, job.plan.donor_shard, ss, out)
            serve_l17(proxy, expected, out, f"(a) round {r + 1}, after {phase}")
            if r == 0 and phase == "cutover":
                entry["name"] = "(b) dual write"
                dual_write_readback(dist, planner, ss, job, before, out)
                entry["name"] = "(e) after cutover"
                k1_chain_after(dist, planner, ss, k1_launches, out,
                               "after cutover")
            entry["name"] = "(a) rebalance"

        t0 = time.perf_counter()
        rep = emu.run_rebalance(n_ops=MIGRATE_OPS, zipf_a=1.6, seed=7,
                                phase_hook=hook)
        job = rep["job"]
        row = {"hot": rep["hot"], "donor": rep["plan"]["donor_shard"],
               "recipient": rep["plan"]["recipient_host"],
               "bytes_moved": job["bytes_moved"],
               "cutover_pause_us": job["cutover_pause_us"],
               "imbalance_before": rep["imbalance_before"],
               "imbalance_after": rep["imbalance_after"],
               "rebalanced": rep["rebalanced"],
               "decision_after": rep["decision_after"],
               "queries_identical": rep["queries_identical"],
               "placement": dict(dist.sstore.placement),
               "seconds": time.perf_counter() - t0}
        out["rounds"].append(row)
        log(f"  (a) round {r + 1}: shard {row['donor']} -> host "
            f"{row['recipient']}, {row['bytes_moved']:,} B moved, cutover "
            f"pause {row['cutover_pause_us']} us, imbalance "
            f"{row['imbalance_before']:.3f} -> {row['imbalance_after']:.3f} "
            f"({row['decision_after']}), probes identical "
            f"{row['queries_identical']} ({row['seconds']:.1f} s)")
        check(rep["executed"] and rep["queries_identical"]
              and rep["plan_donor_is_hot"] and job["phase"] == "done",
              f"(a) round {r + 1}: {row}, probes {rep['probes']}")
        if rep["rebalanced"]:
            break
    check(rep["rebalanced"] and rep["decision_after"] == "balanced",
          f"(a): not balanced after {len(out['rounds'])} moves: "
          f"{out['rounds']}")


def migrate_abort(w: dict, expected: dict, out: dict) -> None:
    """(c) a second shard's plan aborted (the operator's `migrate -abort`)
    after its cutover is published: the donor serves again, L1-L7 with
    phase 4's rows on both sides of the swap back."""
    from wukong_tpu_torch.obs.events import get_journal
    from wukong_tpu_torch.obs.placement import MigrationPlan
    from wukong_tpu_torch.runtime.migration import get_migrator
    from wukong_tpu_torch.utils.errors import WukongError

    dist, proxy = w["dist"], w["proxy"]
    sstore = dist.sstore
    donor = (out["rounds"][-1]["hot"] + 1) % DIST_SHARDS
    recipient = (donor + DIST_SHARDS // 2) % DIST_SHARDS
    donor_store, host0 = sstore.stores[donor], sstore.host_of(donor)
    plan = MigrationPlan(
        plan_id="mp-smoke-abort", t_us=0, donor_shard=donor,
        recipient_host=recipient,
        predicted_move_bytes=int(donor_store.memory_bytes()),
        bytes_source="estimate", donor_rate_per_s=0.0, mean_rate_per_s=0.0,
        imbalance_before=0.0, imbalance_after=0.0, window_s=0.0, inputs={},
        reason="the smoke's aborted cutover")
    mig = get_migrator()
    mig.attach(sstore=sstore, owner=proxy)
    seen = {}

    def hook(phase, job):
        if phase == "cutover":
            seen["published"] = sstore.stores[donor] is job.recipient
            serve_l17(proxy, expected, out, "(c) after the cutover")
            seen["aborted"] = mig.abort(cause="operator") is not None

    try:
        mig.run_plan(plan, phase_hook=hook)
        raised = None
    except WukongError as e:
        raised = str(e)
    evs = get_journal().last(kind="shard.migrate.abort", shard=donor)
    check(raised is not None and "aborted" in raised
          and seen == {"published": True, "aborted": True}
          and sstore.stores[donor] is donor_store
          and sstore.host_of(donor) == host0 and bool(evs)
          and evs[-1].attrs.get("swapped_back") is True,
          f"(c): raised {raised!r}, {seen}, donor back "
          f"{sstore.stores[donor] is donor_store}, host "
          f"{sstore.host_of(donor)}, events {evs[-1:]}")
    serve_l17(proxy, expected, out, "(c) after the abort")
    out["abort"] = {"donor": donor, "recipient": recipient,
                    "at_phase": evs[-1].attrs.get("at_phase")}
    log(f"  (c) shard {donor} -> host {recipient} aborted after its cutover: "
        f"the donor serves again, swapped back")


def heal_drill(w: dict, expected: dict, entry: dict, port: int,
               k1_launches, out: dict) -> None:
    """(d) the kill-and-heal drill: a DistEngine over the same partitions
    with replication 2 behind a Proxy (its heal watcher and engine pool
    on), Emulator.run_drill on shard HEAL_SHARD over L1-L7; (e) K1 after
    the heal."""
    from wukong_tpu_torch.parallel import DistEngine, make_mesh
    from wukong_tpu_torch.runtime import recovery
    from wukong_tpu_torch.runtime.emulator import Emulator
    from wukong_tpu_torch.runtime.proxy import Proxy

    dist, planner, ss = w["dist"], w["planner"], w["ss"]
    dist.sstore.invalidate_stagings()  # phase 15's engine serves no more
    stores = list(dist.sstore.stores)
    rss0 = rss_bytes()
    t0 = time.perf_counter()
    with Knobs(None, replication_factor=2, enable_tpu=False):
        dist2 = DistEngine(stores, ss, make_mesh(DIST_SHARDS))
        proxy2 = Proxy(stores[0], ss, device="cuda", planner=planner,
                       dist_engine=dist2)
    rss1 = rss_bytes()
    out["replicas"] = {"rss_before": rss0, "rss_after": rss1,
                       "build_s": time.perf_counter() - t0}
    log(f"  (d) replication 2: {DIST_SHARDS} replica copies (structural "
        f"clones: the CSR arrays are shared) in "
        f"{out['replicas']['build_s']:.1f} s; host RSS {rss0 / 2**30:.2f} -> "
        f"{rss1 / 2**30:.2f} GiB")
    lane = []
    orig_run = recovery.RebuildJob.run

    def counted(job, engine):
        lane.append(job.label)
        return orig_run(job, engine)

    recovery.RebuildJob.run = counted
    try:
        check(bool(proxy2.recovery()._threads),
              "(d): the proxy with replicas started no heal watcher")
        proxy2.engine_pool()  # the rebuild lane
        entry["name"] = "(d) drill"
        t0 = time.perf_counter()
        rep = Emulator(proxy2).run_drill(
            shard=HEAL_SHARD, texts=list(QUERIES.values()),
            rounds=HEAL_ROUNDS)
        drill_s = time.perf_counter() - t0
        deadline = time.monotonic() + 5
        while f"shard-{HEAL_SHARD}" not in lane \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        status, ms, _n, doc = scrape(port, "/healthz")
        sst = dist2.sstore
        out["drill"] = {"report": rep, "seconds": drill_s,
                        "rebuild_lane_jobs": len(lane),
                        "breaker": sst.breaker.state(HEAL_SHARD),
                        "healthz": doc["degraded"] if doc else None}
        check(rep["outage"]["complete"] and rep["outage"]["nrows_match"]
              and rep["outage"]["failovers"] > 0 and rep["healthy"]
              and rep["recovered"] == {"complete": True,
                                       "nrows_match": True},
              f"(d): drill report {rep}")
        check(f"shard-{HEAL_SHARD}" in lane,
              f"(d): no rebuild of shard {HEAL_SHARD} on the rebuild lane "
              f"({lane})")
        check(sst.breaker.state(HEAL_SHARD) == "closed"
              and HEAL_SHARD not in sst.failover_shards,
              f"(d): breaker {sst.breaker.state(HEAL_SHARD)}, failover "
              f"{sorted(sst.failover_shards)}")
        check(status == 200 and "shards" not in doc["degraded"],
              f"(d): /healthz {status} {doc}")
        log(f"  (d) drill on shard {HEAL_SHARD}: outage "
            f"{rep['outage']['rounds']} rounds complete, "
            f"{rep['outage']['failovers']} failovers; {len(lane)} rebuilds "
            f"on the rebuild lane; healed, breaker closed, /healthz "
            f"{doc['degraded']}; verify round as the baseline "
            f"{rep['baseline']['nrows']} ({drill_s:.1f} s)")
        serve_l17(proxy2, expected, out, "(d) after the heal")
        entry["name"] = "(e) after heal"
        k1_chain_after(dist2, planner, ss, k1_launches, out, "after heal")
    finally:
        recovery.RebuildJob.run = orig_run
        proxy2.recovery().stop()
        stop_pool(proxy2)


def serve_migrate_heal(w: dict, expected: dict, results: dict, entry: dict,
                       port: int, k1_launches, card: str) -> None:
    """Phase 16 (parts (a)-(e)) on phase 15's world, migration armed."""
    from wukong_tpu_torch.runtime.migration import get_migrator

    out = results["migrate"] = {"card": card}
    t_phase = time.perf_counter()
    try:
        with Knobs(None, migration_enable=True):
            for part, fn in (("(a) rebalance", lambda: migrate_rebalance(
                                 w, expected, entry, k1_launches, out)),
                             ("(c) abort", lambda: migrate_abort(
                                 w, expected, out)),
                             ("(d) drill", lambda: heal_drill(
                                 w, expected, entry, port, k1_launches,
                                 out))):
                entry["name"] = part
                t0 = time.perf_counter()
                fn()
                out.setdefault("part_s", {})[part] = time.perf_counter() - t0
    finally:
        get_migrator().reset()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 16 seconds by part {out['part_s']}; {out['seconds']:.1f} "
        f"s in all; {card}")


def phase16(args, world15: dict, expected: dict, results: dict, entry: dict,
            port: int, errs: dict, kernel_fns: dict, capture_all) -> list:
    """Phase 16 with its kernel captures (K1 by part); returns its
    kernels-line rows."""
    import torch

    kind, card = results["kind"], results["card"]
    log(f"migrate and heal: LUBM-{args.scale} over {DIST_SHARDS} shard slots "
        f"on {kind} (phase 15's world): the rebalance through the migration "
        f"actuator with L1-L7 after every phase, a load -d batch in the "
        f"dual-write window, an aborted cutover, the kill-and-heal drill "
        f"with replication 2; {card}")
    t0 = time.perf_counter()
    for fn, _plain, _b in kernel_fns.values():
        fn.launches = 0
    captures = capture_all(lambda a: ", " + entry["name"],
                           lambda a: ", " + entry["name"])
    try:
        serve_migrate_heal(world15, expected, results, entry, port,
                           lambda: captures["probe_kernel"].wrapped.launches,
                           card)
    finally:
        restore_all(captures.values())
    torch.cuda.synchronize()
    ml = {name: fn.launches for name, (fn, _p, _b) in kernel_fns.items()}
    k1 = captures["probe_kernel"].launches
    log(f"migrate and heal: kernel launches {ml}; K1 by part {k1} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(sum(k1.values()) == ml["probe_kernel"] > 0,
          "K1 never launched in phase 16, or its launches by part do not "
          "add up to its count")
    for tag in ("(e) after cutover", "(e) after heal"):
        check(k1.get(", " + tag, 0) > 0, f"K1 never launched {tag}")
    results["migrate"]["launches"] = {n: dict(c.launches)
                                      for n, c in captures.items()}
    rows = captured_rows(captures, "16 migrate and heal", kernel_fns, errs)
    del captures
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=640,
                    help="LUBM universities for the serve phase")
    ap.add_argument("--cross-scale", type=int, default=40,
                    help="LUBM universities for the CPU/GPU cross-check")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the measurements to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from wukong_tpu_torch.engine import cuda_lib
    from wukong_tpu_torch.engine import tpu_kernels as K
    from wukong_tpu_torch.engine import tpu_stream as S
    from wukong_tpu_torch.runtime.proxy import Proxy

    t_start = time.perf_counter()
    # ---- 1. device ------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    log(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}"
        f"); nvidia-smi: {card}")
    build_s = cuda_lib.build_all()
    outcome = cuda_lib.last_build_outcome
    boot = compile_cache_boot(outcome)
    log(f"build: {len(cuda_lib.SOURCES)} CUDA sources with nvcc in "
        f"{build_s:.1f} s; the build cache's outcome: {outcome} (the device "
        f"observatory's boot counter for it: {boot:g})")
    check(boot >= 1, f"the build cache's outcome {outcome} is not on the "
          "device observatory's boot counter")
    results = {"card": card, "kind": kind, "build_s": build_s,
               "build_cache": {"outcome": outcome, "boot_count": boot},
               "scale": args.scale, "seed": args.seed, "queries": {},
               "batches": {}, "extended": {}, "batched": {}}

    # ---- 2. kernels on adversarial cases ---------------------------------
    errs = {name: 0 for name in KERNELS}
    t0 = time.perf_counter()
    kernel_cases(errs)
    torch.cuda.synchronize()
    log(f"kernels: adversarial cases agree with the plain versions "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    n = probe_stress_cases(errs)
    torch.cuda.synchronize()
    log(f"kernels: {n} K1 probe stress cases, 10 runs each, identical and "
        f"equal to the plain version ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    n = emit_stress_cases(errs)
    torch.cuda.synchronize()
    log(f"kernels: {n} K2/K3 look-back stress cases, 10 runs each, identical "
        f"and equal to the plain versions ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    n = level_probe_checks(errs)
    torch.cuda.synchronize()
    log(f"kernels: {n} level_probe cases equal to the plain version bit for "
        f"bit ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    n = knn_cases(errs)
    torch.cuda.synchronize()
    log(f"kernels: {n} knn_scan cases agree with the plain version (ties bit "
        f"for bit; largest score difference {errs['knn_scan']:.2e}) "
        f"({time.perf_counter() - t0:.1f} s)")

    # what raw memory_allocated holds before phase 3: phase 13's drop of the
    # LUBM-640 proxy must fall back to it
    from wukong_tpu_torch import native

    gc.collect()
    mem_base = torch.cuda.memory_allocated()
    native.reset_counts()

    # ---- 3. store -------------------------------------------------------
    g, ss, triples, attrs = build_world(args.scale, args.seed, results,
                                        with_attrs=True)
    ntriples = len(triples)
    proxy = Proxy(g, ss, device="cuda", budget_bytes=60 << 30)
    t0 = time.perf_counter()
    resident = stage_all(proxy)
    results["setup_s"]["stage"] = time.perf_counter() - t0
    log(f"store: staged {resident:,} bytes on the card "
        f"({results['setup_s']['stage']:.1f} s)")
    results.update(triples=ntriples, resident_bytes=resident)
    check_native("phase 3's partition build and staging",
                 ("sort_triples_perm", "build_bucket_table_native"), results)

    # ---- 4. serve (the main path) ----------------------------------------
    def capture_all(probe_class=lambda a: "", emit_class=lambda a: ""):
        # expand_rows: one class a phase (a row each), its largest output
        return {"probe_kernel": Capture(K, "probe_kernel", probe_size,
                                        probe_class),
                "expand_rows": Capture(K, "expand_rows",
                                       lambda a: (a[0].shape[0] + 1) * a[4]),
                "stream_emit": Capture(S, "stream_emit",
                                       lambda a: a[0].shape[0], emit_class),
                "stream_emit_m": Capture(S, "stream_emit_m",
                                         lambda a: a[0].shape[0],
                                         emit_class)}

    captures = capture_all()
    kernel_fns = {"probe_kernel": (captures["probe_kernel"].orig, K.probe_plain,
                                   probe_work),
                  "expand_rows": (captures["expand_rows"].orig,
                                  K.expand_rows_plain, expand_rows_work),
                  "stream_emit": (captures["stream_emit"].orig,
                                  S.stream_emit_plain, emit_work),
                  "stream_emit_m": (captures["stream_emit_m"].orig,
                                    S.stream_emit_m_plain,
                                    lambda a: emit_work(a, mhot=True))}
    for fn, _plain, _b in kernel_fns.values():
        fn.launches = 0
    log(f"serve: LUBM-{args.scale} on {kind}")
    try:
        phase4 = serve(proxy, HEAVY, S.stream_mdup(), results)
    finally:
        restore_all(captures.values())
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, (fn, _p, _b) in kernel_fns.items()}
    log(f"serve: kernel launches on the main path {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on the main path")
    rows = captured_rows(captures, "4 basic suite", kernel_fns, errs)

    # ---- 5. extended suite (the main path's second part) ------------------
    from wukong_tpu_torch.types import OUT

    for fn, _plain, _b in kernel_fns.values():
        fn.launches = 0
    log(f"extended: LUBM-{args.scale} on {kind}")
    captures = capture_all(probe_class_of(proxy))
    try:
        serve_extended(proxy, results)
    finally:
        restore_all(captures.values())
    torch.cuda.synchronize()
    ext = {name: fn.launches for name, (fn, _p, _b) in kernel_fns.items()}
    log(f"extended: kernel launches {ext}, K1 by class "
        f"{captures['probe_kernel'].launches}")
    check(captures["probe_kernel"].launches.get(", combined segment", 0) > 0,
          "probe_kernel never probed the combined segment in the extended "
          "suite")
    rows += captured_rows(captures, "5 extended suite", kernel_fns, errs)
    check(sum(r["launches"] for r in rows if r["name"] == "probe_kernel")
          == launches["probe_kernel"] + ext["probe_kernel"],
          "K1's launches by class do not add up to its count")
    vseg = proxy.gpu.dstore._cache.get(("vpv", int(OUT)))
    check(vseg is not None and vseg.edges2 is not None
          and vseg.bline.device.type == "cuda",
          "the OUT combined segment is not resident on the card")
    log(f"extended: OUT combined segment resident, {vseg.num_keys:,} keys, "
        f"{vseg.num_edges:,} edges, {vseg.nbytes:,} bytes")
    first = results["extended"]["x_vers_kuu"]["runs_ms"][0]
    results["setup_s"]["combined_out_first_query_ms"] = first
    log(f"extended: x_vers_kuu's first run, which stages the OUT combined "
        f"segment, {first:,.1f} ms (host CPU "
        f"{results['setup_s']['host_cpu']})")
    check_native("phases 4-5's stagings, the OUT combined segment's among "
                 "them", ("build_bucket_table_native",), results)
    results["extended_launches"] = ext

    # ---- 7. batched serving under the planner (the main path's third part)
    for fn, _plain, _b in kernel_fns.values():
        fn.launches = 0
    log(f"batched: LUBM-{args.scale} on {kind}, planner and batches")
    entry = {"name": ""}
    captures = capture_all(lambda a: entry["name"], lambda a: entry["name"])
    replay: list = []
    try:
        with walk_pinned("7"):
            serve_batched(proxy, triples, phase4, args.seed, entry, results,
                          replay)
    finally:
        restore_all(captures.values())
    torch.cuda.synchronize()
    bat = {name: fn.launches for name, (fn, _p, _b) in kernel_fns.items()}
    by_entry = {name: dict(c.launches) for name, c in captures.items()}
    log(f"batched: kernel launches {bat}; by entry point {by_entry}")
    check(captures["probe_kernel"].launches.get(
        "execute_batch_index (slice)", 0) > 0,
        "probe_kernel was never launched by the slice-mode batches")
    results["batched"]["launches"] = by_entry
    rows += merged_rows(captures, "7 batched serving", kernel_fns, errs)
    with StreamAudit() as audit, walk_pinned("7, replayed"):
        call_all(replay)  # after the counts: not main-path work
    replay.clear()  # the calls hold the proxy
    results["batched"]["stream_arms"] = audit.report(
        "phase 7, each entry point once on each input")

    # ---- 8. the serving runtime on phase 3's proxy -----------------------
    log(f"runtime: LUBM-{args.scale} on {kind}, capacity fallback and "
        f"sparql-emu")
    results["runtime"] = {}
    serve_fallback(proxy, phase4, results)
    with tempfile.TemporaryDirectory() as root, walk_pinned("8"):
        mixes = {mix: write_mix(root, mix, heavy)
                 for mix, heavy in (("light", False), ("mixed", True))}
        for fn, _plain, _b in kernel_fns.values():
            fn.launches = 0
        captures = capture_all(lambda a: entry["name"],
                               lambda a: entry["name"])
        try:
            serve_emu(proxy, mixes, entry, results)
        finally:
            restore_all(captures.values())
        torch.cuda.synchronize()
        emu = {name: dict(c.launches) for name, c in captures.items()}
        log(f"runtime: sparql-emu kernel launches by mix {emu}")
        check(sum(captures["probe_kernel"].launches.values()) > 0,
              "probe_kernel was never launched by sparql-emu")
        results["runtime"]["emu_launches"] = emu
        rows += captured_rows(captures, "8 sparql-emu, ", kernel_fns, errs)
        with StreamAudit() as audit:
            audit_emu(proxy, mixes)
        results["runtime"]["stream_arms"] = audit.report(
            "phase 8 sparql-emu, both mixes")

    # ---- 9. live serving with coalescing, on phase 3's proxy -------------
    log(f"live: LUBM-{args.scale} on {kind}, Proxy.serve_query from "
        f"concurrent clients, batching off and on")
    live = live_prepare(proxy, results)
    # the HTTP plane and the metrics ring at 1 s, scraped through the run
    port = start_http_plane()
    results["http"] = {"port": port}
    log(f"live: the HTTP plane on 127.0.0.1:{port}, the metrics ring every "
        f"{TSDB_INTERVAL_S} s, a scraper over {len(ENDPOINTS)} endpoints "
        f"every {SCRAPE_PAUSE_S} s")
    for fn, _plain, _b in kernel_fns.values():
        fn.launches = 0
    classes = LiveClasses()
    captures = capture_all(classes.of, classes.of)
    try:
        with classes, walk_pinned("9"), Scraper(port) as scraper:
            serve_live(proxy, live,
                       lambda: captures["probe_kernel"].wrapped.launches,
                       results)
    finally:
        restore_all(captures.values())
    results["http"]["phase9"] = scraper.report("phase 9, live serving")
    # down before phase 10, whose overload drill rides the host's pace
    stop_http_plane()
    torch.cuda.synchronize()
    by_class = {name: dict(c.launches) for name, c in captures.items()}
    log(f"live: kernel launches by class {by_class}")
    check(sum(captures["probe_kernel"].launches.values())
          == kernel_fns["probe_kernel"][0].launches,
          "K1's launches by class do not add up to its count")
    check(sum(captures["expand_rows"].launches.values()) > 0,
          "expand_rows never launched in phase 9")
    for name in ("stream_emit", "stream_emit_m"):
        if not sum(captures[name].launches.values()):
            log(f"live: {name} not launched in phase 9 (its chains probe; "
                f"phases 2 and 4-8 hold it)")
    results["live"]["launches"] = by_class
    rows += captured_rows(captures, "9 live serving", kernel_fns, errs)

    # ---- 10. multi-tenant serving, on phase 3's proxy --------------------
    log(f"tenants: LUBM-{args.scale} on {kind}, admission, SLOs, tracing "
        f"and EXPLAIN ANALYZE through Emulator.run_tenants")
    t0 = time.perf_counter()
    for fn, _plain, _b in kernel_fns.values():
        fn.launches = 0
    captures = capture_all(lambda a: entry["name"], lambda a: entry["name"])
    try:
        with walk_pinned("10"):
            serve_tenants(proxy, live,
                          lambda: captures["probe_kernel"].wrapped.launches,
                          entry, results)
    finally:
        restore_all(captures.values())
    torch.cuda.synchronize()
    by_run = {name: dict(c.launches) for name, c in captures.items()}
    log(f"tenants: kernel launches by part {by_run} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(sum(captures["probe_kernel"].launches.values())
          == kernel_fns["probe_kernel"][0].launches > 0,
          "K1 never launched in phase 10, or its launches by part do not "
          "add up to its count")
    check(sum(captures["expand_rows"].launches.values()) > 0,
          "expand_rows never launched in phase 10")
    for name in ("stream_emit", "stream_emit_m"):
        if not sum(captures[name].launches.values()):
            log(f"tenants: {name} not launched in phase 10 (its chains "
                f"probe; phases 2 and 4-8 hold it)")
    results["tenants"]["launches"] = by_run
    rows += merged_rows(captures, "10 multi-tenant serving", kernel_fns,
                        errs)

    # ---- 11. the planner's other two execution strategies ----------------
    from wukong_tpu_torch.join import kernels as JK

    log(f"strategies: LUBM-{args.scale} on {kind}, WCOJ and compiled "
        f"templates through Proxy.serve_query at default knobs")
    t0 = time.perf_counter()
    fb0 = fallback_counts()
    kernel_fns["level_probe"] = (JK.level_probe, JK.level_probe_plain, None)
    for fn, _plain, _b in kernel_fns.values():
        fn.launches = 0
    captures = capture_all(lambda a: entry["name"], lambda a: entry["name"])
    lpc = lp_captures(entry)
    try:
        serve_strategies(proxy, phase4, entry, results)
        serve_cyclic(entry, results)
    finally:
        restore_all(list(captures.values()) + lpc)
    torch.cuda.synchronize()
    strat = {name: fn.launches for name, (fn, _p, _b) in kernel_fns.items()}
    log(f"strategies: kernel launches {strat} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(strat["level_probe"] > 0,
          "level_probe was never launched by phase 11")
    check(sum(sum(c.launches.values()) for c in lpc) == strat["level_probe"],
          "level_probe's launches by class do not add up to its count")
    fb = {k: v - fb0[k] for k, v in fallback_counts().items()}
    log(f"strategies: fallback counters over phase 11 {fb}; totals "
        f"{fallback_counts()}")
    check(not any(fb.values()), f"phase 11 degraded a strategy: {fb}")
    log(f"strategies: resident bytes by kind "
        f"{results['strategies']['resident_bytes']}")
    results["strategies"]["launches"] = strat
    results["strategies"]["seconds"] = time.perf_counter() - t0
    del kernel_fns["level_probe"]
    rows += captured_rows(captures, "11 strategies, ", kernel_fns, errs)
    rows += lp_rows(lpc, "11 strategies", errs)
    del captures, lpc  # their kept inputs hold the proxy's stagings

    # ---- 13. the hybrid graph+vector plane, on phase 3's proxy -----------
    from wukong_tpu_torch.obs.heat import get_heat
    from wukong_tpu_torch.vector import knn as KN

    log(f"hybrid: LUBM-{args.scale} on {kind}, knn() through "
        f"Proxy.serve_query: the GraphRAG mix, the full-size scan, "
        f"pattern-then-rank, the drill, scraped, the metrics snapshot every "
        f"{SNAPSHOT_S} s; {card}")
    port = start_http_plane()
    results["http"]["port13"] = port
    get_heat().reset()  # the phase's vector scans are its only charges
    with tempfile.TemporaryDirectory() as snapdir:
        snap_path = os.path.join(snapdir, "metrics.json")
        with Knobs(None, metrics_snapshot_s=SNAPSHOT_S,
                   metrics_snapshot_path=snap_path), \
                ScanCount(KN) as own, Scraper(port) as scraper:
            rows += serve_hybrid(proxy, results, errs, args.seed)
        results["http"]["phase13"] = scraper.report(
            "phase 13, the hybrid plane")
        observatory_after_hybrid(port, own, snap_path,
                                 results["http"]["phase13"])
    del own, scraper
    idle_burst(port, results["http"].setdefault("idle", {}))
    analysis_gates(results.setdefault("gates", {}))

    # ---- 14. the serving caches and streams, on phase 3's proxy ----------
    log(f"caches and streams: LUBM-{args.scale} on {kind}, the read-mostly "
        f"drill (shadow, then the result cache and views), a burst of pure "
        f"hits, {STREAM_EPOCHS} stream epochs on the pool's stream lane; "
        f"{card}")
    t0 = time.perf_counter()
    for fn, _plain, _b in kernel_fns.values():
        fn.launches = 0
    captures = capture_all(lambda a: entry["name"], lambda a: entry["name"])
    try:
        serve_caches_streams(proxy, triples, entry, results, args.seed)
    finally:
        restore_all(captures.values())
    torch.cuda.synchronize()
    by_part = {name: dict(c.launches) for name, c in captures.items()}
    log(f"caches and streams: kernel launches by part {by_part} "
        f"({time.perf_counter() - t0:.1f} s)")
    k1 = captures["probe_kernel"].launches
    check(sum(k1.values()) == kernel_fns["probe_kernel"][0].launches,
          "K1's launches by part do not add up to its count")
    check(k1.get("(a) burst misses", 0) > 0,
          "K1 did not launch on the burst texts' misses")
    check(not any(c.launches.get("(a) hit burst", 0)
                  for c in captures.values()),
          "a kernel launched in the hit burst")
    results["caches_streams"]["launches"] = by_part
    rows += merged_rows(captures, "14 caches and streams", kernel_fns, errs)
    del captures

    # ---- the drop of phase 3's proxy --------------------------------------
    stats = proxy.planner.stats  # phase 7's, of the world as synthesized
    del proxy, g, vseg
    drop_check(mem_base, results)

    # ---- 15. the distributed engine, 8 shard slots on the card -----------
    rows += phase15(args, (triples, attrs, ss, stats), phase4, results,
                    entry, port, errs, mem_base, kernel_fns, capture_all)
    del triples, attrs, stats

    # ---- 6. cross-check (after phases 7 and 8, on phase 3's store) ------
    gx, ssx, tx = build_world(args.cross_scale, args.seed)
    on_cpu = Proxy(gx, ssx, device="cpu")
    on_gpu = Proxy(gx, ssx, device="cuda")
    cross_rows = {}
    for name, text in list(QUERIES.items()) + list(EXT_QUERIES.items()):
        a, b = on_cpu.serve_query(text), on_gpu.serve_query(text)
        check(a.result.status_code == b.result.status_code == 0,
              f"cross-check {name}: status")
        check(rows_multiset(a) == rows_multiset(b),
              f"cross-check {name}: cpu {a.result.nrows} rows vs cuda "
              f"{b.result.nrows} rows")
        if name in ORDERED:
            check(a.result.table.tolist() == b.result.table.tolist(),
                  f"cross-check {name}: row order differs")
        cross_rows[name] = rows_multiset(b)
        log(f"  cross-check LUBM-{args.cross_scale} {name}: "
            f"{a.result.nrows:,} rows equal on cpu and cuda")
    cross_check_batched(on_cpu, on_gpu, tx, args.seed)
    explain_parity(on_cpu, on_gpu, results)
    results["cross_scale"] = args.cross_scale
    del on_cpu, on_gpu, gx, tx

    # ---- 8. the console on a directory the port writes -------------------
    log(f"console: LUBM-{args.cross_scale} written by write_dataset, "
        f"console.main on {kind}")
    for fn, _plain, _b in kernel_fns.values():
        fn.launches = 0
    captures = capture_all()
    try:
        console_phase(args.cross_scale, args.seed, cross_rows, results, port)
    finally:
        restore_all(captures.values())
    torch.cuda.synchronize()
    check(kernel_fns["probe_kernel"][0].launches > 0,
          "probe_kernel was never launched by the console's queries")
    rows += captured_rows(captures, "8 console", kernel_fns, errs)

    # ---- 12. data in and durability --------------------------------------
    log(f"data in: WatDiv-{WATDIV_SCALE}, YAGO n_person {YAGO_PERSONS:,}, "
        f"DBpedia-shaped {GENERIC_ENTITIES:,} entities, online inserts, WAL, "
        f"checkpoint and recover on {kind}; {card}")
    t0 = time.perf_counter()
    fb0 = fallback_counts()
    kernel_fns["level_probe"] = (JK.level_probe, JK.level_probe_plain, None)
    for fn, _plain, _b in kernel_fns.values():
        fn.launches = 0
    captures = capture_all(lambda a: entry["name"], lambda a: entry["name"])
    lpc = lp_captures(entry)
    try:
        serve_data_in(entry, results, seed=args.seed)
    finally:
        restore_all(list(captures.values()) + lpc)
    torch.cuda.synchronize()
    data = {name: fn.launches for name, (fn, _p, _b) in kernel_fns.items()}
    fb = {k: v - fb0[k] for k, v in fallback_counts().items()}
    results["data_in"].update(launches=data, fallbacks=fb,
                              seconds=time.perf_counter() - t0)
    log(f"data in: kernel launches {data}; fallback counters over phase 12 "
        f"{fb} ({time.perf_counter() - t0:.1f} s); {card}")
    check(data["probe_kernel"] > 0, "probe_kernel never launched in phase 12")
    check(data["level_probe"] > 0, "level_probe never launched in phase 12")
    check(not any(fb.values()), f"phase 12 degraded a strategy: {fb}")
    for name in ("stream_emit", "stream_emit_m"):
        log(f"data in: {name} " + (f"launched {data[name]} times"
                                   if data[name] else "not launched")
            + " in phase 12")
    del kernel_fns["level_probe"]
    rows += merged_rows(captures, "12 data in", kernel_fns, errs)
    rows += lp_merged_row(lpc, "12 data in", errs)
    for row in rows:  # every check of a kernel: phase 2 and every phase row
        row["max_abs_err"] = errs[row["name"]]
    results["kernels"] = rows
    results["total_s"] = time.perf_counter() - t_start
    log(f"done in {results['total_s']:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
