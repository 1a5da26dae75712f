"""Runtime knobs the port reads (a subset of the JAX package's ``Global``).

Only the fields this package consults live here; each keeps the JAX
package's name and default so a configuration means the same thing to both.
No knob routes a CUDA tensor to a plain PyTorch version: on the card every
kernel of the path is the hand-written one.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class _Global:
    # smallest / largest binding-table capacity class (rows); the largest
    # bounds every intermediate result of one device chain
    table_capacity_min: int = 1024
    table_capacity_max: int = 1 << 25
    # device segment-cache budget in GiB (LRU eviction above it); the name
    # is the JAX package's, the budget is the card's memory
    tpu_mem_cache_gb: int = 4
    # sort-merge executor for replicate index batches (else the eager
    # probe chain with a qid column)
    enable_merge_join: bool = True
    # stream-emit kernels for dense expansions inside the merge executor
    enable_stream_expand: bool = True
    # planner-proved-empty queries answer without device work
    enable_empty_shortcircuit: bool = True
    # stage every segment of a chain before its first step runs
    gpu_enable_pipeline: bool = True
    # the proxy plans with its cost-based planner when it has one (else a
    # user plan, else the greedy heuristic)
    enable_planner: bool = True
    # const-start instances answered together by one execute_batch
    device_batch: int = 1024
    # ceiling on the slice count suggest_index_batch may pick for a heavy
    # (index-origin) query
    heavy_batch_max: int = 64


Global = _Global()
