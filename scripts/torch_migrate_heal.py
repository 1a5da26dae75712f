"""Run chip_smoke's phases 15 and 16 alone on the GPU: the distributed
engine over 8 shard slots, then live shard migration and shard healing on
the same world (the rebalance through the migration actuator with L1-L7
after every phase, a `load -d` batch in the dual-write window, an aborted
cutover, the kill-and-heal drill with replication 2, K1 after the cutover
and the heal), and the drop check of both.

    python3 scripts/torch_migrate_heal.py [--scale 640] [--seed 0]
        [--out PATH]

It builds the kernels, synthesizes LUBM-<scale> from the seed, serves the
seven basic shapes and phase 15's extended shapes once on a single-card
Proxy for the rows both phases hold theirs against, drops that proxy,
generates the planner's statistics and calls ``chip_smoke.phase15`` (which
runs phase 16 before its drop check). It prints phase 16's rows of the
kernels line last; ``--out`` also writes both phases' records and every
kernel row as JSON. About 4.5 minutes at LUBM-640 on an H100. Needs a CUDA
GPU and nvcc.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=640)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_migrate_heal: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from wukong_tpu_torch.engine import cuda_lib
    from wukong_tpu_torch.engine import tpu_kernels as K
    from wukong_tpu_torch.engine import tpu_stream as S
    from wukong_tpu_torch.planner.stats import Stats
    from wukong_tpu_torch.runtime.proxy import Proxy

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    cs.log(f"device {kind}; {card}")
    cs.log(f"build {cuda_lib.build_all():.1f} s")
    results = {"card": card, "kind": kind, "extended": {}}
    g, ss, triples, attrs = cs.build_world(args.scale, args.seed, results,
                                           with_attrs=True)
    proxy = Proxy(g, ss, device="cuda", budget_bytes=60 << 30)
    expected = {}
    t0 = time.perf_counter()
    for name, text in cs.QUERIES.items():
        expected[name] = cs.sorted_table(
            proxy.run_single_query(text, blind=False))
    with cs.Knobs(None, enable_planner=False):
        for name in cs.DIST_EXT:
            q = proxy.run_single_query(cs.EXT_QUERIES[name], blind=False)
            results["extended"][name] = {"rows": q.result.nrows}
    cs.log(f"single-card rows {time.perf_counter() - t0:.1f} s")
    del proxy, g, q
    gc.collect()
    torch.cuda.synchronize()
    mem_base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    stats = Stats.generate(triples)
    cs.log(f"statistics {time.perf_counter() - t0:.1f} s")
    port = cs.start_http_plane()

    def capture_all(probe_class=lambda a: "", emit_class=lambda a: ""):
        return {"probe_kernel": cs.Capture(K, "probe_kernel", cs.probe_size,
                                           probe_class),
                "stream_emit": cs.Capture(S, "stream_emit",
                                          lambda a: a[0].shape[0],
                                          emit_class),
                "stream_emit_m": cs.Capture(S, "stream_emit_m",
                                            lambda a: a[0].shape[0],
                                            emit_class)}

    kernel_fns = {"probe_kernel": (K.probe_kernel, K.probe_plain,
                                   cs.probe_work),
                  "stream_emit": (S.stream_emit, S.stream_emit_plain,
                                  cs.emit_work),
                  "stream_emit_m": (S.stream_emit_m, S.stream_emit_m_plain,
                                    lambda a: cs.emit_work(a, mhot=True))}
    errs = {name: 0 for name in cs.KERNELS}
    t0 = time.perf_counter()
    rows = cs.phase15(args, (triples, attrs, ss, stats), expected, results,
                      {"name": ""}, port, errs, mem_base, kernel_fns,
                      capture_all)
    cs.stop_http_plane()
    cs.log(f"phases 15-16 {time.perf_counter() - t0:.1f} s; total "
           f"{time.perf_counter() - t_start:.1f} s; {card}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"results": {k: results[k] for k in ("dist",
                                                           "migrate")},
                       "kernels": rows}, f, indent=1, default=str)
    print(json.dumps({"kernels": [r for r in rows
                                  if r["phase"].startswith("16")]},
                     default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
