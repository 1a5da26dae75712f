"""Time the heavy replicate batches under choices of the stream arm and
of the scatter dump, on the GPU, in turns, in one process: ``t``, this
build (a loose multiplicity bound runs K3 and the gather arm and the device
picks, unless the lower bound, B in a replicate batch, is past mdup;
dropped scatter writes spread over tpu_kernels.DUMP slots); ``d``, the
same without the lower bound; ``e``, the earlier host-only choice (a loose
bound takes the gather arm alone); ``1``, this build with every dropped
write on one slot, as before the spread.

    python3 scripts/torch_arm_ab.py [--scale 640] [--seed 0] [--runs 5]
        [--order t1et1e] [--out PATH]

It synthesizes LUBM-<scale> from the seed (triples only), stages the
basic suite's segments (chip_smoke.stage_all), and serves q1 and q2 (the
heavy shapes with streamed steps) through GPUEngine.execute_batch_index:
under the heuristic plan at B = 1 and 4, as chip_smoke's phase 4 does, and
under the type-centric planner over Stats.generate at
suggest_index_batch's B and through execute_batch_index_many (K = 2), as
its phase 7 does (the engine sizes every batch from those statistics). Each turn of ``--order`` makes ``--runs`` calls
of each after one untimed call: host clock around the call and a
synchronize, and CUDA events around every stream_expand call (device ms a
batch spent in the streamed steps, K3 and gather both counted). It prints each turn's
medians and each choice's pooled min / median / max, and fails if the
choices' counts differ. Needs a CUDA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=640)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--order", default="t1et1e")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as smoke
    from wukong_tpu_torch.engine import cuda_lib
    from wukong_tpu_torch.engine import tpu_kernels as K
    from wukong_tpu_torch.engine import tpu_stream as S
    from wukong_tpu_torch.loader.lubm import VirtualLubmStrings, generate_lubm
    from wukong_tpu_torch.planner.optimizer import Planner
    from wukong_tpu_torch.planner.stats import Stats
    from wukong_tpu_torch.runtime.proxy import Proxy
    from wukong_tpu_torch.store.gstore import build_partition

    if not torch.cuda.is_available():
        print("torch_arm_ab: no CUDA GPU available", file=sys.stderr)
        return 1
    cuda_lib.build_all()
    triples, _ = generate_lubm(args.scale, seed=args.seed)
    proxy = Proxy(build_partition(triples, 0, 1),
                  VirtualLubmStrings(args.scale, seed=args.seed),
                  device="cuda", budget_bytes=60 << 30)
    smoke.stage_all(proxy)
    heuristic = {n: proxy.parse(smoke.QUERIES[n]) for n in ("lubm_q1",
                                                            "lubm_q2")}
    stats = Stats.generate(triples)
    proxy.planner, proxy.gpu.stats = Planner(stats), stats
    eng = proxy.gpu
    now = S.stream_expand
    mdup = S.stream_mdup()

    def earlier(skey, sstart, sdeg, edges, cur, n, live, cap_out, mult,
                mhot=True, mdup=mdup, mult_lo=1):
        # the earlier choice: a bound past mdup, or none, takes the gather
        return now(skey, sstart, sdeg, edges, cur, n, live, cap_out, mult,
                   mhot=mhot and mult is not None and mult <= mdup,
                   mdup=mdup)

    def device(skey, sstart, sdeg, edges, cur, n, live, cap_out, mult,
               mhot=True, mdup=mdup, mult_lo=1):
        # no lower bound: every loose bound leaves the choice to the device
        return now(skey, sstart, sdeg, edges, cur, n, live, cap_out, mult,
                   mhot=mhot, mdup=mdup)

    events: list = []

    def timed(fn):
        def call(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **kw)
            e.record()
            events.append((s, e))
            return out
        return call

    spill = K._spill

    def one_slot(n, size, like):
        return size

    # arm -> (stream_expand, dump-slot rule)
    arms = {"t": (timed(now), spill), "d": (timed(device), spill),
            "e": (timed(earlier), spill), "1": (timed(now), one_slot)}
    jobs = {}
    for name, q in heuristic.items():
        for B in (1, 4):
            jobs[f"{name} heuristic B={B}"] = (
                lambda q=q, B=B: [eng.execute_batch_index(q, B)])
    for name in ("lubm_q1", "lubm_q2"):
        q = proxy.parse(smoke.QUERIES[name])
        B = eng.suggest_index_batch(q)
        jobs[f"{name} replicate B={B}"] = (
            lambda q=q, B=B: [eng.execute_batch_index(q, B)])
        jobs[f"{name} window B={B} K=2"] = (
            lambda q=q, B=B: eng.execute_batch_index_many(q, B, 2))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    res: dict = {"card": smi, "scale": args.scale, "order": args.order,
                 "turns": []}
    counts: dict = {}
    for turn in args.order:
        S.stream_expand, K._spill = arms[turn]
        S._spill = K._spill
        try:
            got = {}
            for job, fn in jobs.items():
                want = [c.tolist() for c in fn()]  # untimed: learns caps
                counts.setdefault(job, want)
                smoke.check(want == counts[job],
                            f"{job}: counts differ between the choices")
                ms, dev = [], []
                for _ in range(args.runs):
                    events.clear()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    dev.append(sum(s.elapsed_time(e) for s, e in events))
                got[job] = {"ms": ms, "stream_ms": dev,
                            "steps": len(events)}
                smoke.log(f"turn {turn} {job}: median "
                          f"{statistics.median(ms):.2f} ms, streamed "
                          f"steps {statistics.median(dev):.3f} ms "
                          f"({len(events)} a call)")
            res["turns"].append({"arm": turn, "jobs": got})
        finally:
            S.stream_expand, K._spill, S._spill = now, spill, spill
    for job in jobs:
        for arm in sorted(set(args.order)):
            ms = [m for t in res["turns"] if t["arm"] == arm
                  for m in t["jobs"][job]["ms"]]
            dev = [m for t in res["turns"] if t["arm"] == arm
                   for m in t["jobs"][job]["stream_ms"]]
            smoke.log(f"{job} [{arm}]: {min(ms):.2f} / "
                      f"{statistics.median(ms):.2f} / {max(ms):.2f} ms; "
                      f"streamed steps {statistics.median(dev):.3f} ms")
    smoke.log(smi)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
