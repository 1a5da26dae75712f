"""Run the overload drill of ``bench.py --tenants`` on the GPU with a
rung-3 rejection that first yields the GIL for each of several times
(``proxy.REJECT_YIELD_S``; 0 raises at once, as the JAX proxy does) and
spaces each tenant's rejections by each of several times
(``proxy.REJECT_SPACING_S``; 0 holds every rejection for the yield alone),
in turns, in one process. A turn written ``Y/S`` also runs with the
interpreter's GIL switch interval at S us (``sys.setswitchinterval``; the
default is 5,000).

    python3 scripts/torch_tenants_ab.py [--scale 640] [--seed 0]
        [--yields-us 0,Y,Y,0] [--spacings-us P,P,P,P] [--duration 3]
        [--warmup 1] [--out PATH]

Y and P, the defaults, are this build's ``REJECT_YIELD_S`` and
``REJECT_SPACING_S``; ``--spacings-us`` gives one value for each turn of
``--yields-us``.

It synthesizes LUBM-<scale> from the seed, serves chip_smoke's light texts
(``?s ub:advisor <a>``, bench.py --serve-batched's) under the greedy
heuristic plan with the engine pool started and batching on, and runs
``Emulator.run_tenants`` with the default classes at ``overload_x`` = 2
(gold 4, silver 4 and bulk 8 clients, every client sending its next query
at once, a rejected one too) with admission armed at chip_smoke's quotas
and in-flight ceiling. Each turn of ``--yields-us`` prints every tenant's
rate, p50, p99, served, partial and rejected counts and compliance, and
whether gold held its SLO (latency met, error budget left >= 0, never
partial nor rejected). Needs a CUDA GPU and nvcc.
"""

from __future__ import annotations

import argparse
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
    ap.add_argument("--yields-us", default=None)
    ap.add_argument("--spacings-us", default=None)
    ap.add_argument("--duration", type=float, default=3.0)
    ap.add_argument("--warmup", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch_tenants_ab: no CUDA GPU available", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from wukong_tpu_torch.config import Global
    from wukong_tpu_torch.engine import cuda_lib
    from wukong_tpu_torch.runtime import proxy as proxy_mod
    from wukong_tpu_torch.runtime.admission import get_admission
    from wukong_tpu_torch.runtime.emulator import Emulator

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    cuda_lib.build_all()
    g, ss, _triples = smoke.build_world(args.scale, args.seed)
    proxy = proxy_mod.Proxy(g, ss, device="cuda", budget_bytes=60 << 30)
    light, _heavy = smoke.live_texts(proxy)
    build_s = proxy_mod.REJECT_YIELD_S
    build_p = proxy_mod.REJECT_SPACING_S
    ys = (args.yields_us.split(",") if args.yields_us
          else ["0", "Y", "Y", "0"])
    ps = (args.spacings_us.split(",") if args.spacings_us
          else ["P"] * len(ys))
    if len(ps) != len(ys):
        ap.error("--spacings-us needs one value for each turn")
    switch_s = sys.getswitchinterval()
    arms = []
    for y, p in zip(ys, ps):
        y, _, sw = y.partition("/")
        arms.append((build_s if y == "Y" else float(y) / 1e6,
                     build_p if p == "P" else float(p) / 1e6,
                     float(sw) / 1e6 if sw else switch_s))
    Global.silent = True
    Global.enable_batching = True
    Global.heavy_lane = True
    proxy.engine_pool()
    turns = []
    try:
        # untimed: stages the texts' segment and warms the batcher
        Emulator(proxy).run_tenants(light, duration_s=1.0, warmup_s=0.5)
        Global.enable_admission = True
        Global.admission_quotas = smoke.TENANT_QUOTAS
        Global.admission_max_inflight = smoke.TENANT_MAX_INFLIGHT
        for y, p, sw in arms:
            proxy_mod.REJECT_YIELD_S = y
            proxy_mod.REJECT_SPACING_S = p
            sys.setswitchinterval(sw)
            get_admission().reset()
            t0 = time.perf_counter()
            rep = Emulator(proxy).run_tenants(
                light, duration_s=args.duration, warmup_s=args.warmup,
                overload_x=2.0, seed=1)
            row = {"yield_s": y, "spacing_s": p, "switch_interval_s": sw,
                   "wall_s": round(time.perf_counter() - t0, 3),
                   "decisions": rep["admission"]["decisions"]}
            for t, r in rep["tenants"].items():
                slo = r["slo"] or {}
                row[t] = {k: r[k] for k in ("clients", "qps", "p50_us",
                                            "p99_us", "served", "errors",
                                            "partial", "rejected")}
                row[t].update({k: slo.get(k) for k in (
                    "compliance", "error_budget_remaining", "latency_met")})
            g_ = row["gold"]
            row["gold_held"] = bool(
                g_["latency_met"] is True
                and (g_["error_budget_remaining"] or 0.0) >= 0.0
                and g_["partial"] == 0 and g_["rejected"] == 0)
            turns.append(row)
            print(json.dumps(row), flush=True)
    finally:
        proxy_mod.REJECT_YIELD_S = build_s
        proxy_mod.REJECT_SPACING_S = build_p
        sys.setswitchinterval(switch_s)
        Global.enable_admission = False
        smoke.stop_pool(proxy)
        if proxy._batcher is not None:
            proxy._batcher.close()
    out = {"card": card, "scale": args.scale, "seed": args.seed,
           "turns": turns}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
