"""Time LUBM shapes (the seven basic ones by default) through an earlier
build of the port beside the current one, on the GPU, in turns.

    python3 scripts/torch_serve_ab.py OTHER [--scale 640] [--seed 0]
        [--runs 11] [--order otto] [--shapes NAME,...] [--out PATH]

OTHER is a directory that holds an earlier ``wukong_tpu_torch/`` package,
for example ``git archive <commit> wukong_tpu_torch | tar -x -C
archive_check/parent``. Each turn of ``--order`` (``o`` for OTHER, ``t`` for
this checkout) is its own process: it builds that package's CUDA kernels,
synthesizes LUBM-<scale> from the seed (triples only, which every build
of the port can load), stages the basic suite's segments
(chip_smoke.stage_all), then the OUT combined segment that variable
predicates probe, timing each staging (``stage_s``, ``combined_out_s``;
``setup_s`` is synthesis and partitioning and the basic staging), and
serves the shapes of ``--shapes`` (names of chip_smoke.QUERIES or
EXT_QUERIES that need no attributes; default the seven of QUERIES) through
Proxy.serve_query: one untimed round, then ``--runs`` rounds of them all
(host clock around the call and a synchronize, as chip_smoke's phases 4
and 5 time them). It prints each turn's set-up and median and each build's
pooled min / median / max a shape, says whether the two builds' ranges
overlap, and fails if the builds' row counts differ. Needs a CUDA GPU and
nvcc.
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


def worker(tree: str, scale: int, seed: int, runs: int, shapes: list) -> dict:
    """One turn: the package under ``tree`` serves ``shapes``."""
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as smoke
    from wukong_tpu_torch.engine import cuda_lib
    from wukong_tpu_torch.loader.lubm import VirtualLubmStrings, generate_lubm
    from wukong_tpu_torch.runtime.proxy import Proxy
    from wukong_tpu_torch.store.gstore import build_partition
    from wukong_tpu_torch.types import OUT

    pkg = os.path.dirname(cuda_lib.__file__)
    smoke.check(os.path.realpath(pkg).startswith(os.path.realpath(tree)),
                f"imported {pkg}, not the package under {tree}")
    cuda_lib.build_all()
    t0 = time.perf_counter()
    triples, _ = generate_lubm(scale, seed=seed)
    proxy = Proxy(build_partition(triples, 0, 1),
                  VirtualLubmStrings(scale, seed=seed), device="cuda",
                  budget_bytes=60 << 30)
    t1 = time.perf_counter()
    smoke.stage_all(proxy)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    # the OUT combined segment, which the first variable-predicate shape
    # stages (x_vers_kuu's first run)
    # (earlier builds named the proxy's device engine ``engine``)
    eng = proxy.gpu if hasattr(proxy, "gpu") else proxy.engine
    eng.dstore.versatile_segment(OUT)
    torch.cuda.synchronize()
    stage = {"setup_s": t2 - t0, "stage_s": t2 - t1,
             "combined_out_s": time.perf_counter() - t2}
    texts = {name: {**smoke.QUERIES, **smoke.EXT_QUERIES}[name]
             for name in shapes}
    for text in texts.values():  # one untimed round: first touches
        proxy.serve_query(text)
    lat = {name: [] for name in texts}
    rows = {}
    for _ in range(runs):
        for name, text in texts.items():
            t0 = time.perf_counter()
            q = proxy.serve_query(text)
            torch.cuda.synchronize()
            lat[name].append((time.perf_counter() - t0) * 1e3)
            smoke.check(q.result.status_code == 0, f"{name}: status "
                        f"{q.result.status_code!r}")
            rows[name] = q.result.nrows
    return {"package": pkg, **stage, "rows": rows, "runs_ms": lat}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="directory holding the earlier package")
    ap.add_argument("--scale", type=int, default=640)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=11,
                    help="rounds of the shapes in each turn")
    ap.add_argument("--order", default="otto",
                    help="turns: o = OTHER, t = this checkout")
    ap.add_argument("--shapes", default="lubm_q1,lubm_q2,lubm_q3,lubm_q4,"
                    "lubm_q5,lubm_q6,lubm_q7",
                    help="comma-separated shape names of chip_smoke's "
                         "QUERIES and EXT_QUERIES (none with attributes)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    shapes = args.shapes.split(",")
    if args.worker:
        print("AB_RESULT " + json.dumps(
            worker(args.worker, args.scale, args.seed, args.runs, shapes)),
            flush=True)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("torch_serve_ab: no CUDA GPU available", file=sys.stderr)
        return 1
    import chip_smoke as smoke

    known = {**smoke.QUERIES, **smoke.EXT_QUERIES}
    smoke.check(all(name in known for name in shapes),
                f"unknown shapes in {shapes}; known: {sorted(known)}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    trees = {"o": os.path.abspath(args.other), "t": ROOT}
    turns = []
    for label in args.order:
        p = subprocess.run(
            [sys.executable, os.path.abspath(__file__), trees[label],
             "--worker", trees[label], "--scale", str(args.scale),
             "--seed", str(args.seed), "--runs", str(args.runs),
             "--shapes", args.shapes],
            capture_output=True, text=True, timeout=1800)
        out = [ln for ln in p.stdout.splitlines()
               if ln.startswith("AB_RESULT ")]
        smoke.check(p.returncode == 0 and len(out) == 1,
                    f"turn {label} failed (rc {p.returncode}):\n"
                    f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
        res = json.loads(out[0][len("AB_RESULT "):])
        res["label"] = label
        turns.append(res)
        print(f"turn {label} ({res['package']}): set-up {res['setup_s']:.2f}"
              f" s (staging {res['stage_s']:.2f} s), OUT combined segment "
              f"staged in {res['combined_out_s']:.2f} s; median ms "
              + ", ".join(
                  f"{n} {statistics.median(v):.2f}"
                  for n, v in res["runs_ms"].items()), flush=True)
    smoke.check(all(t["rows"] == turns[0]["rows"] for t in turns),
                "row counts differ between turns: "
                f"{[t['rows'] for t in turns]}")
    summary = {}
    for name in shapes:
        pooled = {label: sorted(x for t in turns if t["label"] == label
                                for x in t["runs_ms"][name])
                  for label in sorted(set(args.order))}
        stat = {label: {"min": v[0], "median": statistics.median(v),
                        "max": v[-1]} for label, v in pooled.items()}
        if len(stat) == 2:
            o, t = stat["o"], stat["t"]
            stat["overlap"] = o["min"] <= t["max"] and t["min"] <= o["max"]
            stat["t_over_o"] = t["median"] / o["median"]
        summary[name] = stat
        print(f"  {name}: {turns[0]['rows'][name]:,} rows; " + "; ".join(
            f"{lab} min {s['min']:.2f} median {s['median']:.2f} max "
            f"{s['max']:.2f}" for lab, s in stat.items()
            if isinstance(s, dict))
            + (f"; this/other median {stat['t_over_o']:.3f}, ranges "
               f"{'overlap' if stat['overlap'] else 'apart'}"
               if "overlap" in stat else ""), flush=True)
    results = {"card": card, "scale": args.scale, "seed": args.seed,
               "runs": args.runs, "order": args.order, "shapes": shapes,
               "turns": turns, "summary": summary}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from chip_smoke import SmokeFailure

    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"torch_serve_ab: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
