"""Time chip_smoke's light live workload (bench.py --serve-batched's) through
an earlier build of the port beside the current one, on the GPU, in turns.

    python3 scripts/torch_live_ab.py OTHER [--scale 640] [--seed 0]
        [--order otao] [--one-process] [--duration 5] [--warmup 1]
        [--out PATH]

OTHER is a directory that holds an earlier checkout, for example ``git
archive <commit> | tar -x -C archive_check/parent``. Each turn of
``--order`` is its own process: ``o`` runs OTHER's package, ``t`` this
checkout's, ``a`` this checkout's with the reply-side tenant
accounting and the event journal off (``enable_tenant_accounting`` and
``enable_events``, both on by default), ``d`` this checkout's with
the device observatory off (``enable_device_obs``, on by default), and
``r`` this checkout's with the reuse observatory's reply hook off
(``enable_reuse``, on by default; OTHER is then not read, so ``.`` will do
with ``--order rttr``). A turn builds the package's CUDA
kernels, synthesizes LUBM-<scale> from the seed, serves each light text
once (staging and the parse and plan caches), then drives the texts
(``?s ub:advisor <a>`` over 512 anchors) from 16 closed-loop clients
through ``Emulator.run_serving`` under the heuristic plan, batching off
and then on, as chip_smoke's phase 9 does (without its planner). It
prints each turn's rate, p50 and p99 and each arm's pooled rates, and
fails on an error reply. With ``--one-process`` (an order of ``t``, ``a``,
``d`` and ``r`` only) every turn runs in one process over one world, each
setting its knobs and restoring them after, so the turns differ only in
those knobs. Needs a CUDA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIENTS = 16


ARM_KNOBS = {"t": {}, "o": {},
             "a": {"enable_tenant_accounting": False, "enable_events": False},
             "d": {"enable_device_obs": False},
             "r": {"enable_reuse": False}}


def worker(tree: str, arms: str, scale: int, seed: int, duration: float,
           warmup: float) -> list:
    """The package under ``tree`` serves the light workload once for each
    letter of ``arms``, with that arm's knobs set."""
    sys.path.insert(0, tree)
    import chip_smoke as smoke
    from wukong_tpu_torch.config import Global
    from wukong_tpu_torch.engine import cuda_lib
    from wukong_tpu_torch.runtime.emulator import Emulator
    from wukong_tpu_torch.runtime.proxy import Proxy

    pkg = os.path.dirname(cuda_lib.__file__)
    smoke.check(os.path.realpath(pkg).startswith(os.path.realpath(tree)),
                f"imported {pkg}, not the package under {tree}")
    cuda_lib.build_all()
    g, ss, _triples = smoke.build_world(scale, seed)
    proxy = Proxy(g, ss, device="cuda", budget_bytes=60 << 30)
    light, _heavy = smoke.live_texts(proxy)
    Global.silent = True
    for text in light:
        proxy.serve_query(text, blind=True)
    turns = []
    try:
        for arm in arms:
            knobs = ARM_KNOBS[arm]
            saved = {k: getattr(Global, k) for k in knobs}
            for k, v in knobs.items():
                setattr(Global, k, v)
            runs = {}
            try:
                for batching in (False, True):
                    Global.enable_batching = batching
                    rep = Emulator(proxy).run_serving(
                        light, duration_s=duration, warmup_s=warmup,
                        clients=CLIENTS, seed=1)
                    smoke.check(rep["errors"] == 0,
                                f"{rep['errors']} error replies")
                    runs["on" if batching else "off"] = {
                        k: rep[k] for k in ("qps", "p50_us", "p99_us",
                                            "served")}
            finally:
                for k, v in saved.items():
                    setattr(Global, k, v)
            turns.append({"package": pkg, "runs": runs, "label": arm})
    finally:
        Global.enable_batching = False
        if proxy._batcher is not None:
            proxy._batcher.close()
    return turns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="directory holding the earlier checkout")
    ap.add_argument("--scale", type=int, default=640)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--order", default="otao",
                    help="turns: o = OTHER, t = this checkout, a = this "
                         "checkout with tenant accounting and events off, "
                         "d = this checkout with the device observatory "
                         "off, r = this checkout with enable_reuse off")
    ap.add_argument("--one-process", action="store_true",
                    help="every turn in one process (t, a, d, r only)")
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--warmup", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--arm", default="t", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print("AB_RESULT " + json.dumps(
            worker(args.worker, args.arm, args.scale, args.seed,
                   args.duration, args.warmup)), flush=True)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("torch_live_ab: no CUDA GPU available", file=sys.stderr)
        return 1
    import chip_smoke as smoke

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    trees = {"o": os.path.abspath(args.other), "t": ROOT, "a": ROOT,
             "d": ROOT, "r": ROOT}
    if args.one_process and "o" in args.order:
        ap.error("--one-process runs this checkout only: no o turn")
    turns = []
    for label in ([args.order] if args.one_process else args.order):
        p = subprocess.run(
            [sys.executable, os.path.abspath(__file__), trees[label[0]],
             "--worker", trees[label[0]], "--arm", label,
             "--scale", str(args.scale), "--seed", str(args.seed),
             "--duration", str(args.duration),
             "--warmup", str(args.warmup)],
            capture_output=True, text=True, timeout=1800)
        out = [ln for ln in p.stdout.splitlines()
               if ln.startswith("AB_RESULT ")]
        smoke.check(p.returncode == 0 and len(out) == 1,
                    f"turn {label} failed (rc {p.returncode}):\n"
                    f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
        for res in json.loads(out[0][len("AB_RESULT "):]):
            turns.append(res)
            print(f"turn {res['label']} ({res['package']}): " + "; ".join(
                f"batching {b} {r['qps']:,.1f} queries/s, p50 "
                f"{r['p50_us']:,} us, p99 {r['p99_us']:,} us"
                for b, r in res["runs"].items()), flush=True)
    summary = {}
    for label in sorted(set(args.order)):
        summary[label] = {b: sorted(t["runs"][b]["qps"] for t in turns
                                    if t["label"] == label)
                          for b in ("off", "on")}
        print(f"  {label}: queries/s batching off {summary[label]['off']}, "
              f"on {summary[label]['on']}", flush=True)
    results = {"card": card, "scale": args.scale, "seed": args.seed,
               "order": args.order, "one_process": args.one_process,
               "clients": CLIENTS,
               "duration_s": args.duration, "turns": turns,
               "summary": summary}
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
        print(f"torch_live_ab: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
