"""expand_rows on the GPU: phase 2's adversarial cases, both query suites
on the card against the CPU proxy at a small scale, then phase 10's overload
drill (run C) in turns with this build's expand_rows (``k``) and with its
plain version, the torch row plan that ran on the card before the kernel,
in its place (``t``), in one process over one world.

    python3 scripts/torch_expand_rows_ab.py [--scale 640] [--cross-scale 40]
        [--seed 0] [--order ktkttktk] [--duration 3] [--warmup 1]
        [--out PATH]

Each turn runs ``Emulator.run_tenants`` with the default classes at
``overload_x`` = 2 (gold 4, silver 4 and bulk 8 clients) with admission
armed at chip_smoke's quotas and in-flight ceiling, the engine pool started
and batching on, over chip_smoke's light texts (``?s ub:advisor <a>``),
and prints every tenant's rate, p50, p99 and compliance over the last 512
replies, whether gold held its SLO (latency met, error budget left >= 0),
expand_rows' launches, the process's CPU seconds over the turn's wall
seconds, and for the fused flights (``FusedGroup.run`` on the pool's batch
lane) their count, members, wall and thread-CPU ms, with the wall and
thread-CPU ms a call of each of their parts: the seed table's upload, K1,
the row plan and gathers (expand_rows or the torch plan), the end-of-chain
sync and the scatter to the members. The last line sums each arm's turns
(mean, least and most). The host's pace moves the drill 2-3x within one
call: compare arms within a call, in turns. Needs a CUDA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Parts:
    """Wall and thread-CPU seconds of every call of a few functions."""

    def __init__(self):
        self.acc = defaultdict(lambda: [0, 0.0, 0.0])
        self.undo = []

    def wrap(self, owner, name: str, label: str) -> None:
        orig = getattr(owner, name)
        acc = self.acc

        def timed(*a, **kw):
            w0, c0 = time.perf_counter(), time.thread_time()
            try:
                return orig(*a, **kw)
            finally:
                p = acc[label]
                p[0] += 1
                p[1] += time.perf_counter() - w0
                p[2] += time.thread_time() - c0

        if hasattr(orig, "launches"):  # a kernel wrapper counts on itself
            timed.launches = orig.launches
        setattr(owner, name, timed)
        self.undo.append((owner, name, orig, timed))

    def unwrap_last(self) -> None:
        owner, name, orig, timed = self.undo.pop()
        setattr(owner, name, orig)
        if hasattr(orig, "launches"):  # the launches made while wrapped
            orig.launches = timed.launches

    def report(self) -> dict:
        return {k: {"calls": n, "wall_ms": round(w / max(n, 1) * 1e3, 4),
                    "cpu_ms": round(c / max(n, 1) * 1e3, 4)}
                for k, (n, w, c) in sorted(self.acc.items())}

    def restore(self) -> None:
        while self.undo:
            self.unwrap_last()


def cross_check(smoke, scale: int, seed: int) -> dict:
    """Both suites of chip_smoke on the card and on the CPU over one
    partition: every status and row multiset equal."""
    from wukong_tpu_torch.engine import tpu_kernels as K
    from wukong_tpu_torch.runtime.proxy import Proxy

    g, ss, _triples, _attrs = smoke.build_world(scale, seed, with_attrs=True)
    on_cpu, on_gpu = Proxy(g, ss, device="cpu"), Proxy(g, ss, device="cuda")
    n0 = K.expand_rows.launches
    differ = []
    for name, text in {**smoke.QUERIES, **smoke.EXT_QUERIES}.items():
        a, b = on_cpu.serve_query(text), on_gpu.serve_query(text)
        if (int(a.result.status_code) != int(b.result.status_code)
                or smoke.rows_multiset(a) != smoke.rows_multiset(b)):
            differ.append(name)
    return {"scale": scale, "shapes": len(smoke.QUERIES)
            + len(smoke.EXT_QUERIES), "differ": differ,
            "expand_rows_launches": K.expand_rows.launches - n0}


def summary(turns: list) -> dict:
    out = {}
    for arm in sorted({t["arm"] for t in turns}):
        rows = [t for t in turns if t["arm"] == arm]

        def span(key, sub=None):
            v = [r[key] if sub is None else r[key][sub] for r in rows]
            return {"mean": round(sum(v) / len(v), 4), "min": min(v),
                    "max": max(v)}

        out[arm] = {"turns": len(rows),
                    "held": sum(r["gold_held"] for r in rows),
                    "qps": span("qps"), "gold_qps": span("gold", "qps"),
                    "gold_p50_us": span("gold", "p50_us"),
                    "gold_p99_us": span("gold", "p99_us"),
                    "gold_compliance": span("gold", "compliance"),
                    "flight_wall_ms": span("flights", "wall_ms"),
                    "cores_busy": span("cores_busy")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=640)
    ap.add_argument("--cross-scale", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--order", default="ktkttktk")
    ap.add_argument("--duration", type=float, default=3.0)
    ap.add_argument("--warmup", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if set(args.order) - {"k", "t"}:
        ap.error("--order letters are k and t")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch_expand_rows_ab: no CUDA GPU available", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from wukong_tpu_torch.config import Global
    from wukong_tpu_torch.engine import cuda_lib
    from wukong_tpu_torch.engine import tpu as tpu_mod
    from wukong_tpu_torch.engine import tpu_kernels as K
    from wukong_tpu_torch.runtime import batcher as bm
    from wukong_tpu_torch.runtime.admission import get_admission
    from wukong_tpu_torch.runtime.emulator import Emulator
    from wukong_tpu_torch.runtime.proxy import Proxy

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    cuda_lib.build_all()
    errs = {"expand_rows": 0}
    smoke.expand_rows_checks(errs)
    torch.cuda.synchronize()
    print(f"expand_rows: {len(smoke.expand_rows_cases())} cases equal to the "
          f"plain version, 3 runs each", flush=True)
    cross = cross_check(smoke, args.cross_scale, args.seed)
    print(f"cross-check: {json.dumps(cross)}", flush=True)
    if cross["differ"]:
        return 1

    g, ss, _triples = smoke.build_world(args.scale, args.seed)
    proxy = Proxy(g, ss, device="cuda", budget_bytes=60 << 30)
    light, _heavy = smoke.live_texts(proxy)
    Global.silent = True
    Global.enable_batching = True
    Global.heavy_lane = True
    proxy.engine_pool()
    kern = K.expand_rows
    turns = []
    parts = Parts()
    try:
        # untimed: stages the texts' segment and warms the batcher
        Emulator(proxy).run_tenants(light, duration_s=1.0, warmup_s=0.5)
        Global.enable_admission = True
        Global.admission_quotas = smoke.TENANT_QUOTAS
        Global.admission_max_inflight = smoke.TENANT_MAX_INFLIGHT
        parts.wrap(K, "upload", "upload")
        parts.wrap(K, "probe_kernel", "probe_kernel")
        parts.wrap(tpu_mod._ChainState, "sync", "sync")
        parts.wrap(bm.FusedGroup, "_scatter", "scatter")
        flights = []
        orig_run = bm.FusedGroup.run

        def run(group, engine=None):
            w0, c0 = time.perf_counter(), time.thread_time()
            try:
                return orig_run(group, engine)
            finally:
                flights.append((len(group.members),
                                time.perf_counter() - w0,
                                time.thread_time() - c0))

        bm.FusedGroup.run = run
        parts.undo.append((bm.FusedGroup, "run", orig_run, run))
        for arm in args.order:
            K.expand_rows = kern if arm == "k" else K.expand_rows_plain
            parts.wrap(K, "expand_rows", "row_plan")
            parts.acc.clear()
            flights.clear()
            get_admission().reset()
            n0 = kern.launches
            p0, w0 = time.process_time(), time.perf_counter()
            rep = Emulator(proxy).run_tenants(
                light, duration_s=args.duration, warmup_s=args.warmup,
                overload_x=2.0, seed=1)
            cpu_s, wall_s = time.process_time() - p0, time.perf_counter() - w0
            parts.unwrap_last()
            row = {"arm": arm, "qps": rep["qps"],
                   "cores_busy": round(cpu_s / wall_s, 3),
                   "expand_rows_launches": kern.launches - n0,
                   "decisions": rep["admission"]["decisions"]}
            for t, r in rep["tenants"].items():
                slo = r["slo"] or {}
                row[t] = {k: r[k] for k in ("clients", "qps", "p50_us",
                                            "p99_us", "served", "rejected")}
                row[t].update({k: slo.get(k) for k in (
                    "compliance", "error_budget_remaining", "latency_met")})
            gd = row["gold"]
            row["gold_held"] = bool(gd["latency_met"] is True and (
                gd["error_budget_remaining"] or 0.0) >= 0.0)
            n = max(len(flights), 1)
            row["flights"] = {
                "count": len(flights),
                "members": round(sum(f[0] for f in flights) / n, 2),
                "wall_ms": round(sum(f[1] for f in flights) / n * 1e3, 4),
                "cpu_ms": round(sum(f[2] for f in flights) / n * 1e3, 4),
                "parts": parts.report()}
            turns.append(row)
            print(json.dumps(row), flush=True)
    finally:
        K.expand_rows = kern
        parts.restore()
        Global.enable_admission = False
        smoke.stop_pool(proxy)
        if proxy._batcher is not None:
            proxy._batcher.close()
    out = {"card": card, "scale": args.scale, "seed": args.seed,
           "cross_check": cross, "turns": turns, "by_arm": summary(turns)}
    print(json.dumps({"by_arm": out["by_arm"]}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
