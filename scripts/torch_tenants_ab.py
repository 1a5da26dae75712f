"""Run the overload drill of ``bench.py --tenants`` on the GPU with a
rung-3 rejection that first yields the GIL for each of several times
(``proxy.REJECT_YIELD_S``; 0 raises at once, as the JAX proxy does) and
spaces each tenant's rejections by each of several times
(``proxy.REJECT_SPACING_S``; 0 holds every rejection for the yield alone),
in turns, in one process. A turn written ``Y/S`` also runs with the
interpreter's GIL switch interval at S us (``sys.setswitchinterval``; the
default is 5,000). ``--reuse`` sets ``enable_reuse`` (the reuse
observatory's reply hook) for each turn, and ``--freeze`` moves every
object alive before a turn out of the collector's reach for that turn
(``gc.freeze``, undone after it). ``--plane`` precedes each turn's drill
with ``--pre`` seconds of chip_smoke's phase 9 light serving (16 clients,
batching on, admission off), as the smoke's phase 9 precedes its phase
10: ``0`` with no HTTP plane, then the metrics ring dropped and the heap
collected; ``s`` with the HTTP plane up, the metrics ring at 1 s and
chip_smoke's Scraper (a round of every endpoint each 1 s), then
chip_smoke's ``stop_http_plane`` (the plane down, the ring dropped and
back at its default interval, the heap collected); ``k`` as ``s`` but
stopped without dropping the ring or collecting the heap.

    python3 scripts/torch_tenants_ab.py [--scale 640] [--seed 0]
        [--yields-us 0,Y,Y,0] [--spacings-us P,P,P,P] [--reuse 1,1,1,1]
        [--freeze 0,0,0,0] [--plane 0,s,k] [--pre 10] [--duration 3]
        [--warmup 1] [--out PATH]

Y and P, the defaults, are this build's ``REJECT_YIELD_S`` and
``REJECT_SPACING_S``; ``--spacings-us``, ``--reuse``, ``--freeze`` and
``--plane`` give one value for each turn of ``--yields-us`` (with
``--plane`` alone, every turn's yield is Y). With ``--plane`` it also
prints, for each of its letters, gold's compliance, p99 and late calls
over the turns with that letter (mean, least and most).

It synthesizes LUBM-<scale> from the seed, serves chip_smoke's light texts
(``?s ub:advisor <a>``, bench.py --serve-batched's) under the greedy
heuristic plan with the engine pool started and batching on, and runs
``Emulator.run_tenants`` with the default classes at ``overload_x`` = 2
(gold 4, silver 4 and bulk 8 clients, every client sending its next query
at once, a rejected one too) with admission armed at chip_smoke's quotas
and in-flight ceiling. Each turn of ``--yields-us`` prints every tenant's
rate, p50, p99, served, partial and rejected counts and compliance, and
whether gold held its SLO (latency met, error budget left >= 0, never
partial nor rejected). Each turn also lists the collector's pauses
(count and milliseconds by generation, the longest) and gold's replies over
its 50 ms, each with its end in seconds from the turn's start and the
collections and metrics-sampler snapshots (``tsdb``) that overlapped it. Needs a CUDA GPU and nvcc.
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


class TimedReplies:
    """Stands for the proxy in Emulator.run_tenants: passes each call on
    and keeps (tenant, start, end) of every reply, in perf_counter
    seconds."""

    def __init__(self, proxy):
        import threading

        self.proxy = proxy
        self.monitor = proxy.monitor
        self.spans: list = []
        self._lock = threading.Lock()

    def serve_query(self, text, blind=True, tenant="default"):
        t0 = time.perf_counter()
        try:
            return self.proxy.serve_query(text, blind=blind, tenant=tenant)
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.spans.append((tenant, t0, t1))

    def late(self, tenant: str, limit_us: int, pauses: list,
             t_base: float) -> list:
        """The tenant's replies over ``limit_us``: end (s from t_base), ms,
        and the collections (generation, ms) that overlapped each."""
        out = []
        for ten, t0, t1 in self.spans:
            if ten != tenant or (t1 - t0) * 1e6 <= limit_us:
                continue
            gcs = [(gen, round((b - a) * 1e3, 2)) for gen, a, b in pauses
                   if a < t1 and b > t0]
            out.append({"end_s": round(t1 - t_base, 3),
                        "ms": round((t1 - t0) * 1e3, 2), "gc": gcs})
        return out


def gc_summary(pauses: list, t_base: float) -> dict:
    """Count, total ms and longest ms of the collector's pauses by
    generation (and of the metrics sampler's snapshots), and the longest
    one's start in s from t_base."""
    out: dict = {}
    for gen, a, b in pauses:
        d = out.setdefault(gen if gen == "tsdb" else f"gen{gen}", {"n": 0, "ms": 0.0, "max_ms": 0.0,
                                         "max_at_s": None})
        ms = (b - a) * 1e3
        d["n"] += 1
        d["ms"] += ms
        if ms > d["max_ms"]:
            d["max_ms"], d["max_at_s"] = ms, round(a - t_base, 3)
    for d in out.values():
        d["ms"], d["max_ms"] = round(d["ms"], 2), round(d["max_ms"], 2)
    return out


def before_drill(smoke, proxy, light, plane: str, seconds: float) -> dict:
    """A turn's lead-in (``--plane``): phase 9's light serving for
    ``seconds``, with the HTTP plane scraped (``s``, ``k``) or without it
    (``0``), then the plane's end as the letter says. Returns the lead-in's
    rate, the scrapes, and the metrics ring's samples and the heap's
    tracked objects as the drill starts."""
    from wukong_tpu_torch.config import Global, GlobalConfig
    from wukong_tpu_torch.obs import get_tsdb, stop_metrics_http
    from wukong_tpu_torch.runtime.emulator import Emulator

    Global.enable_admission = False
    port = smoke.start_http_plane() if plane != "0" else None
    scraper = smoke.Scraper(port) if port is not None else None
    if scraper is not None:
        scraper.__enter__()
    try:
        rep = Emulator(proxy).run_serving(light, duration_s=seconds,
                                          warmup_s=0.5, clients=16, seed=1)
    finally:
        if scraper is not None:
            scraper.__exit__(None, None, None)
    out = {"qps": rep["qps"], "errors": rep["errors"]}
    if scraper is not None:
        out["scrapes"] = scraper.report(f"lead-in {plane}")["requests"]
    if plane == "s":
        smoke.stop_http_plane()
    elif plane == "k":
        stop_metrics_http()
        smoke.set_tsdb_interval(GlobalConfig.tsdb_interval_s)
    else:
        get_tsdb().reset()
        gc.collect()
    out["ring_samples"] = len(get_tsdb())
    out["tracked_objects"] = len(gc.get_objects())
    return out


def by_plane(turns: list) -> dict:
    """Gold's compliance, p99 and late calls over the turns of each
    ``--plane`` letter: mean, least and most, and how many turns held."""
    out: dict = {}
    for letter in sorted({t["plane"] for t in turns}):
        rows = [t for t in turns if t["plane"] == letter]
        d = out[letter] = {"turns": len(rows),
                           "held": sum(t["gold_held"] for t in rows)}
        for key, vals in (
                ("compliance", [t["gold"]["compliance"] or 0.0
                                for t in rows]),
                ("p99_us", [t["gold"]["p99_us"] for t in rows]),
                ("qps", [t["gold"]["qps"] for t in rows]),
                ("late", [len(t["gold_late"]) for t in rows])):
            d[key] = {"mean": sum(vals) / len(vals), "min": min(vals),
                      "max": max(vals)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=640)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--yields-us", default=None)
    ap.add_argument("--spacings-us", default=None)
    ap.add_argument("--reuse", default=None)
    ap.add_argument("--freeze", default=None)
    ap.add_argument("--plane", default=None)
    ap.add_argument("--pre", type=float, default=10.0)
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
    from wukong_tpu_torch.obs import tsdb as tsdb_mod
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
    planes = args.plane.split(",") if args.plane else None
    if planes is not None and set(planes) - {"0", "s", "k"}:
        ap.error("--plane letters are 0, s and k")
    ys = (args.yields_us.split(",") if args.yields_us
          else ["Y"] * len(planes) if planes else ["0", "Y", "Y", "0"])
    ps = (args.spacings_us.split(",") if args.spacings_us
          else ["P"] * len(ys))
    rs = args.reuse.split(",") if args.reuse else ["1"] * len(ys)
    fs = args.freeze.split(",") if args.freeze else ["0"] * len(ys)
    planes = planes or [None] * len(ys)
    if not len(ps) == len(rs) == len(fs) == len(planes) == len(ys):
        ap.error("--spacings-us, --reuse, --freeze and --plane need one "
                 "value for each turn")
    switch_s = sys.getswitchinterval()
    build_reuse = Global.enable_reuse
    pauses: list = []  # (generation, start, end) in perf_counter seconds
    started: list = []

    def on_gc(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            pauses.append((info["generation"], started.pop(),
                           time.perf_counter()))

    gc.callbacks.append(on_gc)
    # the metrics sampler's snapshots, timed as the collector's pauses are
    # (generation "tsdb")
    sample_once = tsdb_mod.MetricsTSDB.sample_once

    def timed_sample(self, *a, **kw):
        t = time.perf_counter()
        try:
            return sample_once(self, *a, **kw)
        finally:
            pauses.append(("tsdb", t, time.perf_counter()))

    tsdb_mod.MetricsTSDB.sample_once = timed_sample
    gc.collect()
    t_full = time.perf_counter()
    gc.collect()
    heap = {"tracked_objects": len(gc.get_objects()),
            "full_collection_ms": round(
                (time.perf_counter() - t_full) * 1e3, 2)}
    print(f"heap: {heap}", flush=True)
    arms = []
    for y, p, r, f, pl in zip(ys, ps, rs, fs, planes):
        y, _, sw = y.partition("/")
        arms.append((build_s if y == "Y" else float(y) / 1e6,
                     build_p if p == "P" else float(p) / 1e6,
                     float(sw) / 1e6 if sw else switch_s,
                     r != "0", f != "0", pl))
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
        for y, p, sw, reuse, freeze, plane in arms:
            pre = (before_drill(smoke, proxy, light, plane, args.pre)
                   if plane is not None else None)
            Global.enable_admission = True
            proxy_mod.REJECT_YIELD_S = y
            proxy_mod.REJECT_SPACING_S = p
            sys.setswitchinterval(sw)
            Global.enable_reuse = reuse
            get_admission().reset()
            if freeze:
                gc.freeze()
            pauses.clear()
            timed = TimedReplies(proxy)
            t0 = time.perf_counter()
            try:
                rep = Emulator(timed).run_tenants(
                    light, duration_s=args.duration, warmup_s=args.warmup,
                    overload_x=2.0, seed=1)
            finally:
                if freeze:
                    gc.unfreeze()
            row = {"yield_s": y, "spacing_s": p, "switch_interval_s": sw,
                   "reuse": reuse, "frozen": freeze, "plane": plane,
                   "pre": pre,
                   "wall_s": round(time.perf_counter() - t0, 3),
                   "decisions": rep["admission"]["decisions"],
                   "gc": gc_summary(pauses, t0),
                   "gold_late": timed.late("gold", 50_000, pauses, t0)}
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
            if plane is not None:
                Global.enable_admission = False
    finally:
        proxy_mod.REJECT_YIELD_S = build_s
        proxy_mod.REJECT_SPACING_S = build_p
        sys.setswitchinterval(switch_s)
        Global.enable_reuse = build_reuse
        gc.callbacks.remove(on_gc)
        tsdb_mod.MetricsTSDB.sample_once = sample_once
        Global.enable_admission = False
        smoke.stop_pool(proxy)
        if proxy._batcher is not None:
            proxy._batcher.close()
    out = {"card": card, "scale": args.scale, "seed": args.seed,
           "heap": heap, "turns": turns}
    if args.plane:
        out["by_plane"] = by_plane(turns)
        print(json.dumps({"by_plane": out["by_plane"]}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
