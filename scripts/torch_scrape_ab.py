"""Time what scraping the HTTP plane costs live serving, on the GPU, in
turns in one process over one world.

    python3 scripts/torch_scrape_ab.py [--scale 640] [--seed 0]
        [--order oqQo] [--duration 3] [--warmup 1] [--out PATH]

One process builds the port's CUDA kernels, synthesizes LUBM-<scale> from
the seed with its attributes, plans with the type-centric planner (as
chip_smoke's phases 9 and 13 do), embeds every professor (make_vectors,
dim 64), starts the HTTP plane on a free loopback port with the metrics
ring at 1 s, and then runs each turn of ``--order``: ``o`` with no
scraper, ``q`` with chip_smoke's Scraper every 0.25 s between rounds of
every endpoint, ``Q`` with it every 1 s. A turn serves phase 9's light
texts (``?s ub:advisor <a>`` over 512 anchors) from 16 closed-loop clients
with batching on through ``Emulator.run_serving``, then phase 13's
GraphRAG mix (8 clients, the hybrid template over 64 Zipf-popular
anchors, knn_device auto) through ``Emulator.run_graphrag``, each
``--duration`` s after ``--warmup`` s. It prints each turn's rates, p50
and p99, the scraper's rounds and per-endpoint p50, then for each arm the
mean, least and most of its turns' light rate, light p99 and mix rate,
and fails on an error reply or a failed scrape. Needs a CUDA GPU and
nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAUSES = {"o": None, "q": 0.25, "Q": 1.0}  # seconds between scrape rounds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=640)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--order", default="oqQo")
    ap.add_argument("--duration", type=float, default=3.0)
    ap.add_argument("--warmup", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if set(args.order) - set(PAUSES):
        ap.error(f"--order letters are {sorted(PAUSES)}")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_scrape_ab: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from wukong_tpu_torch.config import Global
    from wukong_tpu_torch.engine import cuda_lib
    from wukong_tpu_torch.loader.datagen import make_vectors
    from wukong_tpu_torch.planner.optimizer import Planner
    from wukong_tpu_torch.planner.stats import Stats
    from wukong_tpu_torch.runtime.emulator import Emulator
    from wukong_tpu_torch.runtime.proxy import Proxy
    from wukong_tpu_torch.types import OUT
    from wukong_tpu_torch.vector.vstore import upsert_batch_into

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    smoke.log(f"scrape A/B: {torch.cuda.get_device_name(0)}; {card}")
    cuda_lib.build_all()
    g, ss, triples = smoke.build_world(args.scale, args.seed)
    proxy = Proxy(g, ss, device="cuda", budget_bytes=60 << 30,
                  planner=Planner(Stats.generate(triples)))
    proxy.gpu.stats = proxy.planner.stats
    del triples
    light, _heavy = smoke.live_texts(proxy)
    pid = ss.str2id(f"<{smoke.UBI}advisor>")
    profs = np.unique(np.asarray(g.get_index(pid, OUT), np.int64))
    gr = smoke.GRAPHRAG
    upsert_batch_into([g], profs, make_vectors(profs, gr["dim"], seed=0))
    graph = [f"SELECT ?s WHERE {{ ?s <{smoke.UBI}advisor> "
             f"{ss.id2str(int(a))} . }}" for a in profs[:gr["graph_texts"]]]
    anchors = [ss.id2str(int(a)) for a in profs[:gr["anchors"]]]
    port = smoke.start_http_plane()
    proxy.engine_pool()
    with smoke.Knobs("GraphRAG", enable_vectors=True,
                     vector_dim=gr["dim"], knn_device="auto",
                     knn_split_threshold=smoke.KNN_SPLIT):
        Global.enable_batching = True
        for text in light + graph[:8]:  # staging, parse and plan caches
            proxy.serve_query(text, blind=True)
        proxy.serve_query(smoke.HYBRID_TEMPLATE.replace("{anchor}",
                                                        anchors[0]))
        turns = []
        for arm in args.order:
            pause = PAUSES[arm]
            scraper = (smoke.Scraper(port, pause) if pause is not None
                       else None)
            if scraper is not None:
                scraper.__enter__()
            t0 = time.perf_counter()
            try:
                Global.enable_batching = True
                lite = Emulator(proxy).run_serving(
                    light, duration_s=args.duration, warmup_s=args.warmup,
                    clients=16, seed=1)
                Global.enable_batching = False
                mix = Emulator(proxy).run_graphrag(
                    graph, smoke.HYBRID_TEMPLATE, anchors,
                    duration_s=args.duration, warmup_s=args.warmup,
                    clients=gr["clients"], seed=1, zipf_a=gr["zipf_a"],
                    hybrid_frac=gr["hybrid_frac"])
            finally:
                if scraper is not None:
                    scraper.__exit__(None, None, None)
            smoke.check(lite["errors"] == 0 and mix["errors"] == 0,
                        f"turn {arm}: error replies")
            turn = {"arm": arm, "pause_s": pause,
                    "seconds": time.perf_counter() - t0,
                    "light_qps": lite["qps"], "light_p50_us": lite["p50_us"],
                    "light_p99_us": lite["p99_us"], "mix_qps": mix["qps"],
                    "hybrid": mix["hybrid"], "graph": mix["graph"]}
            if scraper is not None:
                turn["scrapes"] = scraper.report(f"turn {arm}")
            smoke.log(f"turn {arm} (scrape pause {pause}): light "
                      f"{lite['qps']} q/s p50 {lite['p50_us']} us p99 "
                      f"{lite['p99_us']} us; GraphRAG {mix['qps']} q/s, "
                      f"hybrid {mix['hybrid']}, graph {mix['graph']}")
            turns.append(turn)
    smoke.stop_pool(proxy)
    arms = {}
    for arm in sorted(set(args.order)):
        rows = [t for t in turns if t["arm"] == arm]
        arms[arm] = {"turns": len(rows)}
        for key in ("light_qps", "light_p99_us", "mix_qps"):
            vals = [t[key] for t in rows]
            arms[arm][key] = {"mean": sum(vals) / len(vals),
                              "min": min(vals), "max": max(vals)}
        smoke.log(f"arm {arm} over {len(rows)} turns: " + ", ".join(
            f"{key} mean {v['mean']:.1f} ({v['min']}-{v['max']})"
            for key, v in arms[arm].items() if key != "turns"))
    out = {"card": card, "scale": args.scale, "order": args.order,
           "duration_s": args.duration, "turns": turns, "arms": arms}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
