"""Time level_probe of an earlier csrc/level_probe.cu beside the current
one, on the GPU, on the inputs phases 11 and 12 of chip_smoke.py give it.

    python3 scripts/torch_level_probe_ab.py OLD_level_probe.cu
        [--scale 640] [--seed 0] [--no-watdiv] [--out PATH]

OLD is an earlier wukong_tpu_torch/csrc/level_probe.cu whose wk_level_probe
takes no dense-index arguments, for example ``git show
b83d318:wukong_tpu_torch/csrc/level_probe.cu``. It is called as its wrapper
called it (every check, one torch.empty a call, the descriptors packed a
launch). The current kernel is called through join.kernels.level_probe.

The script synthesizes LUBM-<scale>, plans with the planner over its
statistics (phase 7's), and runs phase 11 as the smoke runs it
(chip_smoke.serve_strategies: the default routes, WCOJ and the compiled
template forced, the regrow, EXPLAIN ANALYZE; then serve_cyclic, the
cyclic worlds), keeping the largest input of each class of the level
probe's calls (its call site and the part that made it, as the smoke's
rows name them). Unless --no-watdiv, it then serves WatDiv-2750 with
WCOJ and the compiled template forced on its twelve templates (phase
12's forced routes, on the whole store) and keeps that phase's largest
input, both call sites merged. On each input it holds both builds
against level_probe_plain bit for bit, times them in turns (old, new,
new, old; chip_smoke.time_ms: 25 calls back to back, CUDA events, median
of 3) warm, and again with the L2 flushed before every launch, and
splits each build's time a call into device time by kernel with its
launches a call (torch.profiler) and host time (the wall time of
enqueueing 200 calls, over 200, the median of 5), and on the classes of
2^21 candidates and more the current wrapper's host time by part (the
whole call, its allocation). Beside them: the plain
version's time, the library call's where there is one (chip_smoke.
lp_library), the bound (chip_smoke.level_probe_work), each build's
registers and spills (nvcc -Xptxas -v) and the card's name and power
limit. Needs nvcc and a CUDA GPU; both builds go under
wukong_tpu_torch/build/.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_emit_ab import finish_build, start_build  # noqa: E402
from torch_knn_ab import TURNS, card_name, device_split  # noqa: E402
from torch_probe_ab import cold_ms, host_ms  # noqa: E402


class OldAdj(ctypes.Structure):
    """The earlier build's adjacency descriptor (no dense index)."""

    _fields_ = [("keys", ctypes.c_void_p), ("offsets", ctypes.c_void_p),
                ("edges", ctypes.c_void_p), ("anchors", ctypes.c_void_p),
                ("nkeys", ctypes.c_int), ("nedges", ctypes.c_int),
                ("depth", ctypes.c_int), ("pad", ctypes.c_int)]


def old_level_probe(path):
    """The earlier library's level probe, wrapped as its wrapper wrapped
    it."""
    import torch

    from wukong_tpu_torch.engine import cuda_lib
    from wukong_tpu_torch.join import kernels as JK

    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.wk_level_probe_max_adj.argtypes = []
    lib.wk_level_probe.argtypes = [P, P, I, P, I, I, P, I, P, I, P]
    lib.wk_level_probe.restype = I
    lib.wk_error_string.argtypes = [I]
    lib.wk_error_string.restype = ctypes.c_char_p
    max_adj = int(lib.wk_level_probe_max_adj())

    def run(valid, cand, glob, adj):
        # the earlier wrapper, call for call (a keys index left out)
        adj = [(keys, offsets, edges, anchors, max(int(depth), 1))
               for keys, offsets, edges, anchors, depth, *_i in adj]
        JK._check_probe_args(valid, cand, glob,
                             [a + (None,) for a in adj])
        C = cand.shape[0]
        mask = torch.empty(C, dtype=torch.bool, device=cand.device)
        if C == 0:
            return mask
        stream = cuda_lib.stream_ptr(cand)
        src = valid
        chunks = [adj[i:i + max_adj]
                  for i in range(0, len(adj), max_adj)] or [[]]
        for k, chunk in enumerate(chunks):
            descs = (OldAdj * max(len(chunk), 1))()
            for j, (keys, offsets, edges, anchors, depth) in enumerate(chunk):
                descs[j] = OldAdj(keys.data_ptr(), offsets.data_ptr(),
                                  edges.data_ptr(), anchors.data_ptr(),
                                  keys.shape[0], edges.shape[0], depth, 0)
            use_glob = glob is not None and k == 0
            rc = lib.wk_level_probe(
                src.data_ptr(), cand.data_ptr(), C,
                glob.data_ptr() if use_glob else None,
                glob.shape[0] if use_glob else 0, int(use_glob),
                ctypes.cast(descs, ctypes.c_void_p), len(chunk),
                mask.data_ptr(), cand.get_device(), stream)
            cuda_lib.check(lib, rc, "earlier level_probe.cu")
            cuda_lib.count_launch(run)
            src = mask
        return mask

    run.launches = 0
    return run


def host_parts_ms(a) -> dict:
    """Host ms a call of the current wrapper on input ``a``: the whole
    call, and its allocation alone (the mask with the scratch after it)."""
    import torch

    from wukong_tpu_torch.join import kernels as JK

    valid, cand, glob, adj = a
    mask = JK.level_probe(*a)
    nbytes = mask.untyped_storage().nbytes()
    return {"wrapper": host_ms(lambda: JK.level_probe(*a)),
            "alloc": host_ms(lambda: torch.empty(
                nbytes, dtype=torch.bool, device=cand.device)[
                    :cand.shape[0]])}


def phase11_inputs(scale: int, seed: int) -> dict:
    """{class: ((size, args, kw), launches)} of the level probe's calls in
    phase 11 (see the module note)."""
    import torch

    import chip_smoke as smoke
    from wukong_tpu_torch.planner.optimizer import Planner
    from wukong_tpu_torch.planner.stats import Stats
    from wukong_tpu_torch.runtime.proxy import Proxy

    g, ss, triples = smoke.build_world(scale, seed)
    t0 = time.perf_counter()
    proxy = Proxy(g, ss, device="cuda", budget_bytes=60 << 30)
    stats = Stats.generate(triples)  # phase 7's planner
    proxy.planner, proxy.gpu.stats = Planner(stats), stats
    del triples
    smoke.log(f"planner statistics in {time.perf_counter() - t0:.1f} s")
    phase4, single = {}, {}
    with smoke.Knobs(None, join_strategy="walk", template_device="host"):
        for name in smoke.STRATEGY_SHAPES:
            q, lat = smoke.timed_runs(
                lambda n=name: proxy.serve_query(smoke.QUERIES[n]), 3)
            phase4[name] = smoke.sorted_table(q)
            single[name] = {"median_ms": statistics.median(lat),
                            "rows": q.result.nrows}
    results = {"batched": {"single": single}}
    entry = {"name": ""}
    lpc = smoke.lp_captures(entry)
    try:
        try:  # a route check that fails still leaves the inputs it made
            smoke.serve_strategies(proxy, phase4, entry, results)
        except smoke.SmokeFailure as e:
            smoke.log(f"phase 11's check failed (inputs kept): {e}")
        smoke.serve_cyclic(entry, results)
    finally:
        smoke.restore_all(lpc)
    torch.cuda.synchronize()
    return {"11 strategies" + cls: (best, cap.launches[cls])
            for cap in lpc for cls, best in sorted(cap.best.items())
            if cap.launches.get(cls, 0)}


def watdiv_input(seed: int) -> dict:
    """{class: ((size, args, kw), launches)}: the largest level-probe input
    of WatDiv-2750's twelve templates with WCOJ and the compiled template
    forced, both call sites merged (phase 12's row)."""
    import chip_smoke as smoke
    from wukong_tpu_torch.loader.watdiv import (
        VirtualWatdivStrings,
        generate_watdiv,
    )

    scale = smoke.WATDIV_SCALE
    triples, _lay = generate_watdiv(scale, seed=seed)
    proxy, _stats = smoke.world_proxy(
        triples, VirtualWatdivStrings(scale, seed), "cuda",
        f"WatDiv-{scale}")
    del triples
    texts = {n: t for n, (t, _tm, _c) in
             smoke.watdiv_texts(proxy, seed).items()}
    entry = {"name": ""}
    lpc = smoke.lp_captures(entry)
    try:
        for knobs in ({"join_strategy": "wcoj", "join_device": "device"},
                      {"join_strategy": "walk",
                       "template_device": "device"}):
            with smoke.Knobs(None, **knobs):
                smoke.served_rows(proxy, texts, "cuda", 1, entry, "(d) ")
    finally:
        smoke.restore_all(lpc)
    n = sum(sum(c.launches.values()) for c in lpc)
    bests = [b for c in lpc for b in c.best.values()]
    if not bests:
        return {}
    return {"12 data in, WatDiv forced": (max(bests, key=lambda b: b[0]), n)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old", help="an earlier csrc/level_probe.cu")
    ap.add_argument("--scale", type=int, default=640,
                    help="LUBM universities to serve")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-watdiv", action="store_true",
                    help="skip phase 12's WatDiv input")
    ap.add_argument("--out", default=None,
                    help="also write the results to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_level_probe_ab: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from wukong_tpu_torch.engine import cuda_lib
    from wukong_tpu_torch.join import kernels as JK

    card = card_name()
    print(f"card: {card}", flush=True)
    builds = [start_build(os.path.abspath(args.old), "level_probe_old"),
              start_build(str(cuda_lib.CSRC / "level_probe.cu"),
                          "level_probe_ptxas")]
    cuda_lib.build_all()
    fns = {"old": old_level_probe(finish_build(builds[0])),
           "new": JK.level_probe}
    finish_build(builds[1])

    inputs = phase11_inputs(args.scale, args.seed)
    if not args.no_watdiv:
        inputs.update(watdiv_input(args.seed))
    results = {"card": card, "scale": args.scale, "seed": args.seed,
               "classes": {}}
    for cls, ((_size, a, _kw), launches) in inputs.items():
        want = JK.level_probe_plain(*a)
        for label, fn in fns.items():
            err = smoke.max_abs_diff([fn(*a)], [want])
            smoke.check(err == 0, f"{label} level_probe != plain on {cls} "
                        f"({err} rows differ)")
        del want
        nbytes, ops, what = smoke.level_probe_work(a)
        bound = max(nbytes / smoke.HBM_BYTES_PER_S,
                    ops / smoke.CORE_OPS_PER_S) * 1e3
        lib = smoke.lp_library(*a)
        row = results["classes"][cls] = {
            "input": what, "launches": launches, "bound_ms": bound,
            "warm_turns_ms": [(label, smoke.time_ms(lambda f=fns[label]:
                                                    f(*a)))
                              for label in TURNS],
            "cold_turns_ms": [(label, cold_ms(lambda f=fns[label]: f(*a)))
                              for label in TURNS],
            "split": {label: {"host_ms": host_ms(lambda f=fn: f(*a)),
                              "device_by_kernel": device_split(fn, a)}
                      for label, fn in fns.items()},
            "plain_ms": smoke.time_ms(lambda: JK.level_probe_plain(*a),
                                      reps=5),
            "library_ms": (smoke.time_ms(lambda: lib(*a)) if lib
                           else None)}
        print(f"{cls}: {launches} launches; input {what}; bound "
              f"{bound:.5f} ms; plain {row['plain_ms']:.4f} ms; library "
              f"{row['library_ms']}", flush=True)
        for name in ("warm", "cold"):
            print(f"  {name} ms in turns: " + ", ".join(
                f"{label} {ms:.5f}" for label, ms in row[f"{name}_turns_ms"]),
                flush=True)
        for label, sp in row["split"].items():
            dev = sp["device_by_kernel"]
            print(f"  {label}: device {sum(v[0] for v in dev.values()):.5f} "
                  f"ms in {sum(v[1] for v in dev.values()):g} launches a "
                  f"call {dev}; host {sp['host_ms']:.5f} ms a call",
                  flush=True)
        if what["C"] >= 1 << 21 and what["J"] <= 8:  # the large classes
            row["host_parts_ms"] = host_parts_ms(a)
            print(f"  new wrapper's host ms a call by part: "
                  f"{row['host_parts_ms']}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from chip_smoke import SmokeFailure

    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"torch_level_probe_ab: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
