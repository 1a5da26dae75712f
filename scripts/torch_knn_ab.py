"""Time knn_scan of an earlier csrc/knn_scan.cu beside the current one, on
the GPU, on the inputs phase 13 of chip_smoke.py gives it.

    python3 scripts/torch_knn_ab.py OLD_knn_scan.cu [--scale 640] [--seed 0]
        [--out PATH]

OLD is an earlier wukong_tpu_torch/csrc/knn_scan.cu with the C entry
points wk_knn_scratch_words and wk_knn_scan, for example
``git show b83d318:wukong_tpu_torch/csrc/knn_scan.cu``. It is called as
its wrapper called it (every check, a ctypes call for the scratch size,
three torch.empty a call). The current kernel is called through
vector.knn.knn_scan.

The script synthesizes LUBM-<scale> and makes phase 13's vectors as the
smoke does: the advisors' professors embedded with make_vectors (dim 64,
seed 0) and staged, then every other entity's vector drawn on the card
from seed + 13 and the whole block staged again. Its classes: (a) a
GraphRAG slice (the second of the 7 row ranges sliced_topk cuts the
professors' block into at knn_split_threshold 65,536; k = 8, cosine),
(b) the whole block at k = 10 under each metric and at k = 100,000
(the radix path), (c) the slot list of the GraduateStudents (k = 10,
cosine). On each it holds both builds against knn_scan_plain with phase
2's equality (chip_smoke.knn_agree), times them in turns (old, new, new,
old; chip_smoke.time_ms: 25 calls back to back, CUDA events, median of
3) warm, and again with the L2 flushed before every launch, and splits
each build's time a call into device time by kernel with its launches a
call (torch.profiler) and host time (the wall time of enqueueing 200
calls, over 200, the median of 5), and for k <= 256 the current
wrapper's host time by part (the whole call, its allocation, the bare
ctypes launch). Beside them: the plain version's and
the library call's (chip_smoke.knn_library) time, the bound, each
build's registers and spills (nvcc -Xptxas -v) and the card's name and
power limit. Needs nvcc and a CUDA GPU; both builds go under
wukong_tpu_torch/build/.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_emit_ab import finish_build, start_build  # noqa: E402
from torch_probe_ab import cold_ms, host_ms  # noqa: E402

TURNS = ("old", "new", "new", "old")
SLICES = 7  # (a): 455,840 professors over knn_split_threshold 65,536
BIG_K = 100_000


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def device_split(fn, args, runs: int = 10) -> dict:
    """{kernel name: [device ms a call, launches a call]} from
    torch.profiler over ``runs`` calls (empty if it saw no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn(*args)
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        # aten:: ops would count their kernels twice; cuda* are host calls
        if us and not ev.key.startswith(("aten::", "cuda")):
            split[ev.key] = [us / 1e3 / runs, ev.count / runs]
    return split


def old_knn(path):
    """The earlier library's knn_scan, wrapped as its wrapper wrapped it."""
    import torch

    from wukong_tpu_torch.engine import cuda_lib
    from wukong_tpu_torch.vector import knn as KN

    lib = ctypes.CDLL(str(path))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.wk_knn_max_dim.argtypes = []
    lib.wk_knn_scratch_words.argtypes = [LL, I, I]
    lib.wk_knn_scratch_words.restype = LL
    lib.wk_knn_scan.argtypes = [P, I, P, LL, LL, P, P, I, I, P, P, P, I, P]
    lib.wk_knn_scan.restype = I
    lib.wk_error_string.argtypes = [I]
    lib.wk_error_string.restype = ctypes.c_char_p
    max_dim = int(lib.wk_knn_max_dim())

    def run(base, alive, anchor, k, metric, rows=None, slots=None):
        # the earlier wrapper, call for call
        if metric not in KN._METRIC_CODE:
            raise ValueError(metric)
        if base.dtype != torch.float32 or base.dim() != 2:
            raise ValueError("base")
        if alive.dtype != torch.bool or tuple(alive.shape) != (
                base.shape[0],):
            raise ValueError("alive")
        d = int(base.shape[1])
        if anchor.dtype != torch.float32 or tuple(anchor.shape) != (d,):
            raise ValueError("anchor")
        tensors = [base, alive, anchor]
        if slots is not None:
            if slots.dtype != torch.int64 or slots.dim() != 1:
                raise ValueError("slots")
            tensors.append(slots)
            lo, m = 0, int(slots.shape[0])
        else:
            lo, hi = (0, int(base.shape[0])) if rows is None else \
                map(int, rows)
            if not 0 <= lo <= hi <= base.shape[0]:
                raise ValueError("rows")
            m = hi - lo
        cuda_lib.require_cuda("knn_scan", *tensors)
        dev = base.device
        for t in tensors[1:]:
            if t.device != dev:
                raise ValueError("device")
        kk = min(int(k), m)
        out_s = torch.empty(max(kk, 0), dtype=torch.float32, device=dev)
        out_i = torch.empty(max(kk, 0), dtype=torch.int64, device=dev)
        if kk <= 0:
            return out_s, out_i
        if d > max_dim or m >= 2**31 - 1:
            raise ValueError("size")
        words = int(lib.wk_knn_scratch_words(m, kk, dev.index))
        scratch = torch.empty(max(words, 1), dtype=torch.int64, device=dev)
        rc = lib.wk_knn_scan(
            base.data_ptr(), d, alive.data_ptr(), lo, m,
            slots.data_ptr() if slots is not None else None,
            anchor.data_ptr(), KN._METRIC_CODE[metric], kk,
            scratch.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            dev.index, cuda_lib.stream_ptr(base))
        cuda_lib.check(lib, rc, "earlier knn_scan.cu")
        cuda_lib.count_launch(run)
        return out_s, out_i

    run.launches = 0
    return run


def host_parts_ms(a) -> dict:
    """Host ms a call of the current wrapper on input ``a``: the whole
    call, its one allocation (both outputs in one buffer), and the bare
    ctypes launch on outputs made once."""
    import torch

    from wukong_tpu_torch.engine import cuda_lib
    from wukong_tpu_torch.vector import knn as KN

    base, alive, q, k, metric, rows, slots = a
    out_s, out_i = KN.knn_scan(*a)
    kk, d, di = out_s.shape[0], base.shape[1], base.get_device()
    stream = cuda_lib.stream_ptr(base)
    lo = 0 if rows is None else rows[0]
    m = (slots.shape[0] if slots is not None else
         base.shape[0] if rows is None else rows[1] - rows[0])
    scratch = KN._block_scratch[(di, stream)]
    sp = None if slots is None else slots.data_ptr()
    entry, code = KN._wk.wk_knn_scan, KN._METRIC_CODE[metric]

    def alloc():
        o_i, o_s = torch.empty(3 * kk, dtype=torch.float32,
                               device=base.device).split_with_sizes(
                                   (2 * kk, kk))
        return o_s, o_i.view(torch.int64)

    def launch():
        entry(base.data_ptr(), d, alive.data_ptr(), lo, m, sp, q.data_ptr(),
              code, kk, scratch.data_ptr(), out_s.data_ptr(),
              out_i.data_ptr(), di, stream)

    return {"wrapper": host_ms(lambda: KN.knn_scan(*a)),
            "alloc": host_ms(alloc), "launch": host_ms(launch)}


def phase13_inputs(scale: int, seed: int, device="cuda") -> dict:
    """{class: knn_scan args} as phase 13 makes them (see the module
    note); the (a) slice keeps the professors' staged block alive."""
    import numpy as np
    import torch

    import chip_smoke as smoke
    from wukong_tpu_torch.config import Global
    from wukong_tpu_torch.loader.datagen import make_vectors
    from wukong_tpu_torch.types import IN, OUT
    from wukong_tpu_torch.vector import knn as KN
    from wukong_tpu_torch.vector.vstore import upsert_batch_into

    dim = smoke.GRAPHRAG["dim"]
    g, ss, _triples = smoke.build_world(scale, seed)
    Global.enable_vectors, Global.vector_dim = True, dim
    pid = ss.str2id(f"<{smoke.UBI}advisor>")
    profs = np.unique(np.asarray(g.get_index(pid, OUT), np.int64))
    upsert_batch_into([g], profs, make_vectors(profs, dim, seed=0))
    vs = g.vstore
    blk = KN.staged_block(vs, device)
    anchor = torch.from_numpy(np.asarray(vs.get(int(profs[0])),
                                         np.float32)).to(device)
    n = int(blk.base.shape[0])
    bounds = np.linspace(0, n, SLICES + 1).astype(np.int64)
    rows = (int(bounds[1]), int(bounds[2]))
    out = {"(a) GraphRAG slice": (blk.base, blk.alive, anchor, 8, "cosine",
                                  rows, None)}
    others = np.setdiff1d(np.asarray(g.v_set, np.int64), profs)
    gen = torch.Generator(device=device).manual_seed(seed + 13)
    big = torch.randn((len(others), dim), generator=gen,
                      device=device).cpu().numpy()
    upsert_batch_into([g], others, big)
    del big
    blk = KN.staged_block(vs, device)
    a_vid = next(int(v) for v in others[len(others) // 3:]
                 if ss.id2str(int(v)).startswith("<"))
    anchor = torch.from_numpy(np.asarray(vs.get(a_vid), np.float32)).to(
        device)
    for metric in ("cosine", "dot", "l2"):
        out[f"(b) whole block, k=10, {metric}"] = (
            blk.base, blk.alive, anchor, 10, metric, None, None)
    out[f"(b) whole block, k={BIG_K}, cosine"] = (
        blk.base, blk.alive, anchor, BIG_K, "cosine", None, None)
    gs = ss.str2id(f"<{smoke.UBI}GraduateStudent>")
    cand = np.unique(np.asarray(g.get_index(gs, IN), np.int64))
    slots = np.asarray([vs.slot_of.get(v, -1) for v in cand.tolist()],
                       np.int64)
    slots = torch.from_numpy(slots[slots >= 0]).to(device)
    out["(c) slot list, GraduateStudent"] = (blk.base, blk.alive, anchor,
                                             10, "cosine", None, slots)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old", help="an earlier csrc/knn_scan.cu")
    ap.add_argument("--scale", type=int, default=640,
                    help="LUBM universities to synthesize")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the results to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_knn_ab: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from wukong_tpu_torch.engine import cuda_lib
    from wukong_tpu_torch.vector import knn as KN

    card = card_name()
    print(f"card: {card}", flush=True)
    builds = [start_build(os.path.abspath(args.old), "knn_scan_old"),
              start_build(str(cuda_lib.CSRC / "knn_scan.cu"),
                          "knn_scan_ptxas")]
    cuda_lib.build_all()
    fns = {"old": old_knn(finish_build(builds[0])), "new": KN.knn_scan}
    finish_build(builds[1])

    inputs = phase13_inputs(args.scale, args.seed)
    results = {"card": card, "scale": args.scale, "seed": args.seed,
               "classes": {}}
    for cls, a in inputs.items():
        base, alive, q, k, metric, rows, slots = a
        want = KN.knn_scan_plain(base, alive, q, k + 1, metric, rows, slots)
        errs = {label: smoke.knn_agree(fn(*a), want)
                for label, fn in fns.items()}
        smoke.knn_agree(smoke.knn_library(*a), want)
        del want
        nbytes, ops, what = smoke.knn_work(a)
        bound = max(nbytes / smoke.HBM_BYTES_PER_S,
                    ops / smoke.CORE_OPS_PER_S) * 1e3
        row = results["classes"][cls] = {
            "input": what, "bound_ms": bound, "max_abs_err": errs,
            "warm_turns_ms": [(label, smoke.time_ms(lambda f=fns[label]:
                                                    f(*a)))
                              for label in TURNS],
            "cold_turns_ms": [(label, cold_ms(lambda f=fns[label]: f(*a)))
                              for label in TURNS],
            "split": {label: {"host_ms": host_ms(lambda f=fn: f(*a)),
                              "device_by_kernel": device_split(fn, a)}
                      for label, fn in fns.items()},
            "plain_ms": smoke.time_ms(lambda: KN.knn_scan_plain(*a), reps=5),
            "library_ms": smoke.time_ms(lambda: smoke.knn_library(*a))}
        print(f"{cls}: input {what}; bound {bound:.5f} ms; plain "
              f"{row['plain_ms']:.4f} ms; library {row['library_ms']:.4f} "
              f"ms; max_abs_err {errs}", flush=True)
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
        if k <= 256:  # where the card may wait on the host
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
        print(f"torch_knn_ab: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
