"""Time K2/K3 of an earlier csrc/stream_emit.cu beside the current one, on
the GPU, on the inputs the port's main path gives them.

    python3 scripts/torch_emit_ab.py OLD_stream_emit.cu [--scale 640]
        [--seed 0] [--out PATH]

OLD is an earlier wukong_tpu_torch/csrc/stream_emit.cu of the five-pass
design (tile sums, scan, tile row counts, scan, emit), for example
``git show 905e2ad:wukong_tpu_torch/csrc/stream_emit.cu``. It is called as
that design's caller called it: both outputs pre-zeroed with torch.zeros,
6 int64 of scratch a tile. The current kernel is called through
tpu_stream.stream_emit / stream_emit_m.

The script synthesizes LUBM-<scale>, serves the index-origin shapes q1, q2
and q6 in replicate batches through Proxy.serve_batch_index (as phase 4 of
chip_smoke.py does) and keeps the inputs of K2's and K3's largest calls. On
those it holds both builds against the plain versions, times them in turns
(old, new, new, old; chip_smoke.time_ms) and splits each build's device
time a call by CUDA kernel with torch.profiler. It prints each source's
registers and spills (nvcc -Xptxas -v) and the card's name and power limit.
Needs nvcc and a CUDA GPU; both builds go under wukong_tpu_torch/build/.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("stream_emit", "stream_emit_m")


def start_build(src: str, name: str):
    """Start nvcc on src with the port's flags and -Xptxas -v; returns
    (name, process, library path)."""
    from wukong_tpu_torch.engine import cuda_lib

    cuda_lib.BUILD.mkdir(parents=True, exist_ok=True)
    out = cuda_lib.BUILD / f"lib{name}.so"
    p = subprocess.Popen([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas",
                          "-v", "-o", str(out), src], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    return name, p, out


def finish_build(build):
    """Wait for a build, print its ptxas resource lines, return its path."""
    name, p, out = build
    text, _ = p.communicate()
    if p.returncode:
        raise SystemExit(f"nvcc of {name} failed:\n{text}")
    for line in text.splitlines():
        if any(k in line for k in ("Compiling entry", "spill stores", "Used")):
            print(f"  {name}: {line.strip()}")
    return out


def old_emits(path) -> dict:
    """The earlier library's K2 and K3, wrapped as its design's caller
    wrapped them."""
    import torch

    from wukong_tpu_torch.engine import cuda_lib

    lib = cuda_lib.bind(ctypes.CDLL(str(path)), "stream_emit.cu",
                        ("wk_stream_tile", "wk_stream_emit",
                         "wk_stream_emit_m"))
    tile = lib.wk_stream_tile()

    def wrap(fn):
        def run(edges, dsel, dpar, cap_out):
            dev = edges.device
            E = edges.shape[0]
            val = torch.zeros(cap_out, dtype=torch.int32, device=dev)
            par = torch.zeros(cap_out, dtype=torch.int32, device=dev)
            total = torch.empty((), dtype=torch.int64, device=dev)
            scratch = torch.empty(6 * max(-(-E // tile), 1),
                                  dtype=torch.int64, device=dev)
            rc = fn(edges.data_ptr(), dsel.data_ptr(), dpar.data_ptr(), E,
                    cap_out, val.data_ptr(), par.data_ptr(), total.data_ptr(),
                    scratch.data_ptr(), cuda_lib.stream_ptr(edges))
            cuda_lib.check(lib, rc, "earlier stream_emit.cu")
            return val, par, total

        return run

    return {"stream_emit": wrap(lib.wk_stream_emit),
            "stream_emit_m": wrap(lib.wk_stream_emit_m)}


def kernel_split_ms(fn, args, runs: int = 10) -> dict:
    """Device ms a call spends in each CUDA kernel or memset (the fills of
    torch.zeros included), by name, from torch.profiler over ``runs`` calls
    (empty if the profiler saw no device time)."""
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
            split[ev.key] = us / 1e3 / runs
    return split


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old", help="an earlier csrc/stream_emit.cu")
    ap.add_argument("--scale", type=int, default=640,
                    help="LUBM universities to serve")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the results to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_emit_ab: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from wukong_tpu_torch.engine import cuda_lib
    from wukong_tpu_torch.engine import tpu_stream as S
    from wukong_tpu_torch.runtime.proxy import Proxy

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    builds = [start_build(os.path.abspath(args.old), "stream_emit_old"),
              start_build(str(cuda_lib.CSRC / "stream_emit.cu"),
                          "stream_emit_ptxas")]
    cuda_lib.build_all()
    old = old_emits(finish_build(builds[0]))
    finish_build(builds[1])

    g, ss, _ = smoke.build_world(args.scale, args.seed)
    proxy = Proxy(g, ss, device="cuda", budget_bytes=60 << 30)
    caps = {name: smoke.Capture(S, name, lambda a: a[0].shape[0])
            for name in KERNELS}
    try:
        for name in ("lubm_q1", "lubm_q2", "lubm_q6"):
            text = smoke.QUERIES[name]
            proxy.serve_batch_index(text, 1)
            for B in smoke.batch_sizes(proxy, text, S.stream_mdup()):
                proxy.serve_batch_index(text, B)
    finally:
        for c in caps.values():
            c.restore()

    results = {"card": card, "scale": args.scale, "seed": args.seed}
    for name, plain in zip(KERNELS, (S.stream_emit_plain,
                                     S.stream_emit_m_plain)):
        cap = caps[name]
        smoke.check("" in cap.best, f"{name}: no main-path call")
        a = cap.best[""][1]  # (edges, dsel, dpar or drow, cap_out)
        emits = {"old": old[name], "new": cap.orig}
        ref = plain(*a)
        for label, fn in emits.items():
            err = smoke.max_abs_diff(fn(*a), ref)
            smoke.check(err == 0, f"{label} {name} != plain ({err})")
        turns = [(label, smoke.time_ms(lambda f=emits[label]: f(*a)))
                 for label in ("old", "new", "new", "old")]
        _bytes, _ops, what = smoke.emit_work(a, mhot=name == "stream_emit_m")
        results[name] = {
            "input": what, "turns_ms": turns,
            "split_ms": {label: kernel_split_ms(fn, a)
                         for label, fn in emits.items()}}
        print(f"{name}: input {what}; ms in turns {turns}; device split "
              f"{results[name]['split_ms']}", flush=True)
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
        print(f"torch_emit_ab: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
