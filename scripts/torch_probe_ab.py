"""Time K1 of an earlier csrc/probe.cu beside the current one, on the GPU,
on the inputs the port's main path gives K1.

    python3 scripts/torch_probe_ab.py OLD_probe.cu [--scale 640] [--seed 0]
        [--out PATH]

OLD is an earlier wukong_tpu_torch/csrc/probe.cu of the one-thread-a-row
design over separate bkey/bstart/bdeg arrays, for example
``git show 519b666:wukong_tpu_torch/csrc/probe.cu``. It is called as that
design's wrapper called it (every check on every call, three torch.empty,
the stream through torch.cuda.current_stream), on its three arrays made
once a table from the staged bucket lines. The current kernel is called
through tpu_kernels.probe_kernel.

The script synthesizes LUBM-<scale>, serves the seven basic shapes once
each and the index-origin shapes in replicate batches (chip_smoke.py's
phase 4), then the extended suite once each (phase 5), and keeps K1's
largest input of each class: phase 4, phase 5 on predicate segments, phase
5 on the combined segment. On each it prints the table's bucket count NB,
the input's size and the time a fill of the outputs' bytes takes (the
card's write rate, the floor of a frontier that is mostly padding), holds
both builds against probe_plain (exactly equal), times them in turns (old,
new, new, old; chip_smoke.time_ms) warm, and again with the L2 flushed
before every launch (a 100 MB buffer written between launches, outside the
timed events), and splits each build's time a call into device time
(torch.profiler) and host time (the wall time of enqueueing 200 calls,
over 200, the median of 5). On the combined class, where the card waits on
the host, the current wrapper's host time is split into its output
allocations and the bare ctypes launch. It prints each build's registers
and spills (nvcc -Xptxas -v) and the card's name and power limit. Needs
nvcc and a CUDA GPU; both builds go under wukong_tpu_torch/build/.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

from torch_emit_ab import finish_build, kernel_split_ms, start_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLUSH_BYTES = 100 << 20
TURNS = ("old", "new", "new", "old")


def old_probe(path):
    """The earlier library's K1, wrapped as its design's wrapper wrapped it;
    takes the staged (bline, bhi) and makes its bkey/bstart/bdeg once a
    table."""
    import torch

    from wukong_tpu_torch.engine import cuda_lib
    from wukong_tpu_torch.engine import tpu_kernels as K

    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.wk_probe.argtypes = [P, P, P, P, P, I, I, I, P, P, P, P]
    lib.wk_probe.restype = I
    lib.wk_error_string.argtypes = [I]
    lib.wk_error_string.restype = ctypes.c_char_p
    split: dict = {}

    def run(bline, bhi, cur, n, max_probe):
        key = (bline.data_ptr(), bhi.data_ptr())
        if key not in split:
            NB = bline.shape[0]
            pairs = torch.cat([bline[:, 8:].reshape(NB, 4, 2),
                               bhi.view(NB, 4, 2)], 1).view(NB * 8, 2)
            split[key] = (bline[:, :K.BUCKET].contiguous().view(-1),
                          pairs[:, 0].contiguous(), pairs[:, 1].contiguous())
        bkey, bstart, bdeg = split[key]
        # the earlier design's wrapper, call for call
        cuda_lib.require_cuda("probe_kernel", bkey, bstart, bdeg, cur)
        for t in (bkey, bstart, bdeg, cur):
            if t.dtype != K.I32:
                raise TypeError(f"probe_kernel: int32 expected, got {t.dtype}")
        if bkey.shape[0] % K.BUCKET or bkey.data_ptr() % 16:
            raise ValueError("probe_kernel: bucket table must be [NB*8] and "
                             "16-byte aligned")
        C = cur.shape[0]
        n_dev = K.as_count(n, cur.device)
        found = torch.empty(C, dtype=torch.bool, device=cur.device)
        start = torch.empty(C, dtype=K.I32, device=cur.device)
        deg = torch.empty(C, dtype=K.I32, device=cur.device)
        if C == 0:
            return found, start, deg
        rc = lib.wk_probe(bkey.data_ptr(), bstart.data_ptr(), bdeg.data_ptr(),
                          cur.data_ptr(), n_dev.data_ptr(), C,
                          bkey.shape[0] // K.BUCKET, int(max_probe),
                          found.data_ptr(), start.data_ptr(), deg.data_ptr(),
                          torch.cuda.current_stream(cur.device).cuda_stream)
        cuda_lib.check(lib, rc, "earlier probe.cu")
        return found, start, deg

    return run


def cold_ms(fn, reps: int = 20) -> float:
    """Median device ms of one fn() launched right after a 100 MB buffer was
    written (the L2 holds none of its inputs), CUDA events around the launch
    alone."""
    import torch

    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    fn()
    pairs = []
    for i in range(reps):
        flush.fill_(i)
        # keep the card busy while the host enqueues the timed launch, so
        # the events time the card and not the host's pace
        torch.cuda._sleep(200_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def host_ms(fn, runs: int = 200) -> float:
    """Host ms a call: the wall time of enqueueing ``runs`` calls back to
    back, before the closing synchronize, over ``runs`` (median of 5)."""
    import torch

    times = []
    for _ in range(5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / runs)
        torch.cuda.synchronize()
    return statistics.median(times)


def host_parts_ms(a) -> dict:
    """Host ms a call of the current wrapper on input ``a``, of its two
    output allocations, and of the bare ctypes launch on outputs allocated
    once."""
    import torch

    from wukong_tpu_torch.engine import cuda_lib
    from wukong_tpu_torch.engine import tpu_kernels as K

    bline, bhi, cur, n, max_probe = a
    found, start, deg = K.probe_kernel(*a)
    C, dev = cur.shape[0], cur.get_device()
    entry = cuda_lib.library("probe.cu").wk_probe

    def alloc():
        sd = torch.empty((2, -(-C // 4) * 4), dtype=K.I32, device=cur.device)
        torch.empty(C, dtype=torch.bool, device=cur.device)
        return (sd[:, :C] if C % 4 else sd).unbind(0)

    def launch():
        entry(bline.data_ptr(), bhi.data_ptr(), cur.data_ptr(), n.data_ptr(),
              C, bline.shape[0], max_probe, found.data_ptr(),
              start.data_ptr(), deg.data_ptr(), dev, cuda_lib.stream_ptr(cur))

    return {"wrapper": host_ms(lambda: K.probe_kernel(*a)),
            "alloc": host_ms(alloc), "launch": host_ms(launch)}


def capture_inputs(proxy) -> dict:
    """K1's largest input of each class of its calls while the proxy serves
    the basic suite (singles, then replicate batches) and the extended suite,
    each shape once: {class: ((size, args, kwargs), launches)}."""
    import chip_smoke as smoke
    from wukong_tpu_torch.engine import tpu_kernels as K
    from wukong_tpu_torch.engine import tpu_stream as S

    best = {}
    cap = smoke.Capture(K, "probe_kernel", smoke.probe_size)
    try:
        for text in smoke.QUERIES.values():
            proxy.serve_query(text)
        for name in ("lubm_q1", "lubm_q2", "lubm_q6"):
            text = smoke.QUERIES[name]
            proxy.serve_batch_index(text, 1)
            for B in smoke.batch_sizes(proxy, text, S.stream_mdup()):
                proxy.serve_batch_index(text, B)
    finally:
        cap.restore()
    best["4 basic suite"] = (cap.best[""], cap.launches[""])
    cap = smoke.Capture(K, "probe_kernel", smoke.probe_size,
                        smoke.probe_class_of(proxy))
    try:
        for text in smoke.EXT_QUERIES.values():
            proxy.serve_query(text)
    finally:
        cap.restore()
    for cls, b in cap.best.items():
        best["5 extended suite" + cls] = (b, cap.launches[cls])
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old", help="an earlier csrc/probe.cu")
    ap.add_argument("--scale", type=int, default=640,
                    help="LUBM universities to serve")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the results to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_probe_ab: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from wukong_tpu_torch.engine import cuda_lib
    from wukong_tpu_torch.engine import tpu_kernels as K
    from wukong_tpu_torch.runtime.proxy import Proxy

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    builds = [start_build(os.path.abspath(args.old), "probe_old"),
              start_build(str(cuda_lib.CSRC / "probe.cu"), "probe_ptxas")]
    cuda_lib.build_all()
    fns = {"old": old_probe(finish_build(builds[0])), "new": K.probe_kernel}
    finish_build(builds[1])

    g, ss, _ = smoke.build_world(args.scale, args.seed)
    proxy = Proxy(g, ss, device="cuda", budget_bytes=60 << 30)
    inputs = capture_inputs(proxy)

    results = {"card": card, "scale": args.scale, "seed": args.seed,
               "classes": {}}
    for cls, ((_size, a, _kw), launches) in sorted(inputs.items()):
        nbytes, ops, what = smoke.probe_work(a)
        bound = max(nbytes / smoke.HBM_BYTES_PER_S,
                    ops / smoke.CORE_OPS_PER_S) * 1e3
        what["NB"] = a[0].shape[0]
        ref = K.probe_plain(*a)
        for label, fn in fns.items():
            err = smoke.max_abs_diff(fn(*a), ref)
            smoke.check(err == 0, f"{label} K1 != plain on {cls} ({err})")
        del ref
        # the card's own time to write the outputs' 9 B a row, nothing read
        fill = torch.empty(9 * a[2].shape[0], dtype=torch.uint8,
                           device="cuda")
        row = results["classes"][cls] = {
            "input": what, "launches": launches, "bound_ms": bound,
            "fill_ms": smoke.time_ms(fill.zero_),
            "warm_turns_ms": [(label, smoke.time_ms(lambda f=fns[label]:
                                                    f(*a)))
                              for label in TURNS],
            "cold_turns_ms": [(label, cold_ms(lambda f=fns[label]: f(*a)))
                              for label in TURNS],
            "split": {label: {"host_ms": host_ms(lambda f=fn: f(*a)),
                              "device_by_kernel_ms": kernel_split_ms(fn, a)}
                      for label, fn in fns.items()}}
        del fill
        print(f"{cls}: {launches} launches; input {what}; bound "
              f"{bound:.5f} ms; a fill of the outputs' bytes "
              f"{row['fill_ms']:.5f} ms", flush=True)
        for name in ("warm", "cold"):
            print(f"  {name} ms in turns: " + ", ".join(
                f"{label} {ms:.5f}" for label, ms in row[f"{name}_turns_ms"]),
                flush=True)
        for label, sp in row["split"].items():
            print(f"  {label}: device "
                  f"{sum(sp['device_by_kernel_ms'].values()):.5f} ms, host "
                  f"{sp['host_ms']:.5f} ms a call", flush=True)
        if cls.endswith("combined segment"):  # the card idles: host's pace
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
        print(f"torch_probe_ab: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
