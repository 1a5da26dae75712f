"""Trace exporters: Chrome trace-event JSON (Perfetto) + the device trace.

The port's copy of the JAX package's obs/export.py.
``chrome_trace_events`` flattens QueryTraces into the Chrome trace-event
format (``chrome://tracing`` / https://ui.perfetto.dev): spans become
complete ("X") events, span events become instants ("i"), one virtual
thread row per (trace, real thread) so concurrent queries don't interleave
on one track. ``write_chrome_trace`` wraps that in the JSON envelope.

``device_trace`` scopes ``torch.profiler`` (CPU and, with a card, CUDA
activities through CUPTI) around a block and writes the capture into a
directory as a Chrome trace: the per-kernel view of the block's device
work, the hand-written kernels that ``engine/cuda_lib.py`` launches through
ctypes among them. ``maybe_device_trace`` gates it on the ``xprof_dir``
knob (environment form ``WUKONG_XPROF_DIR``), so callers wrap a hot path
at no cost by default. The profiler is process-wide: a second capture
while one is open raises. A capture that holds no CUDA kernel after its
block launched one (a hand-written kernel by the launch counters of
``engine/cuda_lib.py``, or any kernel by the CUDA runtime or driver launch
calls the capture recorded) is a fault and raises; it never passes as an
empty file. ``kernel_summary`` reads a capture's kernels back.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading

_capture_lock = threading.Lock()
_capturing = False  # guarded by: _capture_lock
_capture_seq = itertools.count(1)
#: path of the most recent device capture (None before the first)
last_capture: str | None = None


def _trace_events(path: str) -> list[dict]:
    with open(path) as f:
        js = json.load(f)
    return js.get("traceEvents", []) if isinstance(js, dict) else js


def _is_kernel(e: dict) -> bool:
    return e.get("ph") == "X" and str(e.get("cat", "")).lower() == "kernel"


def kernel_events(path: str) -> list[dict]:
    """The CUDA kernel events ("X" events of category ``kernel``) of a
    Chrome trace written by :func:`device_trace`."""
    return [e for e in _trace_events(path) if _is_kernel(e)]


def check_capture(path: str, hand_launches: int = 0) -> None:
    """Raise when the capture at ``path`` holds no CUDA kernel although its
    block launched one: ``hand_launches`` hand-written kernels, or any
    kernel launch call (``cudaLaunchKernel``, ``cuLaunchKernel`` and their
    variants) among the capture's CUDA runtime and driver events."""
    evs = _trace_events(path)
    if any(_is_kernel(e) for e in evs):
        return
    calls = sum(1 for e in evs
                if str(e.get("cat", "")).lower() in ("cuda_runtime",
                                                     "cuda_driver")
                and "LaunchKernel" in str(e.get("name", "")))
    if hand_launches or calls:
        raise RuntimeError(
            f"device trace {path} holds no CUDA kernel after "
            f"{hand_launches} hand-written kernel launches and {calls} "
            "kernel launch calls in its block")


def kernel_summary(path: str) -> list[dict]:
    """Per-kernel device time of a capture, largest first:
    ``[{"name", "calls", "total_us", "max_us"}]``."""
    acc: dict[str, dict] = {}
    for e in kernel_events(path):
        d = acc.setdefault(e.get("name", "?"), {
            "name": e.get("name", "?"), "calls": 0, "total_us": 0.0,
            "max_us": 0.0})
        dur = float(e.get("dur", 0.0))
        d["calls"] += 1
        d["total_us"] += dur
        d["max_us"] = max(d["max_us"], dur)
    return sorted(acc.values(), key=lambda d: -d["total_us"])


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a torch.profiler trace of everything inside the block and
    write it to ``logdir`` as ``device_trace_<pid>_<n>.json``; the path is
    left in ``last_capture``."""
    global _capturing, last_capture
    import torch
    from torch.profiler import ProfilerActivity, profile

    from wukong_tpu_torch.engine import cuda_lib

    with _capture_lock:
        if _capturing:
            raise RuntimeError("a device trace is already being captured "
                               "(the profiler is process-wide)")
        _capturing = True
    try:
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        launched = cuda_lib.thread_launches()
        with profile(activities=acts) as prof:
            yield prof
        launched = cuda_lib.thread_launches() - launched
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(
            logdir, f"device_trace_{os.getpid()}_{next(_capture_seq)}.json")
        prof.export_chrome_trace(path)
        check_capture(path, launched)
        last_capture = path
    finally:
        with _capture_lock:
            _capturing = False


def maybe_device_trace():
    """``device_trace`` when a capture directory is configured — the
    ``xprof_dir`` knob first, then ``WUKONG_XPROF_DIR`` — else a
    nullcontext."""
    from wukong_tpu_torch.config import Global

    logdir = str(Global.xprof_dir) or os.environ.get("WUKONG_XPROF_DIR")
    return device_trace(logdir) if logdir else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# Chrome trace-event JSON
# ---------------------------------------------------------------------------

def chrome_trace_events(traces) -> list[dict]:
    """Flatten traces into Chrome trace-event dicts (ts/dur in usec)."""
    events: list[dict] = []
    tid_map: dict[tuple, int] = {}

    def vtid(trace, real_tid) -> int:
        key = (trace.trace_id, real_tid)
        if key not in tid_map:
            tid_map[key] = len(tid_map) + 1
            events.append({
                "name": "thread_name", "ph": "M", "pid": 0,
                "tid": tid_map[key],
                "args": {"name": f"{trace.trace_id} "
                                 f"[{trace.kind} qid={trace.qid}]"}})
        return tid_map[key]

    for tr in traces:
        for sp in tr.spans:
            t = vtid(tr, sp.tid)
            events.append({
                "name": sp.name, "cat": tr.kind, "ph": "X",
                "ts": sp.t0_us, "dur": max(sp.dur_us, 1), "pid": 0, "tid": t,
                "args": {**sp.attrs, "trace_id": tr.trace_id}})
            for (ts, name, attrs) in sp.events:
                events.append({
                    "name": name, "cat": tr.kind, "ph": "i", "s": "t",
                    "ts": ts, "pid": 0, "tid": t,
                    "args": {**attrs, "trace_id": tr.trace_id}})
    return events


def write_chrome_trace(path: str, traces) -> str:
    """Write traces as a Perfetto-loadable JSON file; returns the path."""
    payload = {"traceEvents": chrome_trace_events(traces),
               "displayTimeUnit": "ms"}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f)
    return path
