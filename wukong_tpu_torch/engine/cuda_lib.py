"""Build and bind the port's hand-written CUDA kernels (csrc/*.cu).

Each source compiles with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC`` into its own shared library with a plain C
interface, loaded with ctypes. The build runs at first use into
``wukong_tpu_torch/build/`` (listed in .gitignore), keyed by a hash of the
source so an edited kernel is never served from a stale library; all sources
compile in parallel (one nvcc process each). Nothing here runs at import time:
the CPU never builds or loads a kernel.

Every C entry point returns ``cudaGetLastError()`` after its launches;
``check`` turns a nonzero code into an exception. Each wrapper counts its
launches with ``count_launch``, exactly under concurrent serving threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
SOURCES = ("probe.cu", "stream_emit.cu", "level_probe.cu", "knn_scan.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures: every pointer and the stream as c_void_p, ints as c_int
_SIGNATURES = {
    "probe.cu": {
        "wk_probe": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _P],
    },
    "stream_emit.cu": {
        "wk_stream_tile": [],
        "wk_stream_scratch_bytes": [_LL],
        "wk_stream_emit": [_P, _P, _P, _LL, _LL, _P, _P, _P, _P, _P],
        "wk_stream_emit_m": [_P, _P, _P, _LL, _LL, _P, _P, _P, _P, _P],
    },
    "level_probe.cu": {
        "wk_level_probe_max_adj": [],
        "wk_level_probe_glob_words": [_I, _I],
        "wk_level_probe_index_words": [_LL, _LL, _I],
        "wk_level_probe_build_index": [_P, _I, _P, _LL, _I, _P],
        "wk_level_probe": [_P, _P, _I, _P, _I, _I, _P, _LL, _P, _I, _P, _I,
                           _P],
    },
    "knn_scan.cu": {
        "wk_knn_block_max_k": [],
        "wk_knn_max_dim": [],
        "wk_knn_block_scratch_words": [_I],
        "wk_knn_radix_scratch_words": [_LL, _I],
        "wk_knn_scan": [_P, _I, _P, _LL, _LL, _P, _P, _I, _I, _P, _P, _P,
                        _I, _P],
    },
}
# return types other than c_int
_RESTYPES = {"wk_stream_scratch_bytes": _LL,
             "wk_level_probe_glob_words": _LL,
             "wk_level_probe_index_words": _LL,
             "wk_knn_block_scratch_words": _LL,
             "wk_knn_radix_scratch_words": _LL}

_libs: dict = {}
_lock = threading.Lock()
_count_lock = threading.Lock()
_tls = threading.local()
build_seconds: float | None = None  # wall time of the last build_all()


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(put the CUDA toolkit's bin/ on PATH)")
    return exe


def _target(src: str) -> Path:
    digest = hashlib.sha256((CSRC / src).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"lib{Path(src).stem}-{digest}.so"


def build_all() -> float:
    """Compile every source that has no current library, in parallel.
    Returns the wall seconds spent (0 when everything was built)."""
    global build_seconds
    with _lock:
        todo = [s for s in SOURCES if not _target(s).exists()]
        t0 = time.perf_counter()
        if todo:
            BUILD.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = []
            for src in todo:
                tmp = _target(src).with_suffix(f".{os.getpid()}.tmp")
                p = subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                procs.append((src, tmp, p))
            errors = []
            for src, tmp, p in procs:
                out, _ = p.communicate()
                if p.returncode != 0:
                    errors.append(f"nvcc {src} failed ({p.returncode}):\n{out}")
                else:
                    os.replace(tmp, _target(src))
            if errors:
                raise RuntimeError("\n".join(errors))
        build_seconds = time.perf_counter() - t0
        return build_seconds


def library(src: str) -> ctypes.CDLL:
    """The loaded library of one source, built on first use."""
    lib = _libs.get(src)
    if lib is not None:
        return lib
    if not _target(src).exists():
        build_all()
    with _lock:
        lib = _libs.get(src)
        if lib is None:
            lib = bind(ctypes.CDLL(str(_target(src))), src)
            _libs[src] = lib
    return lib


def bind(lib: ctypes.CDLL, src: str, names=None) -> ctypes.CDLL:
    """Declare the C signatures of ``src``'s entry points (all of them, or
    ``names``) and of wk_error_string on a loaded library."""
    for name, argtypes in _SIGNATURES[src].items():
        if names is None or name in names:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
    lib.wk_error_string.argtypes = [ctypes.c_int]
    lib.wk_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.wk_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")


def count_launch(fn) -> None:
    """One launch more on ``fn.launches`` (a kernel wrapper's counter) and
    on the calling thread's own count. Serving threads launch at once, and
    a bare ``+= 1`` on a shared attribute loses increments."""
    with _count_lock:
        fn.launches += 1
    _tls.launches = getattr(_tls, "launches", 0) + 1


def thread_launches() -> int:
    """Kernel launches the calling thread has made so far (every kernel):
    the difference across one call is that call's own, whatever other
    threads launch meanwhile."""
    return getattr(_tls, "launches", 0)


def stream_ptr(t) -> int:
    """The raw handle of the current CUDA stream of ``t``'s device, read
    without building a torch.cuda.Stream object (a cost on every launch)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())


def require_aligned(what: str, *tensors) -> None:
    """Raise unless every tensor's data starts on a 16-byte boundary (the
    kernels' 16 B vector loads and stores)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: tensor data at {t.data_ptr():#x} is not "
                             "16-byte aligned")


def require_cuda(what: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor (the kernels'
    only input form)."""
    for t in tensors:
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{what}: expected contiguous CUDA tensors, got "
                             f"{t.device} contiguous={t.is_contiguous()}")
