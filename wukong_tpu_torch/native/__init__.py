"""Native host runtime (C++ via ctypes) with the numpy paths as fallback.

The port's copy of the JAX package's native/ package and of its C++ source
(``wukong_native.cpp`` here, a copy): three host steps that the reference
also runs natively — mmap id-triple parsing, the 8-way bucket placement of a
device segment's hash table, and the radix argsort of triple columns.

The library builds at first use with the host C++ compiler (``-O3 -shared
-fPIC``) into ``wukong_tpu_torch/build/`` (listed in .gitignore), named by a
hash of the source, so an edited source is never served from a stale
library; nothing is written beside the source. Every entry point degrades
to its numpy path when no compiler or library is available: these are host
steps, not kernels, and the numpy path is their plain version.

``counts`` records the path each call took, per entry point
(``{"parse_id_triples": {"native": N, "numpy": M}, ...}``), in plain
integers that a run reads to show that its host steps went native.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "wukong_native.cpp"
BUILD = _DIR.parent / "build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib = None
_tried = False
_lock = threading.Lock()

ENTRY_POINTS = ("parse_id_triples", "sort_triples_perm",
                "build_bucket_table_native")
counts = {name: {"native": 0, "numpy": 0} for name in ENTRY_POINTS}


def _count(name: str, path: str) -> None:
    with _lock:
        counts[name][path] += 1


def reset_counts() -> None:
    with _lock:
        for c in counts.values():
            c["native"] = c["numpy"] = 0


def _compiler():
    for cc in ("c++", "g++", "cc", "gcc"):
        try:
            subprocess.run([cc, "--version"], capture_output=True, check=True)
            return cc
        except (OSError, subprocess.CalledProcessError):
            continue
    return None


def library_path() -> Path:
    """Where the library of the current source lives (keyed by the hash of
    the source and the flags)."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"libwukong_native-{digest}.so"


def get_lib():
    """Load (building if needed) the native library; None when unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            so = library_path()
            if not so.exists():
                cc = _compiler()
                if cc is None:
                    return None
                BUILD.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run([cc, *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                               check=True, capture_output=True)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            lib.parse_id_triples.restype = ctypes.c_long
            lib.parse_id_triples.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_long]
            lib.build_bucket_table.restype = ctypes.c_int
            lib.build_bucket_table.argtypes = [
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_long,
                ctypes.c_long, ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32)]
            lib.sort_triples.restype = None
            lib.sort_triples.argtypes = [
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_long,
                ctypes.POINTER(ctypes.c_int64)]
            lib.sort_triples32.restype = None
            lib.sort_triples32.argtypes = [
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_long,
                ctypes.POINTER(ctypes.c_int32)]
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            _lib = None
    return _lib


def _ptr64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _ptr32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


# ---------------------------------------------------------------------------
# public entry points (numpy fallback inside)
# ---------------------------------------------------------------------------


def parse_id_triples(path: str) -> np.ndarray:
    """Parse one 's\\tp\\to' text file into an [N,3] int64 array."""
    lib = get_lib()
    if lib is None:
        _count("parse_id_triples", "numpy")
        arr = np.loadtxt(path, dtype=np.int64, ndmin=2)
        return arr.reshape(-1, 3) if arr.size else np.empty((0, 3), np.int64)
    _count("parse_id_triples", "native")
    # size guess: ~12 bytes/triple lower bound
    cap = max(os.path.getsize(path) // 6 + 16, 16)
    while True:
        s = np.empty(cap, dtype=np.int64)
        p = np.empty(cap, dtype=np.int64)
        o = np.empty(cap, dtype=np.int64)
        n = lib.parse_id_triples(path.encode(), _ptr64(s), _ptr64(p),
                                 _ptr64(o), cap)
        if n == -2:
            raise ValueError(f"malformed id-triple line in {path}")
        if n < 0:
            raise OSError(f"native parse failed for {path}")
        if n <= cap:
            return np.stack([s[:n], p[:n], o[:n]], axis=1)
        cap = n


def build_bucket_table_native(keys: np.ndarray, offsets: np.ndarray,
                              num_buckets: int):
    """Native 8-way bucket placement (bit-identical to the numpy rounds of
    engine/device_store.build_hash_table); None when unavailable/failed,
    and the caller takes the numpy rounds."""
    lib = get_lib()
    if lib is None or len(keys) == 0:
        _count("build_bucket_table_native", "numpy")
        return None
    k = np.ascontiguousarray(keys, dtype=np.int64)
    off = np.ascontiguousarray(offsets, dtype=np.int64)
    bkey = np.empty((num_buckets, 8), dtype=np.int32)
    bstart = np.empty((num_buckets, 8), dtype=np.int32)
    bdeg = np.empty((num_buckets, 8), dtype=np.int32)
    mp = lib.build_bucket_table(_ptr64(k), _ptr64(off), len(k), num_buckets,
                                _ptr32(bkey), _ptr32(bstart), _ptr32(bdeg))
    if mp < 0:
        _count("build_bucket_table_native", "numpy")
        return None
    _count("build_bucket_table_native", "native")
    return bkey, bstart, bdeg, int(mp)


def sort_triples_perm(primary: np.ndarray, secondary: np.ndarray,
                      tertiary: np.ndarray) -> np.ndarray | None:
    """Radix argsort by (primary, secondary, tertiary); None if unavailable.

    int32 columns take the native int32 path (int32 perm and scratch). Ids
    are non-negative by the store contract (check_vid_range), so unsigned
    radix digits agree with signed order in both widths. The sort is
    stable, so the permutation equals ``np.lexsort``'s."""
    lib = get_lib()
    if lib is None:
        _count("sort_triples_perm", "numpy")
        return None
    _count("sort_triples_perm", "native")
    n = len(primary)
    if (n < 2**31 - 1
            and primary.dtype == secondary.dtype == tertiary.dtype
            and primary.dtype == np.int32):
        perm = np.empty(n, dtype=np.int32)
        lib.sort_triples32(
            _ptr32(np.ascontiguousarray(tertiary, np.int32)),
            _ptr32(np.ascontiguousarray(secondary, np.int32)),
            _ptr32(np.ascontiguousarray(primary, np.int32)),
            n, _ptr32(perm))
        return perm
    perm = np.empty(n, dtype=np.int64)
    lib.sort_triples(
        _ptr64(np.ascontiguousarray(tertiary, np.int64)),
        _ptr64(np.ascontiguousarray(secondary, np.int64)),
        _ptr64(np.ascontiguousarray(primary, np.int64)),
        n, _ptr64(perm))
    return perm
