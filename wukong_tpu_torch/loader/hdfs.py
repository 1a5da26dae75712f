"""HDFS dataset source — the hdfs_loader.hpp analogue.

The reference gates an HDFS-backed loader behind USE_HADOOP and wraps libhdfs
(core/loader/hdfs_loader.hpp:28-58 lists a directory and opens istreams over
it; utils/hdfs.hpp holds the C-API RAII glue). This package links no
libhdfs; it reaches HDFS through the ``hdfs`` CLI instead
(`hdfs dfs -ls/-get`): same capability surface — list an HDFS dataset
directory, fetch its id/attr/string files — without a native dependency.
Availability is probed once; everything degrades to a clean WukongError when
no client is installed (the reference fails at build time instead).

The fetched files land in a local staging directory and flow through the
standard POSIX pipeline (loader/base.py), so HDFS datasets get chunked-npy
support for free.

The port's copy of the JAX package's loader/hdfs.py: the same client
commands, staging layout and errors.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

from wukong_tpu_torch.utils.errors import ErrorCode, WukongError
from wukong_tpu_torch.utils.logger import log_info

_state: dict = {"cmd": None, "probed": False}


def _hdfs_cmd() -> list[str] | None:
    """Resolve the HDFS client command once. WUKONG_HDFS_CMD overrides (e.g.
    "hadoop fs"); otherwise `hdfs` must be on PATH."""
    if not _state["probed"]:
        _state["probed"] = True
        override = os.environ.get("WUKONG_HDFS_CMD")
        if override:
            _state["cmd"] = override.split()
        elif shutil.which("hdfs"):
            _state["cmd"] = ["hdfs", "dfs"]
    return _state["cmd"]


def hdfs_available() -> bool:
    return _hdfs_cmd() is not None


def _run(args: list[str]) -> str:
    """One HDFS CLI invocation through the resilience layer: transient
    failures (non-zero exit, client timeout, injected chaos at the
    ``hdfs.read`` fault site) retry with exponential backoff + jitter; only
    after the attempts are spent does the clean WukongError surface."""
    from wukong_tpu_torch.runtime import faults
    from wukong_tpu_torch.runtime.resilience import retry_call
    from wukong_tpu_torch.utils.errors import RetryExhausted

    cmd = _hdfs_cmd()
    if cmd is None:
        raise WukongError(
            ErrorCode.FILE_NOT_FOUND,
            "no HDFS client: install an `hdfs` CLI or set WUKONG_HDFS_CMD")

    def attempt():
        faults.site("hdfs.read")
        return subprocess.run(
            cmd + args, check=True, capture_output=True,
            timeout=int(os.environ.get("WUKONG_HDFS_TIMEOUT", "600")))

    try:
        r = retry_call(attempt, site="hdfs.read",
                       retry_on=(faults.TransientFault,
                                 subprocess.CalledProcessError,
                                 subprocess.TimeoutExpired, OSError))
    except RetryExhausted as e:
        last = e.last
        if isinstance(last, subprocess.CalledProcessError):
            raise WukongError(
                ErrorCode.FILE_NOT_FOUND,
                f"hdfs {' '.join(args)} failed: "
                f"{last.stderr.decode()[-200:]}")
        if isinstance(last, subprocess.TimeoutExpired):
            raise WukongError(ErrorCode.FILE_NOT_FOUND,
                              f"hdfs {' '.join(args)} timed out")
        raise WukongError(ErrorCode.FILE_NOT_FOUND,
                          f"hdfs {' '.join(args)} failed: {last!r}")
    return r.stdout.decode()


def list_dir(hdfs_dir: str) -> list[str]:
    """FILE paths directly under an HDFS directory (playing
    hdfs_loader.hpp:33-45's list_files role). Parses full `-ls` output so
    directories can be skipped — `-ls -C` prints both, and `-get` on a
    directory copies it recursively, leaving a subdirectory the flat POSIX
    staging pipeline does not expect."""
    out = _run(["-ls", hdfs_dir])
    paths = []
    for ln in out.splitlines():
        # permission-string lines: "-rw-r--r-- 3 user grp size date time path";
        # bounded split keeps paths containing spaces intact
        parts = ln.split(None, 7)
        if len(parts) == 8 and parts[0][0] == "-":
            paths.append(parts[7])
    return paths


# files the POSIX pipeline understands (loader/base.py + string_server +
# planner statfile persistence)
_WANTED_PREFIXES = ("id_", "attr_", "str_", "host", "statfile", "preshard")
_WANTED_SUFFIXES = (".nt", ".npy", ".json")


def fetch_dataset(hdfs_dir: str, local_dir: str | None = None) -> str:
    """Stage an HDFS dataset directory locally; returns the staging path.

    Only dataset files are fetched (id/attr triples, string maps, planner
    statfile, preshard metadata). Repeated calls reuse a warm staging dir
    keyed by a hash of the HDFS path (collision-free across datasets), so
    console `load -d hdfs://...` after a restart is cheap. Files download to
    a temp name and rename on success — an interrupted fetch never poisons
    the warm cache. The staging root is per-user and mode 0700.
    """
    if local_dir is None:
        import getpass
        import hashlib

        tag = hashlib.sha256(hdfs_dir.encode()).hexdigest()[:16]
        root = os.path.join(tempfile.gettempdir(),
                            f"wukong_hdfs_{getpass.getuser()}")
        os.makedirs(root, mode=0o700, exist_ok=True)
        st = os.stat(root)  # refuse a pre-planted root (0700 only applies
        if st.st_uid != os.getuid() or (st.st_mode & 0o077):  # on creation)
            raise WukongError(
                ErrorCode.FILE_NOT_FOUND,
                f"staging root {root} is not owned by this user with mode "
                "0700 — remove it or pass an explicit local_dir")
        local_dir = os.path.join(root, tag)
    os.makedirs(local_dir, exist_ok=True)
    fetched = have = 0
    for path in list_dir(hdfs_dir):
        name = os.path.basename(path)
        if not (name.startswith(_WANTED_PREFIXES)
                or name.endswith(_WANTED_SUFFIXES)):
            continue
        dst = os.path.join(local_dir, name)
        if os.path.exists(dst):
            have += 1
            continue  # warm cache; delete the staging dir to force re-fetch
        tmp = dst + ".part"
        try:
            _run(["-get", path, tmp])
            os.replace(tmp, dst)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        fetched += 1
    if fetched + have == 0:
        raise WukongError(
            ErrorCode.FILE_NOT_FOUND,
            f"{hdfs_dir} holds no dataset files (id_*/attr_*/str_* ...)")
    log_info(f"hdfs: staged {fetched} files ({have} warm) "
             f"from {hdfs_dir} -> {local_dir}")
    return local_dir


def is_hdfs_path(path: str) -> bool:
    return path.startswith("hdfs://")


def resolve_dataset_dir(path: str) -> str:
    """Local path passthrough; hdfs:// paths are staged first. The single
    entry point console/proxy use so every loader API accepts either."""
    if is_hdfs_path(path):
        return fetch_dataset(path)
    return path
