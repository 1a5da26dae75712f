"""Thread→core binding (reference: core/bind.hpp).

The reference discovers the NUMA topology with hwloc (load_node_topo,
bind.hpp:81-127), builds a default one-core-per-thread assignment, optionally
overrides it from a `core.bind` file (one NUMA node per line, thread ids
listed in binding order — bind.hpp:129-169), and pins each proxy/engine
pthread with sched_setaffinity (bind.hpp:171-183).

Here the host runtime is a Python thread pool (runtime/scheduler.py), but the
semantics are the same: discover nodes from sysfs (`/sys/devices/system/node`),
map engine tids to cores (default round-robin, or a user `core.bind` file with
the reference's format), and pin via `os.sched_setaffinity` — a direct wrapper
over the same syscall hwloc uses. On hosts without the syscall (macOS) or with
a single core the binder degrades to a no-op, matching the reference's
`enable_binding` gate (bind.hpp:68).

The port's copy of the JAX package's runtime/bind.py: the engine pool's
threads call ``get_binder().bind_thread(tid)`` as they start, and the
console's ``-b/--bind core.bind`` loads a binding file.
"""

from __future__ import annotations

import glob
import os
import re

from wukong_tpu_torch.utils.logger import log_debug, log_error, log_warn

_HAS_AFFINITY = hasattr(os, "sched_setaffinity")


def _parse_cpulist(text: str) -> list[int]:
    """Parse a sysfs cpulist ("0-3,8,10-11") into a sorted core list."""
    cores: list[int] = []
    for part in text.strip().split(","):
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-", 1)
            cores.extend(range(int(lo), int(hi) + 1))
        else:
            cores.append(int(part))
    return cores


class CoreBinder:
    """NUMA topology + tid→core map + setaffinity pinning."""

    def __init__(self):
        self.cpu_topo: list[list[int]] = []  # per-NUMA-node core lists
        self.default_bindings: list[int] = []  # flat node-major core order
        self.core_bindings: dict[int, int] = {}  # user tid -> core
        self.enabled = False
        self.load_node_topo()

    # -- topology ------------------------------------------------------
    def load_node_topo(self) -> None:
        """Discover NUMA nodes from sysfs; fall back to one flat node built
        from the process affinity mask (the hwloc PU fallback,
        bind.hpp:108-122)."""
        self.cpu_topo = []
        self.default_bindings = []
        nodes = sorted(glob.glob("/sys/devices/system/node/node[0-9]*"),
                       key=lambda p: int(re.search(r"(\d+)$", p).group(1)))
        usable = (set(os.sched_getaffinity(0)) if _HAS_AFFINITY
                  else set(range(os.cpu_count() or 1)))
        for nd in nodes:
            try:
                with open(os.path.join(nd, "cpulist")) as f:
                    cores = [c for c in _parse_cpulist(f.read()) if c in usable]
            except OSError:
                continue
            if cores:
                self.cpu_topo.append(cores)
        if not self.cpu_topo:
            self.cpu_topo = [sorted(usable)]
        for node in self.cpu_topo:
            self.default_bindings.extend(node)
        log_debug(f"TOPO: {len(self.cpu_topo)} nodes, "
                  f"{len(self.default_bindings)} cores")

    @property
    def num_cores(self) -> int:
        return len(self.default_bindings)

    # -- binding file --------------------------------------------------
    def load_core_binding(self, fname: str) -> bool:
        """`core.bind` format (bind.hpp:129-169): one NUMA node per line;
        the numbers are THREAD ids in binding order, mapped onto that node's
        cores round-robin. '#' lines are comments."""
        try:
            f = open(fname)
        except OSError:
            log_error(f"{fname} does not exist.")
            return False
        nnodes = len(self.cpu_topo)
        node_i = 0
        nbs = 0
        with f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                cores = self.cpu_topo[node_i % nnodes]
                for j, tok in enumerate(line.split()):
                    self.core_bindings[int(tok)] = cores[j % len(cores)]
                    nbs += 1
                node_i += 1
        if node_i < nnodes:
            log_warn("core.bind does not use all NUMA nodes")
        elif node_i > nnodes:
            log_warn("core.bind exceeds the number of NUMA nodes")
        from wukong_tpu_torch.config import Global

        if nbs < getattr(Global, "num_engines", 0):
            log_warn("#engines (config) exceeds #bindings (core.bind)")
        self.enabled = True
        return True

    def core_of(self, tid: int) -> int | None:
        """Core for thread tid: user map first, else default round-robin."""
        if not self.default_bindings:
            return None
        if tid in self.core_bindings:
            return self.core_bindings[tid]
        return self.default_bindings[tid % len(self.default_bindings)]

    # -- pinning -------------------------------------------------------
    def bind_to_core(self, core: int) -> bool:
        """Pin the CURRENT thread to one core (bind.hpp:171-183)."""
        if not _HAS_AFFINITY:
            return False
        try:
            os.sched_setaffinity(0, {core})
            return True
        except OSError as e:
            log_error(f"failed to set affinity (core {core}): {e}")
            return False

    def bind_thread(self, tid: int) -> bool:
        """Pin the current thread according to tid's assignment; no-op when
        binding is disabled or the host has a single usable core."""
        if not self.enabled or self.num_cores <= 1:
            return False
        core = self.core_of(tid)
        return core is not None and self.bind_to_core(core)

    def bind_to_all(self) -> bool:
        """Release the current thread to every discovered core (the
        unbind path, bind.hpp:194-205)."""
        if not _HAS_AFFINITY or not self.default_bindings:
            return False
        try:
            os.sched_setaffinity(0, set(self.default_bindings))
            return True
        except OSError as e:
            log_error(f"failed to reset affinity: {e}")
            return False

    def get_core_binding(self) -> set[int]:
        return set(os.sched_getaffinity(0)) if _HAS_AFFINITY else set()

    def unbind_to_core(self) -> set[int]:
        """Record + release the current binding (bind.hpp:207-216)."""
        prev = self.get_core_binding()
        self.bind_to_all()
        return prev


_binder: CoreBinder | None = None


def get_binder() -> CoreBinder:
    global _binder
    if _binder is None:
        _binder = CoreBinder()
    return _binder
