"""Hashing helpers (reference: utils/math.hpp).

``hash_mod`` is the load-balancing primitive used to place a vertex on a worker
(math.hpp:51, used by gstore.hpp:301 and base_loader.hpp:172-173). The rebuild
keeps the same function so partition assignment is deterministic and matches
between the host loader, the CPU engine, and the device all-to-all shuffle.
"""

from __future__ import annotations


def hash_mod(v, n: int):
    """Partition id of vertex v among n workers. Works on scalars and arrays."""
    return v % n


def hash_u64(key: int) -> int:
    """Invertible 64-bit mix (math.hpp:58-80, Lemire-style). Stats.generate
    mixes predicate ids with it into out-predicate-set signatures."""
    key = (~key + (key << 21)) & 0xFFFFFFFFFFFFFFFF
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & 0xFFFFFFFFFFFFFFFF
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & 0xFFFFFFFFFFFFFFFF
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & 0xFFFFFFFFFFFFFFFF
    return key
