"""Partition placement helper (reference: utils/math.hpp).

``hash_mod`` is the load-balancing primitive used to place a vertex on a worker
(math.hpp:51, used by gstore.hpp:301 and base_loader.hpp:172-173). The rebuild
keeps the same function so partition assignment is deterministic and matches
between the host loader, the CPU engine, and the device all-to-all shuffle.
"""

from __future__ import annotations


def hash_mod(v, n: int):
    """Partition id of vertex v among n workers. Works on scalars and arrays."""
    return v % n
