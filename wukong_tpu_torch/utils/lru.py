"""Shared bounded-LRU cache helper.

Eviction is least-recently-*used*: ``get`` refreshes recency, ``put`` evicts
the coldest entry once ``maxsize`` is exceeded. Thread-safe: all operations
hold one lock (the payloads are small and the operations are dict moves).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

_MISS = object()


class LRUCache:
    """Bounded mapping with least-recently-used eviction."""

    def __init__(self, maxsize: int = 1024):
        self.maxsize = max(int(maxsize), 1)
        self._d: OrderedDict = OrderedDict()  # guarded by: _lock
        self._lock = threading.Lock()

    def get(self, key, default=None):
        with self._lock:
            v = self._d.get(key, _MISS)
            if v is _MISS:
                return default
            self._d.move_to_end(key)
            return v

    def put(self, key, value) -> None:
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)

    def pop(self, key, default=None):
        with self._lock:
            return self._d.pop(key, default)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def items(self) -> list:
        """A snapshot of the (key, value) pairs, coldest first."""
        with self._lock:
            return list(self._d.items())
