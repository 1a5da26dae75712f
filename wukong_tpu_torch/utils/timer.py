"""Microsecond timer (reference: utils/timer.hpp:28-62); the port's copy of
the JAX package's utils/timer.py."""

from __future__ import annotations

import time


def get_usec() -> int:
    return time.perf_counter_ns() // 1000
