"""Microsecond timer (reference: utils/timer.hpp:28-62); the port's copy of
the JAX package's utils/timer.py."""

from __future__ import annotations

import time


def get_usec() -> int:
    return time.perf_counter_ns() // 1000


class StopWatch:
    def __init__(self):
        self.start = get_usec()

    def elapsed_usec(self) -> int:
        return get_usec() - self.start

    def restart(self) -> int:
        now = get_usec()
        dt = now - self.start
        self.start = now
        return dt
