"""Leveled logger (reference: utils/logger2.hpp — 8 levels, runtime-settable).

The port's copy of the JAX package's utils/logger.py. The console command
``logger <level>`` sets the level at runtime. Lines go to stderr.
"""

from __future__ import annotations

import sys
import time

# reference levels (logger2.hpp:112-119)
LOG_EVERYTHING = 0
LOG_DEBUG = 1
LOG_INFO = 2
LOG_EMPH = 3
LOG_WARNING = 4
LOG_ERROR = 5
LOG_FATAL = 6
LOG_NONE = 7

_LEVEL_NAMES = {
    LOG_EVERYTHING: "ALL",
    LOG_DEBUG: "DEBUG",
    LOG_INFO: "INFO",
    LOG_EMPH: "EMPH",
    LOG_WARNING: "WARN",
    LOG_ERROR: "ERROR",
    LOG_FATAL: "FATAL",
}

_COLORS = {
    LOG_DEBUG: "\033[36m",
    LOG_INFO: "",
    LOG_EMPH: "\033[1;32m",
    LOG_WARNING: "\033[1;33m",
    LOG_ERROR: "\033[1;31m",
    LOG_FATAL: "\033[1;41m",
}
_RESET = "\033[0m"

_current_level = LOG_INFO
_t0 = time.time()


def set_log_level(level: int) -> None:
    global _current_level
    _current_level = int(level)


def get_log_level() -> int:
    return _current_level


def _write(level: int, msg: str) -> None:
    if level < _current_level:
        return
    name = _LEVEL_NAMES.get(level, "?")
    color = _COLORS.get(level, "") if sys.stderr.isatty() else ""
    reset = _RESET if color else ""
    ts = time.time() - _t0
    sys.stderr.write(f"{color}[{ts:9.3f}s {name:5s}]{reset} {msg}\n")


def log_debug(msg: str) -> None:
    _write(LOG_DEBUG, msg)


def log_info(msg: str) -> None:
    _write(LOG_INFO, msg)


def log_warn(msg: str) -> None:
    _write(LOG_WARNING, msg)


def log_error(msg: str) -> None:
    _write(LOG_ERROR, msg)
