"""Leveled callback logger (reference: core/utils/log.hpp:33-60).

The reference exposes a process-wide leveled logger with a pluggable callback;
we wrap :mod:`logging` behind the same shape so embedders can redirect output.
"""

from __future__ import annotations

import logging
from enum import IntEnum
from typing import Callable, Optional


class Level(IntEnum):
    FATAL = 0
    ERROR = 1
    WARN = 2
    INFO = 3
    DEBUG = 4
    TRACE = 5


_PY_LEVELS = {
    Level.FATAL: logging.CRITICAL,
    Level.ERROR: logging.ERROR,
    Level.WARN: logging.WARNING,
    Level.INFO: logging.INFO,
    Level.DEBUG: logging.DEBUG,
    Level.TRACE: logging.DEBUG,
}

_logger = logging.getLogger("iresearch_tpu")
_callback: Optional[Callable[[Level, str], None]] = None


def set_callback(cb: Optional[Callable[[Level, str], None]]) -> None:
    """Install a log sink; ``None`` restores the default stdlib logger."""
    global _callback
    _callback = cb


def log(level: Level, msg: str, *args) -> None:
    if args:
        msg = msg % args
    if _callback is not None:
        _callback(level, msg)
    else:
        _logger.log(_PY_LEVELS[level], msg)


def info(msg: str, *args) -> None:
    log(Level.INFO, msg, *args)


def warn(msg: str, *args) -> None:
    log(Level.WARN, msg, *args)


def error(msg: str, *args) -> None:
    log(Level.ERROR, msg, *args)


def debug(msg: str, *args) -> None:
    log(Level.DEBUG, msg, *args)
