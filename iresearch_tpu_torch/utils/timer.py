"""Registered scoped timers (reference: core/utils/timer_utils.hpp:42-127).

The reference registers named timers that aggregate (count, total ns) per name
and can be flushed for benchmark reporting; the CLI drivers rely on this for
per-category query timing. Same contract here, as a context manager.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, Tuple


class TimerRegistry:
    """Aggregates (count, total_ns) per timer name; thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stats: Dict[str, Tuple[int, int]] = {}

    @contextmanager
    def scoped(self, name: str) -> Iterator[None]:
        start = time.perf_counter_ns()
        try:
            yield
        finally:
            elapsed = time.perf_counter_ns() - start
            with self._lock:
                count, total = self._stats.get(name, (0, 0))
                self._stats[name] = (count + 1, total + elapsed)

    def visit(self, visitor: Callable[[str, int, int], bool]) -> bool:
        """Call ``visitor(name, count, total_ns)`` per timer; stop on False."""
        with self._lock:
            snapshot = dict(self._stats)
        for name, (count, total) in snapshot.items():
            if not visitor(name, count, total):
                return False
        return True

    def stats(self) -> Dict[str, Tuple[int, int]]:
        with self._lock:
            return dict(self._stats)

    def flush_stats(self) -> Dict[str, Tuple[int, int]]:
        """Return and reset the aggregated stats (reference: flush_stats)."""
        with self._lock:
            snapshot = dict(self._stats)
            self._stats.clear()
        return snapshot


_registry = TimerRegistry()


def registry() -> TimerRegistry:
    return _registry


def scoped_timer(name: str):
    """``with scoped_timer("indexing.flush"): ...`` (SCOPED_TIMER analog)."""
    return _registry.scoped(name)
