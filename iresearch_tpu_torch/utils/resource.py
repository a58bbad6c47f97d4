"""Cooperative memory accounting (reference: core/resource_manager.hpp:32-72
IResourceManager with Increase/Decrease hooks threaded through writers,
readers, and consolidations).

A ResourceManager tracks bytes per category and may veto growth by raising
ResourceLimitExceeded from a user-provided limiter. The default global
manager only counts; install a limiter to enforce budgets.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

CATEGORY_READERS = "readers"
CATEGORY_WRITERS = "writers"
CATEGORY_CONSOLIDATIONS = "consolidations"
CATEGORY_DEVICE = "device"


class ResourceLimitExceeded(MemoryError):
    pass


class ResourceManager:
    def __init__(
        self, limiter: Optional[Callable[[str, int, int], bool]] = None
    ) -> None:
        """``limiter(category, current, delta) -> allowed`` may veto."""
        self._lock = threading.Lock()
        self._used: Dict[str, int] = {}
        self._limiter = limiter

    def increase(self, category: str, nbytes: int) -> None:
        with self._lock:
            cur = self._used.get(category, 0)
            if self._limiter is not None and not self._limiter(
                category, cur, nbytes
            ):
                raise ResourceLimitExceeded(
                    f"{category}: {cur} + {nbytes} bytes rejected"
                )
            self._used[category] = cur + nbytes

    def decrease(self, category: str, nbytes: int) -> None:
        with self._lock:
            self._used[category] = max(0, self._used.get(category, 0) - nbytes)

    def used(self, category: str) -> int:
        with self._lock:
            return self._used.get(category, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._used)


_global = ResourceManager()


def manager() -> ResourceManager:
    return _global


def set_manager(m: ResourceManager) -> ResourceManager:
    global _global
    old = _global
    _global = m
    return old
