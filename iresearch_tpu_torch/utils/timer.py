"""Registered scoped timers (reference: core/utils/timer_utils.hpp:42-127),
and the query path's spans.

The reference registers named timers that aggregate (count, total ns) per name
and can be flushed for benchmark reporting; the CLI drivers rely on this for
per-category query timing. Same contract here, as a context manager.

``span(name, **attrs)`` marks one step of the query path (``exec/``) and
``note(**attrs)`` adds attributes to the innermost open span. Spans are
recorded only while a ``torch.profiler`` session records, so whoever
profiles the process gets the program's steps beside the device's
operations; otherwise ``span`` returns one shared no-op context manager.
``take_spans()`` returns what was recorded (``Span``: name, start and end
on ``time.perf_counter_ns``, the enclosing span's index, attributes) and
clears the buffer, which holds at most ``SPAN_CAPACITY`` spans.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List, NamedTuple, Tuple

from torch.autograd import profiler as _autograd_profiler


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


# --- spans of the query path --------------------------------------------------

SPAN_CAPACITY = 1 << 20


class Span(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns
    end_ns: int
    parent: int  # index of the span open on the same thread at the start, -1 for none
    attrs: dict


class _NoSpan:
    """What ``span`` returns while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


_NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("rec", "stack")

    def __init__(self, rec: list, stack: list) -> None:
        self.rec, self.stack = rec, stack

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.rec[2] = time.perf_counter_ns()
        self.stack.pop()


class _Stacks(threading.local):
    def __init__(self) -> None:
        self.stack: List[list] = []  # this thread's open spans' records


class SpanRecorder:
    """A bounded in-memory buffer of spans: each thread nests its own, a
    span past ``capacity`` is dropped and counted. Records are lists
    ``[name, start, end, parent record, attrs]`` until ``take``."""

    def __init__(self, capacity: int = SPAN_CAPACITY) -> None:
        self.capacity = capacity
        self._records: List[list] = []
        self._dropped = 0
        self._lock = threading.Lock()  # the drop count and ``take``
        self._local = _Stacks()

    def span(self, name: str, **attrs):
        """A context manager that records the block as span ``name`` while
        a ``torch.profiler`` session records, else a shared no-op."""
        if not _autograd_profiler._is_profiler_enabled:
            return _NO_SPAN
        stack = self._local.stack
        rec = [name, time.perf_counter_ns(), 0, stack[-1] if stack else None, attrs]
        records = self._records
        if len(records) < self.capacity:
            records.append(rec)
        else:  # dropped: still opened, so that its notes stay its own
            with self._lock:
                self._dropped += 1
        stack.append(rec)
        return _OpenSpan(rec, stack)

    def note(self, **attrs) -> None:
        """Add ``attrs`` to this thread's innermost open span, if any."""
        if _autograd_profiler._is_profiler_enabled:
            stack = self._local.stack
            if stack:
                stack[-1][4].update(attrs)

    def take(self) -> Tuple[List[Span], int]:
        """(the spans recorded since the last take, in the order they
        started; how many were dropped past ``capacity``), the buffer
        cleared. Call it with no span open."""
        with self._lock:
            records, self._records = self._records, []
            dropped, self._dropped = self._dropped, 0
        index = {id(r): i for i, r in enumerate(records)}
        return [
            Span(name, a, b, -1 if p is None else index.get(id(p), -1), attrs)
            for name, a, b, p, attrs in records
        ], dropped


_spans = SpanRecorder()
# ``with span("batch.run", kind=...): ...``, ``note(hit=True)``,
# ``take_spans()``: the process's recorder, bound for the hot path
span = _spans.span
note = _spans.note
take_spans = _spans.take
