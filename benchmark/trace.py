"""The device trace of a slice of the window, read from ``torch.profiler``.

The profiler traces the device alone (CUPTI's activities, no host
operators), so that what it adds to a request stays small. ``Slice`` holds
the device's operations (kernels, copies, sets) as intervals on the
profiler's clock, the benchmark's host spans (timed on the host's clock
and moved onto the profiler's by a marker, below), the slice's wall length
and the requests it held. Busy time is the union of the device intervals,
not the sum of their lengths, so overlapping operations count once; an
idle gap is named by the host span that covers its middle (``client``
where none does: the harness between requests).

The marker: ``start`` is called between requests, with the device idle;
it launches one small fill and notes the host's clock at the launch. That
fill is the slice's first device operation, and the distance between the
two clocks is taken from it (off by the launch's few microseconds, where
the gaps it names last milliseconds).
"""

from __future__ import annotations

import time
from collections import Counter
from typing import List, NamedTuple, Optional, Tuple

Interval = Tuple[float, float]  # seconds on the profiler's clock


class Slice(NamedTuple):
    ops: List[Tuple[str, float, float]]  # (name, start s, end s) of each device op
    spans: List[Tuple[str, float, float]]  # (name, start s, end s) of host spans
    window_s: float
    requests: int

    def union(self) -> List[Interval]:
        out: List[List[float]] = []
        for _name, a, b in sorted(self.ops, key=lambda o: o[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.union())

    def op_seconds(self, part: str) -> float:
        """Summed device seconds of the operations whose name holds ``part``."""
        return sum(b - a for name, a, b in self.ops if part in name)

    def top_ops(self, n: int = 10) -> List[list]:
        by = Counter()
        for name, a, b in self.ops:
            by[name[:160]] += b - a
        return [[name, s] for name, s in by.most_common(n)]

    def idle_by_span(self, n: int = 10) -> List[list]:
        """Idle device seconds inside the slice, summed by the host span
        that covers each gap's middle."""
        busy = self.union()
        if not busy:
            return []
        t0 = min(a for _n, a, _b in self.spans) if self.spans else busy[0][0]
        t1 = max(b for _n, _a, b in self.spans) if self.spans else busy[-1][1]
        edges = [(t0, t0)] + busy + [(t1, t1)]
        spans = sorted(self.spans, key=lambda s: s[1])
        by = Counter()
        for (_a, end), (start, _b) in zip(edges, edges[1:]):
            if start <= end:
                continue
            mid = 0.5 * (end + start)
            name = "client"
            for sname, a, b in spans:
                if a > mid:
                    break
                if b >= mid:
                    name = sname
            by[name] += start - end
        return [[name, s] for name, s in by.most_common(n)]


class Profiler:
    """``torch.profiler`` of the device over a part of the window:
    ``start()`` and ``stop(requests)`` at request boundaries, the host's
    spans noted with ``span``, ``read()`` after the window."""

    def __init__(self, device) -> None:
        from torch.profiler import profile

        self.prof = profile(activities=activities(device))
        self.device = device
        self.t0 = self.t1 = self.mark = 0.0
        self.requests = 0
        self.on = False
        self.spans: List[Tuple[str, float, float]] = []  # on the host's clock

    def start(self) -> None:
        import torch

        self.prof.start()
        self.on = True
        self.t0 = time.perf_counter()
        marker = torch.empty(1, device=self.device)
        self.mark = time.perf_counter()
        marker.fill_(1.0)

    def span(self, name: str, a: float, b: float) -> None:
        self.spans.append((name, a, b))

    def stop(self, requests: int) -> None:
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.on = False
        self.requests = requests

    def read(self) -> Optional[Slice]:
        if not self.requests:
            return None
        ops = [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
               for e in self.prof.events() if e.device_type.name == "CUDA"]
        shift = min(a for _n, a, _b in ops) - self.mark if ops else 0.0
        spans = [(n, a + shift, b + shift) for n, a, b in self.spans]
        return Slice(ops, spans, self.t1 - self.t0, self.requests)


def activities(device):
    """The device's activities; the host's where the device is the CPU
    (the benchmark's tests), whose slice then holds no device operation."""
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU]


def warm_profiler(run, device) -> None:
    """Profile ``run()`` once, so that the profiler's own start-up (CUPTI)
    falls in set-up and not in the traced slice."""
    from torch.profiler import profile

    with profile(activities=activities(device)):
        run()

