"""The program's own spans in the traced slice, for the per-layer metrics
that read them (``layer_metrics/*``).

The program records its steps (``iresearch_tpu_torch/utils/timer.py:
span``: name, start and end on ``time.perf_counter_ns``, the enclosing
span, attributes such as ``hit``) while a ``torch.profiler`` session
records, so in a traced run it records the slice and nothing else.
``of(ctx)`` takes them once a run (``take_spans``, kept in
``ctx.objects``), groups them into the slice's requests and places them
on the profiler's clock; it returns None where the program records no
spans (one without ``take_spans``), so that its readers report nothing.

Requests: the slice starts and stops between requests, so each request's
first top-level span has one name (``batch.init`` in the fresh driver,
``batch.run`` in the replay driver) and a span of that name starts each
request; the program's spans of a request are those from its first span
to the next request's, on the program's own clock. Placement: the
harness's spans (``Context.span``) lie on the same host clock before
``benchmark/trace.py`` moves them onto the profiler's, and each
request's first harness span (``prepare``, ``run``) opens just before
its first program span. The shift is the median over the requests of
the difference between the two starts; the spread of those differences
(max - min) is the alignment's error, logged.

Idle time is put down to the innermost program span that covers it: each
span's own time is its interval less its children's. ``of`` logs that
breakdown once a run, with the program's cache counters
(``plan_cache_stats``, ``fused_cache_stats``: the whole run's, set-up
included).
"""

from __future__ import annotations

import bisect
import statistics
from collections import Counter
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

KEY = "program_spans"


class Placed(NamedTuple):
    name: str
    start: float  # s, on the profiler's clock
    end: float
    parent: int  # index in ``Spans.all``, -1 for none
    attrs: dict


class Spans:
    """The slice's program spans: ``all`` in start order, ``requests`` the
    indices of each request's spans, ``harness`` each request's harness
    spans (name, start s, end s), the shift (the median of the requests'
    differences ``diffs``), its error (their max - min) and their
    quartiles, in s, and the count dropped past the program's buffer."""

    def __init__(self, all_: List[Placed], requests: List[List[int]],
                 harness: List[List[Tuple[str, float, float]]],
                 diffs: List[float], dropped: int) -> None:
        self.all, self.requests, self.harness = all_, requests, harness
        self.shift, self.error, self.dropped = statistics.median(diffs), max(diffs) - min(diffs), dropped
        self.quartiles = statistics.quantiles(diffs, n=4) if len(diffs) > 1 else diffs * 3

    def median_ms(self, names: Sequence[str]) -> Optional[float]:
        """The median over the requests of each request's summed ms of
        the spans named ``names``."""
        if not self.requests:
            return None
        return 1e3 * statistics.median(
            sum(self.all[i].end - self.all[i].start for i in req if self.all[i].name in names)
            for req in self.requests)

    def hit_pct(self, name: str) -> Optional[float]:
        """The share of the spans named ``name`` whose ``hit`` is true, in %."""
        hits = [bool(s.attrs.get("hit")) for s in self.all if s.name == name]
        return 100.0 * sum(hits) / len(hits) if hits else None

    def own_intervals(self) -> List[Tuple[float, float, str]]:
        """(start, end, name) of each span's own time: its interval less
        its children's."""
        children: Dict[int, List[int]] = {}
        for i, s in enumerate(self.all):
            if s.parent >= 0:
                children.setdefault(s.parent, []).append(i)
        out = []
        for i, s in enumerate(self.all):
            t = s.start
            for c in children.get(i, ()):
                if self.all[c].start > t:
                    out.append((t, self.all[c].start, s.name))
                t = max(t, self.all[c].end)
            if s.end > t:
                out.append((t, s.end, s.name))
        return out

    def idle_by_span(self, busy: List[Tuple[float, float]]) -> Counter:
        """Idle device seconds by the innermost program span over them,
        ``busy`` the union of the device's intervals (sorted)."""
        idle = [(busy[j][1], busy[j + 1][0]) for j in range(len(busy) - 1)]
        if busy:
            idle = [(float("-inf"), busy[0][0])] + idle + [(busy[-1][1], float("inf"))]
        starts = [a for a, _b in idle]
        by = Counter()
        for a, b, name in self.own_intervals():
            j = max(0, bisect.bisect_right(starts, a) - 1)
            while j < len(idle) and idle[j][0] < b:
                lo, hi = max(a, idle[j][0]), min(b, idle[j][1])
                if hi > lo:
                    by[name] += hi - lo
                j += 1
        return by


def _group(harness_spans) -> List[List[Tuple[str, float, float]]]:
    """The harness's spans of each request, split where the first span's
    name recurs."""
    spans = sorted(harness_spans, key=lambda s: s[1])
    out: List[list] = []
    for s in spans:
        if not out or s[0] == spans[0][0]:
            out.append([])
        out[-1].append(s)
    return out


def place(spans, dropped: int, harness_spans, log=None) -> Optional[Spans]:
    """``Spans`` of the program's ``spans`` (``timer.Span``, on the host's
    clock) over the harness's ``harness_spans`` (name, start s, end s on
    the profiler's clock); None where either is empty."""
    roots = [i for i, s in enumerate(spans) if s.parent < 0]
    harness = _group(harness_spans)
    if not roots or not harness:
        return None
    first = spans[roots[0]].name
    starts = [i for i in roots if spans[i].name == first]
    n = min(len(starts), len(harness))
    if log is not None and len(starts) != len(harness):
        log(f"program spans: {len(starts)} requests against the harness's {len(harness)}; "
            f"the first {n} paired")
    diffs = [harness[r][0][1] - spans[starts[r]].start_ns * 1e-9 for r in range(n)]
    shift = statistics.median(diffs)
    requests: List[List[int]] = [[] for _ in range(n)]
    out, r = [], -1
    for i, s in enumerate(spans):
        if r + 1 < len(starts) and i == starts[r + 1]:
            r += 1
        out.append(Placed(s.name, s.start_ns * 1e-9 + shift, s.end_ns * 1e-9 + shift,
                          s.parent, s.attrs))
        if 0 <= r < n:
            requests[r].append(i)
    return Spans(out, requests, harness[:n], diffs, dropped)


def of(ctx) -> Optional[Spans]:
    """The run's program spans, taken and placed on the first call (and
    the breakdown logged), or None where there are none to read."""
    if KEY in ctx.objects:
        return ctx.objects[KEY]
    ctx.objects[KEY] = None
    from iresearch_tpu_torch.utils import timer

    take = getattr(timer, "take_spans", None)
    if take is None or ctx.trace is None:
        return None
    spans, dropped = take()
    ps = ctx.objects[KEY] = place(spans, dropped, ctx.trace.spans, ctx.log)
    if ps is not None:
        log_breakdown(ps, ctx.trace, ctx.log)
    from iresearch_tpu_torch.exec import batch, plancache

    ctx.log(f"program counters since the process started: plan cache "
            f"{plancache.plan_cache_stats()}, fused passes {batch.fused_cache_stats()}")
    return ps


def log_breakdown(ps: Spans, trace, log) -> None:
    """The alignment, each harness span's mean ms and the share of it
    under each program span name, and the slice's idle seconds by
    innermost program span."""
    quartiles = ", ".join(f"{1e6 * (q - ps.shift):.2f}" for q in ps.quartiles)
    log(f"program spans: {len(ps.all)} in {len(ps.requests)} requests, {ps.dropped} dropped; "
        f"shift {ps.shift:.6f} s, alignment error {1e6 * ps.error:.2f} us (the differences' "
        f"quartiles less their median: {quartiles} us)")
    total: Counter = Counter()
    under: Dict[str, Counter] = {}
    for req, harness in zip(ps.requests, ps.harness):
        for hname, a, b in harness:
            total[hname] += b - a
            c = under.setdefault(hname, Counter())
            for i in req:
                s = ps.all[i]
                if a <= 0.5 * (s.start + s.end) <= b:
                    c[s.name] += s.end - s.start
                    if s.parent < 0:
                        c["(top-level)"] += s.end - s.start
    n = max(1, len(ps.harness))
    for hname, t in total.items():
        shares = ", ".join(f"{name} {100 * s / t:.1f}%"
                           for name, s in under[hname].most_common()) or "none"
        log(f"harness span {hname}: mean {1e3 * t / n:.4f} ms; under program spans: {shares}")
    busy = trace.union()
    if not busy:
        return
    idle = ps.idle_by_span(busy)
    in_program = sum(idle.values())
    log(f"idle device s of the slice ({trace.window_s - trace.busy_s():.6f} s): "
        f"{in_program:.6f} under program spans; by innermost span: "
        + ", ".join(f"{name} {s:.6f}" for name, s in idle.most_common()))


def idle_in_program_pct(ctx) -> Optional[float]:
    """The device's idle time that lies under any program span, over the
    slice's wall time, in %."""
    ps = of(ctx)
    tr = ctx.trace
    if ps is None or not tr.ops:
        return None
    return 100.0 * sum(ps.idle_by_span(tr.union()).values()) / tr.window_s
