"""Prepared-plan cache — the states_cache analog for serving workloads.

The reference prepares a filter once into ``filter::prepared`` holding
per-segment cached term states, then executes it cheaply many times
(core/search/filter.hpp:62-78, states_cache.hpp; index-search.cpp:705
prepares outside the timing loop). A serving workload here creates fresh
filter objects per request, so the analog is a process-wide LRU keyed by
the VALUE of the filter (filters are frozen dataclasses — structural
equality and hashing are free) plus the segment identity and compile
flags. A hit skips prepare (term lookups, stats), the plan walk, tier
selection, and WAND bound computation entirely; the plan's side-cache
(`SegmentPlan.cache`) then also reuses device uploads and skyline specs
across requests.

Correctness:
* the key includes the segment's process-unique ``serial`` — a reopened
  segment (new deletes, merged away) gets a new reader and never hits
  stale plans;
* term weights depend on INDEX-WIDE stats (idf over all segments), so
  the key includes the full segment-list identity;
* Proxy filters carry per-object cache semantics and aux plans embed
  [A, nd] host arrays — both are excluded (compile each time).

``plan_cache_stats()`` counts, since the process started, the lookups that
hit, the compiles (misses: every call that did not hit), the entries
evicted past ``_CACHE_MAX`` and the compiled plans not stored (uncacheable
filters, aux plans, plans over ``_ROW_LIMIT`` rows); ``get_plan`` also
notes ``hit`` on the open span (``utils/timer.py:note``).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

from iresearch_tpu_torch.search import filters as F
from iresearch_tpu_torch.utils.timer import note

_CACHE: "OrderedDict[tuple, object]" = OrderedDict()
_CACHE_MAX = int(os.environ.get("IRS_PLAN_CACHE_MAX", "8192"))
# plans whose row arrays exceed this many total rows are not cached
# (a hot-prefix expansion can hold ~MBs of row indices per plan)
_ROW_LIMIT = int(os.environ.get("IRS_PLAN_CACHE_ROW_LIMIT", str(1 << 20)))


_STATS = {"hits": 0, "misses": 0, "evictions": 0, "not_stored": 0}
_STATS_LOCK = threading.Lock()


def _count(name: str, n: int = 1) -> None:
    with _STATS_LOCK:
        _STATS[name] += n


def clear_plan_cache() -> None:
    _CACHE.clear()


def plan_cache_info() -> Tuple[int, int]:
    return len(_CACHE), _CACHE_MAX


def plan_cache_stats() -> Dict[str, int]:
    """{"hits", "misses", "evictions", "not_stored"}: counts since the
    process started (a cleared cache keeps them)."""
    with _STATS_LOCK:
        return dict(_STATS)


def _cacheable_filter(flt) -> bool:
    if isinstance(flt, F.Proxy):
        return False
    if isinstance(flt, (F.And, F.Or)):
        return all(_cacheable_filter(c) for c in flt.filters)
    if isinstance(flt, F.Not):
        return _cacheable_filter(flt.filter)
    if isinstance(flt, F.ByNested):
        return _cacheable_filter(flt.parent) and _cacheable_filter(flt.child)
    return True


def get_plan(
    compiler,
    flt,
    seg_idx: int,
    *,
    wand: bool,
    device_phrase: bool,
    scorer,
):
    """Cached `compiler.compile(...)` (default modes/dense only)."""
    segments = compiler.prepared.segments
    sr = segments[seg_idx]
    key: Optional[tuple] = None
    if _CACHE_MAX > 0 and _cacheable_filter(flt):
        try:
            key = (
                tuple(s.serial for s in segments),
                sr.serial,
                seg_idx,
                flt,
                scorer,
                wand,
                device_phrase,
            )
            hit = _CACHE.get(key)
        except TypeError:  # unhashable filter payload: compile uncached
            key = None
            hit = None
        if hit is not None:
            _CACHE.move_to_end(key)
            _count("hits")
            note(hit=True)
            return hit
    _count("misses")
    note(hit=False)
    plan = compiler.compile(
        flt, seg_idx, wand=wand, device_phrase=device_phrase
    )
    stored = False
    if key is not None and plan.aux_pairs is None and not plan.device_aux:
        rows = sum(len(g.rows_d) for g in plan.groups)
        if rows <= _ROW_LIMIT:
            _CACHE[key] = plan
            stored = True
            evicted = 0
            while len(_CACHE) > _CACHE_MAX:
                _CACHE.popitem(last=False)
                evicted += 1
            if evicted:
                _count("evictions", evicted)
    if not stored:
        _count("not_stored")
    return plan
