"""Cross-segment merged term dictionary view.

At multi-segment scale the host cost of a multiterm query is S
independent dictionary intersections (VERDICT r4: Fuzzy1 24.2 ms
amortized @25M = 5 dicts × Levenshtein-DFA scan + 5 plan setups). The
reference also pays one automaton×FST intersect per segment
(formats_burst_trie.cpp:3139, multiterm_query.hpp caches the per-segment
states) but its per-segment cost is µs; here ONE intersect against a
merged dictionary replaces all S:

* built once per (field, segment-serial set) — a k-way union of the
  per-segment sorted term blobs into one sorted unique-term dictionary
  plus per-segment tid maps (merged id -> segment tid, -1 when absent);
* any DFA/regex/range intersection runs against the merged blob only;
  survivors map back to per-segment tids with one gather per segment.

Cached in a small module LRU keyed by segment serials, so reader reopen
with unchanged segments reuses the view (the reopen-reuses-readers
analog, directory_reader_impl.cpp:209+).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np

# total input terms beyond which the merged view is not built (the
# per-segment path stays available; counted via a cap counter)
MERGED_DICT_MAX = int(os.environ.get("IRS_MERGED_DICT_MAX", "30000000"))
_CACHE_MAX = 32
_cache: "OrderedDict[tuple, MergedDict]" = OrderedDict()


class MergedDict:
    """Union dictionary over segments for one field."""

    def __init__(self, blob: bytes, offsets: np.ndarray, seg_tid: np.ndarray):
        self.term_blob = blob
        self.term_offsets = offsets  # u64 [U+1]
        self.seg_tid = seg_tid  # i32 [S, U]; -1 = term absent in segment
        self.num_terms = len(offsets) - 1

    def term(self, mid: int) -> bytes:
        lo, hi = int(self.term_offsets[mid]), int(self.term_offsets[mid + 1])
        return self.term_blob[lo:hi]

    def prefix_range(self, prefix: bytes) -> Tuple[int, int]:
        import bisect

        terms = _DictSeq(self)
        lo = bisect.bisect_left(terms, prefix)
        hi = bisect.bisect_left(terms, prefix + b"\xff" * 8)
        # \xff padding overshoots only for terms equal to prefix+\xff...;
        # scan forward conservatively
        while hi < self.num_terms and self.term(hi).startswith(prefix):
            hi += 1
        return lo, hi

    def dfa_intersect(self, lo, hi, trans, accept) -> Optional[np.ndarray]:
        """Merged tids accepted by the DFA, or None without native lib."""
        from iresearch_tpu_torch import native

        return native.dfa_intersect(
            self.term_blob,
            self.term_offsets.astype(np.int64),
            lo,
            hi,
            trans,
            accept,
        )


class _DictSeq:
    def __init__(self, md: MergedDict) -> None:
        self._md = md

    def __len__(self) -> int:
        return self._md.num_terms

    def __getitem__(self, i: int) -> bytes:
        return self._md.term(i)


def merged_dict(
    segments: Sequence, field_name: str
) -> Optional[MergedDict]:
    """The cached merged dictionary for these segments' field, or None
    (single segment, missing field, or over the size cap)."""
    srs = [sr for sr in segments if sr.field(field_name) is not None]
    if len(srs) < 2:
        return None
    key = (field_name,) + tuple(sr.serial for sr in segments)
    md = _cache.get(key)
    if md is not None:
        _cache.move_to_end(key)
        return md
    total = sum(sr.field(field_name).num_terms for sr in srs)
    if total > MERGED_DICT_MAX:
        from iresearch_tpu_torch.utils.metrics import registry

        registry().counter(
            "irs_merged_dict_skipped",
            help_="multiterm expansions using per-segment dictionary "
            "intersections because the union exceeded IRS_MERGED_DICT_MAX",
        )
        return None
    md = _build(segments, field_name)
    _cache[key] = md
    while len(_cache) > _CACHE_MAX:
        _cache.popitem(last=False)
    return md


def _build(segments: Sequence, field_name: str) -> MergedDict:
    """np.unique over the concatenated per-segment term arrays: the
    inverse indices ARE each segment's merged ids (terms within one
    segment are already unique, so the per-segment maps are bijections
    onto their subset)."""
    S = len(segments)
    parts: List[np.ndarray] = []
    seg_of: List[int] = []
    for s, sr in enumerate(segments):
        fp = sr.field(field_name)
        if fp is None:
            continue
        offs = fp.term_offsets.astype(np.int64)
        blob = fp.term_blob
        arr = np.empty(len(offs) - 1, object)
        for i in range(len(offs) - 1):
            arr[i] = blob[offs[i] : offs[i + 1]]
        parts.append(arr)
        seg_of.append(s)
    cat = np.concatenate(parts) if parts else np.empty(0, object)
    uniq, inv = np.unique(cat, return_inverse=True)
    U = len(uniq)
    seg_tid = np.full((S, U), -1, np.int32)
    base = 0
    for arr, s in zip(parts, seg_of):
        n = len(arr)
        seg_tid[s, inv[base : base + n]] = np.arange(n, dtype=np.int32)
        base += n
    blob = b"".join(uniq)
    offsets = np.zeros(U + 1, np.uint64)
    if U:
        offsets[1:] = np.cumsum([len(t) for t in uniq])
    return MergedDict(blob, offsets, seg_tid)
