"""Consolidation candidate policies.

Reference: core/utils/index_utils.hpp:32-84 — ConsolidateCount /
ConsolidateDocsLive / ConsolidateDocsFill / ConsolidateTier (Lucene-tiered
scoring). Policies receive a DirectoryReader and return the indices of the
segments to merge.

A copy of ``iresearch_tpu/index/consolidate.py``.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np

Policy = Callable[["DirectoryReader"], List[int]]  # noqa: F821


def consolidate_count(threshold: int = 1):
    """Merge everything whenever the segment count exceeds ``threshold``."""

    def policy(reader) -> List[int]:
        if len(reader.segments) > threshold:
            return list(range(len(reader.segments)))
        return []

    return policy


def consolidate_docs_live(deleted_fraction: float = 0.1):
    """Merge segments whose deleted-doc fraction exceeds the threshold."""

    def policy(reader) -> List[int]:
        out = []
        for i, sr in enumerate(reader.segments):
            if sr.num_docs == 0:
                out.append(i)
                continue
            frac = 1.0 - sr.live_docs_count / sr.num_docs
            if frac > deleted_fraction:
                out.append(i)
        return out if len(out) > 1 else []

    return policy


def consolidate_docs_fill(fill_threshold: float = 0.85):
    """Merge segments whose live fill factor is below the threshold."""

    def policy(reader) -> List[int]:
        out = [
            i
            for i, sr in enumerate(reader.segments)
            if sr.num_docs and sr.live_docs_count / sr.num_docs < fill_threshold
        ]
        return out if len(out) > 1 else []

    return policy


def _segment_bytes(sr) -> int:
    """Approximate on-disk byte size of a segment's live data."""
    total = 0
    for fname in sr.field_names():
        fp = sr.field(fname)
        total += sum(a.nbytes for a in fp.doc_words + fp.freq_words)
        total += sum(a.nbytes for a in fp.base + fp.bmax + fp.bmaxf)
        total += fp.entries.nbytes + fp.norms.nbytes + len(fp.term_blob)
        if fp.pos_words is not None:
            total += sum(a.nbytes for a in fp.pos_words)
    for cname in sr.column_names():
        col = sr.column(cname)
        # v6 blocked columns keep blob=b""; offsets[-1] = uncompressed size
        total += (
            int(col.offsets[-1]) if col.offsets is not None and len(col.offsets)
            else len(col.blob)
        )
    live = sr.live_docs_count / sr.num_docs if sr.num_docs else 1.0
    return max(1, int(total * live))


def consolidate_bytes(threshold: float = 0.2):
    """Merge segments smaller than ``threshold`` x total index bytes
    (reference: ConsolidateBytes, index_utils.hpp:32-45)."""

    def policy(reader) -> List[int]:
        sizes = [_segment_bytes(sr) for sr in reader.segments]
        total = sum(sizes) or 1
        out = [i for i, s in enumerate(sizes) if s / total < threshold]
        return out if len(out) > 1 else []

    return policy


def consolidate_bytes_accum(threshold: float = 0.5):
    """Merge the smallest run of segments whose cumulative size stays under
    ``threshold`` x total (reference: ConsolidateBytesAccum)."""

    def policy(reader) -> List[int]:
        sizes = sorted(
            (_segment_bytes(sr), i) for i, sr in enumerate(reader.segments)
        )
        total = sum(s for s, _ in sizes) or 1
        out = []
        acc = 0
        for s, i in sizes:
            if (acc + s) / total > threshold:
                break
            acc += s
            out.append(i)
        return sorted(out) if len(out) > 1 else []

    return policy


def consolidate_tier(
    reader=None,
    *,
    min_segments: int = 2,
    max_segments: int = 10,
    floor_segment_docs: int = 1 << 14,
):
    """Tiered policy: merge the run of smallest segments.

    Segments below ``floor_segment_docs`` are treated as equal-sized (the
    Lucene/reference "floor" that sweeps up tiny flush segments). Picks up
    to ``max_segments`` of the smallest candidates when at least
    ``min_segments`` exist. Callable directly as a policy too.
    """

    def policy(r) -> List[int]:
        sizes = [
            (max(sr.live_docs_count, 1), i) for i, sr in enumerate(r.segments)
        ]
        if len(sizes) < min_segments:
            return []
        sizes.sort()
        chosen = [i for _, i in sizes[:max_segments]]
        return chosen if len(chosen) >= min_segments else []

    if reader is not None:  # used directly as a policy
        return policy(reader)
    return policy
