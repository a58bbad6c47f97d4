"""Cross-shard uniform dense-term layout for the sharded executor
(``iresearch_tpu/parallel/dense_stack.py``, a numpy-only copy).

Per-segment DenseCaches (formats/dense.py) disagree across shards: a term
dense in one shard may be sparse in another, grid row counts differ
(nd_s/128), and width classes differ (per-shard max freq). The sharded
executor needs ONE structure per query, so this module builds a searcher-owned
uniform layout:

* a term (by BYTES — tids are segment-local) is grid-eligible iff it has a
  dense span in EVERY shard that contains the field (shards without the
  term at all contribute zero rows, which is exact: freq 0 = no match);
* every eligible term gets one uniform width class (the max across
  shards; smaller-class grids repack losslessly upward) and one uniform
  row interval [1 + j*stride, 1 + (j+1)*stride) where stride = max shard
  ndrows — identical START on every shard, so a plan's DenseSpan is
  shard-invariant and stacks trivially;
* pools are stacked [S, rows_c, wpb] on the host; the searcher uploads
  each of its own segments' [rows_c, wpb] slices (``parallel/sharded.py``).

`wrap_segments` returns readers whose dense_span/dense_cache present this
uniform geometry to the (unmodified) PlanCompiler, so compile(dense=True)
produces identical dense structures on every shard; the searcher executes
them against the stacked pools.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from iresearch_tpu_torch.formats.bitpack import (
    BITS,
    pack_blocks,
    unpack_blocks,
    words_per_block,
)
from iresearch_tpu_torch.formats.spec import BLOCK, NUM_CLASSES


@dataclass
class _UniformCache:
    """DenseCache-compatible view of the uniform layout for ONE shard.

    Provides exactly what PlanCompiler's dense handling reads: ``spans``
    (tid -> (class, start)), ``ndrows`` and ``bmaxf`` (per-class row max
    freqs, used for WAND upper bounds). Skyline summaries are absent
    (dl_min=None) — the sharded path does not use the skyline tier.
    """

    ndrows: int
    spans: Dict[int, Tuple[int, int]]
    bmaxf: List[np.ndarray]
    dl_min = None
    avgdl: float = 1.0


class UniformDenseLayout:
    """Uniform cross-shard dense layout for one field."""

    def __init__(self, segments, fname: str) -> None:
        self.fname = fname
        self.segments = list(segments)
        S = len(self.segments)
        per_shard = []  # (sr, cache) for shards that have the field
        for sr in self.segments:
            fp = sr.field(fname)
            if fp is None:
                per_shard.append(None)
                continue
            per_shard.append(sr.dense_cache(fname))
        # eligible = dense in EVERY shard where the term exists (a shard
        # lacking the term entirely reads zero rows — exact); a term that
        # is sparse in any shard stays sparse everywhere (plan structures
        # must be shard-invariant)
        candidates: set = set()
        for sr, cache in zip(self.segments, per_shard):
            if cache is None:
                continue
            terms = sr.terms(fname)
            candidates |= {bytes(terms[tid]) for tid in cache.spans}
        elig = set()
        for b in candidates:
            ok = True
            for sr, cache in zip(self.segments, per_shard):
                if sr.field(fname) is None:
                    continue
                tid = sr.lookup_term(fname, b)
                if tid is None:
                    continue  # absent: zero rows, exact
                if cache is None or tid not in cache.spans:
                    ok = False
                    break
            if ok:
                elig.add(b)
        self.terms: List[bytes] = sorted(elig)
        self.stride = max(
            [c.ndrows for c in per_shard if c is not None] or [1]
        )
        # uniform class per term: max across shards
        self.cls: Dict[bytes, int] = {}
        for sr, cache in zip(self.segments, per_shard):
            if cache is None:
                continue
            terms = sr.terms(fname)
            for tid, (c, _st) in cache.spans.items():
                b = bytes(terms[tid])
                if b in elig:
                    self.cls[b] = max(self.cls.get(b, 0), c)
        # uniform start per term, grouped by class
        by_cls: List[List[bytes]] = [[] for _ in range(NUM_CLASSES)]
        for b in self.terms:
            by_cls[self.cls[b]].append(b)
        # rows [0, stride) of every class pool are a ZERO region: a shard
        # lacking a term entirely executes its span at start=0 — freq 0 on
        # every lane, an exact no-op — so span sets stay shard-invariant
        self.start: Dict[bytes, int] = {}
        self.rows_c = [self.stride * (1 + len(t)) for t in by_cls]
        for c, terms_c in enumerate(by_cls):
            for j, b in enumerate(terms_c):
                self.start[b] = self.stride * (1 + j)
        # stacked pools + per-shard bmaxf in uniform geometry
        self.pools_np: List[np.ndarray] = []
        self.bmaxf_np: List[np.ndarray] = []  # [S, rows_c] per class
        for c in range(NUM_CLASSES):
            wpb = words_per_block(BITS[c])
            pool = np.zeros((S, self.rows_c[c], wpb), np.uint32)
            bm = np.zeros((S, self.rows_c[c]), np.uint32)
            for si, (sr, cache) in enumerate(zip(self.segments, per_shard)):
                if cache is None:
                    continue
                terms = sr.terms(fname)
                rev = {bytes(terms[tid]): tid for tid in cache.spans}
                for b in by_cls[c]:
                    tid = rev.get(b)
                    if tid is None:
                        continue  # term absent in this shard: zero rows
                    c_s, st_s = cache.spans[tid]
                    nr = cache.ndrows
                    dst = self.start[b]
                    src = cache.pools[c_s][st_s : st_s + nr]
                    if c_s == c:
                        pool[si, dst : dst + nr] = src
                    else:  # repack upward to the uniform class
                        grid = unpack_blocks(src, BITS[c_s])
                        pool[si, dst : dst + nr] = pack_blocks(
                            grid, BITS[c]
                        )
                    bm[si, dst : dst + nr] = cache.bmaxf[c_s][
                        st_s : st_s + nr
                    ]
            self.pools_np.append(pool)
            self.bmaxf_np.append(bm)
        self._wrapped: Dict[int, "_WrappedReader"] = {}

    def lookup(self, sr, tid: int) -> Optional[Tuple[int, int, int]]:
        """(uniform class, uniform start, stride) for a shard-local tid."""
        b = bytes(sr.terms(self.fname)[tid])
        c = self.cls.get(b)
        if c is None:
            return None
        return (c, self.start[b], self.stride)

    def shard_cache(self, si: int) -> _UniformCache:
        sr = self.segments[si]
        terms = sr.terms(self.fname)
        spans = {}
        fp = sr.field(self.fname)
        if fp is not None:
            # shard-local tids of eligible terms
            for b in self.terms:
                tid = sr.lookup_term(self.fname, b)
                if tid is not None:
                    spans[tid] = (self.cls[b], self.start[b])
        avgdl = (
            float(fp.total_term_freq) / float(fp.docs_with_field)
            if fp is not None and fp.docs_with_field
            else 1.0
        )
        return _UniformCache(
            ndrows=self.stride,
            spans=spans,
            bmaxf=[bm[si] for bm in self.bmaxf_np],
            avgdl=avgdl,
        )


class _WrappedReader:
    """SegmentReader proxy presenting the uniform dense geometry.

    PlanCompiler consults only dense_span()/dense_cache() for grid
    decisions; everything else delegates to the underlying reader.
    """

    def __init__(self, sr, layouts: Dict[str, UniformDenseLayout], si: int):
        self._sr = sr
        self._layouts = layouts
        self._si = si
        self._caches: Dict[str, _UniformCache] = {}

    def __getattr__(self, name):
        return getattr(self._sr, name)

    def dense_span(self, field_name: str, tid: int):
        lay = self._layouts.get(field_name)
        if lay is None:
            return None
        return lay.lookup(self._sr, tid)

    def dense_cache(self, field_name: str):
        c = self._caches.get(field_name)
        if c is None:
            lay = self._layouts.get(field_name)
            if lay is None:
                return None
            c = lay.shard_cache(self._si)
            self._caches[field_name] = c
        return c

    def skyline_index(self, field_name: str, scorer, avgdl: float):
        return None  # the sharded path never uses the skyline tier


def wrap_segments(segments, layouts: Dict[str, UniformDenseLayout]):
    return [
        _WrappedReader(sr, layouts, si) for si, sr in enumerate(segments)
    ]
