"""Segment model: the host reader and its residency on a torch device.

``SegmentData``, ``TermDictView`` and ``SegmentReader`` (term lookup, the
dense-grid cache, the skyline index) are a copy of the host half of
``iresearch_tpu/index/segment.py``; ``carry_segment`` opens a segment file
written by either package.

``DeviceField``/``DeviceSegment`` are built from the same host arrays
(``FieldPostings``, ``DenseCache``) with the same rules as the JAX
package's classes of those names: class pools padded to a power of two
plus the ``DSLICE_PAD`` zero tail, sentinel row 0, ``base``/``bmax``/
``bmaxf`` as int32, inline norm pools, f32 norms clamped >= 1 plus the u16
twin when exact, the ``norms_grid`` view, dense grid pools and position
pools on first use, and the alive mask. u32 words are held as int32
bit-views. Residency is per (reader, device).

Every upload that the JAX package counts is counted in the resource
manager's ``"device"`` category (``utils/resource.py``): a field's pools at
construction, its position and dense grid pools on first use. A limiter
may veto an upload (``ResourceLimitExceeded``); nothing vetoed is kept.
``SegmentReader.invalidate_device()`` drops every residency of the reader
and gives back what was counted.
"""

from __future__ import annotations

import bisect
import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from iresearch_tpu_torch.formats.columnstore import Column
from iresearch_tpu_torch.formats.postings import FieldPostings
from iresearch_tpu_torch.formats.spec import BLOCK, NUM_CLASSES, pad_docs
from iresearch_tpu_torch.utils import resource


@dataclass
class SegmentData:
    """Immutable host-side segment payload."""

    num_docs: int
    fields: Dict[str, FieldPostings]
    columns: Dict[str, Column]


class TermDictView(Sequence):
    """Zero-copy sorted term dictionary over (blob, offsets).

    Replaces the round-1 ``List[bytes]`` materialization: a dictionary of
    T terms costs only the byte blob plus one u64 offset array (a Python
    list of 10M small bytes objects is GBs; this is tens of MB). The
    reference holds millions of terms in an FST index + prefix blocks
    (formats_burst_trie.cpp:951,1457); here the sorted blob IS the
    dictionary and ``bisect`` over this view is the seek.
    """

    __slots__ = ("_blob", "_off")

    def __init__(self, blob: bytes, offsets: np.ndarray) -> None:
        self._blob = blob
        self._off = offsets

    def __len__(self) -> int:
        return len(self._off) - 1

    def __getitem__(self, i):
        if isinstance(i, slice):
            lo, hi, step = i.indices(len(self))
            return [self[j] for j in range(lo, hi, step)]
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        return self._blob[int(self._off[i]) : int(self._off[i + 1])]

    def __eq__(self, other) -> bool:
        if self is other:
            return True
        try:
            if len(other) != len(self):
                return False
        except TypeError:
            return NotImplemented
        return all(a == b for a, b in zip(self, other))

    def __hash__(self):  # pragma: no cover - views are not dict keys
        return object.__hash__(self)

    @property
    def nbytes(self) -> int:
        return len(self._blob) + self._off.nbytes


def _prefix_successor(prefix: bytes) -> Optional[bytes]:
    """Smallest byte string greater than every string with this prefix
    (increment-with-carry; None when the prefix is all 0xff)."""
    p = bytearray(prefix)
    while p and p[-1] == 0xFF:
        p.pop()
    if not p:
        return None
    p[-1] += 1
    return bytes(p)


def _pow2(n: int) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(1, n)))))


# zero-row tail appended to every doc/freq/norm pool: the dslice tier
# (exec/candidates.py:dslice_topk) reads a term's contiguous rows as ONE
# window of up to DSLICE_PAD rows (K2, which never clamps) — the tail
# guarantees start + R never exceeds the padded row count. The planner
# reads it too (a knob: bench_mix.planner_knobs).
DSLICE_PAD = 1024


_SEGMENT_SERIAL = itertools.count(1)


class SegmentReader:
    """Snapshot view of one committed segment (+ its doc mask generation)."""

    def __init__(
        self,
        name: str,
        data: SegmentData,
        masked_docs: Optional[np.ndarray] = None,
    ) -> None:
        self.name = name
        self.data = data
        self.num_docs = data.num_docs
        self._alive = np.ones(data.num_docs, np.bool_)
        if masked_docs is not None and len(masked_docs):
            self._alive[np.asarray(masked_docs, np.int64)] = False
        self._term_lists: Dict[str, TermDictView] = {}
        self._device_states: Dict[torch.device, "DeviceSegment"] = {}
        self._dense: Dict[str, "object"] = {}  # field -> DenseCache | None
        # process-unique identity token for prepared-plan caching
        # (exec/plancache.py) — id() could alias after GC, a serial can't
        self.serial = next(_SEGMENT_SERIAL)
        self._lookup_memo: Dict[Tuple[str, bytes], Optional[int]] = {}

    # --- stats ---------------------------------------------------------

    @property
    def docs_count(self) -> int:
        return self.num_docs

    @property
    def live_docs_count(self) -> int:
        return int(self._alive.sum())

    @property
    def alive(self) -> np.ndarray:
        return self._alive

    @property
    def has_deletes(self) -> bool:
        d = getattr(self, "_has_deletes", None)
        if d is None:
            d = not bool(self._alive.all())
            self._has_deletes = d
        return d

    def field_names(self) -> List[str]:
        return sorted(self.data.fields)

    def field(self, name: str) -> Optional[FieldPostings]:
        return self.data.fields.get(name)

    def column(self, name: str) -> Optional[Column]:
        return self.data.columns.get(name)

    def column_names(self) -> List[str]:
        return sorted(self.data.columns)

    # --- term dictionary ----------------------------------------------

    def terms(self, field_name: str) -> TermDictView:
        tl = self._term_lists.get(field_name)
        if tl is None:
            fp = self.data.fields.get(field_name)
            if fp is not None:
                tl = TermDictView(fp.term_blob, fp.term_offsets)
            else:
                tl = TermDictView(b"", np.zeros(1, np.uint64))
            self._term_lists[field_name] = tl
        return tl

    def lookup_term(self, field_name: str, term: bytes) -> Optional[int]:
        """Exact term -> tid (reference: term_reader seek, burst trie).

        Memoized: serving workloads re-look-up a hot term set every
        request (the reference's states_cache keeps seek cookies for the
        same reason, core/search/states_cache.hpp)."""
        key = (field_name, term)
        memo = self._lookup_memo
        hit = memo.get(key, -2)
        if hit != -2:
            return hit
        tl = self.terms(field_name)
        i = bisect.bisect_left(tl, term)
        out = i if (i < len(tl) and tl[i] == term) else None
        if len(memo) >= 1 << 17:  # bound host memory on adversarial streams
            memo.clear()
        memo[key] = out
        return out

    def term_range(
        self,
        field_name: str,
        low: Optional[bytes],
        high: Optional[bytes],
        include_low: bool = True,
        include_high: bool = True,
    ) -> Tuple[int, int]:
        """tid range [lo, hi) of terms within the bounds (None = unbounded)."""
        tl = self.terms(field_name)
        if low is None:
            lo = 0
        elif include_low:
            lo = bisect.bisect_left(tl, low)
        else:
            lo = bisect.bisect_right(tl, low)
        if high is None:
            hi = len(tl)
        elif include_high:
            hi = bisect.bisect_right(tl, high)
        else:
            hi = bisect.bisect_left(tl, high)
        return lo, max(lo, hi)

    def term_prefix_range(self, field_name: str, prefix: bytes) -> Tuple[int, int]:
        tl = self.terms(field_name)
        lo = bisect.bisect_left(tl, prefix)
        succ = _prefix_successor(prefix)
        hi = len(tl) if succ is None else bisect.bisect_left(tl, succ)
        return lo, max(lo, hi)

    # --- dense high-df term cache (formats/dense.py) -------------------

    def dense_cache(self, field_name: str):
        """Host DenseCache for this field (built lazily; None if no term
        qualifies). Pure acceleration: the oracle never reads it."""
        if field_name in self._dense:
            return self._dense[field_name]
        fp = self.data.fields.get(field_name)
        cache = None
        if fp is not None:
            from iresearch_tpu_torch.formats.dense import build_dense_cache

            # deleted docs are zeroed at build: grid consumers (fused
            # scan, skyline, gridmix probes) then need no alive mask
            cache = build_dense_cache(
                fp, self.num_docs,
                alive=self._alive if self.has_deletes else None,
            )
        self._dense[field_name] = cache
        return cache

    def skyline_index(self, field_name: str, scorer, avgdl: float):
        """Per-(field, scorer, avgdl) SkylineIndex (exec/skyline.py) over
        this segment's dense cache; None when the field has no dense
        cache or doc lengths exceed u16 (the row summaries are u16).

        Keyed by the INDEX-WIDE avgdl the query scores with — a reopen
        that shifts avgdl rebuilds the permutation (prepare shares avgdl
        between oracle and device, so the key is exact by construction).
        """
        key = (field_name, scorer, float(avgdl))
        cached = getattr(self, "_skyline", None)
        if cached is None:
            cached = self._skyline = {}
        if key in cached:
            return cached[key]
        idx = None
        cache = self.dense_cache(field_name)
        if cache is not None and cache.dl_min is not None:
            fp = self.data.fields[field_name]
            if len(fp.norms) == 0 or fp.norms.max(initial=0) < 65536:
                from iresearch_tpu_torch.exec.skyline import SkylineIndex

                idx = SkylineIndex(cache, scorer, avgdl)
        cached[key] = idx
        return idx

    def dense_span(self, field_name: str, tid: int):
        """(class, start_row, ndrows) of a term's grid rows, or None."""
        cache = self.dense_cache(field_name)
        if cache is None:
            return None
        span = cache.spans.get(tid)
        if span is None:
            return None
        return (span[0], span[1], cache.ndrows)

    # --- device --------------------------------------------------------

    def device(self, device=None) -> "DeviceSegment":
        """This reader's residency on ``device`` (the card when None)."""
        from iresearch_tpu_torch.device import require_cuda

        return device_state(self, require_cuda() if device is None else device)

    def device_field(self, field_name: str, device=None) -> "DeviceField":
        """One field's pools on ``device`` (the card when None)."""
        return self.device(device).field(field_name)

    def invalidate_device(self) -> None:
        """Drop every device residency of this reader and give back the
        bytes counted for it."""
        for st in self._device_states.values():
            for df in st._fields.values():
                resource.manager().decrease(resource.CATEGORY_DEVICE, df.device_bytes)
        self._device_states.clear()


def _pad_rows(arr: np.ndarray, rp: int) -> np.ndarray:
    out = np.zeros((rp,) + arr.shape[1:], arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def _i32(arr: np.ndarray) -> np.ndarray:
    """int32 view of u32 words, int32 copy of anything else."""
    if arr.dtype == np.uint32:
        return np.ascontiguousarray(arr).view(np.int32)
    return arr.astype(np.int32)


def dl_rows(norms: torch.Tensor, rows: Optional[torch.Tensor] = None):
    """f32 doc lengths of ``norms[rows]`` (all rows when None).

    u16 lengths are gathered through their int16 view (whose indexing
    every backend implements) and widened exactly through int32."""
    if norms.dtype == torch.float32:
        return norms if rows is None else norms[rows]
    x = norms.view(torch.int16)
    if rows is not None:
        x = x[rows]
    return (x.to(torch.int32) & 0xFFFF).to(torch.float32)


class DeviceField:
    """One field's pools resident on ``device`` (see module docstring)."""

    def __init__(self, fp: FieldPostings, device: torch.device) -> None:
        self.device = device

        def up(arr: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(_i32(arr)).to(device)

        self.doc_words, self.freq_words, self.base = [], [], []
        self.bmax, self.bmaxf = [], []
        self.nrm_words = [] if fp.nrm_words is not None else None
        for c in range(NUM_CLASSES):
            rp = _pow2(fp.doc_words[c].shape[0]) + DSLICE_PAD
            self.doc_words.append(up(_pad_rows(fp.doc_words[c], rp)))
            self.base.append(up(_pad_rows(fp.base[c], rp)))
            self.bmax.append(up(_pad_rows(fp.bmax[c], rp)))
            rpf = _pow2(fp.freq_words[c].shape[0]) + DSLICE_PAD
            self.freq_words.append(up(_pad_rows(fp.freq_words[c], rpf)))
            self.bmaxf.append(up(_pad_rows(fp.bmaxf[c], rpf)))
            if self.nrm_words is not None:
                rpn = _pow2(fp.nrm_words[c].shape[0]) + DSLICE_PAD
                self.nrm_words.append(up(_pad_rows(fp.nrm_words[c], rpn)))
        nd_pad = pad_docs(len(fp.norms))
        norms = np.ones(nd_pad, np.float32)
        norms[: len(fp.norms)] = np.maximum(fp.norms, 1).astype(np.float32)
        self.norms = torch.from_numpy(norms).to(device)
        # u16 twin for the fused scan, exact while every length fits
        self.norms_u16 = (
            torch.from_numpy(norms.astype(np.uint16)).to(device)
            if norms.max(initial=1.0) < 65536.0
            else None
        )
        self.device_bytes = sum(
            t.nbytes
            for t in self.doc_words + self.freq_words + (self.nrm_words or [])
            + self.base + self.bmax + self.bmaxf + [self.norms]
            + ([self.norms_u16] if self.norms_u16 is not None else [])
        )
        resource.manager().increase(resource.CATEGORY_DEVICE, self.device_bytes)
        # position pools upload on first use (pos_words()): only phrase
        # queries touch them, and they are the largest transfer
        self._fp = fp
        self._pos_words: Dict[int, torch.Tensor] = {}
        self._dense_words: Dict[int, torch.Tensor] = {}
        self._norms_grid: Optional[torch.Tensor] = None
        if fp.docs_with_field > 0:
            self.avgdl = float(fp.total_term_freq) / float(fp.docs_with_field)
        else:
            self.avgdl = 1.0

    def norms_grid(self) -> torch.Tensor:
        """[ndrows, 128] view of the norms (the u16 twin when exact)."""
        if self._norms_grid is None:
            src = self.norms_u16 if self.norms_u16 is not None else self.norms
            self._norms_grid = src.reshape(-1, BLOCK)
        return self._norms_grid

    def pos_words(self, c: int) -> torch.Tensor:
        """Packed position pool of class ``c``, rows padded to a power of
        two (uploaded on first use)."""
        t = self._pos_words.get(c)
        if t is None:
            src = self._fp.pos_words[c]
            t = torch.from_numpy(_i32(_pad_rows(src, _pow2(src.shape[0])))).to(
                self.device
            )
            resource.manager().increase(resource.CATEGORY_DEVICE, t.nbytes)
            self._pos_words[c] = t
            self.device_bytes += t.nbytes
        return t

    def dense_words(self, dense_cache, c: int) -> torch.Tensor:
        """Dense grid pool of class ``c`` (uploaded on first use)."""
        t = self._dense_words.get(c)
        if t is None:
            t = torch.from_numpy(_i32(dense_cache.pools[c])).to(self.device)
            resource.manager().increase(resource.CATEGORY_DEVICE, t.nbytes)
            self._dense_words[c] = t
            self.device_bytes += t.nbytes
        return t


class DeviceSegment:
    """One segment on ``device``: the alive mask and per-field pools."""

    def __init__(self, sr: SegmentReader, device: torch.device) -> None:
        self.device = device
        self.num_docs = sr.num_docs
        self.nd_pad = pad_docs(sr.num_docs)
        padded = np.zeros(self.nd_pad, np.bool_)
        padded[: sr.num_docs] = sr.alive
        self.alive = torch.from_numpy(padded).to(device)
        self._sr = sr
        self._fields: Dict[str, DeviceField] = {}

    def field(self, name: str) -> DeviceField:
        df = self._fields.get(name)
        if df is None:
            df = DeviceField(self._sr.data.fields[name], self.device)
            self._fields[name] = df
        return df

    @property
    def device_bytes(self) -> int:
        return self.alive.nbytes + sum(
            f.device_bytes for f in self._fields.values()
        )


def device_state(sr: SegmentReader, device) -> DeviceSegment:
    """The reader's residency on ``device``, created on first use and kept
    on the reader (its snapshot, deletes included, is immutable). Only a
    ``SegmentReader`` has one: a proxy such as the sharded planner's
    ``parallel/dense_stack.py:_WrappedReader`` presents another dense
    geometry and would cache the wrong grid pools."""
    if not isinstance(sr, SegmentReader):
        raise TypeError(f"{type(sr).__name__} is not a SegmentReader")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    st = sr._device_states.get(device)
    if st is None:
        st = sr._device_states[device] = DeviceSegment(sr, device)
    return st


def carry_segment(name: str, blob: bytes, masked_docs=None) -> SegmentReader:
    """A reader over a segment file's bytes (``write_segment`` of either
    package: the format is shared) with ``masked_docs`` deleted."""
    from iresearch_tpu_torch.formats.segment_io import read_segment

    return SegmentReader(name, read_segment(blob), masked_docs=masked_docs)
