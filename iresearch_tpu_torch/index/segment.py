"""Segment residency on a torch device (``index/segment.py``).

``DeviceField``/``DeviceSegment`` are built from the same host arrays
(``FieldPostings``, ``DenseCache``) with the same rules as the JAX
package's classes of those names: class pools padded to a power of two
plus the ``DSLICE_PAD`` zero tail, sentinel row 0, ``base``/``bmax``/
``bmaxf`` as int32, inline norm pools, f32 norms clamped >= 1 plus the u16
twin when exact, the ``norms_grid`` view, dense grid pools on first use,
and the alive mask. u32 words are held as int32 bit-views.

Residency is per (reader, device) and never touches the JAX package's
``SegmentReader.device()``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from iresearch_tpu.formats.postings import FieldPostings
from iresearch_tpu.formats.spec import BLOCK, NUM_CLASSES, pad_docs
from iresearch_tpu.index.segment import DSLICE_PAD, SegmentReader, _pow2


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

    def dense_words(self, dense_cache, c: int) -> torch.Tensor:
        """Dense grid pool of class ``c`` (uploaded on first use)."""
        t = self._dense_words.get(c)
        if t is None:
            t = torch.from_numpy(_i32(dense_cache.pools[c])).to(self.device)
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


def device_state(sr: SegmentReader, device: torch.device) -> DeviceSegment:
    """The reader's residency on ``device``, created on first use and kept
    on the reader (its snapshot, deletes included, is immutable)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    states = sr.__dict__.setdefault("_torch_device_state", {})
    st = states.get(device)
    if st is None:
        st = states[device] = DeviceSegment(sr, device)
    return st
