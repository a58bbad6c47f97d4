"""Inversion: token tuples -> sorted postings entries.

Reference hot path: core/index/field_data.cpp:985 (``field_data::invert``)
builds an in-RAM hash->byte-pool index one token at a time. The TPU-native
replacement is a *segment sort*: the token stream for a field is three flat
arrays ``(tid, doc, pos)``; inversion is one stable sort by ``tid`` (tokens
already arrive in (doc, pos) order) followed by run-length detection of
``(tid, doc)`` runs. ``invert_numpy`` is a copy of
``iresearch_tpu/index/invert.py``'s host path; ``invert_device`` runs the
sort and the run detection as PyTorch operations on a device. They produce
identical entry arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class InvertedEntries:
    """Sorted postings entries for one field (input to the encoder)."""

    e_doc: np.ndarray  # u32 [E]
    e_freq: np.ndarray  # u32 [E]
    term_ptr: np.ndarray  # i64 [T+1]
    pos_flat: np.ndarray  # u32 [num_tokens] positions in entry order
    norms: np.ndarray  # u32 [num_docs] tokens per doc
    order: np.ndarray = None  # i64 [num_tokens] arrival->flat permutation
    # (pos_flat == tok_pos[order]; any position-parallel stream reorders
    # the same way: offsets, payloads)


def invert_numpy(
    tok_tid: np.ndarray,
    tok_doc: np.ndarray,
    tok_pos: np.ndarray,
    num_terms: int,
    num_docs: int,
) -> InvertedEntries:
    """Host inversion. Tokens must be in (doc asc, pos asc) arrival order."""
    tok_tid = np.asarray(tok_tid, dtype=np.int64)
    tok_doc = np.asarray(tok_doc, dtype=np.int64)
    tok_pos = np.asarray(tok_pos, dtype=np.uint32)
    n = len(tok_tid)
    norms = np.bincount(tok_doc, minlength=num_docs).astype(np.uint32)
    if n == 0:
        return InvertedEntries(
            e_doc=np.zeros(0, np.uint32),
            e_freq=np.zeros(0, np.uint32),
            term_ptr=np.zeros(num_terms + 1, np.int64),
            pos_flat=np.zeros(0, np.uint32),
            norms=norms,
            order=np.zeros(0, np.int64),
        )
    order = np.argsort(tok_tid, kind="stable")
    stid = tok_tid[order]
    sdoc = tok_doc[order]
    pos_flat = tok_pos[order]

    key = stid * np.int64(num_docs) + sdoc
    is_new = np.empty(n, dtype=bool)
    is_new[0] = True
    np.not_equal(key[1:], key[:-1], out=is_new[1:])
    entry_starts = np.flatnonzero(is_new)
    e_doc = sdoc[entry_starts].astype(np.uint32)
    counts = np.diff(np.append(entry_starts, n))
    e_freq = counts.astype(np.uint32)

    term_ptr = np.zeros(num_terms + 1, dtype=np.int64)
    entry_tid = stid[entry_starts]
    # bincount, not ufunc.at: add.at is ~us/element and dominates at
    # hundreds of millions of tokens
    term_ptr[1:] = np.bincount(entry_tid, minlength=num_terms)
    np.cumsum(term_ptr, out=term_ptr)
    return InvertedEntries(e_doc, e_freq, term_ptr, pos_flat, norms, order)


def invert_device(
    tok_tid: np.ndarray,
    tok_doc: np.ndarray,
    tok_pos: np.ndarray,
    num_terms: int,
    num_docs: int,
    *,
    device=None,
) -> InvertedEntries:
    """Device inversion: one stable sort by term id plus vectorized run
    detection on ``device`` (the card when None), the rest on the host.
    Equal to ``invert_numpy`` on the same tokens, field by field.

    The JAX package pads the stream to a power of two so that its jitted
    kernel compiles once per bucket; eager PyTorch needs no padding, so
    the arrays keep their length and no sentinel tokens are dropped."""
    import torch

    from iresearch_tpu_torch.device import require_cuda

    dev = require_cuda() if device is None else torch.device(device)
    n = len(tok_tid)
    norms = np.bincount(
        np.asarray(tok_doc, np.int64), minlength=num_docs
    ).astype(np.uint32)
    if n == 0:
        return InvertedEntries(
            e_doc=np.zeros(0, np.uint32),
            e_freq=np.zeros(0, np.uint32),
            term_ptr=np.zeros(num_terms + 1, np.int64),
            pos_flat=np.zeros(0, np.uint32),
            norms=norms,
            order=np.zeros(0, np.int64),
        )

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    tid = up(tok_tid, np.int32)
    doc = up(tok_doc, np.int32)
    # u32 positions ride as their int32 bit-view: they are only permuted
    pos = up(np.asarray(tok_pos, np.uint32).view(np.int32), np.int32)
    # torch.sort is unstable unless asked; stable keeps the (doc, pos)
    # arrival order inside each term
    stid, order = torch.sort(tid, stable=True)
    sdoc = doc[order]
    spos = pos[order]
    # run boundary where (tid, doc) changes; no 64-bit key needed
    is_new = torch.ones(n, dtype=torch.bool, device=dev)
    is_new[1:] = (stid[1:] != stid[:-1]) | (sdoc[1:] != sdoc[:-1])
    eidx = torch.cumsum(is_new, 0) - 1  # int64 entry index of each token
    num_entries = int(eidx[-1]) + 1
    e_freq = torch.zeros(num_entries, dtype=torch.int32, device=dev).index_add_(
        0, eidx, torch.ones(n, dtype=torch.int32, device=dev)
    )
    # every token of a run carries the run's doc and tid, so the gather at
    # the run starts equals the JAX kernel's scatter-max
    starts = torch.nonzero(is_new).reshape(-1)
    e_doc = sdoc[starts]
    entry_tid = stid[starts].to(torch.int64)
    term_ptr = np.zeros(num_terms + 1, dtype=np.int64)
    term_ptr[1:] = torch.bincount(entry_tid, minlength=num_terms).cpu().numpy()
    np.cumsum(term_ptr, out=term_ptr)
    return InvertedEntries(
        e_doc.cpu().numpy().astype(np.uint32),
        e_freq.cpu().numpy().astype(np.uint32),
        term_ptr,
        spos.cpu().numpy().view(np.uint32),
        norms,
        order.cpu().numpy(),
    )
