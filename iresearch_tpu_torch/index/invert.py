"""Inversion: token tuples -> sorted postings entries.

Reference hot path: core/index/field_data.cpp:985 (``field_data::invert``)
builds an in-RAM hash->byte-pool index one token at a time. The TPU-native
replacement is a *segment sort*: the token stream for a field is three flat
arrays ``(tid, doc, pos)``; inversion is one stable sort by ``tid`` (tokens
already arrive in (doc, pos) order) followed by run-length detection of
``(tid, doc)`` runs. A copy of ``iresearch_tpu/index/invert.py``'s numpy
host path; its device path (``invert_device``) is not ported yet.
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
