"""On-device postings format constants.

Reference format (core/formats/formats_10.cpp:90-333): 128-doc bit-packed
delta blocks with embedded 9-level skip lists, bitwidth chosen per block.

TPU-native format: a posting list is a run of *bit-packed block rows* in
one of six pow2-width classes (see formats/bitpack.py). Doc-delta blocks
and frequency blocks are classed **independently** (a rare term has wide
deltas but tiny freqs), mirroring the reference's separate .doc stream
widths. Consequences:

* every block decodes independently (``docs = base + cumsum(unpack(w))``)
  so decode is embarrassingly parallel across the block axis — the role
  the skip list played for seeks is served by ``base``/``bmax`` metadata;
* pow2 widths make unpack repeat+shift+mask — pure VPU, no gathers;
* the final partial block is padded with ``delta=0, freq=0``: a padded
  lane repeats the previous doc id with zero frequency, contributing
  *exactly zero* score and zero match count — no masks anywhere in the
  execution path; row 0 of every pool is an all-zero sentinel block so
  gather padding can point at row 0.
"""

from __future__ import annotations

from enum import IntEnum, IntFlag

import numpy as np

# Docs per postings block (reference: format_traits::block_size == 128,
# formats_10.cpp:90). 128 is also the TPU lane count — a block is one vector.
BLOCK = 128

# Width classes: pow2 bit widths (see formats/bitpack.py BITS).
NUM_CLASSES = 6


def pad_docs(n: int) -> int:
    """Padded doc-axis length for device arrays (alive, norms, dense folds).

    Small segments round up to the next power of two; large ones to the
    next multiple of pow2/8 (a 3-bit mantissa). This bounds the number of
    distinct jit signatures while capping padding waste at 12.5% — a 5M-doc
    segment pads to 5.24M, not 8.4M.
    """
    n = max(1, int(n))
    if n <= 8192:
        p = 1
        while p < n:
            p <<= 1
        return p
    g = 1 << (n.bit_length() - 4)  # pow2_floor(n) / 8
    return ((n + g - 1) // g) * g


class TermCols(IntEnum):
    """Column layout of the per-term entry table (u32 ``[num_terms, 10]``)."""

    DF = 0         # document frequency
    TTF = 1        # total term frequency (sum of freqs)
    DCLS = 2       # width class of this list's doc-delta blocks
    FCLS = 3       # width class of this list's freq blocks
    DSTART = 4     # first block row within the doc-class pool
    FSTART = 5     # first block row within the freq-class pool
    NBLOCKS = 6    # number of blocks
    POS_BASE = 7   # flat rank of this list's first position (indexes the
                   # OFFS/PAY streams, which stay flat)
    MAX_FREQ = 8   # max in-doc frequency (block-max scoring upper bound)
    MIN_NORM = 9   # min doc length among this term's docs (score upper bound)
    # format v4: positions are bit-packed per term into 128-lane blocks of
    # pow2-width class pools, like docs/freqs (reference packs positions in
    # 128-blocks into .pos, formats_10.cpp:325-333)
    PCLS = 10      # width class of this list's position blocks
    PSTART = 11    # first block row within the position-class pool
    # format v5: per-entry doc lengths (norms) bit-packed into classed
    # block pools parallel to the freq blocks. Scoring needs dl per decoded
    # lane; gathering it from the dense [num_docs] norms array is a random
    # per-lane HBM gather (~7 ns/lane on TPU — measured 70% of query time).
    # Inlining norms into the postings turns that into the same sequential
    # row-gather the doc/freq pools use. (The reference reads norms via a
    # per-doc column, norm.hpp:46-198 — a CPU-cache-friendly pattern that
    # does not translate to TPU.)
    NCLS = 12      # width class of this list's norm blocks
    NSTART = 13    # first block row within the norm-class pool


NUM_TERM_COLS = 14
NUM_TERM_COLS_V3 = 10  # legacy iresearch_tpu/3 entry table (flat positions)
NUM_TERM_COLS_V4 = 12  # legacy iresearch_tpu/4 entry table (no norm pools)


class IndexFeatures(IntFlag):
    """Which per-posting payloads a field records.

    Reference: core/index/index_features.hpp:40 (FREQ/POS/OFFS/PAY bitset).
    """

    NONE = 0
    FREQ = 1
    POS = 2
    OFFS = 4
    PAY = 8
