"""Multi-precision numeric term ranges (``iresearch_tpu/analysis/numeric.py``).

The query half of the JAX package's numeric trie, copied: a numeric range
decomposes into a few term ranges across precision levels. Term layout:
``bytes([shift]) + 8-byte big-endian of (sortable_u64(v) >> shift)``, so
terms at one level sort by value and levels are disjoint prefixes. The
analyzer that writes those terms stays in the JAX package.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple, Union

PRECISION_STEP_DEF = 16
BITS = 64


def sortable_u64(value: Union[int, float]) -> int:
    """Map int64/double to u64 preserving numeric order."""
    if isinstance(value, float):
        bits = struct.unpack("<Q", struct.pack("<d", value))[0]
        if bits & (1 << 63):
            return (~bits) & 0xFFFFFFFFFFFFFFFF  # negative: flip all
        return bits | (1 << 63)  # positive: flip sign
    v = int(value)
    if not -(1 << 63) <= v < (1 << 63):
        raise ValueError("int out of int64 range")
    return (v ^ (1 << 63)) & 0xFFFFFFFFFFFFFFFF


def split_granular_range(
    lo: int, hi: int, step: int = PRECISION_STEP_DEF
) -> List[Tuple[int, int, int]]:
    """Decompose inclusive u64 range [lo, hi] into (shift, lo, hi) covers.

    Classic numeric-trie split (the semantic twin of the reference's
    granular term collection, granular_range_filter.cpp:88-174): edges are
    covered at fine levels, the middle at coarse levels. Bounds in each
    output tuple are inclusive *unshifted* u64s aligned to the level.
    """
    U64 = 0xFFFFFFFFFFFFFFFF
    out: List[Tuple[int, int, int]] = []
    shift = 0
    while True:
        diff = (1 << (shift + step)) & U64
        mask = ((1 << step) - 1) << shift
        has_lower = (lo & mask) != 0
        has_upper = (hi & mask) != mask
        next_lo = ((lo + diff if has_lower else lo) & U64) & ~mask
        next_hi = ((hi - diff if has_upper else hi) & U64) & ~mask
        lower_wrapped = next_lo < lo
        upper_wrapped = next_hi > hi
        if (
            shift + step >= BITS
            or next_lo > next_hi
            or lower_wrapped
            or upper_wrapped
        ):
            out.append((shift, lo, hi))
            break
        if has_lower:
            out.append((shift, lo, lo | mask))
        if has_upper:
            out.append((shift, hi & ~mask, hi))
        lo, hi, shift = next_lo, next_hi, shift + step
    return out


def granular_term_ranges(
    low: Optional[Union[int, float]],
    high: Optional[Union[int, float]],
    include_low: bool = True,
    include_high: bool = True,
    step: int = PRECISION_STEP_DEF,
) -> List[Tuple[bytes, bytes]]:
    """Inclusive byte-term ranges covering the numeric range across levels."""
    lo = 0 if low is None else sortable_u64(low)
    hi = 0xFFFFFFFFFFFFFFFF if high is None else sortable_u64(high)
    if low is not None and not include_low:
        if lo == 0xFFFFFFFFFFFFFFFF:
            return []
        lo += 1
    if high is not None and not include_high:
        if hi == 0:
            return []
        hi -= 1
    if lo > hi:
        return []
    out = []
    for shift, a, b in split_granular_range(lo, hi, step):
        out.append(
            (
                bytes([shift]) + struct.pack(">Q", (a >> shift) << shift),
                bytes([shift]) + struct.pack(">Q", (b >> shift) << shift),
            )
        )
    return out
