"""Multi-precision numeric terms (``iresearch_tpu/analysis/numeric.py``).

A copy of the JAX package's numeric trie (reference:
core/analysis/token_streams.hpp:115-240, numeric_token_stream with
PRECISION_STEP_DEF=16, and core/search/granular_range_filter.cpp): a
numeric value is indexed as one term per granularity level, and a numeric
range decomposes into a few term ranges across levels. Term layout:
``bytes([shift]) + 8-byte big-endian of (sortable_u64(v) >> shift)``, so
terms at one level sort by value and levels are disjoint prefixes.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple, Union

from iresearch_tpu_torch.analysis.token import Token
from iresearch_tpu_torch.analysis.analyzers import Analyzer, register

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


def level_term(u64: int, shift: int) -> bytes:
    return bytes([shift]) + struct.pack(">Q", (u64 >> shift) << shift)


def numeric_terms(value: Union[int, float], step: int = PRECISION_STEP_DEF) -> List[bytes]:
    u = sortable_u64(value)
    return [level_term(u, s) for s in range(0, BITS, step)]


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


class NumericAnalyzer(Analyzer):
    """Emits one term per granularity level for a numeric value.

    Higher-level terms carry position increment 0 in the reference; here
    all terms share position 0 of the field.
    """

    name = "numeric"

    def __init__(self, step: int = PRECISION_STEP_DEF) -> None:
        self.step = step

    def tokenize(self, text) -> List[Token]:
        value = text
        if isinstance(value, str):
            value = float(value) if ("." in value or "e" in value.lower()) else int(value)
        return [Token(term=t, position=0) for t in numeric_terms(value, self.step)]


register("numeric", lambda a: NumericAnalyzer(step=int(a.get("step", PRECISION_STEP_DEF))))
