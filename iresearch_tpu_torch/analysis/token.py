"""Token attributes (reference: core/analysis/token_attributes.hpp:38-138).

A token carries the term bytes, its position (offsets by position increment
semantics: same-position tokens share a position), and source offsets.

A copy of ``iresearch_tpu/analysis/token.py``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Token:
    term: bytes
    position: int
    start: int = 0  # byte/char offset of token start in source text
    end: int = 0    # one past the token end
    payload: bytes = b""  # arbitrary per-position payload (reference: PAY)
