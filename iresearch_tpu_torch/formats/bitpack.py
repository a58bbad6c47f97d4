"""Pow2-bit block packing (``iresearch_tpu/formats/bitpack.py``).

The numpy half (``BITS``, ``bits_class``, ``words_per_block``,
``pack_blocks``, ``unpack_blocks``) is a copy of the JAX package's; the
torch half replaces ``unpack_jnp``. A block is 128 lanes (BLOCK) -> 4*b
u32 words at width b, planar: lane j lives in word ``j % 4b`` at bit
``(j // 4b) * b``.

Pools are held as int32 bit-views of the u32 words on every torch
device: torch has no u32 right shift on the CPU, and an arithmetic shift
followed by the width mask is exact — for b < 32 the mask clears the
sign bits, for b = 32 the shift is 0 and the mask is -1.
"""

from __future__ import annotations

import numpy as np
import torch

from iresearch_tpu_torch.formats.spec import BLOCK

BITS = (1, 2, 4, 8, 16, 32)
NUM_BIT_CLASSES = len(BITS)


def bits_class(max_value) -> np.ndarray | int:
    """Smallest class index whose width holds ``max_value``."""
    limits = np.array([1 << b for b in BITS[:-1]], dtype=np.uint64)
    return np.digitize(np.asarray(max_value, np.uint64), limits)


def words_per_block(b: int) -> int:
    return (BLOCK * b) // 32  # == 4*b


def _lane_shifts(b: int) -> np.ndarray:
    # planar layout: lane j lives in word j % (4*b) at bit (j // (4*b)) * b
    g = 32 // b
    return np.repeat(np.arange(g, dtype=np.uint32) * b, words_per_block(b))


def _mask(b: int) -> int:
    return 0xFFFFFFFF if b == 32 else (1 << b) - 1


def pack_blocks(vals: np.ndarray, b: int) -> np.ndarray:
    """[n, 128] u32 (< 2^b) -> [n, 4*b] u32 words, planar layout.

    Pure u32 arithmetic: every shifted value stays inside 32 bits (val <
    2^b shifted by <= 32-b)."""
    n = vals.shape[0]
    if vals.shape != (n, BLOCK):
        raise ValueError(f"vals: shape {vals.shape}, expected [n, {BLOCK}]")
    g = 32 // b
    wpb = words_per_block(b)
    vals = np.asarray(vals, np.uint32)
    words = vals[:, :wpb].copy()
    for j in range(1, g):
        words |= vals[:, j * wpb : (j + 1) * wpb] << np.uint32(j * b)
    return words


def unpack_blocks(words: np.ndarray, b: int) -> np.ndarray:
    """[n, 4*b] u32 words -> [n, 128] u32 (host/oracle path)."""
    g = 32 // b
    rep = np.tile(words, (1, g))
    return (rep >> _lane_shifts(b)[None, :]) & np.uint32(_mask(b))


def lane_mask(b: int) -> int:
    """The int32 mask of a b-bit lane (-1 at b = 32)."""
    return -1 if b == 32 else (1 << b) - 1


def unpack_torch(words: torch.Tensor, b: int) -> torch.Tensor:
    """int32 [..., 4b] words -> int32 [..., 128] lanes (u32 bit patterns).

    Counterpart of ``unpack_jnp``: lane j lives in word ``j % 4b`` at bit
    ``(j // 4b) * b``."""
    g = 32 // b
    wpb = words_per_block(b)
    if words.shape[-1] != wpb:
        raise ValueError(f"last dim {words.shape[-1]} != 4*b = {wpb}")
    rep = words.repeat(*([1] * (words.dim() - 1)), g)
    shifts = (
        torch.arange(g, dtype=torch.int32, device=words.device) * b
    ).repeat_interleave(wpb)
    return (rep >> shifts) & lane_mask(b)
