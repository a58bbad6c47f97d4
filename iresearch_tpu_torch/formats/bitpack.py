"""Planar pow2-bit unpack on torch tensors (``formats/bitpack.py``).

Pools are held as int32 bit-views of the u32 words on every device:
torch has no u32 right shift on the CPU, and an arithmetic shift followed
by the width mask is exact — for b < 32 the mask clears the sign bits, for
b = 32 the shift is 0 and the mask is -1.
"""

from __future__ import annotations

import torch

from iresearch_tpu.formats.bitpack import words_per_block


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
