"""Exact top-k in (score desc, doc asc) order.

Counterpart of ``exec/candidates.py:topk_docs`` (and of ``ops/topk.py``'s
``wide_top_k`` when ``docs`` is the lane index). The JAX package's
tournament works around XLA's TopK lowering on the TPU and is not ported;
its tie rule is, because ``torch.topk`` breaks ties by no fixed rule
(``topk([1, 1, 1, .5], 2)`` returns indices [1, 2] on the CPU).

Each (score, doc) pair becomes one int64 key whose order is the wanted
order: the f32 score's bits mapped to a signed int that sorts like the
float, above ``IMAX - doc``. One ``torch.topk`` over the keys is then
exact; equal keys are equal (score, doc) pairs, so their order is moot.
"""

from __future__ import annotations

from typing import Optional

import torch

_IMAX32 = 2**31 - 1


def _order_key(scores: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    s = scores + 0.0  # -0.0 -> +0.0: equal floats must give equal keys
    bits = s.view(torch.int32).to(torch.int64)
    hi = torch.where(bits < 0, bits ^ _IMAX32, bits)
    return (hi << 32) | (_IMAX32 - docs.to(torch.int64))


def topk_docs(
    scores: torch.Tensor, docs: Optional[torch.Tensor], k: int
):
    """(vals f32 [..., k], docs [..., k]) of the k best entries of the last
    axis by (score desc, doc asc). ``docs=None`` ranks by position (the
    ``lax.top_k`` order) and returns positions as int32."""
    if scores.dtype != torch.float32:
        raise TypeError(f"scores: dtype {scores.dtype}, expected float32")
    if docs is None:
        docs = torch.arange(
            scores.shape[-1], dtype=torch.int32, device=scores.device
        ).expand(scores.shape)
    if docs.shape != scores.shape:
        raise ValueError(f"docs {tuple(docs.shape)} != scores {tuple(scores.shape)}")
    if not 0 < k <= scores.shape[-1]:
        raise ValueError(f"k={k} outside 1..{scores.shape[-1]}")
    _, idx = torch.topk(_order_key(scores, docs), k, dim=-1, sorted=True)
    return scores.gather(-1, idx), docs.gather(-1, idx)
