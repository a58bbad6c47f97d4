"""Scoring on torch tensors: ``score_block`` and ``_score_expr`` twins.

Both keep the JAX package's operation order so that results agree with it
to float reorder only, and so that a CUDA kernel doing the same operations
in the same order (built with ``--fmad=false``) matches the plain version
bit for bit:

    BM25   w * f / max(f + (c0 + (kb / avgdl) * dl), 1e-9)

Python constants are rounded to f32 on the host (as JAX's weak typing
rounds them) and ``kb / avgdl`` is an f32 division, as JAX computes it
with a traced f32 avgdl.
"""

from __future__ import annotations

import numpy as np
import torch

from iresearch_tpu.search.scorers import BM25, TFIDF, BoostScore, Scorer


def f32(x: float) -> float:
    """``x`` rounded to the nearest f32, as a Python float (exact in f32)."""
    return float(np.float32(x))


def bm25_consts(scorer: BM25):
    """(kb, c0) of the BM25 denominator, each rounded to f32."""
    kb = scorer.k * scorer.b
    return f32(kb), f32(scorer.k - kb)


def _as_f32(avgdl, like: torch.Tensor) -> torch.Tensor:
    if isinstance(avgdl, torch.Tensor):
        return avgdl.to(dtype=torch.float32)
    return torch.tensor(f32(avgdl), dtype=torch.float32, device=like.device)


def _bm25(scorer: BM25, w, f, dl, avgdl):
    kb, c0 = bm25_consts(scorer)
    if scorer.b != 0.0:
        a = _as_f32(avgdl, f)
        c1 = torch.full_like(a, kb) / a  # f32 division on tensors
        denom = f + ((c1 * dl) + c0)
    else:
        denom = f + c0
    return w * f / torch.clamp_min(denom, f32(1e-9))


def score_block_torch(scorer: Scorer, w, f, dl, avgdl):
    """Counterpart of ``score_block(xp=jnp)``: per-posting scores, exactly
    0 where f == 0. ``f``/``dl`` f32 tensors, ``w`` broadcastable."""
    if isinstance(scorer, BM25):
        return _bm25(scorer, w, f, dl, avgdl)
    if isinstance(scorer, TFIDF):
        tf = torch.sqrt(f)
        if scorer.with_norms:
            return w * tf / torch.sqrt(torch.clamp_min(dl, 1.0))
        return w * tf
    if isinstance(scorer, BoostScore):
        return w * (f > 0).to(torch.float32)
    raise TypeError(f"unknown scorer {scorer!r}")


def score_expr_torch(scorer: Scorer, w, f, dl, avgdl):
    """Counterpart of ``ops/dense_scan.py:_score_expr`` (the fused scan's
    expression; TFIDF uses rsqrt there, where ``score_block`` divides)."""
    if isinstance(scorer, BM25):
        return _bm25(scorer, w, f, dl, avgdl)
    if isinstance(scorer, TFIDF):
        if scorer.with_norms:
            return w * torch.sqrt(f) * torch.rsqrt(torch.clamp_min(dl, 1.0))
        return w * torch.sqrt(f)
    if isinstance(scorer, BoostScore):
        return torch.where(f > 0, w, 0.0)
    raise NotImplementedError(type(scorer))
