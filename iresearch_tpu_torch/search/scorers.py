"""Scorers: the BM25, TFIDF and BoostScore descriptors and their torch twins.

The descriptors, ``score_block`` (numpy), ``max_score_blocks`` and the
``get_scorer`` registry are a copy of ``iresearch_tpu/search/scorers.py``.
Formulas (reference: core/search/bm25.cpp, tfidf.cpp, boost_scorer.hpp):

    BM25   idf = log1p((N - df + 0.5) / (df + 0.5)), weight = boost (k+1) idf
           score = weight * tf / (tf + k (1 - b + b dl / avgdl))
    TFIDF  idf = log1p((N + 1) / (df + 1)), score = boost idf sqrt(tf) / sqrt(dl)

``score_block_torch`` and ``score_expr_torch`` keep the JAX package's
operation order on torch tensors, so that results agree with it to float
reorder only, and so that a CUDA kernel doing the same operations in the
same order (built with ``--fmad=false``) matches the plain version bit
for bit:

    BM25   w * f / max(f + (c0 + (kb / avgdl) * dl), 1e-9)

Python constants are rounded to f32 on the host (as JAX's weak typing
rounds them) and ``kb / avgdl`` is an f32 division, as JAX computes it
with a traced f32 avgdl.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class Scorer:
    """Base scorer descriptor; stateless and hashable (jit cache key)."""

    def idf(self, df: int, docs_with_field: int) -> float:
        raise NotImplementedError

    @property
    def kind(self) -> str:
        raise NotImplementedError

    def term_weight(self, boost: float, idf: float) -> float:
        raise NotImplementedError

    def needs_norms(self) -> bool:
        return False


@dataclass(frozen=True)
class BM25(Scorer):
    k: float = 1.2
    b: float = 0.75

    @property
    def kind(self) -> str:
        return "bm25"

    def idf(self, df: int, docs_with_field: int) -> float:
        return math.log1p((docs_with_field - df + 0.5) / (df + 0.5))

    def term_weight(self, boost: float, idf: float) -> float:
        return boost * (self.k + 1.0) * idf

    def needs_norms(self) -> bool:
        return self.b != 0.0

    def norm_consts(self, avgdl: float) -> Tuple[float, float]:
        """(c_const, c_len): denominator = tf + c_const + c_len * dl."""
        kb = self.k * self.b
        return self.k - kb, (kb / avgdl if avgdl > 0 else kb)

    def max_score(self, weight: float, max_freq: float, min_dl: float, avgdl: float) -> float:
        """Upper bound of this term's contribution (block-max/WAND source,
        reference: wand_writer.hpp kDivNorm producers)."""
        c0, c1 = self.norm_consts(avgdl)
        tf = max_freq
        return weight * tf / (tf + c0 + c1 * min_dl)


@dataclass(frozen=True)
class TFIDF(Scorer):
    with_norms: bool = True

    @property
    def kind(self) -> str:
        return "tfidf"

    def idf(self, df: int, docs_with_field: int) -> float:
        return math.log1p((docs_with_field + 1.0) / (df + 1.0))

    def term_weight(self, boost: float, idf: float) -> float:
        return boost * idf

    def needs_norms(self) -> bool:
        return self.with_norms

    def max_score(self, weight: float, max_freq: float, min_dl: float, avgdl: float) -> float:
        tf = math.sqrt(max_freq)
        return weight * tf * (1.0 / math.sqrt(max(min_dl, 1.0)) if self.with_norms else 1.0)


@dataclass(frozen=True)
class BoostScore(Scorer):
    """Constant boost per matching doc (reference: boost_scorer.hpp)."""

    @property
    def kind(self) -> str:
        return "const"

    def idf(self, df: int, docs_with_field: int) -> float:
        return 1.0

    def term_weight(self, boost: float, idf: float) -> float:
        return boost

    def max_score(self, weight: float, max_freq: float, min_dl: float, avgdl: float) -> float:
        return weight


def score_block(
    scorer: Scorer,
    weights,  # [R] or broadcastable per-row term weight
    freqs,  # [R, B] float
    dl,  # [R, B] float doc lengths (>= 1)
    avgdl: float,
    xp=np,
):
    """Per-posting score contributions; exactly 0 where freq == 0.

    ``xp`` is numpy for the host oracle or jax.numpy in the TPU kernel.
    """
    f = freqs
    if isinstance(scorer, BM25):
        # inline norm_consts: avgdl may be a traced jax scalar (callers
        # guarantee avgdl > 0, substituting 1.0 for empty fields)
        kb = scorer.k * scorer.b
        c0 = scorer.k - kb
        denom = f + (c0 + (kb / avgdl) * dl if scorer.b != 0.0 else c0)
        out = weights * f / xp.maximum(denom, 1e-9)
    elif isinstance(scorer, TFIDF):
        tf = xp.sqrt(f)
        if scorer.with_norms:
            out = weights * tf / xp.sqrt(xp.maximum(dl, 1.0))
        else:
            out = weights * tf
    elif isinstance(scorer, BoostScore):
        out = weights * (f > 0).astype(dl.dtype if hasattr(dl, "dtype") else np.float32)
    else:
        raise TypeError(f"unknown scorer {scorer!r}")
    return out


def max_score_blocks(scorer: Scorer, weight: float, max_freq, min_dl: float, avgdl: float):
    """Vectorized per-block score upper bound (WAND source; reference:
    wand_writer.hpp producers). ``max_freq`` is an array of per-block max
    frequencies; ``min_dl`` the term-level minimum doc length."""
    f = np.asarray(max_freq, np.float32)
    if isinstance(scorer, BM25):
        kb = scorer.k * scorer.b
        c0 = scorer.k - kb
        c1 = kb / avgdl if avgdl > 0 else kb
        denom = f + c0 + (c1 * min_dl if scorer.b != 0.0 else 0.0)
        return weight * f / np.maximum(denom, 1e-9)
    if isinstance(scorer, TFIDF):
        tf = np.sqrt(f)
        if scorer.with_norms:
            return weight * tf / np.sqrt(max(min_dl, 1.0))
        return weight * tf
    if isinstance(scorer, BoostScore):
        return np.where(f > 0, np.float32(weight), np.float32(0.0))
    raise TypeError(f"unknown scorer {scorer!r}")


_SCORERS = {
    "bm25": lambda a: BM25(
        k=float(a.get("k", 1.2)), b=float(a.get("b", 0.75))
    ),
    "tfidf": lambda a: TFIDF(with_norms=bool(a.get("withNorms", True))),
    "boost": lambda a: BoostScore(),
}


def get_scorer(name: str, args: dict | None = None) -> Scorer:
    """Named scorer registry (reference: scorers::get, scorers.cpp:92)."""
    if name not in _SCORERS:
        raise KeyError(f"unknown scorer: {name!r}")
    return _SCORERS[name](args or {})


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
