"""K1: fused row-max scan over dense-grid spans, and the rows' rescore.

Counterpart of ``iresearch_tpu/ops/dense_scan.py``. ``dense_scan_rowmax``
is the fused-scan tier's first stage: for every query and every 128-doc
grid row, the max summed span score and its first lane, read straight
from ``(pool, start[q])`` without building any slice. On CUDA tensors it
launches the hand-written kernel (``kernels/csrc/irs_kernels.cu``,
``k1_dense_scan_rowmax``); on CPU tensors it runs
``dense_scan_rowmax_ref``, the plain PyTorch version of the same
function. ``score_rows`` rescores the selected rows exactly (plain torch,
as in the JAX package, where the rescore is XLA).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from iresearch_tpu_torch.device import check_tensor, raw_stream, runs_plain
from iresearch_tpu_torch.formats.bitpack import unpack_torch
from iresearch_tpu_torch.formats.spec import BLOCK
from iresearch_tpu_torch.index.segment import dl_rows
from iresearch_tpu_torch.kernels import build as kb
from iresearch_tpu_torch.search.scorers import (
    BM25,
    TFIDF,
    BoostScore,
    Scorer,
    bm25_consts,
    f32,
    score_expr_torch,
)

MAX_SPANS = 64  # IRS_MAX_SPANS in the kernel source


def _hit_mask(fagg, mm: int):
    return fagg >= float(mm) if mm > 1 else fagg > 0.0


def _accumulate(fagg, f, s: int, conj: bool, mm: int):
    h = (f > 0.0).to(torch.float32) if mm > 1 else f
    if s == 0:
        return h
    return torch.minimum(fagg, h) if conj else fagg + h


def dense_scan_rowmax_ref(
    pools: Sequence[torch.Tensor],
    starts: torch.Tensor,
    ws: torch.Tensor,
    norms: torch.Tensor,
    avgdl: float,
    *,
    scorer: Scorer,
    span_bits: Tuple[int, ...],
    conj: bool = False,
    mm: int = 1,
):
    """Plain PyTorch K1: (row_max f32 [Q, ndrows], row_arg i32 [Q, ndrows]).

    Same math as ``dense_scan_rowmax_xla`` per query, with each span's
    rows taken from ``pools[s][starts[q, s] + r]``."""
    q = starts.shape[0]
    ndrows = norms.shape[0]
    dl = dl_rows(norms)
    ar = torch.arange(ndrows, device=norms.device)
    score = torch.zeros((q, ndrows, BLOCK), dtype=torch.float32, device=norms.device)
    fagg = None
    for s, b in enumerate(span_bits):
        rows = starts[:, s : s + 1].to(torch.int64) + ar  # [Q, ndrows]
        f = unpack_torch(pools[s][rows], b).to(torch.float32)
        score = score + score_expr_torch(
            scorer, ws[:, s, None, None], f, dl, avgdl
        )
        fagg = _accumulate(fagg, f, s, conj, mm)
    masked = torch.where(_hit_mask(fagg, mm), score, float("-inf"))
    amax = masked.amax(dim=-1)
    lane = torch.arange(BLOCK, dtype=torch.int32, device=norms.device)
    first = torch.where(masked == amax[..., None], lane, BLOCK).amin(dim=-1)
    return amax, torch.clamp_max(first, BLOCK - 1).to(torch.int32)


@functools.lru_cache(maxsize=None)
def kernel_scorer(scorer: Scorer):
    """(kind, kb, c0) of the kernel's ``score_expr`` (enum ScoreKind);
    remembered per scorer (the scorers are frozen dataclasses)."""
    if isinstance(scorer, BM25):
        kbv, c0 = bm25_consts(scorer)
        return (0 if scorer.b != 0.0 else 1), kbv, c0
    if isinstance(scorer, TFIDF):
        return (2 if scorer.with_norms else 3), 0.0, 0.0
    if isinstance(scorer, BoostScore):
        return 4, 0.0, 0.0
    raise NotImplementedError(type(scorer))


def dense_scan_rowmax(
    pools: Sequence[torch.Tensor],
    starts: torch.Tensor,
    ws: torch.Tensor,
    norms: torch.Tensor,
    avgdl: float,
    *,
    scorer: Scorer,
    span_bits: Tuple[int, ...],
    conj: bool = False,
    mm: int = 1,
):
    """(row_max f32 [Q, ndrows], row_arg i32 [Q, ndrows]) of the summed
    span scores of every query; -inf for rows without a hit.

    pools: S int32 [rows_s, 4 b_s] grid pools (u32 bit-views); starts:
    int32 [Q, S] first grid row of each span; ws: f32 [Q, S] span weights;
    norms: u16 or f32 [ndrows, 128] doc lengths; avgdl: the span field's
    avgdl."""
    if runs_plain(norms):
        return dense_scan_rowmax_ref(
            pools, starts, ws, norms, avgdl, scorer=scorer,
            span_bits=span_bits, conj=conj, mm=mm,
        )
    dev = norms.device
    S = len(span_bits)
    if not 1 <= S <= MAX_SPANS or len(pools) != S:
        raise ValueError(f"{len(pools)} pools for {S} spans (1..{MAX_SPANS})")
    if norms.dtype not in (torch.uint16, torch.float32):
        raise TypeError(f"norms: dtype {norms.dtype}, expected uint16/float32")
    check_tensor(norms, "norms", norms.dtype, dev, 2)
    if norms.shape[1] != BLOCK:
        raise ValueError(f"norms: {tuple(norms.shape)}, expected [ndrows, {BLOCK}]")
    check_tensor(starts, "starts", torch.int32, dev, 2)
    check_tensor(ws, "ws", torch.float32, dev, 2)
    q, ndrows = starts.shape[0], norms.shape[0]
    if starts.shape[1] != S or tuple(ws.shape) != tuple(starts.shape):
        raise ValueError(f"starts {tuple(starts.shape)} / ws {tuple(ws.shape)} vs S={S}")
    for s, (p, b) in enumerate(zip(pools, span_bits)):
        check_tensor(p, f"pools[{s}]", torch.int32, dev, 2)
        if p.shape[1] != 4 * b:
            raise ValueError(f"pools[{s}]: width {p.shape[1]} != 4*{b}")
    out_max = torch.empty((q, ndrows), dtype=torch.float32, device=dev)
    out_arg = torch.empty((q, ndrows), dtype=torch.int32, device=dev)
    if q == 0:
        return out_max, out_arg
    kind, kbv, c0 = kernel_scorer(scorer)
    lib = kb.library()
    with torch.cuda.device(dev):  # the launch goes to a stream of the current card
        rc = lib.irs_dense_scan_rowmax(
            (ctypes.c_void_p * S)(*(p.data_ptr() for p in pools)),
            (ctypes.c_longlong * S)(*(p.shape[0] for p in pools)),
            (ctypes.c_int * S)(*span_bits),
            S,
            starts.data_ptr(),
            ws.data_ptr(),
            norms.data_ptr(),
            int(norms.dtype == torch.uint16),
            ndrows,
            q,
            kind,
            kbv,
            c0,
            f32(avgdl),
            int(conj),
            int(mm),
            out_max.data_ptr(),
            out_arg.data_ptr(),
            raw_stream(dev),
        )
    kb.check(lib, rc, "dense_scan_rowmax")
    kb.count_launch("dense_scan_rowmax")
    return out_max, out_arg


def score_rows(
    pools: Sequence[torch.Tensor],
    starts: torch.Tensor,
    ws: torch.Tensor,
    norms: torch.Tensor,
    avgdl: float,
    rows: torch.Tensor,
    *,
    scorer: Scorer,
    span_bits: Tuple[int, ...],
    conj: bool = False,
    mm: int = 1,
):
    """Masked scores f32 [Q, m, 128] of each query's selected grid rows
    (``rows`` int [Q, m]): the flat-gather rescore of the batched scan
    tier (``exec/batch.py:242-278``, ``_score_rows``), through the same
    expression as the row-max stage, so selection and score agree."""
    q, m = rows.shape
    flat = rows.reshape(-1).to(torch.int64)
    dl = dl_rows(norms, flat).reshape(q, m, BLOCK)
    score = torch.zeros((q, m, BLOCK), dtype=torch.float32, device=norms.device)
    fagg = None
    for s, b in enumerate(span_bits):
        rows_abs = (starts[:, s : s + 1].to(torch.int64) + rows).reshape(-1)
        f = unpack_torch(pools[s][rows_abs], b).reshape(q, m, BLOCK).to(
            torch.float32
        )
        score = score + score_expr_torch(
            scorer, ws[:, s, None, None], f, dl, avgdl
        )
        fagg = _accumulate(fagg, f, s, conj, mm)
    return torch.where(_hit_mask(fagg, mm), score, float("-inf"))
