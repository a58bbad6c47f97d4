"""K3: postings block decode (gather + unpack + delta prefix sum), plain
and scored.

Counterpart of ``iresearch_tpu/ops/decode.py:decode_rows_pallas`` and of
the XLA decode in ``exec/executor.py:_group_contrib``: docs =
``base[rows_d] + cumsum(unpack(doc_words[rows_d]))`` (int32, wrapping),
freqs = ``f32(int32(unpack(freq_words[rows_f])))``. ``decode_score_rows``
goes on with what ``_group_contrib`` does after the decode, which XLA fused
on the TPU: the doc lengths (the row's inline norm block, or
``norms[docs]`` on segments without norm pools), the score and the match
flag. On CUDA tensors they launch ``k3_decode_rows`` and
``k3_decode_score_rows``; on CPU tensors they run ``decode_rows_ref`` and
``decode_score_rows_ref``. A launch goes to the current stream of the
rows' card, made the current card around the foreign call (a kernel
launched into another card's stream fails; ``torch.cuda.device`` switches
only where the rows' card is not current already).
"""

from __future__ import annotations

import torch

from iresearch_tpu_torch.device import (
    CheckedSets,
    check_tensor,
    raw_stream,
    runs_plain,
)
from iresearch_tpu_torch.formats.bitpack import BITS, unpack_torch
from iresearch_tpu_torch.formats.spec import BLOCK
from iresearch_tpu_torch.kernels import build as kb
from iresearch_tpu_torch.ops.dense_scan import kernel_scorer
from iresearch_tpu_torch.search.scorers import Scorer, f32, score_block_torch


def gather_clamped(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[idx]`` with ``idx`` clamped into range, as an XLA gather
    clamps (an out-of-range index on CUDA is a device assert)."""
    return values[torch.clamp(idx, 0, values.shape[0] - 1).to(torch.int64)]


def decode_rows_ref(doc_words, freq_words, base, rows_d, rows_f, *, bd, bf):
    """Plain PyTorch K3: (docs i32 [R, 128], freqs f32 [R, 128])."""
    rd = rows_d.to(torch.int64)
    d = unpack_torch(doc_words[rd], bd)
    docs = base[rd][:, None] + torch.cumsum(d, dim=1, dtype=torch.int32)
    f = unpack_torch(freq_words[rows_f.to(torch.int64)], bf)
    return docs, f.to(torch.float32)


def decode_score_rows_ref(
    doc_words, freq_words, base, rows_d, rows_f, nrm_words, rows_n, norms,
    w, avgdl, *, bd, bf, bn, scorer: Scorer, want_dl: bool = False,
):
    """Plain PyTorch scored K3: (docs i32 [R, 128], scores f32, matched
    bool[, dl f32]), the decode followed by the doc lengths, the score
    (``score_block_torch``) and ``f > 0``."""
    docs, f = decode_rows_ref(
        doc_words, freq_words, base, rows_d, rows_f, bd=bd, bf=bf
    )
    if bn >= 0:
        # pad lanes carry norm 0 -> clamp to 1 to keep tf math finite
        # (their freq is 0, so they never match or score anyway)
        dl = torch.clamp_min(
            unpack_torch(nrm_words[rows_n.to(torch.int64)], bn).to(torch.float32),
            1.0,
        )
    else:
        dl = gather_clamped(norms, docs)
    sc = score_block_torch(scorer, w[:, None], f, dl, avgdl)
    if want_dl:
        return docs, sc, f > 0, dl
    return docs, sc, f > 0


_pool_sets = CheckedSets()


def _check_pool(t, name, b, dev):
    check_tensor(t, name, torch.int32, dev, 2)
    if b not in BITS or t.shape[1] != 4 * b:
        raise ValueError(f"{name}: width {t.shape[1]} for {b}-bit blocks")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: not 16-byte aligned")


def _pool_args(doc_words, freq_words, base, nrm, bd, bf, bn, dev):
    """The checked pools' share of the foreign call, built once per pool
    set: (doc_words, freq_words, base pointers, doc rows, freq rows,
    nrm_words pointer, norm rows, norms pointer, nd_pad)."""
    _check_pool(doc_words, "doc_words", bd, dev)
    _check_pool(freq_words, "freq_words", bf, dev)
    check_tensor(base, "base", torch.int32, dev, 1)
    if base.shape[0] != doc_words.shape[0]:
        raise ValueError("base and doc_words differ in rows")
    head = (
        doc_words.data_ptr(), freq_words.data_ptr(), base.data_ptr(),
        doc_words.shape[0], freq_words.shape[0],
    )
    if nrm is None:  # the plain form
        return head
    if bn >= 0:
        _check_pool(nrm, "nrm_words", bn, dev)
        return head + (nrm.data_ptr(), nrm.shape[0], None, 0)
    if bn != -1:
        raise ValueError(f"bn={bn}")
    check_tensor(nrm, "norms", torch.float32, dev, 1)
    if nrm.shape[0] < 1:
        raise ValueError("norms: empty")
    return head + (None, 0, nrm.data_ptr(), nrm.shape[0])


def _check_rows(rows_d, rows_f, dev) -> int:
    check_tensor(rows_d, "rows_d", torch.int32, dev, 1)
    check_tensor(rows_f, "rows_f", torch.int32, dev, 1)
    if rows_f.shape != rows_d.shape:
        raise ValueError("rows_d and rows_f differ in length")
    return rows_d.shape[0]


def decode_rows(doc_words, freq_words, base, rows_d, rows_f, *, bd, bf):
    """(docs i32 [R, 128], freqs f32 [R, 128]) of the gathered rows.

    doc_words: int32 [Nd, 4 bd]; freq_words: int32 [Nf, 4 bf]; base:
    int32 [Nd]; rows_d, rows_f: int32 [R]. The pools are checked on the
    first call with them (``CheckedSets``)."""
    if runs_plain(rows_d):
        return decode_rows_ref(
            doc_words, freq_words, base, rows_d, rows_f, bd=bd, bf=bf
        )
    dev = rows_d.device
    pools = (doc_words, freq_words, base)
    static = (dev, bd, bf)
    args = _pool_sets.get(pools, static)
    if args is None:
        args = _pool_sets.put(
            pools, static, _pool_args(*pools, None, bd, bf, -1, dev)
        )
    dw, fw, bs, nd_rows, nf_rows = args
    R = _check_rows(rows_d, rows_f, dev)
    docs, freqs = torch.empty(
        (2, R, BLOCK), dtype=torch.int32, device=dev
    ).unbind(0)
    freqs = freqs.view(torch.float32)
    if R == 0:
        return docs, freqs
    lib = kb.library()
    with torch.cuda.device(dev):  # the launch goes to a stream of the current card
        rc = lib.irs_decode_rows(
            dw, fw, bs, rows_d.data_ptr(), rows_f.data_ptr(), nd_rows, nf_rows,
            R, bd, bf, docs.data_ptr(), freqs.data_ptr(), raw_stream(dev),
        )
    kb.check(lib, rc, "decode_rows")
    kb.count_launch("decode_rows")
    return docs, freqs


def decode_score_rows(
    doc_words, freq_words, base, rows_d, rows_f, nrm_words, rows_n, norms,
    w, avgdl, *, bd, bf, bn, scorer: Scorer, want_dl: bool = False,
):
    """(docs i32 [R, 128], scores f32 [R, 128], matched bool [R, 128][, dl
    f32 [R, 128]]) of the gathered rows: the decode, the doc lengths, the
    score and ``f > 0`` in one launch.

    The pools and rows as ``decode_rows`` takes them. ``bn >= 0``: doc
    lengths are ``max(f32(unpack(nrm_words[rows_n])), 1)``, nrm_words int32
    [Nn, 4 bn], rows_n int32 [R]; ``bn == -1``: they are
    ``norms[clamp(docs)]``, norms f32 [nd_pad]. w: f32 [R], one weight per
    row; avgdl: a float or a one-element f32 tensor on the device."""
    if runs_plain(rows_d):
        return decode_score_rows_ref(
            doc_words, freq_words, base, rows_d, rows_f, nrm_words, rows_n,
            norms, w, avgdl, bd=bd, bf=bf, bn=bn, scorer=scorer,
            want_dl=want_dl,
        )
    dev = rows_d.device
    pools = (doc_words, freq_words, base, nrm_words if bn >= 0 else norms)
    static = (dev, bd, bf, bn)
    args = _pool_sets.get(pools, static)
    if args is None:
        if pools[3] is None:
            raise TypeError("nrm_words (bn >= 0) or norms (bn == -1) is None")
        args = _pool_sets.put(
            pools, static, _pool_args(*pools, bd, bf, bn, dev)
        )
    dw, fw, bs, nd_rows, nf_rows, nw, nn_rows, nrm, nd_pad = args
    R = _check_rows(rows_d, rows_f, dev)
    rn = None
    if bn >= 0:
        check_tensor(rows_n, "rows_n", torch.int32, dev, 1)
        if rows_n.shape[0] != R:
            raise ValueError("rows_d and rows_n differ in length")
        rn = rows_n.data_ptr()
    check_tensor(w, "w", torch.float32, dev, 1)
    if w.shape[0] != R:
        raise ValueError("rows_d and w differ in length")
    avgdl_dev, avgdl_f = None, 0.0
    if isinstance(avgdl, torch.Tensor):
        if avgdl.dtype != torch.float32 or avgdl.device != dev or avgdl.numel() != 1:
            raise ValueError("avgdl: expected one f32 on the rows' device")
        avgdl_dev = avgdl.data_ptr()
    else:
        avgdl_f = f32(avgdl)
    kind, kbv, c0 = kernel_scorer(scorer)
    # docs, scores[, dl] are planes of one allocation
    planes = torch.empty(
        (3 if want_dl else 2, R, BLOCK), dtype=torch.float32, device=dev
    ).unbind(0)
    docs = planes[0].view(torch.int32)
    matched = torch.empty((R, BLOCK), dtype=torch.bool, device=dev)
    res = (docs, planes[1], matched) + planes[2:]
    if R == 0:
        return res
    lib = kb.library()
    with torch.cuda.device(dev):
        rc = lib.irs_decode_score_rows(
            dw, fw, bs, rows_d.data_ptr(), rows_f.data_ptr(), nd_rows, nf_rows,
            R, bd, bf, nw, rn, nn_rows, bn, nrm, nd_pad, w.data_ptr(), avgdl_dev,
            avgdl_f, kind, kbv, c0, docs.data_ptr(), planes[1].data_ptr(),
            matched.data_ptr(), planes[2].data_ptr() if want_dl else None,
            raw_stream(dev),
        )
    kb.check(lib, rc, "decode_score_rows")
    kb.count_launch("decode_score_rows")
    return res
