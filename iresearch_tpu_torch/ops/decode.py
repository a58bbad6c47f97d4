"""K3: postings block decode (gather + unpack + delta prefix sum).

Counterpart of ``iresearch_tpu/ops/decode.py:decode_rows_pallas`` and of
the XLA decode in ``exec/executor.py:_group_contrib``: docs =
``base[rows_d] + cumsum(unpack(doc_words[rows_d]))`` (int32, wrapping),
freqs = ``f32(int32(unpack(freq_words[rows_f])))``. On CUDA tensors it
launches ``k3_decode_rows``; on CPU tensors it runs ``decode_rows_ref``.
"""

from __future__ import annotations

import torch

from iresearch_tpu_torch.device import check_tensor, runs_plain
from iresearch_tpu_torch.formats.bitpack import unpack_torch
from iresearch_tpu_torch.formats.spec import BLOCK
from iresearch_tpu_torch.kernels import build as kb


def decode_rows_ref(doc_words, freq_words, base, rows_d, rows_f, *, bd, bf):
    """Plain PyTorch K3: (docs i32 [R, 128], freqs f32 [R, 128])."""
    rd = rows_d.to(torch.int64)
    d = unpack_torch(doc_words[rd], bd)
    docs = base[rd][:, None] + torch.cumsum(d, dim=1, dtype=torch.int32)
    f = unpack_torch(freq_words[rows_f.to(torch.int64)], bf)
    return docs, f.to(torch.float32)


def decode_rows(doc_words, freq_words, base, rows_d, rows_f, *, bd, bf):
    """(docs i32 [R, 128], freqs f32 [R, 128]) of the gathered rows.

    doc_words: int32 [Nd, 4 bd]; freq_words: int32 [Nf, 4 bf]; base:
    int32 [Nd]; rows_d, rows_f: int32 [R]."""
    if runs_plain(rows_d):
        return decode_rows_ref(
            doc_words, freq_words, base, rows_d, rows_f, bd=bd, bf=bf
        )
    dev = rows_d.device
    check_tensor(doc_words, "doc_words", torch.int32, dev, 2)
    check_tensor(freq_words, "freq_words", torch.int32, dev, 2)
    check_tensor(base, "base", torch.int32, dev, 1)
    check_tensor(rows_d, "rows_d", torch.int32, dev, 1)
    check_tensor(rows_f, "rows_f", torch.int32, dev, 1)
    if doc_words.shape[1] != 4 * bd or freq_words.shape[1] != 4 * bf:
        raise ValueError("pool widths do not match bd/bf")
    if base.shape[0] != doc_words.shape[0]:
        raise ValueError("base and doc_words differ in rows")
    if rows_f.shape != rows_d.shape:
        raise ValueError("rows_d and rows_f differ in length")
    R = rows_d.shape[0]
    docs = torch.empty((R, BLOCK), dtype=torch.int32, device=dev)
    freqs = torch.empty((R, BLOCK), dtype=torch.float32, device=dev)
    if R == 0:
        return docs, freqs
    lib = kb.library()
    rc = lib.irs_decode_rows(
        doc_words.data_ptr(),
        freq_words.data_ptr(),
        base.data_ptr(),
        rows_d.data_ptr(),
        rows_f.data_ptr(),
        doc_words.shape[0],
        freq_words.shape[0],
        R,
        bd,
        bf,
        docs.data_ptr(),
        freqs.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    kb.check(lib, rc, "decode_rows")
    kb.count_launch("decode_rows")
    return docs, freqs
