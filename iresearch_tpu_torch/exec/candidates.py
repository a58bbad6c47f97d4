"""dslice tier core: decode + score + top-k (``exec/candidates.py``).

``dslice_core`` is the batched counterpart of the reference's
``dslice_core``: it takes every query's pre-fetched [R, wpb] row windows
(K2's output), decodes them with K3 (``ops/decode.py``), scores through
``score_block`` and takes the exact top-k.
"""

from __future__ import annotations

import torch

from iresearch_tpu.formats.spec import BLOCK
from iresearch_tpu.search.scorers import Scorer
from iresearch_tpu_torch.formats.bitpack import unpack_torch
from iresearch_tpu_torch.ops.decode import decode_rows
from iresearch_tpu_torch.ops.topk import _IMAX32, topk_docs
from iresearch_tpu_torch.search.scorers import score_block_torch


def dslice_core(
    dwords,  # int32 [Q, R, 4 bd]
    fwords,  # int32 [Q, R, 4 bf]
    nwords,  # int32 [Q, R, 4 bn] or None (bn == -1)
    base_r,  # int32 [Q, R]
    norms,  # f32 [nd_pad]
    nreal,  # int32 [Q] real row counts
    w,  # f32 [Q] term weights
    avgdl,  # f32 tensor (0-dim) or float
    alive,  # bool [nd_pad] or None
    *,
    gbits,
    scorer: Scorer,
    k: int,
    decode=decode_rows,
):
    """Per-query (vals f32 [Q, k], docs i32 [Q, k]). Rows past a query's
    real count decode other terms' data: they are masked by ``nreal`` and
    their doc ids parked at IMAX, so tie-break cannot collide with a real
    doc. ``decode`` is K3 (``decode_rows``) or its plain version."""
    bd, bf, bn = gbits
    Q, R = base_r.shape
    n = Q * R
    rows = torch.arange(n, dtype=torch.int32, device=base_r.device)
    docs, f = decode(
        dwords.reshape(n, -1), fwords.reshape(n, -1), base_r.reshape(n),
        rows, rows, bd=bd, bf=bf,
    )
    docs = docs.reshape(Q, R, BLOCK)
    f = f.reshape(Q, R, BLOCK)
    if bn >= 0:
        dl = torch.clamp_min(unpack_torch(nwords, bn).to(torch.float32), 1.0)
    else:
        dl = norms[torch.clamp(docs, 0, norms.shape[0] - 1).to(torch.int64)]
    sc = score_block_torch(scorer, w[:, None, None], f, dl, avgdl)
    rowix = torch.arange(R, dtype=torch.int32, device=base_r.device)
    live = (rowix[None, :] < nreal[:, None])[:, :, None] & (f > 0)
    if alive is not None:
        live = live & alive[torch.clamp(docs, 0, alive.shape[0] - 1).to(torch.int64)]
    docs = torch.where(live, docs, _IMAX32)
    masked = torch.where(live, sc, float("-inf"))
    return topk_docs(masked.reshape(Q, -1), docs.reshape(Q, -1), k)
