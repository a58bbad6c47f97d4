"""K2: batched contiguous row-slice fetch.

Counterpart of ``iresearch_tpu/ops/dma_gather.py:dma_row_slices``: for
every query q and pool p, ``pools[p][starts[q, p] : starts[q, p] + R]``.
There is no clamping: callers rely on the pools' ``DSLICE_PAD`` zero tail
(``index/segment.py``). On CUDA tensors it launches
``k2_dma_row_slices``; on CPU tensors it runs ``dma_row_slices_ref``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from iresearch_tpu_torch.device import check_tensor, runs_plain
from iresearch_tpu_torch.kernels import build as kb

MAX_POOLS = 4  # IRS_MAX_SLICE_POOLS in the kernel source


def dma_row_slices_ref(
    pools: Sequence[torch.Tensor], starts: torch.Tensor, R: int
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch K2: P x [Q, R, wpb_p] row windows (an index past a
    pool's end raises, as nothing is clamped)."""
    ar = torch.arange(R, device=starts.device)
    return tuple(
        p[starts[:, i : i + 1].to(torch.int64) + ar]
        for i, p in enumerate(pools)
    )


def dma_row_slices(
    pools: Sequence[torch.Tensor], starts: torch.Tensor, R: int
) -> Tuple[torch.Tensor, ...]:
    """P x int32 [Q, R, wpb_p]: pools[p][starts[q, p] : starts[q, p] + R].

    pools: P int32 [rows_p, wpb_p]; starts: int32 [Q, P], with
    ``starts + R <= rows_p`` (the kernel writes zeros for rows past a
    pool's end rather than read foreign memory)."""
    if runs_plain(starts):
        return dma_row_slices_ref(pools, starts, R)
    dev = starts.device
    P = len(pools)
    if not 1 <= P <= MAX_POOLS:
        raise ValueError(f"{P} pools (1..{MAX_POOLS})")
    if R < 1:
        raise ValueError(f"R={R}")
    check_tensor(starts, "starts", torch.int32, dev, 2)
    if starts.shape[1] != P:
        raise ValueError(f"starts {tuple(starts.shape)} for {P} pools")
    for i, p in enumerate(pools):
        check_tensor(p, f"pools[{i}]", torch.int32, dev, 2)
    q = starts.shape[0]
    outs = tuple(
        torch.empty((q, R, p.shape[1]), dtype=torch.int32, device=dev)
        for p in pools
    )
    if q == 0:
        return outs
    lib = kb.library()
    rc = lib.irs_dma_row_slices(
        (ctypes.c_void_p * P)(*(p.data_ptr() for p in pools)),
        (ctypes.c_void_p * P)(*(o.data_ptr() for o in outs)),
        (ctypes.c_longlong * P)(*(p.shape[0] for p in pools)),
        (ctypes.c_int * P)(*(p.shape[1] for p in pools)),
        P,
        starts.data_ptr(),
        q,
        R,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    kb.check(lib, rc, "dma_row_slices")
    kb.count_launch("dma_row_slices")
    return outs
