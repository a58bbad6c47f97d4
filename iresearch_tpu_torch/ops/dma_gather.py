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

from iresearch_tpu_torch.device import (
    CheckedSets,
    check_tensor,
    raw_stream,
    runs_plain,
)
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


_pool_sets = CheckedSets()


def _pool_args(pools: Sequence[torch.Tensor], dev):
    """The checked pools' share of the foreign call: (pointers, row
    counts, row widths as ctypes arrays, the widths as a tuple), built
    once per pool set."""
    P = len(pools)
    if not 1 <= P <= MAX_POOLS:
        raise ValueError(f"{P} pools (1..{MAX_POOLS})")
    for i, p in enumerate(pools):
        check_tensor(p, f"pools[{i}]", torch.int32, dev, 2)
        if p.shape[1] < 1:
            raise ValueError(f"pools[{i}]: empty rows")
    wpb = tuple(p.shape[1] for p in pools)
    return (
        (ctypes.c_void_p * P)(*(p.data_ptr() for p in pools)),
        (ctypes.c_longlong * P)(*(p.shape[0] for p in pools)),
        (ctypes.c_int * P)(*wpb),
        wpb,
    )


def dma_row_slices(
    pools: Sequence[torch.Tensor], starts: torch.Tensor, R: int
) -> Tuple[torch.Tensor, ...]:
    """P x int32 [Q, R, wpb_p]: pools[p][starts[q, p] : starts[q, p] + R].

    pools: P int32 [rows_p, wpb_p]; starts: int32 [Q, P], with
    ``starts + R <= rows_p`` (the kernel writes zeros for rows past a
    pool's end rather than read foreign memory). The P outputs are views
    of one allocation, each starting on a 16-byte boundary. The pools are
    checked on the first call with them (``CheckedSets``)."""
    if runs_plain(starts):
        return dma_row_slices_ref(pools, starts, R)
    dev = starts.device
    pools = tuple(pools)
    args = _pool_sets.get(pools, (dev,))
    if args is None:
        args = _pool_sets.put(pools, (dev,), _pool_args(pools, dev))
    ptrs, rows, widths, wpb = args
    P = len(wpb)
    if R < 1:
        raise ValueError(f"R={R}")
    check_tensor(starts, "starts", torch.int32, dev, 2)
    if starts.shape[1] != P:
        raise ValueError(f"starts {tuple(starts.shape)} for {P} pools")
    q = starts.shape[0]
    # pool p's windows start at a multiple of 4 words, as the kernel's
    # entry point lays them out
    offs = [0]
    for w in wpb:
        offs.append(offs[-1] + (q * R * w + 3) // 4 * 4)
    buf = torch.empty((offs[-1],), dtype=torch.int32, device=dev)
    outs = tuple(
        buf.as_strided((q, R, w), (R * w, w, 1), o) for w, o in zip(wpb, offs)
    )
    if q == 0:
        return outs
    lib = kb.library()
    with torch.cuda.device(dev):  # the launch goes to a stream of the current card
        rc = lib.irs_dma_row_slices(
            ptrs, rows, widths, P, starts.data_ptr(), q, R, buf.data_ptr(),
            raw_stream(dev),
        )
    kb.check(lib, rc, "dma_row_slices")
    kb.count_launch("dma_row_slices")
    return outs
