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
That is the plain version, ``topk_docs_ref``, which a CPU tensor runs.

On a CUDA tensor ``topk_docs`` launches K4 (``kernels/csrc/irs_topk.cu``),
which ranks by the same key in registers and writes the input's own f32
bits, so its output equals the plain version's bit for bit, at every k. A
row wider than one tile takes more than one launch (``_plan``); above
``K4_MAX_K`` winners, more than its shared-memory sort holds, the last
select leaves them unsorted and ``_sort`` orders them through device
memory. A launch goes to the current stream of the scores' card, made the
current card around the foreign call.

``noting_calls()`` collects the shape of every ``topk_docs`` call that its
thread makes inside the block, (Q, N, k, doc bytes): the fused pass notes
the calls that it captured (``exec/batch.py:_FusedPass``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional

import torch

from iresearch_tpu_torch.device import raw_stream, runs_plain
from iresearch_tpu_torch.kernels import build as kb

_IMAX32 = 2**31 - 1
K4_MAX_K = 4096  # irs_topk.cu:K4_MAX_K, the most winners a launch sorts
_DOCS_KIND = {None: 0, torch.int32: 1, torch.int64: 2}
_NOTED = threading.local()  # .calls: the list ``noting_calls`` fills, or None


@contextlib.contextmanager
def noting_calls():
    """A block in which each ``topk_docs`` call of this thread appends
    (rows Q, entries a row N, k, bytes of a doc: 4 or 8, 0 where it ranks
    by position) to the list it yields."""
    prev = getattr(_NOTED, "calls", None)
    _NOTED.calls = calls = []
    try:
        yield calls
    finally:
        _NOTED.calls = prev


def _order_key(scores: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    s = scores + 0.0  # -0.0 -> +0.0: equal floats must give equal keys
    bits = s.view(torch.int32).to(torch.int64)
    hi = torch.where(bits < 0, bits ^ _IMAX32, bits)
    return (hi << 32) | (_IMAX32 - docs.to(torch.int64))


def _check(scores: torch.Tensor, docs: Optional[torch.Tensor], k: int) -> None:
    if scores.dtype != torch.float32:
        raise TypeError(f"scores: dtype {scores.dtype}, expected float32")
    if docs is not None and docs.shape != scores.shape:
        raise ValueError(f"docs {tuple(docs.shape)} != scores {tuple(scores.shape)}")
    if not 0 < k <= scores.shape[-1]:
        raise ValueError(f"k={k} outside 1..{scores.shape[-1]}")


def topk_docs_ref(
    scores: torch.Tensor, docs: Optional[torch.Tensor], k: int
):
    """Plain PyTorch ``topk_docs``: one int64 key per (score, doc) and one
    ``torch.topk`` over the keys, the winners gathered."""
    _check(scores, docs, k)
    if docs is None:
        docs = torch.arange(
            scores.shape[-1], dtype=torch.int32, device=scores.device
        ).expand(scores.shape)
    _, idx = torch.topk(_order_key(scores, docs), k, dim=-1, sorted=True)
    return scores.gather(-1, idx), docs.gather(-1, idx)


def _tile_cap(k: int) -> int:
    """The longest tile of a K4 launch at this k: 4,096 entries (the
    fastest of 2,048-16,384 on the card at the batched pass's shapes), or
    the power of two at or above 4k, so that each launch of ``_plan``
    halves a row or more; up to k = 4,096 at most 16,384, which keep
    their keys in shared memory (irs_topk.cu:K4_TILE_MAX)."""
    return max(4096, 1 << (4 * k - 1).bit_length())


def _plan(n: int, k: int) -> List[int]:
    """K4's launches for rows of ``n`` entries: the tiles of each. A launch
    cuts each row into equal tiles (at least 2k entries each) and leaves
    each tile's k best, ``tiles * k`` a row, for the next; the last holds
    a row in one tile."""
    cap = _tile_cap(k)
    out = []
    while n > cap:
        out.append(-(-n // cap))
        n = out[-1] * k
    return out + [1]


def _sort_launches(k: int) -> int:
    """``_sort``'s launches at this k: its runs of ``K4_MAX_K``, sorted in
    one, then one a level of their pairwise merge."""
    return 1 + (-(-k // K4_MAX_K) - 1).bit_length()


def launches(n: int, k: int) -> int:
    """K4's launches for rows of ``n`` entries at this k."""
    return len(_plan(n, k)) + (_sort_launches(k) if k > K4_MAX_K else 0)


def _select(scores, docs, tiles: int, k: int, vals, out_docs) -> None:
    """One K4 launch: each row of ``scores`` [Q, n] (``docs`` [Q, n] int32
    or int64, or None for positions) cut into ``tiles`` tiles, tile t the
    columns [t * n // tiles, (t + 1) * n // tiles); each tile's k best to
    ``vals`` / ``out_docs`` [Q, tiles * k] at t * k, sorted where
    ``tiles`` is 1 and k is at most ``K4_MAX_K``."""
    dev = scores.device
    q, n = scores.shape
    dptr, drs, dcs = (None, 0, 0) if docs is None else (docs.data_ptr(), *docs.stride())
    lib = kb.library()
    with torch.cuda.device(dev):  # the launch goes to a stream of the current card
        rc = lib.irs_topk_docs(
            scores.data_ptr(), *scores.stride(), dptr, drs, dcs,
            _DOCS_KIND[None if docs is None else docs.dtype], q, n, tiles, k,
            vals.data_ptr(), out_docs.data_ptr(), raw_stream(dev),
        )
    kb.check(lib, rc, "topk_docs")
    kb.count_launch("topk_docs")


def _sort(vals, docs, out_vals, out_docs) -> None:
    """K4's sort of [Q, k] ``vals`` / ``docs`` (int32 or int64; contiguous,
    as ``_select`` leaves them) by (score desc, doc asc) into ``out_vals``
    / ``out_docs``, for k above ``K4_MAX_K``: ``_sort_launches(k)``
    launches over two [2, Q, k] buffers of keys and positions."""
    dev = vals.device
    q, k = vals.shape
    keys = torch.empty((2, q, k), dtype=torch.int64, device=dev)
    pos = torch.empty((2, q, k), dtype=torch.int32, device=dev)
    lib = kb.library()
    with torch.cuda.device(dev):
        rc = lib.irs_topk_sort(
            vals.data_ptr(), docs.data_ptr(), _DOCS_KIND[docs.dtype], q, k,
            keys.data_ptr(), pos.data_ptr(), out_vals.data_ptr(),
            out_docs.data_ptr(), raw_stream(dev),
        )
    kb.check(lib, rc, "topk_docs")
    kb.count_launch("topk_docs", _sort_launches(k))


def topk_docs(
    scores: torch.Tensor, docs: Optional[torch.Tensor], k: int
):
    """(vals f32 [..., k], docs [..., k]) of the k best entries of the last
    axis by (score desc, doc asc). ``docs=None`` ranks by position (the
    ``lax.top_k`` order) and returns positions as int32. On a CUDA tensor
    ``docs`` is int32 or int64 on the same card."""
    noted = getattr(_NOTED, "calls", None)
    if noted is not None:
        n = scores.shape[-1]
        noted.append((scores.numel() // n if n else 0, n, k,
                      0 if docs is None else docs.element_size()))
    if runs_plain(scores):
        return topk_docs_ref(scores, docs, k)
    _check(scores, docs, k)
    if docs is not None:
        if docs.dtype not in _DOCS_KIND:
            raise TypeError(f"docs: dtype {docs.dtype}, expected int32 or int64")
        if docs.device != scores.device:
            raise ValueError(f"docs: on {docs.device}, expected {scores.device}")
    n = scores.shape[-1]
    lead = scores.shape[:-1]
    s = scores.reshape(-1, n)
    d = None if docs is None else docs.reshape(-1, n)
    dtype = torch.int32 if docs is None else docs.dtype
    for tiles in _plan(n, k):
        vals = torch.empty((s.shape[0], tiles * k), dtype=torch.float32, device=s.device)
        out = torch.empty((s.shape[0], tiles * k), dtype=dtype, device=s.device)
        if s.shape[0]:
            _select(s, d, tiles, k, vals, out)
        s, d = vals, out
    if k > K4_MAX_K and s.shape[0]:
        vals, out = torch.empty_like(s), torch.empty_like(d)
        _sort(s, d, vals, out)
        s, d = vals, out
    return s.reshape(*lead, k), d.reshape(*lead, k)
