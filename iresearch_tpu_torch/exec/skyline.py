"""Skyline tier: survivor-row gather and exact rescore (``exec/skyline.py``).

The host half (``SkylineIndex``, ``SkylineSpec``, ``_host_conj_theta`` and
the tuning constants) is the JAX package's numpy code, imported through
``_host``. ``skyline_shape`` and ``skyline_spec`` are copies of the
reference's, because ``skyline_shape`` reaches ``executor.scan_shape``
(which imports jax); ``skyline_index`` builds the ``SkylineIndex`` under
``SegmentReader.skyline_index``'s cache key without going through it.
``skyline_topk_batch`` is the device half in plain torch: the JAX package
runs it in XLA too, with no Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from iresearch_tpu.formats.spec import BLOCK
from iresearch_tpu.search.scorers import Scorer
from iresearch_tpu_torch._host import skyline as _sky
from iresearch_tpu_torch.exec.executor import scan_shape
from iresearch_tpu_torch.formats.bitpack import unpack_torch
from iresearch_tpu_torch.index.segment import dl_rows
from iresearch_tpu_torch.ops.topk import _IMAX32, topk_docs
from iresearch_tpu_torch.search.scorers import score_block_torch


def skyline_index(sr, field_name: str, scorer: Scorer, avgdl: float):
    """``SegmentReader.skyline_index`` without its import of
    ``iresearch_tpu.exec``: same key, same cache on the reader, same
    eligibility (a dense cache with row summaries, doc lengths < 2^16)."""
    key = (field_name, scorer, float(avgdl))
    cached = sr.__dict__.setdefault("_skyline", {})
    if key in cached:
        return cached[key]
    idx = None
    cache = sr.dense_cache(field_name)
    if cache is not None and cache.dl_min is not None:
        fp = sr.data.fields[field_name]
        if len(fp.norms) == 0 or fp.norms.max(initial=0) < 65536:
            idx = _sky.SkylineIndex(cache, scorer, avgdl)
    cached[key] = idx
    return idx


def skyline_shape(plan):
    """"or" | "and" | int mm >= 2 | None (``exec/skyline.py:skyline_shape``)."""
    shape = scan_shape(plan)
    if shape is not None:
        return shape
    if (
        plan.exec_mode != "dense"
        or plan.groups
        or not plan.dense_spans
        or plan.aux_pairs is not None
        or plan.device_aux
    ):
        return None
    L = plan.num_leaves
    if any(int(m) > 1 for m in plan.leaf_min_match[:L]):
        return None
    t = plan.tree
    if (
        t[0] == "or"
        and not t[2]
        and t[4] == "sum"
        and int(t[3]) >= 2
        and all(c[0] == "leaf" for c in t[1])
        and sorted(c[1] for c in t[1]) == list(range(L))
        and [ds.leaf for ds in plan.dense_spans] == list(range(L))
    ):
        return int(t[3])
    return None


def skyline_spec(plan, sr, scorer: Scorer, k: int) -> Optional[_sky.SkylineSpec]:
    """The survivor schedule of an eligible plan, else None — the same
    rules, θ and cost gate as ``exec/skyline.py:skyline_spec``."""
    if not (1 <= k <= _sky.K_MAX) or not _sky._scorer_supported(scorer):
        return None
    shape = skyline_shape(plan)
    if shape not in ("or", "and") and not isinstance(shape, int):
        return None
    spans = plan.dense_spans
    fields = {ds.field_name for ds in spans}
    if len(fields) != 1:
        return None
    fname = next(iter(fields))
    if any(ds.w < 0.0 for ds in spans):
        return None
    if shape == "or":
        scored = [ds for ds in spans if ds.w > 0.0]
    else:
        scored = list(spans)
    if not scored:
        return None
    scored.sort(key=lambda ds: (ds.cls, ds.start))
    ski = skyline_index(sr, fname, scorer, scored[0].avgdl)
    if ski is None:
        return None
    S = len(scored)
    ndrows = scored[0].ndrows
    ws = [float(ds.w) for ds in scored]
    if shape == "or":
        theta = ski.theta(scored, k)
        if not (theta > 0.0):
            return None
        theta_eps = theta * (1.0 - 1e-5) - 1e-30
        rows = ski.survivors(scored, ws, theta_eps)
    else:
        mm = S if shape == "and" else min(int(shape), S + 1)
        hitcnt = np.zeros(ndrows, np.int32)
        acc = np.zeros(ndrows, np.float32)
        for ds, w in zip(scored, ws):
            seg = slice(ds.start, ds.start + ndrows)
            hitcnt += (ski.cache.bmaxf[ds.cls][seg] > 0).astype(np.int32)
            acc += np.float32(w) * ski.ub[ds.cls][seg]
        cand = np.flatnonzero(hitcnt >= mm).astype(np.int32)
        rows = cand
        if len(cand) > 4 * k:
            C = min(len(cand), max(_sky.CONJ_THETA_SAMPLE, 4 * k))
            top = cand[np.argpartition(-acc[cand], C - 1)[:C]]
            theta = _sky._host_conj_theta(
                ski, sr.data.fields[fname], scored, ws, top, scorer,
                scored[0].avgdl, k,
                mm=None if shape == "and" else mm,
            )
            if theta > 0.0:
                theta_eps = theta * (1.0 - 1e-5) - 1e-30
                rows = cand[acc[cand] >= np.float32(theta_eps)]
    M = min(_sky._pow2(max(8, len(rows))), _sky._pow2(ndrows))
    if (
        len(rows) > _sky.SKYLINE_MAX_ROWS
        or M * _sky.SKYLINE_SCAN_RATIO > S * ndrows
    ):
        return None
    padded = np.full(M, _IMAX32, np.int32)
    padded[: len(rows)] = rows
    return _sky.SkylineSpec(
        field_name=fname,
        ndrows=ndrows,
        classes=tuple(ds.cls for ds in scored),
        starts=tuple(ds.start for ds in scored),
        ws=tuple(ws),
        row_ids=padded,
        avgdl=float(scored[0].avgdl),
        k=k,
        conj=shape == "and",
        min_match=1 if shape in ("or", "and") else int(shape),
    )


def skyline_topk_batch(
    span_pools,  # per span: int32 [rows_c, wpb] dense grid pool (shared)
    norms_grid,  # [ndrows, 128] u16/f32 doc lengths (shared)
    rows_b,  # int32 [Q, M] survivor rows, IMAX-padded
    starts_b,  # int32 [Q, S]
    ws_b,  # f32 [Q, S]
    avgdl,  # f32 tensor (0-dim) or float
    *,
    scorer: Scorer,
    span_bits: Tuple[int, ...],
    k: int,
    ndrows: int,
    conj: bool = False,
    mm: int = 1,
):
    """Per-query (vals f32 [Q, k], docs i32 [Q, k]) over the survivor rows
    only: flat row gathers for the whole batch, exact rescore through
    ``score_block``, then the (score desc, doc asc) top-k."""
    S = len(span_pools)
    Q, M = rows_b.shape
    parked = rows_b >= ndrows  # [Q, M]
    safe = torch.where(parked, 0, rows_b).to(torch.int64)
    dl = torch.clamp_min(dl_rows(norms_grid, safe.reshape(-1)), 1.0).reshape(
        Q, M, BLOCK
    )
    score = torch.zeros((Q, M, BLOCK), dtype=torch.float32, device=rows_b.device)
    fagg = None
    for s in range(S):
        rows_abs = torch.where(parked, 0, starts_b[:, s : s + 1] + safe)
        f = unpack_torch(
            span_pools[s][rows_abs.reshape(-1)], span_bits[s]
        ).reshape(Q, M, BLOCK).to(torch.float32)
        score = score + score_block_torch(
            scorer, ws_b[:, s, None, None], f, dl, avgdl
        )
        if mm > 1:  # per-lane hit count for the min_match threshold
            c = (f > 0.0).to(torch.int32)
            fagg = c if fagg is None else fagg + c
        else:
            fagg = f if fagg is None else (
                torch.minimum(fagg, f) if conj else fagg + f
            )
    lane = torch.arange(BLOCK, dtype=torch.int64, device=rows_b.device)
    hit = fagg >= mm if mm > 1 else fagg > 0.0
    match = hit & ~parked[:, :, None]
    docs = torch.where(match, safe[:, :, None] * BLOCK + lane, _IMAX32).to(
        torch.int32
    )
    masked = torch.where(match, score, float("-inf"))
    return topk_docs(masked.reshape(Q, -1), docs.reshape(Q, -1), k)
