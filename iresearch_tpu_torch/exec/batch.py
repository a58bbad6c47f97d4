"""Batched query execution on torch tensors (``exec/batch.py``).

``QueryBatch`` groups prepared queries by plan signature exactly as the
JAX package does (``_plans_and_sigs``, ``_bucket4``) and stacks each group
into one batched call. Three tiers are ported, tried in the reference's
order:

* skyline — survivor-row gather and exact rescore (``exec/skyline.py``);
* dslice — K2 fetches each query's contiguous [R, wpb] windows of the
  doc, freq and norm pools and of ``base``; K3 decodes them; then score
  and top-k (``exec/candidates.py:dslice_core``);
* fused scan — K1 computes every grid row's max for every query straight
  from (pool, start[q]); the top ``m = min(max(2k, 16), ndrows)`` rows
  are rescored exactly with flat gathers.

A group that would take any other tier (candidates, WAND, full fold,
aux) raises ``NotImplementedError`` naming it; nothing runs elsewhere.
The JAX package's relay-upload packing and TPU lane budgets have no
counterpart here: each call's inputs are uploaded once at ``prepare`` and
``run`` only launches work.
"""

from __future__ import annotations

from collections import defaultdict, namedtuple
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from iresearch_tpu.formats.bitpack import BITS
from iresearch_tpu.formats.spec import BLOCK
from iresearch_tpu.search import filters as F
from iresearch_tpu.search.scorers import BM25, Scorer
from iresearch_tpu_torch._host import skyline as _sky
from iresearch_tpu_torch.exec.candidates import dslice_core
from iresearch_tpu_torch.exec.executor import TorchQuery, scan_shape
from iresearch_tpu_torch.exec.skyline import skyline_spec, skyline_topk_batch
from iresearch_tpu_torch.index.segment import device_state
from iresearch_tpu_torch.ops.decode import decode_rows, decode_rows_ref
from iresearch_tpu_torch.ops.dense_scan import (
    dense_scan_rowmax,
    dense_scan_rowmax_ref,
    score_rows,
)
from iresearch_tpu_torch.ops.dma_gather import dma_row_slices, dma_row_slices_ref
from iresearch_tpu_torch.ops.topk import _IMAX32, topk_docs
from iresearch_tpu_torch.search.scorers import f32


# the three kernel stages of the batch path; PLAIN holds their plain
# versions, which ``run_grouped(plain=True)`` calls directly (the kernel
# wrappers themselves take the plain version only for CPU tensors)
Kernels = namedtuple("Kernels", "rowmax row_slices decode")
KERNELS = Kernels(dense_scan_rowmax, dma_row_slices, decode_rows)
PLAIN = Kernels(dense_scan_rowmax_ref, dma_row_slices_ref, decode_rows_ref)


def _bucket4(n: int) -> int:
    """Row-count bucket at 4x granularity (``exec/batch.py:_bucket4``)."""
    b = 8
    while b < n:
        b <<= 2
    return b


def _run_skyline(
    kern, span_pools, norms_grid, rows_b, starts_b, ws_b, avgdl, **kw
):
    return skyline_topk_batch(
        span_pools, norms_grid, rows_b, starts_b, ws_b, avgdl, **kw
    )


def _run_dslice(
    kern, pools, starts, nreal_b, w_b, norms, avgdl, alive,
    *, gbits, scorer, k, R,
):
    """pools: the P slice pools (doc, freq[, nrm], base as [rows, 1]);
    starts: int32 [Q, P]."""
    outs = kern.row_slices(pools, starts, R)
    q = starts.shape[0]
    return dslice_core(
        outs[0], outs[1], outs[2] if gbits[2] >= 0 else None,
        outs[-1].reshape(q, R), norms, nreal_b, w_b, avgdl, alive,
        gbits=gbits, scorer=scorer, k=k, decode=kern.decode,
    )


def _run_scan(
    kern, pools, norms_grid, starts, ws, avgdl_f, avgdl_t,
    *, scorer, span_bits, k, ndrows, conj, mm,
):
    """Fused scan: K1 row maxima, the top-m rows by (max desc, row asc),
    exact rescore. The top 2k rows provably hold every winner
    (``ops/dense_scan.py:dense_scan_topk``)."""
    bv, _arg = kern.rowmax(
        pools, starts, ws, norms_grid, avgdl_f,
        scorer=scorer, span_bits=span_bits, conj=conj, mm=mm,
    )
    m = min(max(2 * k, 16), ndrows)
    _rv, rows = topk_docs(bv, None, m)  # [Q, m]
    masked = score_rows(
        pools, starts, ws, norms_grid, avgdl_t, rows,
        scorer=scorer, span_bits=span_bits, conj=conj, mm=mm,
    )
    lane = torch.arange(BLOCK, dtype=torch.int32, device=rows.device)
    docs = rows[:, :, None] * BLOCK + lane
    q = rows.shape[0]
    return topk_docs(masked.reshape(q, -1), docs.reshape(q, -1), k)


class QueryBatch:
    """Executes many prepared queries per segment in few batched calls.

    Queries are grouped by plan signature; each group becomes one stacked
    call. Results are exact per-query top-k, equal to the JAX package's
    ``QueryBatch`` on the same segment. ``device`` is required: nothing
    picks one."""

    def __init__(
        self,
        filters: Sequence[F.Filter],
        segments: Sequence,
        scorer: Optional[Scorer] = None,
        wand: bool = False,
        wand_sample: int = 16,
        wand_mode: str = "exact",
        *,
        device,
    ) -> None:
        if wand_mode not in ("exact", "strict", "approx"):
            raise ValueError(
                f"wand_mode must be exact|strict|approx, got {wand_mode!r}"
            )
        # wand_sample and wand_mode only steer the WAND tier, which is not
        # ported: a group that needs it raises at prepare
        self.scorer = scorer or BM25()
        self.segments = list(segments)
        self.device = torch.device(device)
        self.queries = [
            TorchQuery(f, self.segments, self.scorer, wand=wand)
            for f in filters
        ]

    def _plans_and_sigs(self, seg_idx: int, k: int):
        """(plans, sky_specs, sigs): per-query plan + stacking signature
        (``exec/batch.py:_plans_and_sigs``)."""
        plans = [q.plan_for_k(seg_idx, k) for q in self.queries]
        sr = self.segments[seg_idx]
        sky_specs: Dict[int, object] = {}
        for qi, p in enumerate(plans):
            sp = None
            if p.exec_mode == "dense" and not p.groups:
                kk = min(k, p.nd_pad)
                skey = ("torch_skyspec", kk)  # the port's own plan.cache key
                if skey in p.cache:
                    sp = p.cache[skey]
                else:
                    sp = skyline_spec(p, sr, self.scorer, kk)
                    p.cache[skey] = sp
            sky_specs[qi] = sp
        sigs = []
        for qi, p in enumerate(plans):
            sp = sky_specs[qi]
            sigs.append(
                (
                    p.tree,
                    p.num_leaves,
                    tuple(
                        (g.field_name, g.dcls, g.fcls, g.ncls) for g in p.groups
                    ),
                    0 if p.aux_pairs is None else len(p.aux_pairs),
                    (bool(p.groups) and p.groups[0].ub is not None)
                    or any(d.ub is not None for d in p.dense_spans),
                    p.exec_mode,
                    p.driver_gi,
                    p.driver_leaf,
                    tuple(_bucket4(len(g.rows_d)) for g in p.groups),
                    tuple(
                        (d.field_name, d.cls, d.leaf, d.ndrows)
                        for d in p.dense_spans
                    ),
                    None
                    if sp is None
                    else (sp.classes, _bucket4(len(sp.row_ids))),
                )
            )
        return plans, sky_specs, sigs

    def prepare(self, seg_idx: int, k: int) -> "PreparedBatch":
        """Stack the plans into device tensors once; ``run`` re-runs them."""
        plans, sky_specs, sigs = self._plans_and_sigs(seg_idx, k)
        sr = self.segments[seg_idx]
        st = device_state(sr, self.device)
        dev = self.device

        def up(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        groups: Dict[tuple, List[int]] = defaultdict(list)
        for qi, sig in enumerate(sigs):
            groups[sig].append(qi)

        calls = []
        for sig, qis in groups.items():
            (_tree, _nl, gkeys, A, use_wand, exec_mode, _dgi, _dl,
             _buckets, dkeys, sky_M) = sig
            reps = [plans[qi] for qi in qis]
            Q = len(qis)
            nd = reps[0].nd_pad
            if sky_M is not None:
                specs = [sky_specs[qi] for qi in qis]
                s0 = specs[0]
                M = sky_M[1]
                dfield = st.field(s0.field_name)
                cache = sr.dense_cache(s0.field_name)
                rows_b = np.full((Q, M), _IMAX32, np.int32)
                for j, sp in enumerate(specs):
                    rows_b[j, : len(sp.row_ids)] = sp.row_ids
                args = (
                    tuple(dfield.dense_words(cache, c) for c in s0.classes),
                    dfield.norms_grid(),
                    up(rows_b, np.int32),
                    up([sp.starts for sp in specs], np.int32),
                    up([sp.ws for sp in specs], np.float32),
                    up(np.float32(s0.avgdl), np.float32),
                )
                kwargs = dict(
                    scorer=self.scorer,
                    span_bits=tuple(BITS[c] for c in s0.classes),
                    k=min(k, nd),
                    ndrows=s0.ndrows,
                    conj=s0.conj,
                    mm=s0.min_match,
                )
                calls.append(("skyline", qis, _run_skyline, args, kwargs))
                continue
            Rs = [
                _sky._pow2(max(len(p.groups[gi].rows_d) for p in reps))
                for gi in range(len(gkeys))
            ]
            if exec_mode == "dslice":
                calls.append(self._dslice_call(st, sr, gkeys, Rs, reps, qis, k, up))
                continue
            if exec_mode != "dense":
                raise NotImplementedError(
                    f"candidates tier (exec_mode={exec_mode!r}) is not ported"
                )
            shapes = {scan_shape(p) for p in reps}
            scan_mode = shapes.pop() if len(shapes) == 1 else None
            if scan_mode is not None and len({f for f, *_ in dkeys}) == 1:
                calls.append(
                    self._scan_call(st, sr, dkeys, reps, qis, k, scan_mode, up)
                )
                continue
            if A:
                raise NotImplementedError("aux tier is not ported")
            if use_wand:
                raise NotImplementedError("WAND tier is not ported")
            raise NotImplementedError("full fold tier is not ported")
        return PreparedBatch(len(plans), calls)

    def _dslice_call(self, st, sr, gkeys, Rs, reps, qis, k, up):
        fname, dcls, fcls, ncls = gkeys[0]
        dfield = st.field(fname)
        has_nrm = dfield.nrm_words is not None and ncls >= 0
        gbits = (BITS[dcls], BITS[fcls], BITS[ncls] if has_nrm else -1)
        pools = [dfield.doc_words[dcls], dfield.freq_words[fcls]]
        if has_nrm:
            pools.append(dfield.nrm_words[ncls])
        pools.append(dfield.base[dcls].reshape(-1, 1))
        R = min(Rs[0], *(p.shape[0] for p in pools))
        starts = np.asarray(
            [
                [p.groups[0].rows_d[0], p.groups[0].rows_f[0]]
                + ([p.groups[0].rows_n[0]] if has_nrm else [])
                + [p.groups[0].rows_d[0]]
                for p in reps
            ],
            np.int64,
        )
        rows = np.asarray([p.shape[0] for p in pools], np.int64)
        if (starts < 0).any() or (starts + R > rows).any():
            raise ValueError("dslice window past a pool's zero tail")
        args = (
            tuple(pools),
            up(starts, np.int32),
            up([p.groups[0].real_rows for p in reps], np.int32),
            up([p.groups[0].weight[0] for p in reps], np.float32),
            dfield.norms,
            up(np.float32(reps[0].group_avgdl[0]), np.float32),
            st.alive if sr.has_deletes else None,
        )
        kwargs = dict(
            gbits=gbits, scorer=self.scorer,
            k=min(k, reps[0].nd_pad, R * BLOCK), R=R,
        )
        return ("dslice", qis, _run_dslice, args, kwargs)

    def _scan_call(self, st, sr, dkeys, reps, qis, k, scan_mode, up):
        fname = dkeys[0][0]
        dfield = st.field(fname)
        cache = sr.dense_cache(fname)
        avgdl = np.float32(reps[0].dense_spans[0].avgdl)
        ndrows = dkeys[0][3]
        args = (
            tuple(dfield.dense_words(cache, cls) for _f, cls, _l, _n in dkeys),
            dfield.norms_grid(),
            up([[ds.start for ds in p.dense_spans] for p in reps], np.int32),
            up([[ds.w for ds in p.dense_spans] for p in reps], np.float32),
            f32(avgdl),
            up(avgdl, np.float32),
        )
        kwargs = dict(
            scorer=self.scorer,
            span_bits=tuple(BITS[cls] for _f, cls, _l, _n in dkeys),
            k=min(k, reps[0].nd_pad),
            ndrows=ndrows,
            conj=scan_mode == "and",
            mm=scan_mode if isinstance(scan_mode, int) else 1,
        )
        return ("scan", qis, _run_scan, args, kwargs)


class PreparedBatch:
    """Device-resident stacked batch; ``run`` only launches work."""

    def __init__(self, num_queries: int, calls) -> None:
        self.num_queries = num_queries
        self._calls = calls

    @property
    def calls(self):
        """[(tier, query_indices, runner, args, kwargs)] in run order; the
        args are the runners' (``_run_skyline``/``_run_dslice``/
        ``_run_scan``) inputs, for checking a kernel at the real shapes."""
        return list(self._calls)

    def run_grouped(self, plain: bool = False):
        """[((vals [Q, k], docs [Q, k]), query_indices), ...] — one entry per
        signature group. ``plain=True`` runs the kernels' plain PyTorch
        versions instead of the kernels (the reference the kernel path is
        checked against on the card)."""
        kern = PLAIN if plain else KERNELS
        return [
            (fn(kern, *args, **kwargs), qis)
            for _tier, qis, fn, args, kwargs in self._calls
        ]

    def run(self, plain: bool = False):
        """Per-query (scores [k], local docs [k]) tensors."""
        out = [None] * self.num_queries
        for (vals, docs), qis in self.run_grouped(plain):
            for j, qi in enumerate(qis):
                out[qi] = (vals[j], docs[j])
        return out
