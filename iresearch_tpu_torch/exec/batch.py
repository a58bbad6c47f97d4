"""Batched query execution on torch tensors (``exec/batch.py``).

``QueryBatch`` groups prepared queries by plan signature exactly as the
JAX package does (``_plans_and_sigs``, ``_bucket4``) and stacks each group
along a leading query axis into one call. ``group_call`` picks a group's
tier in the reference's order and uploads its inputs; the single-query
``DeviceQuery`` calls it with one plan (``single=True``), so both entry
points run the same bodies:

* skyline — survivor-row gather and exact rescore (``exec/skyline.py``);
* fused scan — K1 row maxima, then the top ``m = min(max(2k, 16), ndrows)``
  rows rescored exactly. The single query takes it only for two or more
  spans or a conjunction, as in the JAX package;
* dslice — K2 windows, K3 decode, score, top-k;
* direct, sort, join, gridmix — ``exec/candidates.py:candidate_body``;
* wand — ``exec/executor.py:wand_body``;
* fold, or aux when the plan has host-aux leaves — ``segment_body``, the
  sparse aux uploads densified on the device first.

Plans with on-device phrases (``device_aux``) raise ``NotImplementedError``,
as does ``prepare_all`` (the merge across segments on the device).
Every call's inputs are uploaded once at ``prepare``; ``run`` only
launches work. A batched runner splits the query axis into chunks by a
lane budget (``_chunked``, the counterpart of ``_chunked_vmap``).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from iresearch_tpu.formats.bitpack import BITS
from iresearch_tpu.formats.spec import BLOCK
from iresearch_tpu.index.segment import _pow2
from iresearch_tpu.search import filters as F
from iresearch_tpu.search.scorers import BM25, Scorer
from iresearch_tpu_torch.exec.candidates import candidate_body, dslice_topk
from iresearch_tpu_torch.exec.executor import (  # noqa: F401 (re-exported)
    _NEG_INF,
    KERNELS,
    PLAIN,
    DeviceQuery,
    Kernels,
    densify_aux,
    scan_shape,
    segment_body,
    wand_body,
)
from iresearch_tpu_torch.exec.skyline import skyline_spec, skyline_topk_batch
from iresearch_tpu_torch.index.segment import device_state
from iresearch_tpu_torch.ops.dense_scan import score_rows
from iresearch_tpu_torch.ops.topk import _IMAX32, topk_docs
from iresearch_tpu_torch.search.scorers import f32

# live lanes per batched call: a group materializes Q x width lanes of
# intermediates, so a runner takes at most budget // width queries at a
# time (``exec/batch.py:_BATCH_LANE_BUDGET``; 2^25 lanes ~ 0.8 GB)
_BATCH_LANE_BUDGET = 1 << 25


def _bucket4(n: int) -> int:
    """Row-count bucket at 4x granularity (``exec/batch.py:_bucket4``)."""
    b = 8
    while b < n:
        b <<= 2
    return b


def _slice_q(x, a: int, b: int):
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(_slice_q(e, a, b) for e in x)
    return x[a:b]


def _chunked(one, xs, q: int, width: int):
    """``one(xs)`` over all ``q`` queries when ``q * width`` lanes fit the
    budget, else over chunks of queries with the outputs concatenated.
    ``xs`` nests tuples of tensors whose leading axis is the query."""
    chunk = max(1, min(q, _BATCH_LANE_BUDGET // max(1, width)))
    if chunk >= q:
        return one(xs)
    outs = [one(_slice_q(xs, i, i + chunk)) for i in range(0, q, chunk)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _dense_args(dense_shared, ddyn):
    """Per span (pool, start, w, norms, avgdl[, ub, other]) from the
    shared (pool, norms, avgdl) and the per-query (start, w[, ub, other])."""
    return tuple(
        (sh[0], dd[0], dd[1], sh[1], sh[2]) + tuple(dd[2:])
        for sh, dd in zip(dense_shared, ddyn)
    )


def _run_skyline(kern, span_pools, norms_grid, rows_b, starts_b, ws_b, avgdl, **kw):
    return skyline_topk_batch(
        span_pools, norms_grid, rows_b, starts_b, ws_b, avgdl, **kw
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


def _run_fold(
    kern, pools, rowsets, avgdl, leaf_min, aux_sp, alive, dense_shared,
    dense_dyn, *, tree, gbits, scorer, num_leaves, k, nd, dense_static,
):
    """The fold tier (``exec/batch.py:_run_batch``, fold branch)."""

    def one(xs):
        rs, lm, ax, dd = xs
        am = asc = None
        if ax is not None:
            am, asc = densify_aux(ax, nd)
        match, score = segment_body(
            pools, rs, avgdl, lm, am, asc, alive,
            tree=tree, gbits=gbits, scorer=scorer, num_leaves=num_leaves,
            nd=nd, decode=kern.decode,
            dense_args=_dense_args(dense_shared, dd), dense_static=dense_static,
        )
        return topk_docs(torch.where(match, score, _NEG_INF), None, k)

    width = nd * (max(1, num_leaves) + len(aux_sp or ()))
    return _chunked(one, (rowsets, leaf_min, aux_sp, dense_dyn), leaf_min.shape[0], width)


def _run_wand(
    kern, pools, rowsets, avgdl, leaf_min, alive, dense_shared, dense_dyn,
    *, tree, gbits, scorer, num_leaves, k, nd, sample, wand_mode, dense_static,
):
    """Block-max WAND with per-query θ (``exec/batch.py:_run_batch_wand``)."""

    def one(xs):
        rs, lm, dd = xs
        return wand_body(
            pools, rs, avgdl, lm, alive,
            tree=tree, gbits=gbits, scorer=scorer, num_leaves=num_leaves,
            k=k, nd=nd, sample=sample, mode=wand_mode, decode=kern.decode,
            dense_args=_dense_args(dense_shared, dd), dense_static=dense_static,
        )

    # two fold passes live per query
    width = nd * max(1, num_leaves) * 2
    return _chunked(one, (rowsets, leaf_min, dense_dyn), leaf_min.shape[0], width)


def _run_candidates(
    kern, pools, rowsets, avgdl, leaf_min, alive, nreal, dense_shared,
    dense_dyn, *, mode, driver_gi, nd, num_leaves, **kw,
):
    """The scale-proportional tiers (``exec/batch.py:_run_batch_candidates``)."""

    def one(xs):
        rs, lm, nr, dd = xs
        return candidate_body(
            pools, rs, avgdl, lm, alive, nr, mode=mode, driver_gi=driver_gi,
            nd=nd, num_leaves=num_leaves, decode=kern.decode,
            dense_args=_dense_args(dense_shared, dd), **kw,
        )

    # per-query live width in lanes: the sort carries ~6 operands per
    # decoded lane; join probes decode one block per candidate and
    # probed span; gridmix streams the grid per leaf
    lanes = sum(rs[0].shape[-1] * BLOCK for rs in rowsets)
    if mode == "join":
        width = rowsets[driver_gi][0].shape[-1] * BLOCK * (4 + 64 * max(0, len(rowsets) - 1))
    elif mode == "gridmix":
        width = nd * max(1, num_leaves) + lanes * 6
    else:
        width = lanes * (6 if mode == "sort" else 2)
    return _chunked(
        one, (rowsets, leaf_min, nreal, dense_dyn), leaf_min.shape[0], width
    )


def sky_spec(p, sr, scorer: Scorer, kk: int):
    """The plan's skyline schedule for top-``kk`` (None when ineligible),
    kept in ``plan.cache`` under the port's own key."""
    if p.exec_mode != "dense" or p.groups:
        return None
    key = ("torch_skyspec", kk)
    if key not in p.cache:
        p.cache[key] = skyline_spec(p, sr, scorer, kk)
    return p.cache[key]


def _dense_ub(p, di: int, device):
    """Plan ``p``'s dense span ``di`` block upper bounds on ``device``,
    uploaded once per plan (the counterpart of ``_dense_ub_dev``)."""
    key = ("torch_dense_ub", di, device)
    t = p.cache.get(key)
    if t is None:
        t = torch.from_numpy(np.asarray(p.dense_spans[di].ub, np.float32)).to(device)
        p.cache[key] = t
    return t


def _stack_rows(arrays, R: int, dtype, fill) -> np.ndarray:
    out = np.full((len(arrays), R), fill, dtype)
    for j, a in enumerate(arrays):
        out[j, : len(a)] = a
    return out


def group_call(
    sr, reps, k: int, scorer: Scorer, device,
    *, sky_specs, sky_M, wand_sample: int, wand_mode: str, single: bool,
):
    """(tier, runner, args, kwargs) for plans ``reps`` that share a
    stacking signature, with their inputs uploaded to ``device``;
    ``runner(KERNELS or PLAIN, *args, **kwargs)`` -> (vals [Q, k'],
    docs [Q, k']). The tier dispatch of ``QueryBatch.prepare`` and, with
    ``single=True`` and one plan, of ``DeviceQuery.execute_segment_async``."""
    if any(p.device_aux for p in reps):
        raise NotImplementedError(
            "plans with on-device phrases (device_aux, exec/phrase.py) are "
            "not ported (ROADMAP queue 1 item 11)"
        )
    st = device_state(sr, device)
    p0 = reps[0]
    Q = len(reps)
    nd = p0.nd_pad

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    if sky_M is not None:
        s0 = sky_specs[0]
        dfield = st.field(s0.field_name)
        cache = sr.dense_cache(s0.field_name)
        rows_b = _stack_rows([sp.row_ids for sp in sky_specs], sky_M, np.int32, _IMAX32)
        args = (
            tuple(dfield.dense_words(cache, c) for c in s0.classes),
            dfield.norms_grid(),
            up(rows_b, np.int32),
            up([sp.starts for sp in sky_specs], np.int32),
            up([sp.ws for sp in sky_specs], np.float32),
            up(np.float32(s0.avgdl), np.float32),
        )
        kwargs = dict(
            scorer=scorer,
            span_bits=tuple(BITS[c] for c in s0.classes),
            k=min(k, nd),
            ndrows=s0.ndrows,
            conj=s0.conj,
            mm=s0.min_match,
        )
        return ("skyline", _run_skyline, args, kwargs)
    gkeys = [(g.field_name, g.dcls, g.fcls, g.ncls) for g in p0.groups]
    dkeys = [(d.field_name, d.cls, d.leaf, d.ndrows) for d in p0.dense_spans]
    mode = p0.exec_mode
    # pad each group to the max row count within the signature's bucket
    Rs = [
        _pow2(max(len(p.groups[gi].rows_d) for p in reps))
        for gi in range(len(gkeys))
    ]
    if mode == "dslice":
        return _dslice_call(st, sr, gkeys, Rs, reps, k, scorer, up)
    if mode == "dense":
        shapes = {scan_shape(p) for p in reps}
        scan_mode = shapes.pop() if len(shapes) == 1 else None
        use_scan = scan_mode is not None and len({f for f, *_ in dkeys}) == 1
        if single:
            # single spans run the plain fold, as in the JAX package
            use_scan = use_scan and (len(dkeys) >= 2 or scan_mode == "and")
        if use_scan:
            return _scan_call(st, sr, dkeys, reps, k, scan_mode, scorer, up)
    use_wand = (bool(p0.groups) and p0.groups[0].ub is not None) or any(
        d.ub is not None for d in p0.dense_spans
    )
    pools, rowsets, gbits = [], [], []
    cols = [("rows_d", np.int32, 0), ("rows_f", np.int32, 0),
            ("rows_n", np.int32, 0), ("weight", np.float32, 0.0),
            ("leaf", np.int32, 0)]
    if use_wand:
        # padding rows: ub -inf, so they sort last and never survive
        cols += [("ub", np.float32, -np.inf), ("other", np.float32, 0.0)]
    for gi, (fname, dcls, fcls, ncls) in enumerate(gkeys):
        dfield = st.field(fname)
        has_nrm = dfield.nrm_words is not None and ncls >= 0
        pools.append(
            (
                dfield.doc_words[dcls],
                dfield.freq_words[fcls],
                # legacy segments: the freq pool stands in (unused, bn=-1)
                dfield.nrm_words[ncls] if has_nrm else dfield.freq_words[fcls],
                dfield.base[dcls],
                dfield.norms,
            )
        )
        gbits.append((BITS[dcls], BITS[fcls], BITS[ncls] if has_nrm else -1))
        rowsets.append(tuple(
            up(_stack_rows([getattr(p.groups[gi], name) for p in reps], Rs[gi], dt, fill), dt)
            for name, dt, fill in cols
        ))
    # dense-grid spans: pool/norms shared; start/w (+ub/other for WAND)
    # stack along the query axis
    cand_fields = None
    if mode == "join":
        # probed spans reuse the candidate span's decoded dl only when
        # every candidate group is in the span's field
        cand_fields = (
            {gkeys[p0.driver_gi][0]} if p0.driver_gi >= 0
            else {g[0] for g in gkeys}
        )
    dense_shared, dense_dyn, dense_static = [], [], []
    for di, (fname, cls, leaf, ndrows) in enumerate(dkeys):
        dfield = st.field(fname)
        dense_shared.append((
            dfield.dense_words(sr.dense_cache(fname), cls),
            dfield.norms,
            up(np.float32(p0.dense_spans[di].avgdl), np.float32),
        ))
        dd = (
            up([p.dense_spans[di].start for p in reps], np.int32),
            up([p.dense_spans[di].w for p in reps], np.float32),
        )
        if use_wand:
            # the per-plan uploads stacked to [Q, ndrows] on the device
            # (``exec/batch.py:_stack_dense_dyn``)
            dd += (
                torch.stack([_dense_ub(p, di, device) for p in reps]),
                up([p.dense_spans[di].other for p in reps], np.float32),
            )
        dense_dyn.append(dd)
        same_dl = cand_fields is None or cand_fields == {fname}
        dense_static.append((BITS[cls], leaf, ndrows, same_dl))
    avgdl = up(p0.group_avgdl, np.float32)
    leaf_min = up(np.stack([p.leaf_min_match for p in reps]), np.int32)
    common = dict(
        tree=p0.tree, gbits=tuple(gbits), scorer=scorer,
        num_leaves=p0.num_leaves, nd=nd, dense_static=tuple(dense_static),
    )
    if mode != "dense":
        if mode == "join":
            lanes = Rs[p0.driver_gi] * BLOCK
        elif mode == "gridmix":
            lanes = nd  # the grid view covers every doc
        else:
            lanes = sum(Rs) * BLOCK
        args = (
            tuple(pools), tuple(rowsets), avgdl, leaf_min,
            # skip the per-lane alive gather when nothing is deleted
            st.alive if sr.has_deletes else None,
            up([[g.real_rows * BLOCK for g in p.groups] for p in reps], np.int32),
            tuple(dense_shared), tuple(dense_dyn),
        )
        kwargs = dict(
            common,
            k=min(k, nd, lanes),
            mode=mode,
            driver_gi=p0.driver_gi,
            group_leaf=tuple(int(g.leaf[0]) for g in p0.groups),
            # θ pruning is useless when the sampled phase would already
            # decode every row
            wand=use_wand and max(Rs) > wand_sample,
            sample=wand_sample,
            wand_mode=wand_mode,
        )
        return (mode, _run_candidates, args, kwargs)
    if use_wand:
        args = (
            tuple(pools), tuple(rowsets), avgdl, leaf_min, st.alive,
            tuple(dense_shared), tuple(dense_dyn),
        )
        kwargs = dict(common, k=min(k, nd), sample=wand_sample, wand_mode=wand_mode)
        return ("wand", _run_wand, args, kwargs)
    aux_sp = None
    A = 0 if p0.aux_pairs is None else len(p0.aux_pairs)
    if A:
        # sparse aux upload: per aux a pow2 bucket of match docs (IMAX
        # pad) + scores, densified on the device by the runner
        aux_sp = []
        for a in range(A):
            pairs = [p.aux_pairs[a] for p in reps]
            Mp = _pow2(max(8, max(len(d) for d, _v in pairs)))
            aux_sp.append((
                up(_stack_rows([d for d, _v in pairs], Mp, np.int32, _IMAX32), np.int32),
                up(_stack_rows([v for _d, v in pairs], Mp, np.float32, 0.0), np.float32),
            ))
        aux_sp = tuple(aux_sp)
    args = (
        tuple(pools), tuple(rowsets), avgdl, leaf_min, aux_sp, st.alive,
        tuple(dense_shared), tuple(dense_dyn),
    )
    return ("aux" if A else "fold", _run_fold, args, dict(common, k=min(k, nd)))


def _dslice_call(st, sr, gkeys, Rs, reps, k, scorer, up):
    fname, dcls, fcls, ncls = gkeys[0]
    dfield = st.field(fname)
    has_nrm = dfield.nrm_words is not None and ncls >= 0
    gbits = (BITS[dcls], BITS[fcls], BITS[ncls] if has_nrm else -1)
    pools = [dfield.doc_words[dcls], dfield.freq_words[fcls]]
    if has_nrm:
        pools.append(dfield.nrm_words[ncls])
    pools.append(dfield.base[dcls].reshape(-1, 1))
    # the pow2 row bucket clamped to the (pow2-padded) pool row counts
    # (``exec/executor.py:dslice_shape``)
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
        gbits=gbits, scorer=scorer, k=min(k, reps[0].nd_pad, R * BLOCK), R=R,
    )
    return ("dslice", dslice_topk, args, kwargs)


def _scan_call(st, sr, dkeys, reps, k, scan_mode, scorer, up):
    fname = dkeys[0][0]
    dfield = st.field(fname)
    cache = sr.dense_cache(fname)
    avgdl = np.float32(reps[0].dense_spans[0].avgdl)
    args = (
        tuple(dfield.dense_words(cache, cls) for _f, cls, _l, _n in dkeys),
        dfield.norms_grid(),
        up([[ds.start for ds in p.dense_spans] for p in reps], np.int32),
        up([[ds.w for ds in p.dense_spans] for p in reps], np.float32),
        f32(avgdl),
        up(avgdl, np.float32),
    )
    kwargs = dict(
        scorer=scorer,
        span_bits=tuple(BITS[cls] for _f, cls, _l, _n in dkeys),
        k=min(k, reps[0].nd_pad),
        ndrows=dkeys[0][3],
        conj=scan_mode == "and",
        mm=scan_mode if isinstance(scan_mode, int) else 1,
    )
    return ("scan", _run_scan, args, kwargs)


class QueryBatch:
    """Executes many prepared queries per segment in few batched calls.

    Queries are grouped by plan signature; each group becomes one stacked
    call. Results are exact per-query top-k, equal to the JAX package's
    ``QueryBatch`` on the same segment. ``device`` is required: nothing
    picks one. Phrases are host aux leaves (``device_phrase=False``)."""

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
        self.scorer = scorer or BM25()
        self.segments = list(segments)
        self.wand_sample = wand_sample
        self.wand_mode = wand_mode
        self.device = torch.device(device)
        self.queries = [
            DeviceQuery(
                f, self.segments, self.scorer, wand=wand, wand_mode=wand_mode,
                device_phrase=False, device=self.device,
            )
            for f in filters
        ]

    def _plans_and_sigs(self, seg_idx: int, k: int):
        """(plans, sky_specs, sigs): per-query plan + stacking signature
        (``exec/batch.py:_plans_and_sigs``)."""
        plans = [q.plan_for_k(seg_idx, k) for q in self.queries]
        sr = self.segments[seg_idx]
        sky_specs = [
            sky_spec(p, sr, self.scorer, min(k, p.nd_pad)) for p in plans
        ]
        sigs = []
        for p, sp in zip(plans, sky_specs):
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
        groups: Dict[tuple, List[int]] = defaultdict(list)
        for qi, sig in enumerate(sigs):
            groups[sig].append(qi)
        calls = []
        for sig, qis in groups.items():
            sky_M = sig[10]
            tier, fn, args, kwargs = group_call(
                self.segments[seg_idx], [plans[qi] for qi in qis], k,
                self.scorer, self.device,
                sky_specs=[sky_specs[qi] for qi in qis],
                sky_M=None if sky_M is None else sky_M[1],
                wand_sample=self.wand_sample, wand_mode=self.wand_mode,
                single=False,
            )
            calls.append((tier, qis, fn, args, kwargs))
        return PreparedBatch(len(plans), calls)

    def prepare_all(self, k: int):
        """The merged batch over every segment (``exec/segmerge.py``)."""
        raise NotImplementedError(
            "merging across segments on the device (prepare_all, "
            "exec/segmerge.py) is not ported (ROADMAP queue 1 item 12); "
            "search() merges per-segment results on the host"
        )

    def execute_segment(
        self, seg_idx: int, k: int
    ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Per-query (scores [k'], local docs [k']) for one segment."""
        return [
            (v.cpu().numpy(), d.cpu().numpy())
            for v, d in self.prepare(seg_idx, k).run()
        ]

    def search(self, k: int) -> List[List[Tuple[int, float]]]:
        """Global top-k per query over all segments: one batch per segment,
        host merge of (global_doc, score) ordered by (-score, doc)
        (``exec/batch.py:QueryBatch.search``)."""
        per_seg = [self.execute_segment(s, k) for s in range(len(self.segments))]
        base = np.zeros(len(self.segments) + 1, np.int64)
        np.cumsum([sr.num_docs for sr in self.segments], out=base[1:])
        out: List[List[Tuple[int, float]]] = []
        for qi in range(len(self.queries)):
            cands: List[Tuple[int, float]] = []
            for s, res in enumerate(per_seg):
                vals, docs = res[qi]
                for v, d in zip(vals, docs):
                    if np.isfinite(v):
                        cands.append((int(base[s] + d), float(v)))
            cands.sort(key=lambda t: (-t[1], t[0]))
            out.append(cands[:k])
        return out


class PreparedBatch:
    """Device-resident stacked batch; ``run`` only launches work."""

    def __init__(self, num_queries: int, calls) -> None:
        self.num_queries = num_queries
        self._calls = calls

    @property
    def calls(self):
        """[(tier, query_indices, runner, args, kwargs)] in run order, for
        checking a kernel at the real shapes (see ``group_call``)."""
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
