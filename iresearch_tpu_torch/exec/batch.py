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
* dslice — K2 windows, K3 decode and score (one launch), top-k;
* direct, sort, join, gridmix — ``exec/candidates.py:candidate_body``;
* wand — ``exec/executor.py:wand_body``;
* fold, or aux when the plan has host-aux leaves — ``segment_body``, the
  sparse aux uploads densified on the device first.

A plan's on-device phrase rows (``device_aux``, ``exec/phrase.py``) are
computed on the first run and kept with the call's other inputs (the
keys form of those rows runs in ``parallel/sharded.py``);
``prepare_all`` merges the segments' results on the device
(``exec/segmerge.py``). A batched runner splits the query axis into chunks
by a lane budget (``_chunked``, the counterpart of ``_chunked_vmap``).

What the host makes for a batch is uploaded once, at ``prepare``, in one
packed buffer (``_pack_args``). ``PreparedBatch.run_grouped`` and
``MergedBatch.run`` then run a whole pass as one CUDA graph, kept in a
global LRU cache by the batch's structure (``_FUSED_CACHE``, at most
``IRS_FUSED_CACHE_MAX`` entries, ``clear_fused_cache``), as the JAX
package runs one jitted program; ``fused=False`` runs the groups eagerly.
The single query (``SingleCall``, behind ``DeviceQuery``) and the sharded
executor's signature groups (``parallel/sharded.py``) replay graphs of
their own the same way, each kind in an LRU of its own.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import OrderedDict, defaultdict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from iresearch_tpu_torch.device import current_card
from iresearch_tpu_torch.exec.candidates import candidate_body, dslice_topk
from iresearch_tpu_torch.exec.executor import (  # noqa: F401 (re-exported)
    _NEG_INF,
    KERNELS,
    PLAIN,
    DeviceQuery,
    Kernels,
    densify_aux,
    entry_device,
    scan_shape,
    segment_body,
    wand_body,
)
from iresearch_tpu_torch.exec.skyline import (
    K_MAX,
    skyline_shape,
    skyline_spec,
    skyline_topk_batch,
)
from iresearch_tpu_torch.formats.bitpack import BITS
from iresearch_tpu_torch.formats.spec import BLOCK
from iresearch_tpu_torch.index.segment import _pow2, device_state
from iresearch_tpu_torch.kernels import build as kb
from iresearch_tpu_torch.ops.dense_scan import score_rows
from iresearch_tpu_torch.ops.topk import _IMAX32, noting_calls
from iresearch_tpu_torch.search import filters as F
from iresearch_tpu_torch.search.scorers import BM25, Scorer, f32
from iresearch_tpu_torch.utils.timer import note, span

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


def _stack_dense_dyn(dense_dyn):
    """Each WAND span's per-plan block upper bounds (``_dense_ub``, kept
    in ``plan.cache``) stacked to [Q, ndrows] inside the pass
    (``exec/batch.py:_stack_dense_dyn``); a span whose bounds came
    stacked already (the sharded executor's) stays as it is."""
    return tuple(
        dd[:2] + (torch.stack(dd[2]),) + dd[3:]
        if len(dd) > 2 and type(dd[2]) is tuple else dd
        for dd in dense_dyn
    )


def _run_skyline(kern, span_pools, norms_grid, rows_b, starts_b, ws_b, avgdl, **kw):
    return skyline_topk_batch(
        span_pools, norms_grid, rows_b, starts_b, ws_b, avgdl, kern=kern, **kw
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
    _rv, rows = kern.topk(bv, None, m)  # [Q, m]
    masked = score_rows(
        pools, starts, ws, norms_grid, avgdl_t, rows,
        scorer=scorer, span_bits=span_bits, conj=conj, mm=mm,
    )
    lane = torch.arange(BLOCK, dtype=torch.int32, device=rows.device)
    docs = rows[:, :, None] * BLOCK + lane
    q = rows.shape[0]
    return kern.topk(masked.reshape(q, -1), docs.reshape(q, -1), k)


def _run_fold(
    kern, pools, rowsets, avgdl, leaf_min, aux_sp, alive, dense_shared,
    dense_dyn, phrase=None,
    *, tree, gbits, scorer, num_leaves, k, nd, dense_static, aux_rows=(),
    phrase_keys=None,
):
    """The fold tier (``exec/batch.py:_run_batch``, fold branch).

    ``aux_sp`` holds the host-evaluated aux leaves' sparse uploads,
    ``phrase`` the on-device phrase leaves' dense rows, or a callable
    ``phrase(kern)`` that makes them; ``aux_rows`` says, per aux leaf,
    which of the two it is and its place there. With ``phrase_keys`` (the
    sharded executor's keys form), ``phrase`` holds per leaf its [Q, ...]
    key tensors instead, and ``phrase_keys(chunk)`` makes the rows of each
    chunk of queries."""

    def one(xs):
        rs, lm, ax, dd, pr = xs
        am = asc = None
        if ax:
            am, asc = densify_aux(ax, nd)
        if pr and phrase_keys is not None:
            pr = phrase_keys(pr)
        if pr:
            # every aux leaf's row from where it was made, in leaf order
            rows = [pr[j] if dev else (am[:, j], asc[:, j]) for dev, j in aux_rows]
            am, asc = (torch.stack(x, 1) for x in zip(*rows))
        match, score = segment_body(
            pools, rs, avgdl, lm, am, asc, alive,
            tree=tree, gbits=gbits, scorer=scorer, num_leaves=num_leaves,
            nd=nd, kern=kern,
            dense_args=_dense_args(dense_shared, dd), dense_static=dense_static,
        )
        return kern.topk(torch.where(match, score, _NEG_INF), None, k)

    width = nd * (max(1, num_leaves) + len(aux_rows))
    pr = phrase(kern) if callable(phrase) else phrase
    return _chunked(
        one, (rowsets, leaf_min, aux_sp, dense_dyn, pr), leaf_min.shape[0], width
    )


def _run_wand(
    kern, pools, rowsets, avgdl, leaf_min, alive, dense_shared, dense_dyn,
    *, tree, gbits, scorer, num_leaves, k, nd, sample, wand_mode, dense_static,
):
    """Block-max WAND with per-query θ (``exec/batch.py:_run_batch_wand``)."""
    dense_dyn = _stack_dense_dyn(dense_dyn)

    def one(xs):
        rs, lm, dd = xs
        return wand_body(
            pools, rs, avgdl, lm, alive,
            tree=tree, gbits=gbits, scorer=scorer, num_leaves=num_leaves,
            k=k, nd=nd, sample=sample, mode=wand_mode, kern=kern,
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
    dense_dyn = _stack_dense_dyn(dense_dyn)

    def one(xs):
        rs, lm, nr, dd = xs
        return candidate_body(
            pools, rs, avgdl, lm, alive, nr, mode=mode, driver_gi=driver_gi,
            nd=nd, num_leaves=num_leaves, kern=kern,
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


def _phrase_rows(sr, reps, scorer: Scorer, device):
    """A ``_PhraseRows`` over the plans ``reps``: per on-device phrase leaf
    (match bool [Q, nd], score f32 [Q, nd]), computed by
    ``run_phrase_dense`` on the first call with that kernel set and kept
    (the counterpart of the rows ``_build_device_inputs`` fills once per
    plan)."""
    from iresearch_tpu_torch.exec.phrase import DevicePhraseSpec

    for p in reps:
        for _a, spec in p.device_aux:
            # the keys form (PhraseKeysSpec, device_phrase="keys") runs in
            # the sharded executor alone (parallel/sharded.py), as in the
            # JAX package, whose QueryBatch never compiles it
            if not isinstance(spec, DevicePhraseSpec):
                raise TypeError(
                    f"{type(spec).__name__}: only DevicePhraseSpec rows run "
                    "here (plans compiled with device_phrase=True); the keys "
                    "form runs in parallel/sharded.py"
                )
    return _PhraseRows(sr, reps, scorer, device)


class _PhraseRows:
    """``rows(kern)`` -> per on-device phrase leaf of the plans (match,
    score), made on the first call with ``kern`` and kept once: ``flat``
    moves them into one buffer and keeps views of it in their place."""

    def __init__(self, sr, reps, scorer: Scorer, device) -> None:
        self._args = (sr, reps, scorer, device)
        self._memo = {}
        self._flat = None

    def __call__(self, kern):
        from iresearch_tpu_torch.exec.phrase import run_phrase_dense

        out = self._memo.get(kern)
        if out is None:
            sr, reps, scorer, device = self._args
            out = []
            for j in range(len(reps[0].device_aux)):
                per = [
                    run_phrase_dense(
                        p.device_aux[j][1], sr, scorer, p.nd_pad,
                        device=device, kern=kern,
                    )
                    for p in reps
                ]
                out.append(tuple(torch.stack(x) for x in zip(*per)))
            out = self._memo[kern] = tuple(out)
        return out

    def flat(self):
        """(one uint8 buffer of every leaf's kernel-made scores, then its
        matches, so that every section is aligned; its layout), made on
        the first call (the rows computed then if they are not yet)."""
        if self._flat is None:
            pairs = self(KERNELS)
            self._flat = _flat_outputs([s for _m, s in pairs] + [m for m, _s in pairs])
            self._memo[KERNELS] = _rows_of(*self._flat)
        return self._flat


def _rows_of(flat, layout):
    """The (match, score) pairs that ``_PhraseRows.flat`` laid out in
    ``flat``, as views of it."""
    views = _split_outputs(flat, layout)
    n = len(views) // 2
    return tuple(zip(views[n:], views[:n]))


def _stack_rows(arrays, R: int, dtype, fill) -> np.ndarray:
    out = np.full((len(arrays), R), fill, dtype)
    for j, a in enumerate(arrays):
        out[j, : len(a)] = a
    return out


# what every ``QueryBatch.prepare`` sent where, since the process started
# (``tier_stats``); under ``_TIER_LOCK``
_TIER_KEYS = ("mode_queries", "mode_groups", "tier_queries", "tier_groups")
_TIER_LOCK = threading.Lock()
_TIER_STATS: Dict[str, object] = dict(
    {key: {} for key in _TIER_KEYS}, prepares=0, past_k_max=0
)


def tier_stats() -> Dict[str, object]:
    """Since the process started: the ``QueryBatch.prepare`` calls, the
    queries and signature groups that they sent to each exec mode (the
    plans' ``exec_mode``: ``mode_queries``, ``mode_groups``) and to each
    tier (``group_call``'s: ``tier_queries``, ``tier_groups``), and the
    groups of the skyline's shape (``skyline_shape``) that k above
    ``K_MAX`` kept from the skyline tier (``past_k_max``). Each prepare's
    own counts are noted on its ``batch.stack`` span."""
    with _TIER_LOCK:
        return {key: dict(v) if isinstance(v, dict) else v for key, v in _TIER_STATS.items()}


def _count_tiers(counts: Dict[str, object]) -> None:
    """Add one prepare's ``counts`` to ``_TIER_STATS``."""
    with _TIER_LOCK:
        _TIER_STATS["prepares"] += 1
        _TIER_STATS["past_k_max"] += counts["past_k_max"]
        for key in _TIER_KEYS:
            total = _TIER_STATS[key]
            for name, n in counts[key].items():
                total[name] = total.get(name, 0) + n


def group_call(
    sr, reps, k: int, scorer: Scorer, device,
    *, sky_specs, sky_M, wand_sample: int, wand_mode: str, single: bool,
):
    """(tier, runner, args, kwargs) for plans ``reps`` that share a
    stacking signature. The args hold the segment's tensors on ``device``
    and, for what the host makes per call (rows, starts, weights, avgdl),
    numpy arrays, which ``_pack_args`` uploads in one copy; then
    ``runner(KERNELS or PLAIN, *args, **kwargs)`` -> (vals [Q, k'],
    docs [Q, k']). The tier dispatch of ``QueryBatch.prepare`` and, with
    ``single=True`` and one plan, of ``DeviceQuery.execute_segment_async``."""
    st = device_state(sr, device)
    p0 = reps[0]
    Q = len(reps)
    nd = p0.nd_pad

    def up(a, dtype):
        return np.ascontiguousarray(a, dtype)

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
            # a batch: the per-plan uploads, stacked to [Q, ndrows] by the
            # runner inside the pass (``_stack_dense_dyn``); the single
            # query: packed with its other inputs, so that a fresh query of
            # the same signature replays the same graph
            ub = (
                up(np.asarray(p0.dense_spans[di].ub, np.float32)[None], np.float32)
                if single else tuple(_dense_ub(p, di, device) for p in reps)
            )
            dd += (ub, up([p.dense_spans[di].other for p in reps], np.float32))
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
    A = 0 if p0.aux_pairs is None else len(p0.aux_pairs)
    dev_idx = [a for a, _spec in p0.device_aux]
    # sparse aux upload: per host-evaluated aux a pow2 bucket of match docs
    # (IMAX pad) + scores, densified on the device by the runner; the
    # on-device phrase leaves' rows are skipped here and filled by
    # ``_phrase_rows``
    aux_sp, aux_rows = [], []
    for a in range(A):
        if a in dev_idx:
            aux_rows.append((True, dev_idx.index(a)))
            continue
        aux_rows.append((False, len(aux_sp)))
        pairs = [p.aux_pairs[a] for p in reps]
        Mp = _pow2(max(8, max(len(d) for d, _v in pairs)))
        aux_sp.append((
            up(_stack_rows([d for d, _v in pairs], Mp, np.int32, _IMAX32), np.int32),
            up(_stack_rows([v for _d, v in pairs], Mp, np.float32, 0.0), np.float32),
        ))
    args = (
        tuple(pools), tuple(rowsets), avgdl, leaf_min, tuple(aux_sp), st.alive,
        tuple(dense_shared), tuple(dense_dyn),
        _phrase_rows(sr, reps, scorer, device) if dev_idx else None,
    )
    kwargs = dict(common, k=min(k, nd), aux_rows=tuple(aux_rows))
    return ("aux" if A else "fold", _run_fold, args, kwargs)


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


# --- the fused pass ----------------------------------------------------------
#
# The counterpart of the JAX package's fused program (``exec/batch.py``,
# ``_FUSED_CACHE`` .. ``PreparedBatch.run_grouped``): there one jitted
# program runs every group of a batch, cached globally by the batch's
# static structure because serving creates a fresh batch per request. Here
# that program is a CUDA graph: captured once per structure, replayed with
# one launch, its host-made inputs read from one packed buffer of which the
# cache entry keeps its own copy.

_ALIGN = 256  # bytes: every packed section starts on the allocator's alignment


class _Packed(NamedTuple):
    """Template leaf: a host array's section of the packed buffer."""

    off: int  # bytes
    shape: Tuple[int, ...]
    dtype: torch.dtype


class _Dev(NamedTuple):
    """Template leaf: the batch's ``i``-th long-lived object (a segment's
    pool or norms, a ``plan.cache`` upload, a phrase-rows callable)."""

    i: int


def _pack_args(trees, device):
    """(templates, buffer, dev_args): every numpy array in the arg trees
    ``trees`` (tuples of arrays, tensors and static values) moved into one
    uint8 buffer on ``device``, each section ``_ALIGN``-byte aligned (the
    kernels' vector loads need 16), filled in pinned host memory and
    uploaded in one non-blocking copy (``exec/batch.py:_pack_args``). The
    templates mirror the trees with ``_Packed`` leaves for the arrays and
    ``_Dev`` leaves for the tensors and callables, which are not copied and
    are listed once each in ``dev_args``; other leaves stay as they are."""
    parts, dev_args, dev_index = [], [], {}
    size = 0

    def place(x):
        nonlocal size
        if isinstance(x, np.ndarray):
            a = np.ascontiguousarray(x)
            parts.append((size, a))
            leaf = _Packed(size, a.shape, torch.from_numpy(a[:0]).dtype)
            size += -(-a.nbytes // _ALIGN) * _ALIGN
            return leaf
        if type(x) is tuple:
            return tuple(place(e) for e in x)
        if isinstance(x, torch.Tensor) or callable(x):
            i = dev_index.get(id(x))
            if i is None:
                i = dev_index[id(x)] = len(dev_args)
                dev_args.append(x)
            return _Dev(i)
        return x

    templates = [place(t) for t in trees]
    host = torch.zeros(
        max(size, _ALIGN), dtype=torch.uint8, pin_memory=device.type == "cuda"
    )
    flat = host.numpy()
    for off, a in parts:
        flat[off : off + a.nbytes] = a.reshape(-1).view(np.uint8)
    with current_card(device):
        return templates, host.to(device, non_blocking=True), tuple(dev_args)


def _materialize(t, buf, dev_args):
    """An args tree rebuilt from its template: each ``_Packed`` leaf a
    typed view of ``buf`` (``exec/batch.py:_materialize``)."""
    if isinstance(t, _Packed):
        n = t.dtype.itemsize * int(np.prod(t.shape, dtype=np.int64))
        return buf[t.off : t.off + n].view(t.dtype).reshape(t.shape)
    if isinstance(t, _Dev):
        return dev_args[t.i]
    if type(t) is tuple:
        return tuple(_materialize(e, buf, dev_args) for e in t)
    return t


def _template_key(templates, dev_args, buf):
    """Hashable cache key of a prepared batch (``exec/batch.py:
    _template_key``): each group's runner, template (the packed sections'
    offsets, shapes and dtypes; static values) and kwargs, the buffer's
    size, and for each long-lived tensor what a captured graph reads
    through it: its address, shape, strides, dtype and device (a callable
    by its identity, which its cache entry keeps alive; any other object,
    such as the single query's stand-in for its phrase rows, as it is)."""

    def dev_key(x):
        if isinstance(x, torch.Tensor):
            return (x.data_ptr(), tuple(x.shape), x.stride(), x.dtype, x.device)
        return ("callable", id(x)) if callable(x) else x

    return (
        tuple((fn, tp, tuple(sorted(kw.items()))) for fn, tp, kw in templates),
        tuple(dev_key(x) for x in dev_args),
        buf.numel(),
    )


def _kept(dev_args):
    """The callables of ``dev_args``: their cache entry keeps them, so
    that no other object takes their ``id`` in its key."""
    return tuple(x for x in dev_args if not isinstance(x, torch.Tensor))


# global fused-pass caches: serving creates a fresh PreparedBatch per
# request batch; a batch of the same category mix and row buckets replays
# the entry's graph. LRU-bounded: a long-lived server with a drifting mix
# must not keep graphs forever. One LRU per kind, each of at most
# ``_FUSED_CACHE_MAX`` entries, so that a run of distinct single queries
# (a miss costs milliseconds) never evicts a batch's entry (a miss of the
# index pass costs ~0.4 s): "batch" holds the batches and index passes
# (``_FUSED_CACHE``), "single" the single queries, "sharded" the sharded
# executor's signature groups (an entry a group, holding its graph on
# every shard, so that one pass never evicts its own graphs).
_FUSED_KINDS: "Dict[str, OrderedDict]" = {
    "batch": OrderedDict(), "single": OrderedDict(), "sharded": OrderedDict(),
}
_FUSED_CACHE: "OrderedDict[tuple, _FusedPass]" = _FUSED_KINDS["batch"]
_FUSED_CACHE_MAX = int(os.environ.get("IRS_FUSED_CACHE_MAX", "256"))
_FUSED_LOCK = threading.Lock()
# per kind, since the process started (``fused_cache_stats``); under
# ``_FUSED_LOCK``
_FUSED_STATS: Dict[str, Dict[str, float]] = {
    kind: dict(hits=0, misses=0, evictions=0, captures=0, capture_s=0.0, nodes=0)
    for kind in _FUSED_KINDS
}
# one memory pool per card shared by every cached graph: replays run one
# at a time on the caller's stream and each one's outputs are copied out
# before the next, so one graph's intermediates may lie where another's
# were (fused calls from several threads must share that stream)
_GRAPH_POOLS: Dict[torch.device, tuple] = {}
# one side stream per card for every warm-up and capture: the allocator
# caches freed blocks per stream, so warm-ups on one stream reuse each
# other's memory where a stream per capture would strand it
_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}
# set inside a capture's warm-up run (``_FusedPass.capture``)
_WARM_UP = threading.local()


def warming_up() -> bool:
    """True inside a fused pass's warm-up run, whose outputs are thrown
    away. A body's collective makes no call there (``parallel/sharded.py:
    _all_gather``): every rank of a group must issue the same collectives
    in the same order, so a pass issues one collective a replay whether
    its entry was a miss (warm-up, capture, replay) or a hit (replay),
    which ranks need not share."""
    return getattr(_WARM_UP, "on", False)


def fused_cache_stats() -> Dict[str, Dict[str, float]]:
    """Per kind of ``_FUSED_KINDS``: its lookups that hit and missed, the
    entries evicted past ``_FUSED_CACHE_MAX``, and the CUDA graphs its
    misses captured, their capture seconds and graph nodes; counts since
    the process started (``clear_fused_cache`` keeps them)."""
    with _FUSED_LOCK:
        return {kind: dict(st) for kind, st in _FUSED_STATS.items()}


def clear_fused_cache() -> None:
    """Drop every cached fused pass of every kind and free its graph and
    buffers."""
    with _FUSED_LOCK:
        for cache in _FUSED_KINDS.values():
            cache.clear()
        _GRAPH_POOLS.clear()
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()


def _flat_outputs(outs):
    """(one uint8 tensor holding every output back to back, its layout)."""
    layout, off = [], 0
    for o in outs:
        if off % o.dtype.itemsize:
            raise ValueError(f"output {o.dtype} at byte {off}: misaligned")
        layout.append((off, tuple(o.shape), o.dtype))
        off += o.numel() * o.dtype.itemsize
    return torch.cat([o.reshape(-1).view(torch.uint8) for o in outs]), layout


def _split_outputs(flat, layout):
    return [
        flat[off : off + dt.itemsize * int(np.prod(shape, dtype=np.int64))]
        .view(dt).reshape(shape)
        for off, shape, dt in layout
    ]


class _FusedPass:
    """A cached fused pass: its own copy of the packed buffers and, on the
    card, the CUDA graph of the pass over that copy, the graph's output
    buffer, its launches of each kernel per replay (counted at capture),
    its node count and how often a later call hit it. Its capture, loads
    and replays run with its ``device`` (its buffers' card) current."""

    def __init__(self, device, bufs, kept) -> None:
        self.bufs = tuple(b.clone() for b in bufs)
        self.device = device
        self.kept = kept
        self.graph = None
        self.out = self.layout = None
        self.launches: Dict[str, int] = {}
        # (Q, N, k, doc bytes) of each ``topk_docs`` call of the pass, as
        # captured (on the CPU: as its last run made them)
        self.k4: Tuple[tuple, ...] = ()
        self.nodes = 0
        self.capture_s = 0.0
        self.hits = 0

    def load(self, bufs) -> None:
        with current_card(self.device):
            for dst, src in zip(self.bufs, bufs):
                dst.copy_(src, non_blocking=True)

    def capture(self, body) -> None:
        """Run ``body`` once on a side stream as warm-up (it fills the
        plan and phrase memos, builds the kernels and lets the allocator
        settle; a collective in it stands in locally, ``warming_up``),
        then capture it into one graph. A failure raises."""
        dev = self.device
        with current_card(dev):
            cur = torch.cuda.current_stream(dev)
            side = _CAPTURE_STREAMS.get(dev)
            if side is None:
                side = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                _WARM_UP.on = True
                try:
                    body(self.bufs)
                finally:
                    _WARM_UP.on = False
                graph = torch.cuda.CUDAGraph()
                t0 = time.perf_counter()
                with kb.counted_apart() as launches:
                    # thread-local: this thread may not synchronise while it
                    # captures, but other threads (NCCL's proxy, PyTorch's
                    # watchdog) go on making their calls
                    graph.capture_begin(
                        pool=_GRAPH_POOLS.setdefault(dev, torch.cuda.graph_pool_handle()),
                        capture_error_mode="thread_local")
                    try:
                        with noting_calls() as k4:
                            out, layout = _flat_outputs(body(self.bufs))
                        nodes = kb.capture_nodes(side)
                    except BaseException:
                        with contextlib.suppress(RuntimeError):
                            graph.capture_end()
                        raise
                    graph.capture_end()
                self.capture_s = time.perf_counter() - t0
            cur.wait_stream(side)
        self.graph, self.out, self.layout = graph, out, layout
        self.launches = {n: c for n, c in launches.items() if c}
        self.k4 = tuple(k4)
        self.nodes = nodes

    def run(self, body):
        """The pass's outputs as fresh tensors: the graph replayed and its
        outputs copied out (the graph's kernels counted as launched), or
        on the CPU ``body`` over the entry's buffers. Nothing waits for
        the device."""
        if self.graph is None:
            with noting_calls() as k4:
                outs = body(self.bufs)
            self.k4 = tuple(k4)
            return _split_outputs(*_flat_outputs(outs))
        with current_card(self.device):
            self.graph.replay()
            out = self.out.clone()
        for name, n in self.launches.items():
            kb.count_launch(name, n)
        return _split_outputs(out, self.layout)


class _FusedGroup:
    """A cached pass in parts, one per shard of the sharded executor (its
    card's graph each), or one part holding a whole group body on an NCCL
    mesh: a ``_FusedPass`` per part in ``passes``, and how often a later
    call hit the group."""

    def __init__(self, passes) -> None:
        self.passes = tuple(passes)
        self.hits = 0


def _new_pass(device, bufs, body, kept):
    """A new entry for ``body`` over buffers like ``bufs`` on ``device``:
    on the card its graph captured (span ``fused.capture``, the warm-up
    included; ``k4`` the top-k calls that the warm-up ran and the graph
    holds)."""
    with span("fused.capture"):
        entry = _FusedPass(device, bufs, kept)
        if device.type == "cuda":
            entry.capture(body)
            note(nodes=entry.nodes, launches=dict(entry.launches), k4=entry.k4)
        return entry


def _cached(kind: str, key, make):
    """(entry, hit): the entry of ``key`` in the LRU of ``kind``, made by
    ``make()`` on a miss (its oldest entries evicted past
    ``_FUSED_CACHE_MAX``), moved to the newest and its hit counted on a
    hit; counted in ``_FUSED_STATS`` and noted on the open span (``hit``,
    ``evicted``). Under ``_FUSED_LOCK``."""
    cache, st = _FUSED_KINDS[kind], _FUSED_STATS[kind]
    entry = cache.get(key)
    if entry is None:
        entry = cache[key] = make()
        evicted = 0
        while len(cache) > _FUSED_CACHE_MAX:
            cache.popitem(last=False)
            evicted += 1
        st["misses"] += 1
        st["evictions"] += evicted
        for p in entry.passes if isinstance(entry, _FusedGroup) else (entry,):
            if p.graph is not None:
                st["captures"] += 1
                st["capture_s"] += p.capture_s
                st["nodes"] += p.nodes
        note(hit=False, evicted=evicted)
        return entry, False
    cache.move_to_end(key)
    entry.hits += 1
    st["hits"] += 1
    note(hit=True, evicted=0)
    return entry, True


def _run_fused(kind: str, key, bufs, body, kept=()):
    """The flat outputs of ``body`` (the pass over buffers like ``bufs``)
    through the entry of ``key`` in the LRU of ``kind`` ("batch" or
    "single"): on a miss a new entry (on the card its graph captured), on
    a hit ``bufs`` copied into the entry's own. Span ``fused.run``, its
    children ``fused.capture`` (a miss), ``fused.load`` (a hit) and
    ``fused.replay`` (``k4``: the shapes of the top-k calls it ran)."""
    with span("fused.run", kind=kind), _FUSED_LOCK:
        entry, hit = _cached(kind, key, lambda: _new_pass(bufs[0].device, bufs, body, kept))
        if hit:
            with span("fused.load"):
                entry.load(bufs)
        with span("fused.replay"):
            out = entry.run(body)
            note(k4=entry.k4)
            return out


def _run_fused_group(kind: str, key, parts, kept=()):
    """Per part ``(device, bufs, body)`` (one per shard, or one for an
    NCCL mesh's whole group body, whose ``bufs`` may be empty), the flat
    outputs of its body through the ``_FusedGroup`` of ``key`` in the LRU
    of ``kind`` ("sharded"): on a miss every part captured on its card, on
    a hit each part's buffers copied into its pass's own. The parts'
    replays are issued back to back with no wait for a device between
    them, so that distinct cards run at once. Spans as ``_run_fused``'s."""
    with span("fused.run", kind=kind), _FUSED_LOCK:
        entry, hit = _cached(kind, key, lambda: _FusedGroup(
            _new_pass(dev, bufs, body, kept) for dev, bufs, body in parts))
        if hit:
            with span("fused.load"):
                for p, (_dev, bufs, _body) in zip(entry.passes, parts):
                    p.load(bufs)
        with span("fused.replay"):
            outs = [p.run(body) for p, (_dev, _bufs, body) in zip(entry.passes, parts)]
            note(k4=tuple(c for p in entry.passes for c in p.k4))
            return outs


class _Rows(NamedTuple):
    """Stand-in, in a single query's cache key, for its on-device phrase
    rows: their layout in the buffer that a hit copies in."""

    layout: Tuple[tuple, ...]


class SingleCall:
    """One query's call on one segment (the counterpart of the JAX
    package's jitted ``_run_segment*`` runners): what ``group_call`` made
    for the plan, its host-made inputs in one packed upload, and its fused
    entry.

    ``tier``, ``fn``, ``args`` (over ``buf``) and ``kwargs`` are the eager
    call, ``fn(KERNELS or PLAIN, *args, **kwargs)``. ``run_fused()``
    replays one CUDA graph, kept in the "single" LRU under ``("single",
    _template_key, k)``. The key holds no address of a per-plan tensor, so
    a fresh query of the same tier, row buckets and static arguments hits
    the entry that another query made. On-device phrase rows
    (``_PhraseRows``) are made before the replay, on the first call of
    ``fused_entry``, in one buffer that the plan keeps once and that a hit
    copies into a buffer of the entry's, as the packed inputs are, so
    phrases hit too; the graph reads them, and never computes them."""

    def __init__(self, tier, fn, args, kwargs, device, k: int) -> None:
        (tp,), self.buf, dev_args = _pack_args([args], device)
        self.tier, self.fn, self.kwargs, self.k = tier, fn, kwargs, k
        self.args = _materialize(tp, self.buf, dev_args)
        self._tp, self._dev_args = tp, dev_args
        self._fused = None

    def fused_entry(self):
        """(key, bufs, body) of the call's fused entry, made on the first
        call: for a phrase that computes its rows on the card
        (``_PhraseRows.flat``: K3 and ``run_phrase_dense``)."""
        if self._fused is None:
            dev_args, bufs, key_args = self._dev_args, (self.buf,), self._dev_args
            # at most one callable: the plan's phrase rows
            slot = next((i for i, x in enumerate(dev_args) if callable(x)), None)
            if slot is not None:
                rows, layout = dev_args[slot].flat()
                bufs += (rows,)
                key_args = dev_args[:slot] + (_Rows(tuple(layout)),) + dev_args[slot + 1:]
            tp, fn, kwargs = self._tp, self.fn, self.kwargs

            def body(bufs):
                args = dev_args
                if slot is not None:
                    args = dev_args[:slot] + (_rows_of(bufs[1], layout),) + dev_args[slot + 1:]
                return list(fn(KERNELS, *_materialize(tp, bufs[0], args), **kwargs))

            key = ("single", _template_key(((fn, tp, kwargs),), key_args, self.buf), self.k)
            self._fused = (key, bufs, body)
        return self._fused

    def run_fused(self):
        """(vals [1, k'], docs [1, k']) as fresh tensors, through the
        call's fused entry (span ``batch.run``)."""
        with span("batch.run"):
            key, bufs, body = self.fused_entry()
            return tuple(_run_fused("single", key, bufs, body))


class QueryBatch:
    """Executes many prepared queries per segment in few batched calls.

    Queries are grouped by plan signature; each group becomes one stacked
    call. Results are exact per-query top-k, equal to the JAX package's
    ``QueryBatch`` on the same segment. ``device`` defaults to the card
    (raises without one). Phrases are host aux leaves
    (``device_phrase=False``)."""

    def __init__(
        self,
        filters: Sequence[F.Filter],
        segments: Sequence,
        scorer: Optional[Scorer] = None,
        wand: bool = False,
        wand_sample: int = 16,
        wand_mode: str = "exact",
        *,
        device=None,
    ) -> None:
        if wand_mode not in ("exact", "strict", "approx"):
            raise ValueError(
                f"wand_mode must be exact|strict|approx, got {wand_mode!r}"
            )
        self.scorer = scorer or BM25()
        self.segments = list(segments)
        self.wand_sample = wand_sample
        self.wand_mode = wand_mode
        self.device = entry_device(device)
        with span("batch.init"):
            self.queries = [
                DeviceQuery(
                    f, self.segments, self.scorer, wand=wand, wand_mode=wand_mode,
                    device_phrase=False, device=self.device,
                )
                for f in filters
            ]

    def _sigs(self, plans, seg_idx: int, k: int):
        """(sky_specs, sigs): per-query skyline spec + stacking signature
        of ``plans`` (the second half of ``exec/batch.py:_plans_and_sigs``)."""
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
        return sky_specs, sigs

    def prepare(self, seg_idx: int, k: int) -> "PreparedBatch":
        """Stack the plans into device tensors once; ``run`` re-runs them.
        Span ``batch.prepare``: a ``query.plan`` a query, then
        ``batch.stack`` (signatures, ``group_call``), then ``batch.pack``
        (``PreparedBatch``)."""
        with span("batch.prepare", seg=seg_idx):
            plans = [q.plan_for_k(seg_idx, k) for q in self.queries]
            with span("batch.stack"):
                sky_specs, sigs = self._sigs(plans, seg_idx, k)
                groups: Dict[tuple, List[int]] = defaultdict(list)
                for qi, sig in enumerate(sigs):
                    groups[sig].append(qi)
                calls = []
                counts: Dict[str, object] = dict({key: {} for key in _TIER_KEYS}, past_k_max=0)
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
                    p0 = plans[qis[0]]
                    for key, name, n in (("mode_queries", p0.exec_mode, len(qis)),
                                         ("mode_groups", p0.exec_mode, 1),
                                         ("tier_queries", tier, len(qis)),
                                         ("tier_groups", tier, 1)):
                        counts[key][name] = counts[key].get(name, 0) + n
                    if (sky_M is None and min(k, p0.nd_pad) > K_MAX
                            and skyline_shape(p0) is not None):
                        counts["past_k_max"] += 1
                _count_tiers(counts)
                note(**counts)
            return PreparedBatch(len(plans), calls, self.device)

    def prepare_all(self, k: int):
        """The prepared global batch over every segment: ``run()`` replays
        one CUDA graph of each segment's groups plus the merge and returns
        global (vals [Q, k], docs [Q, k]) (``exec/segmerge.py``). One
        ``prepare`` per segment: the JAX package's joint cross-segment
        grouping and padding only serve to share compiled programs."""
        from iresearch_tpu_torch.exec.segmerge import MergedBatch

        return MergedBatch(
            [self.prepare(si, k) for si in range(len(self.segments))],
            [sr.num_docs for sr in self.segments], k, device=self.device,
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
    """Device-resident stacked batch; ``run_grouped`` replays one CUDA
    graph.

    Every host-made input of every group lies in one packed buffer,
    uploaded in one copy (``_pack_args``). ``run_grouped()`` runs all the
    groups as one pass: on the card one CUDA graph, captured the first time
    a batch of this structure runs and kept in ``_FUSED_CACHE`` under
    ``_template_key``, so a fresh batch of the same category mix and row
    buckets only copies its buffer into the entry's and replays; on the
    CPU the entry's bodies run eagerly over the entry's buffer.
    ``fused=False`` is the debug path: one eager call per group over the
    batch's own buffer."""

    def __init__(self, num_queries: int, calls, device) -> None:
        with span("batch.pack"):
            self.num_queries = num_queries
            templates, self._buf, self._dev_args = _pack_args(
                [c[3] for c in calls], entry_device(device)
            )
            self._templates = tuple(
                (fn, tp, kwargs)
                for (_tier, _qis, fn, _args, kwargs), tp in zip(calls, templates)
            )
            self._calls = [
                (tier, qis, fn, _materialize(tp, self._buf, self._dev_args), kwargs)
                for (tier, qis, fn, _args, kwargs), tp in zip(calls, templates)
            ]
            self._key = _template_key(self._templates, self._dev_args, self._buf)

    @property
    def calls(self):
        """[(tier, query_indices, runner, args, kwargs)] in run order, the
        args over the batch's own packed buffer: the shapes and values the
        fused pass reads from its entry's copy (for checking a kernel at
        the real shapes, see ``group_call``)."""
        return list(self._calls)

    def _body(self, kern):
        """``body((buf,))`` -> the flat outputs [vals, docs, vals, ...] of
        every group, their host-made args read from ``buf``."""
        templates, dev_args = self._templates, self._dev_args

        def body(bufs):
            (buf,) = bufs
            outs = []
            for fn, tp, kwargs in templates:
                outs.extend(fn(kern, *_materialize(tp, buf, dev_args), **kwargs))
            return outs

        return body

    def run_grouped(self, fused: bool = True, plain: bool = False):
        """[((vals [Q, k], docs [Q, k]), query_indices), ...] — one entry per
        signature group, computed in one pass: one CUDA graph replay on the
        card, the outputs fresh tensors that a later call never overwrites.
        ``fused=False`` runs the groups one eager call each (the debug
        path); ``plain=True`` runs the kernels' plain PyTorch versions
        eagerly (the reference the kernel path is checked against on the
        card). Span ``batch.run``."""
        with span("batch.run"):
            if plain or not fused or not self._calls:
                kern = PLAIN if plain else KERNELS
                return [
                    (fn(kern, *args, **kwargs), qis)
                    for _tier, qis, fn, args, kwargs in self._calls
                ]
            outs = _run_fused(
                "batch", self._key, (self._buf,), self._body(KERNELS), _kept(self._dev_args)
            )
            return [
                ((outs[2 * i], outs[2 * i + 1]), c[1])
                for i, c in enumerate(self._calls)
            ]

    def run(self, fused: bool = True, plain: bool = False):
        """Per-query (scores [k], local docs [k]) tensors."""
        out = [None] * self.num_queries
        for (vals, docs), qis in self.run_grouped(fused, plain):
            for j, qi in enumerate(qis):
                out[qi] = (vals[j], docs[j])
        return out
