"""The single-query executor and the fold and WAND bodies (``exec/executor.py``).

Every body takes a leading query axis ``[Q, ...]``; the single query is
``Q = 1`` and ``QueryBatch`` stacks a signature group along the same axis,
so single, batched (and later sharded) execution share one definition,
as they do in the JAX package:

* ``fold_tree`` — the static boolean tree fold over ``[..., n]`` tensors;
* ``group_contrib`` — one row group's decode, doc lengths (the inline
  norm pool, or ``norms[docs]`` on legacy ``bn == -1`` segments), scores
  and match flags in one launch of K3's scored form
  (``ops/decode.py:decode_score_rows``, row-gather form);
* ``dense_contrib`` — one dense-grid span over the ``[nd]`` doc axis;
* ``segment_body`` — per-leaf ``[Q, L, nd]`` score and count scatter-adds,
  the fold and the alive mask;
* ``wand_body`` — block-max WAND in its exact, strict and approx modes.

``DeviceQuery`` prepares through the port's copies of ``HostQuery``,
``PlanCompiler`` and the plan cache (``search/host_eval.py``,
``exec/plan.py``, ``exec/plancache.py``), so sampled terms, idf stats and
tier choice are the reference's; the tests hold each copy against its
original. Plans are shared between queries through the cache, so a caller
never mutates one; uploads are kept in ``plan.cache``.

The entry points take the port's own readers, filters and scorers, and
run on the card unless the caller names another ``device``. A query's
call on a segment (``DeviceQuery.single_call``, ``exec/batch.py:
SingleCall``) replays one CUDA graph per call signature, the counterpart
of the JAX package's jitted ``_run_segment*`` runners: a fresh query of
the same tier, row buckets and static arguments replays the graph another
query captured; ``fused=False`` runs the call eagerly.

Scatter-adds go through ``index_add_``, which on CUDA sums in no fixed
order, as XLA's scatter does on the TPU: fold scores may differ from run
to run in the last ulp and are held to rtol 1e-5, not bit-equality.
"""

from __future__ import annotations

import math
from collections import namedtuple
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from iresearch_tpu_torch.device import require_cuda
from iresearch_tpu_torch.exec import plan as _plan
from iresearch_tpu_torch.exec import plancache as _plancache
from iresearch_tpu_torch.formats.bitpack import unpack_torch
from iresearch_tpu_torch.formats.spec import BLOCK
from iresearch_tpu_torch.index.segment import SegmentReader
from iresearch_tpu_torch.ops.decode import (  # noqa: F401 (re-exported)
    decode_rows,
    decode_rows_ref,
    decode_score_rows,
    decode_score_rows_ref,
    gather_clamped,
)
from iresearch_tpu_torch.ops.dense_scan import (
    dense_scan_rowmax,
    dense_scan_rowmax_ref,
)
from iresearch_tpu_torch.ops.dma_gather import dma_row_slices, dma_row_slices_ref
from iresearch_tpu_torch.ops.topk import topk_docs, topk_docs_ref
from iresearch_tpu_torch.search import filters as F
from iresearch_tpu_torch.search.host_eval import HostQuery
from iresearch_tpu_torch.search.scorers import BM25, Scorer, f32, score_block_torch
from iresearch_tpu_torch.utils.timer import note, span

_NEG_INF = float("-inf")

# the kernels (K3 in its plain and its scored form, K4 the top-k); PLAIN
# holds their plain versions, which a runner given ``PLAIN`` calls directly
# (the kernel wrappers themselves take the plain version only for CPU
# tensors)
Kernels = namedtuple("Kernels", "rowmax row_slices decode decode_score topk")
KERNELS = Kernels(
    dense_scan_rowmax, dma_row_slices, decode_rows, decode_score_rows, topk_docs
)
PLAIN = Kernels(
    dense_scan_rowmax_ref, dma_row_slices_ref, decode_rows_ref,
    decode_score_rows_ref, topk_docs_ref,
)


def scan_shape(plan):
    """Fused-scan eligibility of a plan: None, "or" (any-hit, spans sum
    into one leaf), "and" (all-hit, one span per leaf), or int mm >= 2
    (a min_match disjunction, one span per leaf)
    (``exec/executor.py:scan_shape``)."""
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
    if plan.tree == ("leaf", 0) and L == 1:
        return "or"
    t = plan.tree
    if (
        t[0] in ("and", "or")
        and not t[2]
        and t[4 if t[0] == "or" else 3] == "sum"
        and all(c[0] == "leaf" for c in t[1])
        and sorted(c[1] for c in t[1]) == list(range(L))
        and [ds.leaf for ds in plan.dense_spans] == list(range(L))
    ):
        if t[0] == "and":
            return "and"
        if int(t[3]) >= 2:
            return int(t[3])
    return None


def fold_tree(tree, leaf_match, leaf_score, aux_match, aux_score):
    """(match bool [..., n], score f32 [..., n]) of the static boolean tree
    over per-leaf ``[..., L, n]`` and per-aux ``[..., A, n]`` arrays
    (``exec/executor.py:_fold_tree``)."""
    kind = tree[0]
    shape = leaf_match.shape[:-2] + leaf_match.shape[-1:]
    dev = leaf_match.device

    def zeros():
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    if kind == "empty":
        return torch.zeros(shape, dtype=torch.bool, device=dev), zeros()
    if kind == "all":
        return torch.ones(shape, dtype=torch.bool, device=dev), zeros()
    if kind == "leaf":
        return leaf_match[..., tree[1], :], leaf_score[..., tree[1], :]
    if kind == "aux":
        return aux_match[..., tree[1], :], aux_score[..., tree[1], :]

    def sub(t):
        return fold_tree(t, leaf_match, leaf_score, aux_match, aux_score)

    if kind == "not":
        m, _ = sub(tree[1])
        return ~m, zeros()
    if kind in ("and", "or"):
        if kind == "and":
            _, pos, neg, merge = tree
            min_match = None
        else:
            _, pos, neg, min_match, merge = tree
        match = torch.ones(shape, dtype=torch.bool, device=dev)
        count = torch.zeros(shape, dtype=torch.int32, device=dev)
        # merge of matching children (ScoreMergeType, scorer.hpp:224-235)
        if merge == "max":
            score = torch.full(shape, _NEG_INF, dtype=torch.float32, device=dev)
        elif merge == "min":
            score = torch.full(shape, math.inf, dtype=torch.float32, device=dev)
        else:
            score = zeros()
        for c in pos:
            m, s = sub(c)
            match = match & m
            count = count + m.to(torch.int32)
            if merge == "max":
                score = torch.maximum(score, torch.where(m, s, _NEG_INF))
            elif merge == "min":
                score = torch.minimum(score, torch.where(m, s, math.inf))
            elif merge == "sum":
                score = score + s
        score = torch.where(torch.isfinite(score), score, 0.0)
        if kind == "or":
            match = (
                torch.ones(shape, dtype=torch.bool, device=dev)
                if min_match <= 0
                else count >= min_match
            )
        for c in neg:
            m, _ = sub(c)
            match = match & ~m
        return match, torch.where(match, score, 0.0)
    raise ValueError(f"bad tree node {tree!r}")


def group_contrib(
    pool, rows_d, rows_f, rows_n, w, gbits, avgdl, scorer: Scorer,
    *, kern=KERNELS, want_dl: bool = False,
):
    """Decode and score one row group -> (docs i32 [Q, R, 128], scores f32,
    matched bool[, dl f32]) (``exec/executor.py:_group_contrib``).

    pool: (doc_words, freq_words, nrm_words, base, norms); rows_* and
    ``w``: [Q, R]. One launch of K3's scored form (``kern.decode_score``:
    ``decode_score_rows`` or its plain version) in row-gather form:
    ``rows_d`` and ``rows_f`` differ, padding and pruned rows point at the
    all-zero sentinel row 0. Doc lengths come from the inline norm pool,
    or from ``norms[docs]`` on legacy ``bn == -1`` segments."""
    doc_words, freq_words, nrm_words, base, norms = pool
    bd, bf, bn = gbits
    lead = tuple(rows_d.shape)
    out = kern.decode_score(
        doc_words, freq_words, base, rows_d.reshape(-1), rows_f.reshape(-1),
        nrm_words, rows_n.reshape(-1), norms, w.reshape(-1), avgdl,
        bd=bd, bf=bf, bn=bn, scorer=scorer, want_dl=want_dl,
    )
    return tuple(x.reshape(lead + (BLOCK,)) for x in out)


def dense_contrib(dargs, dstat, scorer: Scorer, keep=None):
    """One dense-grid span's (score f32 [Q, nd], match bool [Q, nd])
    (``exec/executor.py:_dense_contrib``): rows [start, start + ndrows) of
    the span's class pool unpack to the doc axis. ``keep`` (bool
    [Q, ndrows]) optionally masks rows (WAND pruning). Where the doc axis
    (the norms' length) is longer than the grid, as under sharding when
    the largest segment's padded count is not a power of two, the lanes
    past the grid have freq 0."""
    pool, start, w, norms_g, avgdl = dargs[:5]
    bits, _leaf, ndrows = dstat[:3]
    rows = start.to(torch.int64)[:, None] + torch.arange(ndrows, device=start.device)
    freq = unpack_torch(pool[rows], bits).to(torch.float32)  # [Q, ndrows, 128]
    if keep is not None:
        freq = freq * keep[..., None].to(torch.float32)
    f = freq.reshape(start.shape[0], -1)
    if f.shape[-1] < norms_g.shape[-1]:
        f = torch.nn.functional.pad(f, (0, norms_g.shape[-1] - f.shape[-1]))
    sc = score_block_torch(scorer, w[:, None], f, norms_g, avgdl)
    m = f > 0
    return torch.where(m, sc, 0.0), m


def _scatter_leaves(leaf_score, leaf_count, leaf, docs, sc, m):
    """leaf_score/leaf_count [Q, L, nd] += each lane's (sc, m) at (leaf,
    doc). Lanes whose doc falls outside [0, nd) add nothing, as XLA's
    ``mode="drop"``."""
    q, nl, nd = leaf_score.shape
    ok = (docs >= 0) & (docs < nd)
    qix = torch.arange(q, dtype=torch.int64, device=docs.device).view(q, 1, 1)
    idx = (qix * nl + leaf.to(torch.int64)[..., None]) * nd + torch.clamp(
        docs, 0, nd - 1
    )
    idx = idx.reshape(-1)
    leaf_score.view(-1).index_add_(0, idx, torch.where(ok, sc, 0.0).reshape(-1))
    leaf_count.view(-1).index_add_(0, idx, (m & ok).to(torch.int32).reshape(-1))


def _leaf_arrays(
    pools, sets, avgdl, leaf_min, *, gbits, scorer, num_leaves, nd, kern,
    dense_args, dense_static, dense_keep=None,
):
    """(leaf_match bool [Q, L, nd], leaf_score f32 [Q, L, nd]) of the row
    groups ``sets`` and the dense spans, min_match applied."""
    q = leaf_min.shape[0]
    dev = leaf_min.device
    leaf_score = torch.zeros((q, num_leaves, nd), dtype=torch.float32, device=dev)
    leaf_count = torch.zeros((q, num_leaves, nd), dtype=torch.int32, device=dev)
    for gi, (pool, rs) in enumerate(zip(pools, sets)):
        rows_d, rows_f, rows_n, w, leaf = rs[:5]
        docs, sc, m = group_contrib(
            pool, rows_d, rows_f, rows_n, w, gbits[gi], avgdl[gi], scorer,
            kern=kern,
        )
        _scatter_leaves(leaf_score, leaf_count, leaf, docs, sc, m)
    for dargs, dstat in zip(dense_args, dense_static):
        keep = None if dense_keep is None else dense_keep(dargs)
        sc, m = dense_contrib(dargs, dstat, scorer, keep)
        leaf_score[:, dstat[1]] += sc
        leaf_count[:, dstat[1]] += m.to(torch.int32)
    leaf_match = leaf_count >= leaf_min[:, :, None]
    return leaf_match, torch.where(leaf_match, leaf_score, 0.0)


def segment_body(
    pools,  # per group: (doc_words, freq_words, nrm_words, base, norms)
    rowsets,  # per group: (rows_d, rows_f, rows_n, w, leaf), each [Q, R]
    avgdl,  # f32 [G]
    leaf_min,  # int32 [Q, L]
    aux_match,  # bool [Q, A, nd] or None
    aux_score,  # f32 [Q, A, nd] or None
    alive,  # bool [nd]
    *,
    tree,
    gbits,
    scorer: Scorer,
    num_leaves: int,
    nd: int,
    kern=KERNELS,
    dense_args=(),  # per dense span: (pool, start [Q], w [Q], norms, avgdl)
    dense_static=(),  # per dense span: (bits, leaf, ndrows, same_dl)
):
    """(match bool [Q, nd], score f32 [Q, nd]) over one segment's padded
    doc axis (``exec/executor.py:segment_body``)."""
    leaf_match, leaf_score = _leaf_arrays(
        pools, rowsets, avgdl, leaf_min, gbits=gbits, scorer=scorer,
        num_leaves=num_leaves, nd=nd, kern=kern, dense_args=dense_args,
        dense_static=dense_static,
    )
    match, score = fold_tree(tree, leaf_match, leaf_score, aux_match, aux_score)
    return match & alive, score


def densify_aux(aux_sp, nd: int):
    """[Q, A, nd] (match, score) of the sparse host-aux uploads, one
    (docs int32 [Q, M] IMAX-padded, vals f32 [Q, M]) per aux
    (``exec/batch.py:313-321``). Out-of-range docs land in a spare column
    that is cut off, as XLA's ``mode="drop"`` drops them."""
    q = aux_sp[0][0].shape[0]
    dev = aux_sp[0][0].device
    m = torch.zeros((q, len(aux_sp), nd + 1), dtype=torch.bool, device=dev)
    s = torch.zeros((q, len(aux_sp), nd + 1), dtype=torch.float32, device=dev)
    qix = torch.arange(q, device=dev)[:, None]
    for a, (docs, vals) in enumerate(aux_sp):
        d = torch.where((docs >= 0) & (docs < nd), docs, nd).to(torch.int64)
        # a device tensor of values: a Python scalar would be copied from
        # the host, which a graph's capture forbids
        m[qix, a, d] = torch.ones_like(d, dtype=torch.bool)
        s[qix, a, d] = vals
    return m[..., :nd], s[..., :nd]


def sort_by_ub(rs):
    """A WAND rowset with its rows in descending upper-bound order. The
    sort is stable, as ``jnp.argsort``: padding rows (ub = -inf) tie, and
    another order would change which blocks the sampled phase decodes."""
    order = torch.argsort(-rs[5], dim=-1, stable=True)
    return tuple(r.gather(-1, order) for r in rs)


def sample_rows(rs, sample: int):
    """The first ``sample`` rows of every array of a rowset."""
    return tuple(r[:, : min(sample, r.shape[-1])] for r in rs)


def shave_theta(theta: torch.Tensor) -> torch.Tensor:
    """θ lowered by a relative epsilon in f32 so float-order differences
    between the sampled and full passes never prune a true top-k block
    (``exec/executor.py:283``); -inf stays -inf."""
    return torch.where(
        torch.isfinite(theta),
        theta - torch.abs(theta) * f32(1e-5) - f32(1e-30),
        theta,
    )


def prune_rows(rs, theta: torch.Tensor):
    """Rows whose ub + other is below θ [Q] park on the sentinel row 0
    with weight 0; leaf, ub and other are kept."""
    rows_d, rows_f, rows_n, w, leaf, ub, other = rs
    keep = (ub + other) >= theta[:, None]
    return (
        torch.where(keep, rows_d, 0),
        torch.where(keep, rows_f, 0),
        torch.where(keep, rows_n, 0),
        torch.where(keep, w, 0.0),
        leaf, ub, other,
    )


def wand_body(
    pools,
    rowsets,  # per group: (rows_d, rows_f, rows_n, w, leaf, ub, other) [Q, R]
    avgdl,
    leaf_min,
    alive,
    *,
    tree,
    gbits,
    scorer: Scorer,
    num_leaves: int,
    k: int,
    nd: int,
    sample: int,
    mode: str = "exact",  # "exact" | "strict" | "approx"
    kern=KERNELS,
    dense_args=(),  # per dense span: (pool, start, w, norms, avgdl, ub [Q, ndrows], other [Q])
    dense_static=(),
):
    """Block-max WAND top-k for sum-merged positive trees
    (``exec/executor.py:wand_body``): (1) decode only the `sample`
    highest-bound blocks per group and take the k-th partial score as θ;
    (2) park every block with ub + other < θ on the sentinel row and run
    the full fold. "strict" uses θ as it is, "exact" shaves it by a
    relative epsilon, "approx" returns the sampled pass's top-k."""
    kw = dict(
        gbits=gbits, scorer=scorer, num_leaves=num_leaves, nd=nd,
        kern=kern, dense_args=dense_args, dense_static=dense_static,
    )

    def fold_pass(sets, dense_keep):
        lm, ls = _leaf_arrays(pools, sets, avgdl, leaf_min, dense_keep=dense_keep, **kw)
        match, score = fold_tree(tree, lm, ls, None, None)
        return match & alive, score

    def dense_sample_keep(dargs):
        # dense spans keep their top-`sample` rows by row upper bound
        # (ties keep extra rows; more sampled decode only tightens θ)
        ub = dargs[5]
        s = min(sample, ub.shape[-1])
        return ub >= kern.topk(ub, None, s)[0][:, s - 1 : s]

    sorted_sets = [sort_by_ub(rs) for rs in rowsets]
    pm, ps = fold_pass(
        [sample_rows(rs[:5], sample) for rs in sorted_sets], dense_sample_keep
    )
    partial = torch.where(pm, ps, _NEG_INF)
    if mode == "approx":
        return kern.topk(partial, None, k)
    theta = kern.topk(partial, None, k)[0][:, k - 1]
    if mode != "strict":
        theta = shave_theta(theta)
    match, score = fold_pass(
        [prune_rows(rs, theta) for rs in sorted_sets],
        lambda dargs: (dargs[5] + dargs[6][:, None]) >= theta[:, None],
    )
    return kern.topk(torch.where(match, score, _NEG_INF), None, k)


def entry_device(device) -> torch.device:
    """``device`` as a ``torch.device``; the card when it is None (raises
    without one). ``"cuda"`` names the current card by its index, as the
    tensors made on it report their device."""
    if device is None:
        return require_cuda()
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def check_port_objects(segments, scorer=None) -> None:
    """Raise unless the readers and scorer (when given) are the port's own
    classes: the planner and kernels branch on ``isinstance`` of them."""
    for sr in segments:
        if not isinstance(sr, SegmentReader):
            raise TypeError(
                f"segment {type(sr).__module__}.{type(sr).__name__} is not "
                "an iresearch_tpu_torch SegmentReader (carry_segment opens "
                "a segment file of either package)"
            )
    if scorer is not None and not isinstance(scorer, Scorer):
        raise TypeError(f"scorer {scorer!r} is not an iresearch_tpu_torch Scorer")


class DeviceQuery:
    """A prepared query executing on ``device`` (the card when None),
    exact vs the host oracle (``exec/executor.py:DeviceQuery``).

    ``device_phrase=True`` (the default, as in the JAX package) evaluates
    a phrase of plain terms on the device (``exec/phrase.py``) where
    ``compile_phrase`` allows it; ``device_phrase=False`` evaluates every
    phrase on the host as an aux leaf, as ``QueryBatch`` does."""

    def __init__(
        self,
        flt: F.Filter,
        segments: Sequence,
        scorer: Optional[Scorer] = None,
        wand: bool = False,
        wand_sample: int = 16,
        wand_mode: str = "exact",
        device_phrase: bool = True,
        *,
        device=None,
    ) -> None:
        if wand_mode not in ("exact", "strict", "approx"):
            raise ValueError(
                f"wand_mode must be exact|strict|approx, got {wand_mode!r}"
            )
        if not isinstance(flt, F.Filter):
            raise TypeError(f"filter {flt!r} is not an iresearch_tpu_torch Filter")
        self.flt = flt
        self.scorer = scorer or BM25()
        check_port_objects(segments, self.scorer)
        self.wand = wand
        self.wand_sample = wand_sample
        self.wand_mode = wand_mode
        self.device_phrase = device_phrase
        self.device = entry_device(device)
        with span("query.terms"):
            self.prepared = HostQuery(flt, list(segments), self.scorer)
            self.compiler = _plan.PlanCompiler(self.prepared, self.scorer)
        self._plans: Dict[int, _plan.SegmentPlan] = {}
        self._full_plans: Dict[int, _plan.SegmentPlan] = {}

    def plan(self, seg_idx: int):
        p = self._plans.get(seg_idx)
        if p is None:
            p = _plancache.get_plan(
                self.compiler,
                self.flt,
                seg_idx,
                wand=self.wand,
                device_phrase=self.device_phrase,
                scorer=self.scorer,
            )
            self._plans[seg_idx] = p
        return p

    def plan_for_k(self, seg_idx: int, k: int):
        """Plan valid for a top-k of ``k`` (scored-only multiterm plans
        fall back to the full plan beyond ``scored_only_kmax``), under the
        span ``query.plan`` (``hit`` from the plan cache; a recompile of
        the full plan is a miss)."""
        with span("query.plan"):
            p = self.plan(seg_idx)
            if 0 < p.scored_only_kmax < k:
                p = self._full_plans.get(seg_idx)
                if p is None:
                    note(hit=False)
                    p = self.compiler.compile(
                        self.flt,
                        seg_idx,
                        wand=self.wand,
                        device_phrase=self.device_phrase,
                        scored_only=False,
                    )
                    self._full_plans[seg_idx] = p
            return p

    def single_call(self, seg_idx: int, k: int):
        """This query's top-k on one segment as a ``exec/batch.py:
        SingleCall``: the tier's runner and its inputs, uploaded once in
        one packed buffer and kept in ``plan.cache`` (so plans shared
        through the plan cache share uploads), and its fused entry. The
        tier dispatch of ``DeviceQuery.execute_segment_async`` in the JAX
        package."""
        plan = self.plan_for_k(seg_idx, k)
        key = ("torch_call", self.device, k, self.wand_sample, self.wand_mode)
        c = plan.cache.get(key)
        if c is None:
            from iresearch_tpu_torch.exec.batch import SingleCall, group_call, sky_spec

            sr = self.prepared.segments[seg_idx]
            sp = sky_spec(plan, sr, self.scorer, min(k, plan.nd_pad))
            call = group_call(
                sr, [plan], k, self.scorer, self.device,
                sky_specs=[sp],
                sky_M=None if sp is None else len(sp.row_ids),
                wand_sample=self.wand_sample,
                wand_mode=self.wand_mode,
                single=True,
            )
            c = plan.cache[key] = SingleCall(*call, self.device, k)
        return c

    def execute_segment_async(
        self, seg_idx: int, k: int, plain: bool = False, fused: bool = True
    ):
        """Per-segment top-k as fresh tensors on the device: (scores f32
        [k'], local docs i32 [k']), k' <= k; -inf scores are non-matches.
        ``fused=True`` (default) replays the CUDA graph of this call's
        signature (``SingleCall.run_fused``: captured on the first call of
        the signature, by this query or another); ``fused=False`` runs the
        tier eagerly (the debug path); ``plain=True`` runs the kernels'
        plain versions eagerly."""
        c = self.single_call(seg_idx, k)
        if fused and not plain:
            vals, docs = c.run_fused()
        else:
            vals, docs = c.fn(PLAIN if plain else KERNELS, *c.args, **c.kwargs)
        return vals[0], docs[0]

    def execute_segment(
        self, seg_idx: int, k: int, plain: bool = False, fused: bool = True
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-segment top-k -> (scores f32 [k'], local docs i32 [k'])."""
        vals, docs = self.execute_segment_async(seg_idx, k, plain, fused)
        return vals.cpu().numpy(), docs.cpu().numpy()

    def top_k(self, k: int, fused: bool = True) -> List[Tuple[int, float]]:
        """Global top-k (global_doc, score), ordered by (-score, doc)."""
        out: List[Tuple[int, float]] = []
        base = 0
        for s, sr in enumerate(self.prepared.segments):
            vals, docs = self.execute_segment(s, k, fused=fused)
            for v, d in zip(vals, docs):
                if math.isinf(v) and v < 0:
                    continue
                out.append((base + int(d), float(v)))
            base += sr.num_docs
        out.sort(key=lambda t: (-t[1], t[0]))
        return out[:k]


def search_device(
    reader, flt: F.Filter, scorer: Optional[Scorer] = None, k: int = 10,
    *, device=None,
) -> List[Tuple[int, float]]:
    """Top-k (global_doc, score) of ``flt`` over ``reader``'s segments on
    ``device``, the card when None (``exec/executor.py:search_device``)."""
    return DeviceQuery(flt, list(reader.segments), scorer, device=device).top_k(k)
