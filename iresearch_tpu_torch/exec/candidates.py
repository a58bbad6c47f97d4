"""Scale-proportional tiers: query cost O(postings) (``exec/candidates.py``).

Every body takes a leading query axis ``[Q, ...]`` (``Q = 1`` for the
single query) and decodes and scores its postings rows through K3's
scored form (``ops/decode.py:decode_score_rows``, through
``group_contrib``); the join's probe, which needs raw frequencies, goes
through the plain form (``decode_rows``). ``kern`` is the kernel set
(``KERNELS`` or ``PLAIN``):

* ``dslice`` — a single term's contiguous rows, fetched by K2;
* ``direct`` — a single-span leaf: decoded docs are unique, top-k over
  the decoded lanes;
* ``sort`` — general covering trees: a stable sort of the decoded lanes
  by doc, a segmented Hillis-Steele scan over the doc runs, the fold at
  the run ends;
* ``join`` — a conjunction with a single-span driver: every other span is
  probed at the driver's docs (one searched block per candidate, decoded
  by K3; one packed word per candidate for dense-grid spans);
* ``gridmix`` — dense-grid view and sparse candidate view, merged.

All compose with block-max WAND through ``candidate_body``. Results are in
(score desc, doc asc) order; the JAX package orders ties inside the top-k
by lane, so tests compare its output after sorting it the same way.
"""

from __future__ import annotations

import torch

from iresearch_tpu_torch.exec.executor import (
    _NEG_INF,
    KERNELS,
    dense_contrib,
    fold_tree,
    gather_clamped,
    group_contrib,
    prune_rows,
    sample_rows,
    shave_theta,
    sort_by_ub,
)
from iresearch_tpu_torch.formats.bitpack import (
    lane_mask,
    unpack_torch,
    words_per_block,
)
from iresearch_tpu_torch.formats.spec import BLOCK
from iresearch_tpu_torch.ops.topk import _IMAX32
from iresearch_tpu_torch.search.scorers import Scorer, score_block_torch


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
    kern=KERNELS,
):
    """Per-query (vals f32 [Q, k], docs i32 [Q, k]) of pre-fetched [R, wpb]
    row windows, decoded and scored by one launch of K3's scored form
    (``kern.decode_score``) with every window row its own pool row. Rows
    past a query's real count decode other terms' data: they are masked by
    ``nreal`` and their doc ids parked at IMAX, so tie-break cannot collide
    with a real doc."""
    bd, bf, bn = gbits
    Q, R = base_r.shape
    n = Q * R
    rows = torch.arange(n, dtype=torch.int32, device=base_r.device)
    docs, sc, m = kern.decode_score(
        dwords.reshape(n, -1), fwords.reshape(n, -1), base_r.reshape(n),
        rows, rows, None if nwords is None else nwords.reshape(n, -1), rows,
        # contiguous before the reshape: for Q == 1 the expanded view would
        # reshape to a stride-0 view, which the kernel's wrapper refuses
        norms, w[:, None].expand(Q, R).contiguous().reshape(n), avgdl,
        bd=bd, bf=bf, bn=bn, scorer=scorer,
    )
    docs = docs.reshape(Q, R, BLOCK)
    sc = sc.reshape(Q, R, BLOCK)
    rowix = torch.arange(R, dtype=torch.int32, device=base_r.device)
    live = (rowix[None, :] < nreal[:, None])[:, :, None] & m.reshape(Q, R, BLOCK)
    if alive is not None:
        live = live & gather_clamped(alive, docs)
    docs = torch.where(live, docs, _IMAX32)
    masked = torch.where(live, sc, _NEG_INF)
    return kern.topk(masked.reshape(Q, -1), docs.reshape(Q, -1), k)


def dslice_topk(
    kern, pools, starts, nreal, w, norms, avgdl, alive, *, gbits, scorer, k, R
):
    """Single-term top-k of contiguous rows (``exec/candidates.py:
    dslice_topk``; the batch's ``_run_batch_dslice``): K2 fetches every
    query's [R, wpb] windows of the P slice pools (doc, freq[, nrm], base
    as [rows, 1]) from starts int32 [Q, P], then ``dslice_core``."""
    outs = kern.row_slices(pools, starts, R)
    q = starts.shape[0]
    return dslice_core(
        outs[0], outs[1], outs[2] if gbits[2] >= 0 else None,
        outs[-1].reshape(q, R), norms, nreal, w, avgdl, alive,
        gbits=gbits, scorer=scorer, k=k, kern=kern,
    )


def decode_flat(pools, rowsets, avgdl, gbits, scorer: Scorer, *, kern=KERNELS, slicer=None):
    """Every row group decoded into flat per-lane arrays: (docs i32
    [Q, P], score f32, matched bool, leaf i32), P = sum of rows * 128.
    ``slicer`` optionally narrows each rowset (WAND sampled phase)."""
    docs_l, sc_l, m_l, leaf_l = [], [], [], []
    for gi, (pool, rs) in enumerate(zip(pools, rowsets)):
        rows_d, rows_f, rows_n, w, leaf = rs[:5] if slicer is None else slicer(rs)
        docs, sc, m = group_contrib(
            pool, rows_d, rows_f, rows_n, w, gbits[gi], avgdl[gi], scorer,
            kern=kern,
        )
        q = docs.shape[0]
        docs_l.append(docs.reshape(q, -1))
        sc_l.append(sc.reshape(q, -1))
        m_l.append(m.reshape(q, -1))
        leaf_l.append(leaf[:, :, None].expand(docs.shape).reshape(q, -1))
    return tuple(torch.cat(x, dim=-1) for x in (docs_l, sc_l, m_l, leaf_l))


def direct_topk(pools, rowsets, avgdl, alive, *, gbits, scorer, k, kern=KERNELS):
    """Single-span top-k: decoded docs are unique, no combine is needed.
    Trailing padding lanes repeat the last real doc with freq 0 and the
    sentinel decodes to doc 0 with freq 0; both carry matched=False."""
    docs, sc, m, _ = decode_flat(pools, rowsets, avgdl, gbits, scorer, kern=kern)
    match = m if alive is None else m & gather_clamped(alive, docs)
    return kern.topk(torch.where(match, sc, _NEG_INF), docs, k)


def _shift_right(x: torch.Tensor, s: int) -> torch.Tensor:
    """x moved ``s`` lanes toward the end of its last axis, zero-filled."""
    pad = torch.zeros(x.shape[:-1] + (s,), dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :-s]], dim=-1)


def sorted_topk(
    pools, rowsets, avgdl, leaf_min, alive,
    *, tree, gbits, scorer, num_leaves, k, kern=KERNELS, slicer=None,
    dense_leaf=None,  # (score_d [Q, L, nd], count_d [Q, L, nd], leaves)
):
    """Sort + segmented-scan candidate top-k for covering trees.

    The stable sort by doc (as ``lax.sort``) makes each doc's lanes
    contiguous and keeps them in lane order, so the scan sums them in the
    JAX package's order; each run's last lane then holds its doc's
    per-leaf totals and becomes the doc's candidate slot."""
    docs, sc, m, leaf = decode_flat(
        pools, rowsets, avgdl, gbits, scorer, kern=kern, slicer=slicer
    )
    q, P = docs.shape
    dev = docs.device
    sdocs, order = torch.sort(docs, dim=-1, stable=True)
    ssc = sc.gather(-1, order)
    sleaf = leaf.gather(-1, order)
    scnt = m.gather(-1, order).to(torch.float32)
    # channels [Q, L, 2, P]: per-leaf score and per-leaf count (floats;
    # counts are small integers, so f32 addition is exact)
    on = sleaf[:, None, :] == torch.arange(num_leaves, device=dev)[None, :, None]
    chans = torch.stack(
        [torch.where(on, ssc[:, None], 0.0), torch.where(on, scnt[:, None], 0.0)],
        dim=2,
    )
    # segmented inclusive scan over the doc runs
    false = torch.zeros((q, 1), dtype=torch.bool, device=dev)
    conn = torch.cat([false, sdocs[:, 1:] == sdocs[:, :-1]], dim=-1)
    shift = 1
    while shift < P:
        c_prev = _shift_right(conn, shift)
        chans = chans + torch.where(conn[:, None, None], _shift_right(chans, shift), 0.0)
        conn = conn & c_prev
        shift <<= 1
    is_end = torch.cat([sdocs[:, :-1] != sdocs[:, 1:], ~false], dim=-1)
    leaf_score = torch.where(is_end[:, None], chans[:, :, 0], 0.0)
    leaf_count = torch.where(is_end[:, None], chans[:, :, 1], 0.0).to(torch.int32)
    # dense-grid contributions at the candidate docs (gridmix view B),
    # added at run ends only, so each doc counts once
    if dense_leaf is not None:
        score_d, count_d, dense_leaves = dense_leaf
        ndg = score_d.shape[-1]
        cd = torch.clamp(sdocs, 0, ndg - 1).to(torch.int64)
        ok = (sdocs >= 0) & (sdocs < ndg) & is_end
        for lf in dense_leaves:
            leaf_score[:, lf] += torch.where(ok, score_d[:, lf].gather(-1, cd), 0.0)
            leaf_count[:, lf] += torch.where(ok, count_d[:, lf].gather(-1, cd), 0)
    leaf_match = leaf_count >= leaf_min[:, :, None]
    leaf_score = torch.where(leaf_match, leaf_score, 0.0)
    match, score = fold_tree(tree, leaf_match, leaf_score, None, None)
    # only run ends are candidates; covering trees cannot match elsewhere
    match = match & is_end
    if alive is not None:
        match = match & gather_clamped(alive, sdocs)
    return kern.topk(torch.where(match, score, _NEG_INF), sdocs, k)


def dense_probe(dargs, dstat, cdocs, scorer: Scorer, dl=None):
    """(score f32 [Q, P], hit bool [Q, P]) of a dense-grid span at the
    candidate docs: doc d lives in row ``start + d // 128``, lane
    ``d % 128``, i.e. in word ``lane % 4b`` at bit ``(lane // 4b) * b`` —
    one word gather per candidate (``exec/candidates.py:dense_probe``)."""
    pool, start, w, norms_g, avgdl = dargs[:5]
    bits, _leaf, ndrows = dstat[:3]
    nd = ndrows * BLOCK
    cd = torch.clamp(cdocs, 0, nd - 1)
    row = start[:, None].to(torch.int64) + (cd >> 7)
    lane = cd & (BLOCK - 1)
    wpb = words_per_block(bits)
    word = pool[row, (lane % wpb).to(torch.int64)]
    freq = ((word >> ((lane // wpb) * bits)) & lane_mask(bits)).to(torch.float32)
    hit = (freq > 0) & (cdocs < nd) & (cdocs >= 0)
    if dl is None:
        dl = gather_clamped(norms_g, cd)
    sc = score_block_torch(scorer, w[:, None], freq, dl, avgdl)
    return torch.where(hit, sc, 0.0), hit


def join_topk(
    pools, rowsets, avgdl, leaf_min, alive, nreal,
    *, tree, gbits, scorer, num_leaves, k, driver_gi, group_leaf, kern=KERNELS,
    dense_args=(), dense_static=(),
):
    """Block-probe conjunction join (``exec/candidates.py:join_topk``).

    The candidates are the driver span's decoded docs. Every other span
    is never fully decoded: each candidate searches the span's per-block
    first docs (``torch.searchsorted``, right side) for the one 128-doc
    block that could hold it, K3 decodes that block, and a compare and
    masked sum reads its frequency. ``nreal`` int32 [Q, G] counts each
    group's real lanes."""
    G = len(pools)
    q = leaf_min.shape[0]
    dev = leaf_min.device

    def probe(gi, cdocs):
        """(freq f32 [Q, P], weight f32 [Q, P], dl f32 [Q, P] or None) of
        span ``gi`` at each candidate doc; dl None on legacy segments."""
        _bd, _bf, bng = gbits[gi]
        doc_words, freq_words, nrm_words, base, _norms = pools[gi]
        g_rows_d, g_rows_f, g_rows_n, g_w, _gl = rowsets[gi][:5]
        R = g_rows_d.shape[-1]
        # per-row first-doc keys, ascending over the span's real rows;
        # padding rows key IMAX so they sort last
        real = torch.arange(R, dtype=torch.int32, device=dev)[None, :] < (
            nreal[:, gi : gi + 1] >> 7
        )
        base_key = torch.where(real, base[g_rows_d.to(torch.int64)], _IMAX32)
        rowpos = torch.clamp(
            torch.searchsorted(base_key, cdocs, right=True) - 1, 0, R - 1
        )
        rd = g_rows_d.gather(-1, rowpos)
        docs_row, freqs_row = kern.decode(
            doc_words, freq_words, base, rd.reshape(-1),
            g_rows_f.gather(-1, rowpos).reshape(-1), bd=gbits[gi][0], bf=gbits[gi][1],
        )
        docs_row = docs_row.reshape(cdocs.shape + (BLOCK,))
        eq = docs_row == cdocs[..., None]
        # partial-block repeat lanes carry freq 0, so summing over the
        # (possibly repeated) equal lanes yields the real frequency
        freq_at = torch.where(
            eq, freqs_row.reshape(docs_row.shape), 0.0
        ).sum(-1)
        dl_at = None
        if bng >= 0:
            rn = g_rows_n.gather(-1, rowpos).to(torch.int64)
            nrm_row = unpack_torch(nrm_words[rn], bng)
            dl_at = torch.clamp_min(
                torch.where(eq, nrm_row, 0).sum(-1).to(torch.float32), 1.0
            )
        return freq_at, g_w.gather(-1, rowpos), dl_at

    def decode_span(gi):
        rows_d, rows_f, rows_n, w, _leaf = rowsets[gi][:5]
        docs, sc, m, dl = group_contrib(
            pools[gi], rows_d, rows_f, rows_n, w, gbits[gi], avgdl[gi],
            scorer, kern=kern, want_dl=True,
        )
        P = docs.shape[1] * BLOCK
        lane = torch.arange(P, dtype=torch.int32, device=dev)
        cdocs = torch.where(
            lane[None, :] < nreal[:, gi : gi + 1], docs.reshape(q, P), _IMAX32
        )
        return cdocs, sc.reshape(q, P), m.reshape(q, P), dl.reshape(q, P)

    cand_gis = [driver_gi] if driver_gi >= 0 else list(range(G))
    out_docs, out_masked = [], []
    for ci in cand_gis:
        cdocs, csc, cm, cdl = decode_span(ci)
        P = cdocs.shape[1]
        leaf_score = [torch.zeros((q, P), dtype=torch.float32, device=dev)] * num_leaves
        leaf_count = [torch.zeros((q, P), dtype=torch.int32, device=dev)] * num_leaves
        li = group_leaf[ci]
        leaf_score[li] = torch.where(cm, csc, 0.0)
        leaf_count[li] = cm.to(torch.int32)
        valid = cm  # pads and partial-block repeats are never candidates
        for gi in range(G):
            if gi == ci:
                continue
            freq_at, w_at, dl_at = probe(gi, cdocs)
            hit = freq_at > 0
            if dl_at is None:  # legacy span: per-lane norms gather
                dl_at = gather_clamped(pools[gi][4], cdocs)
            sc_at = score_block_torch(scorer, w_at, freq_at, dl_at, avgdl[gi])
            lj = group_leaf[gi]
            leaf_score[lj] = leaf_score[lj] + torch.where(hit, sc_at, 0.0)
            leaf_count[lj] = leaf_count[lj] + hit.to(torch.int32)
            if driver_gi < 0 and gi < ci:
                valid = valid & ~hit  # dedup: earlier span owns the doc
        # dense-grid probed spans: the driver's decoded dl is reused only
        # when the span lives in the same field (dstat[3])
        for dargs, dstat in zip(dense_args, dense_static):
            sc_at, hit = dense_probe(
                dargs, dstat, cdocs, scorer, dl=cdl if dstat[3] else None
            )
            lj = dstat[1]
            leaf_score[lj] = leaf_score[lj] + torch.where(hit, sc_at, 0.0)
            leaf_count[lj] = leaf_count[lj] + hit.to(torch.int32)
        leaf_count_s = torch.stack(leaf_count, dim=1)
        leaf_match = leaf_count_s >= leaf_min[:, :, None]
        leaf_score_s = torch.where(leaf_match, torch.stack(leaf_score, dim=1), 0.0)
        match, score = fold_tree(tree, leaf_match, leaf_score_s, None, None)
        match = match & valid
        if alive is not None:
            match = match & gather_clamped(alive, cdocs)
        out_docs.append(cdocs)
        out_masked.append(torch.where(match, score, _NEG_INF))
    return kern.topk(torch.cat(out_masked, dim=-1), torch.cat(out_docs, dim=-1), k)


def merge_topk_lists(va, da, vb, db, k: int, kern=KERNELS):
    """Exact union of two per-view top-k lists, deduped by doc (the max
    score wins: views only ever underestimate), in (score desc, doc asc)
    order (``exec/candidates.py:merge_topk_lists``)."""
    vals = torch.cat([va, vb], dim=-1)
    # -inf slots carry arbitrary docs: park them on IMAX
    docs = torch.where(torch.isfinite(vals), torch.cat([da, db], dim=-1), _IMAX32)
    # doc asc, score desc: a stable sort by score, then by doc
    o = torch.argsort(-vals, dim=-1, stable=True)
    vals, docs = vals.gather(-1, o), docs.gather(-1, o)
    sd, o = torch.sort(docs, dim=-1, stable=True)
    sv = vals.gather(-1, o)
    first = torch.ones_like(sd, dtype=torch.bool)
    first[:, 1:] = sd[:, 1:] != sd[:, :-1]
    keep = torch.where(first & (sd != _IMAX32), sv, _NEG_INF)
    return kern.topk(keep, sd, k)


def gridmix_topk(
    pools, rowsets, avgdl, leaf_min, alive,
    *, tree, gbits, scorer, num_leaves, k, nd, kern=KERNELS,
    dense_args, dense_static,
):
    """Dual-view execution for sum-merged trees mixing dense-grid and
    sparse spans (``exec/candidates.py:gridmix_topk``): view A folds the
    dense spans on the [nd] grid, view B evaluates the tree exactly at
    the sparse spans' candidate docs; every doc is exact in one view and
    underestimated in the other, so the deduped union holds the top-k."""
    q = leaf_min.shape[0]
    dev = leaf_min.device
    score_d = torch.zeros((q, num_leaves, nd), dtype=torch.float32, device=dev)
    count_d = torch.zeros((q, num_leaves, nd), dtype=torch.int32, device=dev)
    for dargs, dstat in zip(dense_args, dense_static):
        sc, m = dense_contrib(dargs, dstat, scorer)
        score_d[:, dstat[1]] += sc
        count_d[:, dstat[1]] += m.to(torch.int32)
    dense_leaves = tuple(sorted({dstat[1] for dstat in dense_static}))
    leaf_match = count_d >= leaf_min[:, :, None]
    match, score = fold_tree(
        tree, leaf_match, torch.where(leaf_match, score_d, 0.0), None, None
    )
    if alive is not None:
        match = match & alive
    grid_ids = torch.arange(nd, dtype=torch.int32, device=dev).expand(q, nd)
    va, da = kern.topk(torch.where(match, score, _NEG_INF), grid_ids, k)
    # view B's candidate space is only the sparse lanes: its k caps there
    p_sp = sum(rs[0].shape[-1] for rs in rowsets) * BLOCK
    vb, db = sorted_topk(
        pools, rowsets, avgdl, leaf_min, alive,
        tree=tree, gbits=gbits, scorer=scorer, num_leaves=num_leaves,
        k=min(k, p_sp), kern=kern,
        dense_leaf=(score_d, count_d, dense_leaves),
    )
    return merge_topk_lists(va, da, vb, db, k, kern)


def wand_theta(
    pools, sorted_sets, avgdl, leaf_min, alive,
    *, tree, gbits, scorer, num_leaves, k, sample, mode, kern=KERNELS,
    wand_mode="exact",
):
    """Lower-bound θ [Q] from the `sample` highest-upper-bound blocks per
    group (``exec/candidates.py:wand_theta``), f32."""
    def slicer(rs):
        return sample_rows(rs[:5], sample)

    if mode == "direct":
        docs, sc, m, _ = decode_flat(
            pools, sorted_sets, avgdl, gbits, scorer, kern=kern, slicer=slicer
        )
        pm = m if alive is None else m & gather_clamped(alive, docs)
        theta = kern.topk(torch.where(pm, sc, _NEG_INF), None, k)[0][:, k - 1]
    else:  # sort-compact partial fold
        vals, _docs = sorted_topk(
            pools, sorted_sets, avgdl, leaf_min, alive,
            tree=tree, gbits=gbits, scorer=scorer, num_leaves=num_leaves,
            k=k, kern=kern, slicer=slicer,
        )
        theta = vals[:, k - 1]
    if wand_mode in ("strict", "approx"):
        return theta
    return shave_theta(theta)


def candidate_body(
    pools,
    rowsets,
    avgdl,
    leaf_min,
    alive,
    nreal=None,  # int32 [Q, G] real-lane counts (join mode)
    *,
    tree,
    gbits,
    scorer: Scorer,
    num_leaves: int,
    k: int,
    mode: str,  # "direct" | "sort" | "join" | "gridmix"
    driver_gi: int = 0,
    group_leaf: tuple = (),
    wand: bool = False,
    sample: int = 16,
    wand_mode: str = "exact",
    nd: int = 0,
    kern=KERNELS,
    dense_args=(),
    dense_static=(),
):
    """The scale-proportional executor body (``exec/candidates.py:
    candidate_body``): per-query (vals f32 [Q, k], docs i32 [Q, k])."""
    if mode == "gridmix":
        return gridmix_topk(
            pools, rowsets, avgdl, leaf_min, alive,
            tree=tree, gbits=gbits, scorer=scorer, num_leaves=num_leaves,
            k=k, nd=nd, kern=kern, dense_args=dense_args,
            dense_static=dense_static,
        )
    sets = rowsets
    if wand:
        sorted_sets = [sort_by_ub(rs) for rs in rowsets]
        if wand_mode == "approx" and mode in ("direct", "sort"):
            # one pass over the `sample` highest-bound blocks per group;
            # join keeps θ-pruning (approx there = strict θ)
            sets = [sample_rows(rs, sample) for rs in sorted_sets]
        else:
            theta = wand_theta(
                pools, sorted_sets, avgdl, leaf_min, alive,
                tree=tree, gbits=gbits, scorer=scorer, num_leaves=num_leaves,
                k=k, sample=sample, mode=mode, kern=kern,
                wand_mode=wand_mode,
            )
            sets = [prune_rows(rs, theta) for rs in sorted_sets]
    if mode == "direct":
        return direct_topk(
            pools, sets, avgdl, alive, gbits=gbits, scorer=scorer, k=k,
            kern=kern,
        )
    if mode == "join":
        return join_topk(
            pools, sets, avgdl, leaf_min, alive, nreal,
            tree=tree, gbits=gbits, scorer=scorer, num_leaves=num_leaves,
            k=k, driver_gi=driver_gi, group_leaf=group_leaf, kern=kern,
            dense_args=dense_args, dense_static=dense_static,
        )
    return sorted_topk(
        pools, sets, avgdl, leaf_min, alive,
        tree=tree, gbits=gbits, scorer=scorer, num_leaves=num_leaves, k=k,
        kern=kern,
    )
