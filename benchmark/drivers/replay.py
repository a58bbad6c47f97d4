"""A standing query set re-run against the index: closed loop, one client.

The mix's fixed set (``traffic.fixed_mix``) is prepared once in set-up
over a one-segment index, ``QueryBatch(filters, segments, scorer, wand=,
device=).prepare(0, k)``. Each request re-runs it (``run_grouped()``)
and fetches every query's top k to the host with one wait
(``Context.fetch``). Every
answer of the window is judged: the requests' results are grouped by
their bytes and each distinct result is compared in full (a sample of
``MAX_DISTINCT`` of them, drawn from the seed, where a faulty program
gives more).
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np

from benchmark.corpus import stream_seed
from benchmark.harness import unpack
from benchmark.program import port_filter, port_scorer
from benchmark.traffic import categories_of, fixed_mix


MAX_DISTINCT = 16


class State(NamedTuple):
    queries: list
    prep: object
    qis: list  # each group's query indices, as ``run_grouped`` orders them


def setup(ctx):
    from iresearch_tpu_torch.exec.batch import QueryBatch

    mix = ctx.mix
    queries = fixed_mix(mix, ctx.bands)
    vocab = int(ctx.config["corpus"]["vocab"])
    if len(ctx.segments) != 1:
        raise ValueError("the replay driver re-runs a one-segment index")
    qb = QueryBatch(
        [port_filter(q, vocab) for q in queries], ctx.segments,
        port_scorer(ctx.config["scorer"]), wand=bool(mix["wand"]), device=ctx.device,
    )
    prep = qb.prepare(0, ctx.k)
    ctx.objects["batch_calls"] = prep.calls
    ctx.log(f"replay: {len(queries)} queries {categories_of(queries)}, "
            f"{len(prep.calls)} signature groups")
    state = State(queries, prep, [])
    for _ in range(int(mix["warmup_requests"])):
        request(state, ctx, None)
    return state


def next_payload(state, ctx):
    return None


def request(state, ctx, _payload):
    """One re-run and its fetch: (the fetched bytes, their layout)."""
    with ctx.span("run"):
        grouped = state.prep.run_grouped()
    with ctx.span("fetch"):
        got = ctx.fetch([t for vd, _qis in grouped for t in vd])
    if not state.qis:
        state.qis.extend(qis for _vd, qis in grouped)
    return got, len(state.queries)


def _rows(state, got, k: int):
    """(vals [Q, k], docs [Q, k]) of one request's fetch."""
    arrays = unpack(*got)
    vals = np.full((len(state.queries), k), -np.inf, np.float32)
    docs = np.full((len(state.queries), k), -1, np.int64)
    for v, d, qis in zip(arrays[0::2], arrays[1::2], state.qis):
        vals[list(qis), : v.shape[1]] = v
        docs[list(qis), : d.shape[1]] = d
    return vals, docs


def answers(state, records, ctx):
    """Every answer of the window: each distinct result once."""
    distinct = {}
    for got in records:
        if got is not None:
            distinct.setdefault(hashlib.sha256(got[0]).digest(), got)
    ctx.log(f"replay: {len(records)} requests, {len(distinct)} distinct result(s)")
    outs = list(distinct.values())
    if len(outs) > MAX_DISTINCT:
        rng = np.random.default_rng(stream_seed(ctx.seed, "check"))
        outs = [outs[i] for i in sorted(rng.choice(len(outs), MAX_DISTINCT, replace=False))]
    judged = []
    for got in outs:
        vals, docs = _rows(state, got, ctx.k)
        judged += [(q, vals[i], docs[i]) for i, q in enumerate(state.queries)]
    return judged
