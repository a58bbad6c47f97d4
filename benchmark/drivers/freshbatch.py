"""Fresh batches of queries, one batch a request: closed loop, one client.

Each request draws ``batch`` queries with the mix's random law from the
seed's ``window`` stream (set-up warms up on ``warmup_requests`` batches
of its ``warmup`` stream, the same law) and serves them from the filters
in hand to every query's top k on the host; it counts ``batch`` queries.
``"entry": "segment"`` serves a one-segment index as
``QueryBatch(filters, segments, scorer, wand=, device=).prepare(0, k)``
(span ``prepare``) and ``.run_grouped()`` with one fetch of every group
(span ``run``); ``"entry": "index"`` serves any index as
``QueryBatch(...).prepare_all(k)`` (``prepare``) and ``.run()`` with the
fetch (``run``). A sample of ``check_sample`` queries of the window drawn
from the seed, and the first query of each category, is judged.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from benchmark.corpus import stream_seed
from benchmark.harness import unpack
from benchmark.program import port_filter, port_scorer
from benchmark.traffic import QueryStream


class State(NamedTuple):
    stream: QueryStream
    scorer: object
    vocab: int
    entry: str
    batch: int


def setup(ctx):
    mix = ctx.mix
    if mix["entry"] not in ("index", "segment"):
        raise ValueError(f"entry {mix['entry']!r}")
    if mix["entry"] == "segment" and len(ctx.segments) != 1:
        raise ValueError("entry 'segment' serves a one-segment index")
    state = State(QueryStream(mix, ctx.bands, ctx.seed, "window"),
                  port_scorer(ctx.config["scorer"]), int(ctx.config["corpus"]["vocab"]),
                  mix["entry"], int(mix["batch"]))
    warm = QueryStream(mix, ctx.bands, ctx.seed, "warmup")
    for _ in range(int(mix["warmup_requests"])):
        request(state, ctx, _payload(warm, state))
    return state


def _payload(stream, state):
    qs = stream.draw(state.batch)
    return qs, [port_filter(q, state.vocab) for q in qs]


def next_payload(state, ctx):
    return _payload(state.stream, state)


def request(state, ctx, payload):
    """One batch served and fetched: ((queries, each group's query
    indices, the fetched bytes and their layout), queries served)."""
    from iresearch_tpu_torch.exec.batch import QueryBatch

    qs, filters = payload
    with ctx.span("prepare"):
        qb = QueryBatch(filters, ctx.segments, state.scorer, wand=bool(ctx.mix["wand"]),
                        device=ctx.device)
        prep = qb.prepare(0, ctx.k) if state.entry == "segment" else qb.prepare_all(ctx.k)
    with ctx.span("run"):
        if state.entry == "segment":
            grouped = prep.run_grouped()
            qis = [list(g) for _vd, g in grouped]
            got = ctx.fetch([t for vd, _g in grouped for t in vd])
        else:
            qis = [list(range(len(qs)))]
            got = ctx.fetch(list(prep.run()))
    return (qs, qis, got), len(qs)


def answers(state, records, ctx):
    """The judged sample: ``check_sample`` queries of the window drawn from
    the seed, and the first query of each category."""
    where = [(r, j) for r, rec in enumerate(records) if rec is not None
             for j in range(len(rec[0]))]
    rng = np.random.default_rng(stream_seed(ctx.seed, "check"))
    n = len(where)
    pick = set(rng.choice(n, min(n, int(ctx.mix["check_sample"])), replace=False).tolist())
    seen = set()
    for i, (r, j) in enumerate(where):
        cat = records[r][0][j].category
        if cat not in seen:
            seen.add(cat)
            pick.add(i)
    rows = {}
    judged = []
    for i in sorted(pick):
        r, j = where[i]
        if r not in rows:
            rows[r] = _rows(records[r], ctx.k)
        vals, docs = rows[r]
        judged.append((records[r][0][j], vals[j], docs[j]))
    return judged


def _rows(rec, k: int):
    """(vals [Q, k], docs [Q, k]) of one request, -inf and -1 past each
    query's answer."""
    qs, qis, got = rec
    arrays = unpack(*got)
    vals = np.full((len(qs), k), -np.inf, np.float32)
    docs = np.full((len(qs), k), -1, np.int64)
    for v, d, g in zip(arrays[0::2], arrays[1::2], qis):
        vals[g, : v.shape[1]] = v
        docs[g, : d.shape[1]] = d
    return vals, docs
