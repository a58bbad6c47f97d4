"""Fresh queries, one a request: closed loop, one client.

Each request draws a query with the mix's random law from the seed's
``window`` stream (set-up warms up on ``warmup_requests`` requests of its
``warmup`` stream, the same law) and serves it from the filter in hand to
the top k on the host. ``"entry": "index"`` is
``QueryBatch([filter], segments, scorer, wand=, device=).prepare_all(k)``
(span ``prepare``) and ``.run()`` with the fetch (span ``run``);
``"entry": "segment"`` serves it on a one-segment index as
``DeviceQuery(filter, segments, scorer, wand=, device=)`` (``prepare``)
and ``.execute_segment_async(0, k)`` with the fetch (``run``). A sample of
``check_sample`` requests drawn from the seed, and the first of each
category, is judged.
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


def setup(ctx):
    mix = ctx.mix
    if mix["entry"] not in ("index", "segment"):
        raise ValueError(f"entry {mix['entry']!r}")
    if mix["entry"] == "segment" and len(ctx.segments) != 1:
        raise ValueError("entry 'segment' serves a one-segment index")
    state = State(QueryStream(mix, ctx.bands, ctx.seed, "window"),
                  port_scorer(ctx.config["scorer"]), int(ctx.config["corpus"]["vocab"]),
                  mix["entry"])
    warm = QueryStream(mix, ctx.bands, ctx.seed, "warmup")
    for _ in range(int(mix["warmup_requests"])):
        request(state, ctx, _payload(warm, state.vocab))
    return state


def _payload(stream, vocab):
    q = stream.one()
    return q, port_filter(q, vocab)


def next_payload(state, ctx):
    return _payload(state.stream, state.vocab)


def request(state, ctx, payload):
    q, flt = payload
    wand = bool(ctx.mix["wand"])
    if state.entry == "index":
        from iresearch_tpu_torch.exec.batch import QueryBatch

        with ctx.span("prepare"):
            mb = QueryBatch([flt], ctx.segments, state.scorer, wand=wand,
                            device=ctx.device).prepare_all(ctx.k)
        with ctx.span("run"):
            got = ctx.fetch(mb.run())
    else:
        from iresearch_tpu_torch.exec.executor import DeviceQuery

        with ctx.span("prepare"):
            dq = DeviceQuery(flt, ctx.segments, state.scorer, wand=wand, device=ctx.device)
        with ctx.span("run"):
            got = ctx.fetch([t[None] for t in dq.execute_segment_async(0, ctx.k)])
    return (q, got), 1


def answers(state, records, ctx):
    """The judged sample: ``check_sample`` requests drawn from the seed and
    the first request of each category."""
    rng = np.random.default_rng(stream_seed(ctx.seed, "check"))
    n = len(records)
    pick = set(rng.choice(n, min(n, int(ctx.mix["check_sample"])), replace=False).tolist())
    seen = set()
    for i, rec in enumerate(records):
        if rec is not None and rec[0].category not in seen:
            seen.add(rec[0].category)
            pick.add(i)
    judged = []
    for i in sorted(pick):
        if records[i] is None:
            continue
        q, got = records[i]
        vals, docs = unpack(*got)
        v = np.full(ctx.k, -np.inf, np.float32)
        d = np.full(ctx.k, -1, np.int64)
        v[: vals.shape[1]] = vals[0]
        d[: docs.shape[1]] = docs[0]
        judged.append((q, v, d))
    return judged
