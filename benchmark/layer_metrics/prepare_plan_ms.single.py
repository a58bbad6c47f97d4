"""The median over the traced slice's requests of each request's summed
``query.plan`` ms: each query planned on each segment (``plan_for_k``,
through the plan cache)."""

from benchmark import program_spans


def read(ctx):
    ps = program_spans.of(ctx)
    return ps.median_ms(("query.plan",)) if ps else None
