"""The share of the traced slice's ``query.plan`` spans that hit the plan
cache, in % (a plan compiled again for a larger k counts as a miss)."""

from benchmark import program_spans


def read(ctx):
    ps = program_spans.of(ctx)
    return ps.hit_pct("query.plan") if ps else None
