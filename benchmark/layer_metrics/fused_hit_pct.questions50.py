"""The share of the traced slice's ``fused.run`` spans that hit the LRU
of fused passes (a replay without a capture), in %."""

from benchmark import program_spans


def read(ctx):
    ps = program_spans.of(ctx)
    return ps.hit_pct("fused.run") if ps else None
