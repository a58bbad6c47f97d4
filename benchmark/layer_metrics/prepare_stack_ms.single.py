"""The median over the traced slice's requests of each request's summed
``batch.stack`` ms: each segment's skyline specs, signatures and
``group_call`` (the stacked host arrays of its groups)."""

from benchmark import program_spans


def read(ctx):
    ps = program_spans.of(ctx)
    return ps.median_ms(("batch.stack",)) if ps else None
