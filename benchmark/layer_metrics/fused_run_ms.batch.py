"""The median over the traced slice's requests of each request's
``fused.run`` ms: the host's side of the replayed pass (the LRU lookup,
the buffer load, the graph's launch and the copy-out)."""

from benchmark import program_spans


def read(ctx):
    ps = program_spans.of(ctx)
    return ps.median_ms(("fused.run",)) if ps else None
