"""The median over the traced slice's requests of each request's summed
``batch.pack`` and ``merge.init`` ms: each segment's ``PreparedBatch``
(the pinned fill and one upload, ``_pack_args``; the cache key) and the
merge's own pack."""

from benchmark import program_spans


def read(ctx):
    ps = program_spans.of(ctx)
    return ps.median_ms(("batch.pack", "merge.init")) if ps else None
