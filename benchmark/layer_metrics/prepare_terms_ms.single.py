"""The median over the traced slice's requests of each request's summed
``query.terms`` ms: every query's ``DeviceQuery`` built (term lookups and
index-wide statistics, ``HostQuery``; its ``PlanCompiler``)."""

from benchmark import program_spans


def read(ctx):
    ps = program_spans.of(ctx)
    return ps.median_ms(("query.terms",)) if ps else None
