"""The share of the traced slice's queries that their plans sent to the
``gridmix`` exec mode, in %: the ``mode_queries`` counts that each
``batch.stack`` span carries (``exec/batch.py:tier_stats``, whose
whole-run counts it logs). Nothing where the program notes no such
counts."""

from benchmark import program_spans


def read(ctx):
    ps = program_spans.of(ctx)
    if ps is None:
        return None
    from iresearch_tpu_torch.exec import batch

    stats = getattr(batch, "tier_stats", None)
    if stats is not None:
        ctx.log(f"tier counts since the process started: {stats()}")
    modes = [s.attrs["mode_queries"] for s in ps.all
             if s.name == "batch.stack" and "mode_queries" in s.attrs]
    total = sum(n for m in modes for n in m.values())
    if not total:
        return None
    return 100.0 * sum(m.get("gridmix", 0) for m in modes) / total
