"""The device's idle time in the traced slice that lies under any program
span, over the slice's wall time, in % (``idle_pct.single`` less it is
the idle under the harness alone: the fetch and the client)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.idle_in_program_pct(ctx)
