"""The device's idle share of the traced slice's wall time, in %: 1 less
the union of its operations' intervals over the slice."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
