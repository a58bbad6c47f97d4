"""The device's busy time (the union of its operations' intervals) per
request in the traced slice: the fused pass with its fetch."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.ops:
        return None
    return tr.busy_s() / tr.requests * 1e3
