"""The dense scan's share of its roofline, in %: the least time of the
scan groups of the prepared batch (``work.k1_bytes`` over the memory
rate) over the device time of the scan kernel (``k1_dense_scan_rowmax``)
per request in the traced slice."""

from benchmark import work

KERNEL = "k1_dense_scan_rowmax"


def read(ctx):
    tr = ctx.trace
    calls = [c for c in ctx.objects.get("batch_calls", ()) if c[0] == "scan"]
    if tr is None or not calls:
        return None
    device_s = tr.op_seconds(KERNEL) / tr.requests
    if device_s <= 0:
        return None
    nbytes = 0
    for _tier, _qis, _fn, args, _kw in calls:
        pools, norms, starts, ws = args[:4]
        nbytes += work.k1_bytes(pools, starts, ws, norms)
    return 100.0 * work.least_seconds(nbytes) / device_s
