"""The top-k select's share of its roofline, in %: the least time of the
K4 calls that the traced slice ran (``work_k4.k4_bytes`` of the call shapes
that each ``fused.replay`` and ``fused.capture`` span carries, the
capture's for its warm-up run, over the memory rate) over the device
time of K4's operations (``k4_topk_docs``, ``k4_sort_runs``,
``k4_merge``). Nothing where the program notes no shapes."""

from benchmark import program_spans, work, work_k4

KERNELS = ("k4_topk_docs", "k4_sort_runs", "k4_merge")


def read(ctx):
    ps = program_spans.of(ctx)
    tr = ctx.trace
    if ps is None or tr is None:
        return None
    shapes = [c for s in ps.all if s.name in ("fused.replay", "fused.capture")
              for c in s.attrs.get("k4", ())]
    device_s = sum(tr.op_seconds(name) for name in KERNELS)
    if not shapes or device_s <= 0:
        return None
    nbytes = sum(work_k4.k4_bytes(*c) for c in shapes)
    return 100.0 * work.least_seconds(nbytes) / device_s
