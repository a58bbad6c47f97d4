"""The median ms of the ``run`` span: the prepared query run (every
segment's pass and the merge) and its top k fetched to the host."""

import numpy as np


def read(ctx):
    s = ctx.spans.get("run")
    return float(np.median(s)) * 1e3 if s else None
