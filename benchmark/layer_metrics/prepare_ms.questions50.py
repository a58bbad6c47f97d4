"""The median ms of the ``prepare`` span over the window's requests: a
fresh batch's query objects built and prepared (plans, stacking, the
packed upload)."""

import numpy as np


def read(ctx):
    s = ctx.spans.get("prepare")
    return float(np.median(s)) * 1e3 if s else None
