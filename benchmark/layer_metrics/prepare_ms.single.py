"""The median ms of the ``prepare`` span: the program's query objects
built and prepared (plans, stacking, the packed upload)."""

import numpy as np


def read(ctx):
    s = ctx.spans.get("prepare")
    return float(np.median(s)) * 1e3 if s else None
