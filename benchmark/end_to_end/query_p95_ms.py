"""The 95th percentile, in ms, of every request of the window, from the
request in hand to its results on the host."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx.latencies, 95)) * 1e3 if ctx.latencies else None
