"""Seconds from the process's start to the window's: corpus, index
(built, or opened from the seed's cache), the driver's preparation and
warm-up, kernels built and graphs captured."""


def read(ctx):
    return ctx.setup_s
