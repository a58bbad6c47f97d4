"""Queries whose results reached the host in the window, over the
window's seconds (from its start to the end of its last request)."""


def read(ctx):
    return ctx.queries / ctx.window_s if ctx.queries else None
