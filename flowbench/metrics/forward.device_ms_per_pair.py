"""Kernel time of the traced window over the pairs it answered, in ms."""

from flowbench import readers


def read(ctx):
    if ctx.get("kind") != "serve" or not readers.traced(ctx) or not readers.pairs(ctx):
        return None
    return 1e3 * readers.kernel_s(ctx) / readers.pairs(ctx)
