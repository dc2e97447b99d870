"""Kernel time of the traced training window over the steps it ran, in ms."""

from flowbench import readers


def read(ctx):
    if ctx.get("kind") != "train" or not readers.traced(ctx) or not ctx["steps"]:
        return None
    return 1e3 * readers.kernel_s(ctx) / ctx["steps"]
