"""Halo exchanges (the program's ``collective-permute`` count) rank 0
issued in the window, over the pairs answered: the spatial axis's
exchanges, which exist only across cards."""

from flowbench import readers


def read(ctx):
    counts = ctx.get("collectives")
    if ctx.get("kind") != "serve" or counts is None or not readers.pairs(ctx):
        return None
    return counts.get("collective-permute", 0) / readers.pairs(ctx)
