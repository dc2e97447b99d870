"""Share of the traced training window in which no operation ran on the card."""

from flowbench import readers


def read(ctx):
    if ctx.get("kind") != "train" or not readers.traced(ctx):
        return None
    return readers.idle(ctx)
