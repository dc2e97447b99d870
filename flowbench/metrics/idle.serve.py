"""Share of the traced serving window in which no operation ran on the card."""

from flowbench import readers


def read(ctx):
    if ctx.get("kind") != "serve" or not readers.traced(ctx):
        return None
    return readers.idle(ctx)
