"""Median host time of a batch's launch and the dispatch throttle's wait
(the server's ``serve_dispatch`` spans in the traced window)."""

from flowbench import harness, readers


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    return harness.median(readers.span_ms(ctx, "serve_dispatch"))
