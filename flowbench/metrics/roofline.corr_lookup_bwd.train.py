"""Kernel A''s share of its roofline in training: the least time of one
step's backward lookups (one an iteration, d f1 and d f2, in-bounds
positions from the reference's first-step coordinates) times the steps,
over A''s traced time."""

from flowbench import readers, trace, work


def read(ctx):
    if ctx.get("kind") != "train" or not readers.traced(ctx) or "lookup_bwd_iter_work" not in ctx:
        return None
    spent = trace.kernel_s(ctx["trace"].ops, readers.CORR_BWD)
    pk = readers.peaks(ctx)
    bound = ctx["steps"] * sum(work.bound_s(b, o, pk) for b, o in ctx["lookup_bwd_iter_work"])
    return readers.share(bound, spent)
