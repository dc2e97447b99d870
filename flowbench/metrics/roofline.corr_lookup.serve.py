"""Kernel A's share of its roofline while serving: the least time of its
work (bytes or operations at peak; in-bounds patch positions from the
reference's coordinates of a checked answer, per row and iteration) for
every row the batches ran, over the kernel's traced time."""

from flowbench import readers, trace, work


def read(ctx):
    if ctx.get("kind") != "serve" or not readers.traced(ctx) or "lookup_row_work" not in ctx:
        return None
    spent = trace.kernel_s(ctx["trace"].ops, readers.CORR)
    nbytes, ops = ctx["lookup_row_work"]
    launches = readers.rows(ctx) * ctx["mix"]["iter_levels"][0]
    bound = launches * work.bound_s(nbytes, ops, readers.peaks(ctx))
    return readers.share(bound, spent)
