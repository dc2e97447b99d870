"""Kernel B's share of its roofline while serving: the least time of the
four NCUP NConv2d layers' work (shapes only) for every row the batches
ran, over the kernel's traced time. Nothing to read without NCUP."""

from flowbench import readers, trace, work


def read(ctx):
    if ctx.get("kind") != "serve" or not readers.traced(ctx) or "upsampler" not in ctx["config"]:
        return None
    spent = trace.kernel_s(ctx["trace"].ops, readers.NCONV)
    H, W = readers.padded_hw(ctx)
    if ctx["mix"].get("mesh"):
        H //= int(ctx["mix"]["mesh"][1])  # each rank runs its band of rows
    pk = readers.peaks(ctx)
    bound = readers.rows(ctx) * sum(
        work.bound_s(*work.nconv_work(2, H, W, k, cin, cout), pk)
        for k, cin, cout in work.ncup_layers(ctx["config"]))
    return readers.share(bound, spent)
