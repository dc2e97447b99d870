"""Kernel B''s share of its roofline in training: the least time of the
NCUP layers' backward (shapes only; NCUP runs every iteration) times the
iterations and steps, over B''s traced time (its finalize included)."""

from flowbench import readers, trace, work


def read(ctx):
    if ctx.get("kind") != "train" or not readers.traced(ctx) or "upsampler" not in ctx["config"]:
        return None
    mix = ctx["mix"]
    H, W = mix["crop"]
    spent = trace.kernel_s(ctx["trace"].ops, readers.NCONV_BWD)
    layers = work.ncup_layers(ctx["config"])
    pk = readers.peaks(ctx)
    # Every layer's output confidence but the last's feeds a later layer.
    per_up = sum(work.bound_s(*work.nconv_bwd_work(2 * mix["batch"], H, W, k, cin, cout, False,
                                                   i + 1 < len(layers)), pk)
                 for i, (k, cin, cout) in enumerate(layers))
    bound = ctx["steps"] * mix["iters"] * per_up
    return readers.share(bound, spent)
