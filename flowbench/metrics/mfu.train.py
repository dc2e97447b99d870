"""The whole train step's share of the card's f32 peak: three times the
benchmark's analytic training-mode forward FLOPs (the upsampler every
iteration; the recompute not counted) per step, over the traced window."""

from flowbench import readers, work


def read(ctx):
    if ctx.get("kind") != "train" or not readers.traced(ctx) or not ctx["steps"]:
        return None
    mix = ctx["mix"]
    H, W = mix["crop"]
    flops = work.train_step_flops(ctx["config"], mix["batch"], H, W, mix["iters"])
    rate = flops * ctx["steps"] / ctx["trace"].window_s
    return 100.0 * rate / readers.peaks(ctx)["f32_flops"]
