"""The whole forward's share of the cards' f32 peak: the benchmark's
analytic FLOPs of a served pair (padded size, the mix's iteration level,
the upsampler once) times the pairs answered, over the traced window and
the cards of the mesh."""

from flowbench import readers, work


def read(ctx):
    if ctx.get("kind") != "serve" or not readers.traced(ctx) or not readers.pairs(ctx):
        return None
    H, W = readers.padded_hw(ctx)
    flops = work.forward_flops(ctx["config"], 1, H, W, ctx["mix"]["iter_levels"][0])
    rate = flops * readers.pairs(ctx) / ctx["trace"].window_s
    cards = 1
    for n in ctx["mix"].get("mesh", [1]):
        cards *= int(n)
    return 100.0 * rate / (cards * readers.peaks(ctx)["f32_flops"])
