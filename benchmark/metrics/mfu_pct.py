"""The whole step's share of the cards' bf16 peak: the configuration's
analytic training FLOPs of the window's images over the window's time, over
the peak times the chips."""


def read(ctx):
    if ctx.peak is None:
        return None
    w = ctx.window
    flops = ctx.work.train_flops(ctx.config, w["images"])
    return 100.0 * flops / w["seconds"] / (ctx.peak["bf16_flops_per_s"]
                                           * ctx.chips)
