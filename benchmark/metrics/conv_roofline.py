"""The convolutions' share of their compute roofline: the configuration's
convolution FLOPs (forward, input gradient and weight gradient) of the
profiled steps at the bf16 peak, over the device time of the convolution
family's kernels (rank 0)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.steps == 0 or ctx.peak is None:
        return None
    spent = t.family_s(ctx.family("conv"))
    if spent <= 0:
        return None
    need = ctx.work.conv_train_flops(ctx.config, ctx.batch * t.steps)
    return 100.0 * need / ctx.peak["bf16_flops_per_s"] / spent
