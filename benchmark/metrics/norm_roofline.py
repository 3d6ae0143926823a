"""The batch norms' share of their memory roofline: the least time the bytes
they must move take at the card's HBM peak (forward x read and y written,
backward x and dy read and dx written, in the compute dtype, from the
configuration's shapes), over the device time of the batch-norm family's
kernels in the profiled steps (rank 0)."""

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def read(ctx):
    t = ctx.trace
    if t is None or t.steps == 0 or ctx.peak is None:
        return None
    spent = t.family_s(ctx.family("batch_norm"))
    if spent <= 0:
        return None
    need = ctx.work.bn_train_bytes(ctx.config, ctx.batch * t.steps,
                                   DTYPE_BYTES[ctx.config["dtype"]])
    return 100.0 * need / ctx.peak["hbm_bytes_per_s"] / spent
