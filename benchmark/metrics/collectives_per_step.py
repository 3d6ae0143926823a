"""NCCL kernels per profiled step on rank 0: the merge groups' all-reduces
and the step's own reductions of metrics and batch statistics."""


def read(ctx):
    t = ctx.trace
    if t is None or t.steps == 0:
        return None
    n = t.family_count(ctx.family("nccl"))
    return n / t.steps if n else None
