"""Kernel-launch runtime calls (cudaLaunchKernel and kin) per profiled step
on rank 0's stepping host thread and its helpers."""


def read(ctx):
    t = ctx.trace
    if t is None or t.steps == 0 or t.launches == 0:
        return None
    return t.launches / t.steps
