"""Share of an unprofiled step in which no kernel, copy or set runs on the
card (rank 0): one less the device's busy time a profiled step (the union
over streams), over the window's median step. The profiled steps' own span
is not the base: on a host-bound step the profiler's host cost doubles it
(resnet152.b128.1card: 355 ms profiled against 178 ms)."""

import statistics


def read(ctx):
    t = ctx.trace
    if t is None or t.steps == 0 or not t.device_ops:
        return None
    step_s = statistics.median(ctx.window["step_s"])
    return 100.0 * (1.0 - t.busy_s / t.steps / step_s)
