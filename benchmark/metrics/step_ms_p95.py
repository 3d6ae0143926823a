"""95th percentile (nearest rank) of the window's step times in ms: the gap
between CUDA events at step boundaries, at several ranks the largest gap
of any rank for that step."""

import math


def read(ctx):
    s = sorted(ctx.window["step_s"])
    return 1e3 * s[max(math.ceil(0.95 * len(s)) - 1, 0)]
