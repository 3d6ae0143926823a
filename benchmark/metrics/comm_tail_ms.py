"""The communication the backward did not hide, measured where it happens
(rank 0): the program's span recorder (``mgwfbp_tpu_torch.telemetry.
spans``) marks, on each step it arms, B (an event at the end of the
backward: it completes when the backward's device work does) and each
merge group's done event (on an observer stream, after the group's
collectives). A step's tail is max(0, the last done - B); this is the
median over the last ``ctx.trace.steps`` armed steps. torch.profiler arms
the recorder, so these are the profiled steps, and the reading is the
profiled regime's. None where the program has no recorder or the recorder
holds no group."""

import statistics


def read(ctx):
    t = ctx.trace
    if t is None or t.steps == 0:
        return None
    try:
        from mgwfbp_tpu_torch.telemetry import spans
    except ImportError:
        return None
    tails = [s["tail_ms"] for s in spans.recent_steps(t.steps)
             if s["tail_ms"] is not None]
    return statistics.median(tails) if tails else None
