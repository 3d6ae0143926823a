"""Device-idle milliseconds a profiled step inside the program's
``train_step.forward`` ranges (on the stepping thread): over each range,
clipped to the trace's span, the time no device operation ran (the
complement of the busy intervals), summed and divided by the profiled
steps. The ranges are torch.profiler's, so this is the profiled regime's
reading. None where the trace holds no such range (a program without
phase spans)."""

SPAN = "train_step.forward"


def read(ctx, span=SPAN):
    t = ctx.trace
    if t is None or t.steps == 0:
        return None
    ranges = [(max(float(e["ts"]), t.start),
               min(float(e["ts"]) + float(e["dur"]), t.end))
              for e in t.host_ops
              if e["name"] == span and e.get("cat") == "user_annotation"]
    ranges = [(a, b) for a, b in ranges if b > a]
    if not ranges:
        return None
    busy = t.busy_intervals()
    idle = sum((b - a) - sum(max(0.0, min(b, y) - max(a, x))
                             for x, y in busy)
               for a, b in ranges)
    return idle / t.steps / 1e3
