"""The communication a step does not hide: the median step of the trainer in
the window (the slowest rank's per step) less the median step of a second
copy of the model through a TrainStep that issues no collective, on the
same cards in the same run (the slowest rank's median)."""


def read(ctx):
    p = ctx.probe
    if p is None:
        return None
    return 1e3 * (p["trainer_s"] - p["local_s"])
