"""Seconds from the run's start to the first timed step: imports, CUDA, the
trainer (its backward profile and schedule solve at several ranks), the
weights and batches, the check's steps and the warm-up."""


def read(ctx):
    return ctx.window["setup_s"]
