"""Seconds of the trainer's ``setup.reducer`` span on rank 0 (the program's
span recorder, ``mgwfbp_tpu_torch.telemetry.spans``): the cost model, the
backward profile, the schedule solve and attaching the hooks, timed on
the host clock inside ``Trainer.__init__``, before any profiler. None
where the program records no set-up spans."""


def read(ctx):
    try:
        from mgwfbp_tpu_torch.telemetry import spans
    except ImportError:
        return None
    return spans.setup_seconds().get("setup.reducer")
