"""``forward_idle_ms.host_paced`` under the program's
``train_step.backward`` ranges: the device-idle milliseconds a profiled
step while the stepping thread waits on ``loss.backward()`` (the
autograd thread dispatches the backward's kernels) and does the
micro-step's bookkeeping."""

from benchmark import spec

_phase_idle_ms = spec.metric_reader("forward_idle_ms.host_paced")


def read(ctx):
    return _phase_idle_ms(ctx, "train_step.backward")
