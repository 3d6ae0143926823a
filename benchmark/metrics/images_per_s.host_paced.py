"""``images_per_s`` of a cell whose pace a host sets (the launch-bound one-card
ResNet-152, the four-card step that waits for its slowest rank): its own
metric, under ``images_per_s.host_paced``, whose runs spread by a few
per cent on a busy host where a device-paced cell's spread by a tenth of
one."""

from benchmark.metrics.images_per_s import read  # noqa: F401
