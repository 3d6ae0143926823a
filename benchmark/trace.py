"""Reading a torch.profiler Chrome trace of a few steps.

The profiled steps are the ranges named ``STEP`` on the host. The span
read runs from the first such range's start to the end of the last device
operation; device operations are kernels, copies and sets, and the time
the device is busy is the union of their intervals over every stream.
"""

from __future__ import annotations

import json

STEP = "benchmark.step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation") + LAUNCH_CATS


def _matches(name: str, family: dict) -> bool:
    return (any(p in name for p in family["patterns"])
            and not any(p in name for p in family.get("exclude", ())))


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class TraceView:
    """The profiled steps of one trace (times in microseconds, as the
    trace has them; the accessors return seconds)."""

    def __init__(self, events: list[dict]):
        steps = sorted((e for e in events if e.get("ph") == "X"
                        and e.get("name") == STEP
                        and e.get("cat") == "user_annotation"),
                       key=lambda e: e["ts"])
        self.steps = len(steps)
        if not steps:
            self.start = self.end = 0.0
            self.device_ops, self.launches, self.host_ops = [], 0, []
            return
        self.start = float(steps[0]["ts"])
        host_end = max(float(e["ts"]) + float(e["dur"]) for e in steps)
        self.device_ops = [e for e in events if e.get("ph") == "X"
                           and e.get("cat") in DEVICE_CATS
                           and float(e["ts"]) >= self.start]
        self.end = max([host_end] + [float(e["ts"]) + float(e["dur"])
                                     for e in self.device_ops])
        self.launches = sum(
            1 for e in events if e.get("ph") == "X"
            and e.get("cat") in LAUNCH_CATS and "LaunchKernel" in e["name"]
            and self.start <= float(e["ts"]) <= host_end)
        tid = steps[0].get("tid")
        self.host_ops = [e for e in events if e.get("ph") == "X"
                         and e.get("cat") in HOST_CATS and e.get("tid") == tid
                         and e.get("name") != STEP
                         and float(e["ts"]) + float(e["dur"]) >= self.start]

    @classmethod
    def from_file(cls, path: str) -> "TraceView":
        with open(path) as f:
            doc = json.load(f)
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        return cls(events)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        return _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in self.device_ops])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernels(self) -> list[dict]:
        return [e for e in self.device_ops if e.get("cat") == "kernel"]

    def family_s(self, family: dict) -> float:
        """Device seconds of the kernels of ``family`` (summed over
        streams)."""
        return sum(float(e["dur"]) for e in self.kernels()
                   if _matches(e["name"], family)) / 1e6

    def family_count(self, family: dict) -> int:
        return sum(1 for e in self.kernels() if _matches(e["name"], family))

    def unclassified(self, families: dict, n: int = 10,
                     width: int = 120) -> list[list]:
        """[name, seconds] of the ``n`` kernels that took most time and
        belong to none of ``families``."""
        total: dict[str, float] = {}
        for e in self.kernels():
            if not any(_matches(e["name"], f) for f in families.values()):
                total[e["name"]] = total.get(e["name"], 0.0) + float(e["dur"])
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:width], v / 1e6] for k, v in top]

    def top_ops(self, n: int = 10, width: int = 120) -> list[list]:
        """[name, seconds] of the ``n`` device operations that took most
        time over the profiled steps, by name."""
        total: dict[str, float] = {}
        for e in self.device_ops:
            total[e["name"]] = total.get(e["name"], 0.0) + float(e["dur"])
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:width], v / 1e6] for k, v in top]

    def idle_gaps(self, n: int = 10, width: int = 120) -> list[list]:
        """[host op, seconds] of the ``n`` longest stretches in which no
        device operation ran, each named by the innermost host operation
        of the stepping thread running at its middle ("host idle" where
        none ran)."""
        busy = self.busy_intervals()
        gaps, t = [], self.start
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) / 2
            running = [e for e in self.host_ops
                       if float(e["ts"]) <= mid <= float(e["ts"])
                       + float(e["dur"])]
            name = (max(running, key=lambda e: float(e["ts"]))["name"]
                    if running else "host idle")
            out.append([name[:width], (b - a) / 1e6])
        return out

