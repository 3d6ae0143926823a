"""Faults planted in the program's timed path, to show that the check
fails them (the harness's own tests and ``calibrate``; no benchmark run
plants one):

  * ``unchanged``: the step leaves its state as it was (SGD's update is
    skipped);
  * ``half_batch``: half of each batch is left out and the mean taken over
    the rest;
  * ``no_exchange``: the merged all-reduce is left out, each rank keeps
    its own gradient (a multi-rank cell's fault).
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half_batch", "no_exchange")


class _Done:
    """A collective's handle that is already complete."""

    def wait(self) -> bool:
        return True


@contextlib.contextmanager
def plant(name: str, trainer):
    from mgwfbp_tpu_torch.parallel import allreduce
    from mgwfbp_tpu_torch.train import step

    if name == "unchanged":
        original = step.sgd_update_
        step.sgd_update_ = lambda optimizer, lr, ok=None: None
        try:
            yield
        finally:
            step.sgd_update_ = original
    elif name == "half_batch":
        original = trainer.step_batch

        def half(x: torch.Tensor, y: torch.Tensor):
            h = x.shape[1] // 2
            return original(x[:, :h], y[:, :h])

        trainer.step_batch = half
        try:
            yield
        finally:
            del trainer.step_batch
    elif name == "no_exchange":
        cls = allreduce.MergedAllreduce
        original = cls._launch_all_reduce

        def local(self, gi: int, buf: torch.Tensor) -> None:
            buf.mul_(self.world)  # the later mean then gives the local one
            self._inflight.append(allreduce._Inflight(gi, [_Done()], buf))
            self.launches += 1

        cls._launch_all_reduce = local
        try:
            yield
        finally:
            cls._launch_all_reduce = original
    else:
        raise ValueError(f"fault {name!r}: one of {FAULTS}")
