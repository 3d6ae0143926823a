"""Learning-rate schedules (counterpart of ``mgwfbp_tpu/optim/schedules.py``).

Every schedule is a plain ``epoch -> lr`` function of a float epoch (so a
warmup can move within an epoch); ``as_step_fn`` turns one into the
``step -> lr`` function the trainer evaluates once per optimizer step. The
formulas are the JAX package's, evaluated in Python floats.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

EpochSchedule = Callable[[float], float]

CIFAR_MILESTONES = (81, 122, 155)
IMAGENET_MILESTONES = (30, 60, 80)


def _clip01(x: float) -> float:
    return min(max(x, 0.0), 1.0)


def constant(lr: float) -> EpochSchedule:
    return lambda epoch: float(lr)


def warmup_step(
    base_lr: float,
    milestones: Sequence[int] = CIFAR_MILESTONES,
    gamma: float = 0.1,
    warmup_epochs: int = 5,
    warmup_init_scale: float = 0.1,
) -> EpochSchedule:
    """Linear warmup from ``warmup_init_scale * base_lr``, then a factor of
    ``gamma`` at each milestone."""

    def fn(epoch: float) -> float:
        epoch = float(epoch)
        if warmup_epochs <= 0:
            warm = 1.0
        else:
            frac = _clip01(epoch / max(warmup_epochs, 1e-8))
            warm = warmup_init_scale + (1.0 - warmup_init_scale) * frac
        factor = 1.0
        for m in milestones:
            if epoch >= m:
                factor *= gamma
        return base_lr * warm * factor

    return fn


def vgg_halving(base_lr: float, every: int = 25) -> EpochSchedule:
    return lambda epoch: base_lr * 0.5 ** math.floor(float(epoch) / every)


def ptb_staircase(base_lr: float) -> EpochSchedule:
    """Base LR until epoch 63, x0.01 until 80, then x0.001."""

    def fn(epoch: float) -> float:
        epoch = float(epoch)
        return base_lr * (1.0 if epoch < 63 else 0.01 if epoch < 80 else 0.001)

    return fn


def anneal(base_lr: float, factor: float = 1.01) -> EpochSchedule:
    return lambda epoch: base_lr * (1.0 / factor) ** math.floor(float(epoch))


def cosine_warmup(
    base_lr: float, total_epochs: int, warmup_epochs: int = 5,
    min_lr: float = 0.0,
) -> EpochSchedule:
    def fn(epoch: float) -> float:
        epoch = float(epoch)
        if epoch < warmup_epochs:
            return base_lr * _clip01(epoch / max(warmup_epochs, 1e-8))
        t = _clip01(
            (epoch - warmup_epochs) / max(total_epochs - warmup_epochs, 1e-8)
        )
        return min_lr + 0.5 * (base_lr - min_lr) * (1.0 + math.cos(math.pi * t))

    return fn


def resolve(
    name: str,
    base_lr: float,
    dataset: str = "cifar10",
    max_epochs: int = 141,
    warmup_epochs: int = 5,
) -> EpochSchedule:
    """Schedule by name, as the JAX package dispatches it."""
    name = (name or "auto").lower()
    if name in ("auto", "step"):
        milestones = (
            IMAGENET_MILESTONES if dataset == "imagenet" else CIFAR_MILESTONES
        )
        return warmup_step(base_lr, milestones, warmup_epochs=warmup_epochs)
    if name == "cosine":
        return cosine_warmup(base_lr, max_epochs, warmup_epochs)
    if name == "ptb":
        return ptb_staircase(base_lr)
    if name == "anneal":
        return anneal(base_lr)
    if name == "vgg":
        return vgg_halving(base_lr)
    if name == "const":
        return constant(base_lr)
    raise ValueError(f"unknown lr schedule {name!r}")


def as_step_fn(
    schedule: EpochSchedule,
    num_batches_per_epoch: int,
    step_offset: int = 0,
    epoch_offset: float = 0.0,
) -> Callable[[int], float]:
    """``step -> lr``: the optimizer step converted to a float epoch."""

    def fn(step: int) -> float:
        epoch = epoch_offset + (float(step) - step_offset) / max(
            num_batches_per_epoch, 1
        )
        return schedule(epoch)

    return fn
