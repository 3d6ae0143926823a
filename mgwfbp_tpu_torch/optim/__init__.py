"""SGD with momentum and decay/no-decay parameter groups (counterpart of
``mgwfbp_tpu/optim/__init__.py``).

``make_optimizer`` builds ``torch.optim.SGD`` with two parameter groups:
weight decay applies to parameters with ``ndim > 1`` only (conv and dense
kernels; batch-norm scales and biases are excluded), coupled to the
gradient before the momentum trace, which is how both ``torch.optim.SGD``
and the JAX package's optax chain apply it. The learning rate is a
``step -> lr`` function the train step evaluates before every update.

``clip_by_global_norm_`` follows ``optax.clip_by_global_norm`` (scale by
``max_norm / norm`` when the norm is at least ``max_norm``), not
``torch.nn.utils.clip_grad_norm_``, which adds 1e-6 to the norm.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

from mgwfbp_tpu_torch.optim import schedules
from mgwfbp_tpu_torch.optim.schedules import as_step_fn, resolve


def scaled_clip_threshold(max_norm: float, world_size: int = 1) -> float:
    """The distributed clip threshold: ``max_norm`` scaled by sqrt(1/P)
    (worker-averaged gradients carry about sqrt(1/P) of the noise norm)."""
    if world_size > 1:
        return math.sqrt(1.0 / world_size) * max_norm
    return float(max_norm)


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> None:
    """In-place ``optax.clip_by_global_norm(max_norm)`` over ``grads``."""
    if not grads:
        return
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    base_lr: float,
    *,
    momentum: float = 0.9,
    weight_decay: float = 1e-4,
    lr_schedule: str = "auto",
    dataset: str = "cifar10",
    max_epochs: int = 141,
    warmup_epochs: int = 5,
    num_batches_per_epoch: int = 1,
) -> tuple[torch.optim.SGD, Callable[[int], float], Callable[[float], float]]:
    """(optimizer, step -> lr, epoch -> lr) for ``params``."""
    epoch_schedule = resolve(
        lr_schedule, base_lr, dataset=dataset, max_epochs=max_epochs,
        warmup_epochs=warmup_epochs,
    )
    step_fn = as_step_fn(epoch_schedule, num_batches_per_epoch)
    params = list(params)
    groups = [
        {"params": [p for p in params if p.ndim > 1],
         "weight_decay": weight_decay},
        {"params": [p for p in params if p.ndim <= 1], "weight_decay": 0.0},
    ]
    opt = torch.optim.SGD(
        [g for g in groups if g["params"]], lr=step_fn(0), momentum=momentum,
    )
    return opt, step_fn, epoch_schedule


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


__all__ = [
    "as_step_fn",
    "clip_by_global_norm_",
    "make_optimizer",
    "resolve",
    "scaled_clip_threshold",
    "schedules",
    "set_lr",
]
