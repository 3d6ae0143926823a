"""SGD with momentum and decay/no-decay parameter groups (counterpart of
``mgwfbp_tpu/optim/__init__.py``).

``make_optimizer`` builds ``torch.optim.SGD`` with two parameter groups:
weight decay applies to parameters with ``ndim > 1`` only (conv and dense
kernels; batch-norm scales and biases are excluded), coupled to the
gradient before the momentum trace, which is how both ``torch.optim.SGD``
and the JAX package's optax chain apply it. The learning rate is a
``step -> lr`` function the train step evaluates before every update.

``OptimSpec`` is the transparent twin of that optimizer: the same fields
(SGD with momentum, Nesterov and coupled decay, or Adam/AdamW, the
``ndim > 1`` decay mask, the norm clip already scaled to the world, the
``count -> lr`` function) that ``parallel.allreduce.ShardedOptimStep``
re-runs on the flat 1/world bucket shards of the ``rs_opt_ag`` lowering.
``make_optimizer(..., return_spec=True)`` builds it from the same locals
as the ``torch.optim.SGD``, so the two cannot drift.

``clip_by_global_norm_`` follows ``optax.clip_by_global_norm`` (scale by
``max_norm / norm`` when the norm is at least ``max_norm``), not
``torch.nn.utils.clip_grad_norm_``, which adds 1e-6 to the norm.

Checkpoints hold the optimizer as the JAX package's optax tree
(``mgwfbp_tpu/optim/__init__.py``: ``sgd()`` is a chain of the masked
``add_decayed_weights``, ``trace`` and ``scale_by_learning_rate``, behind
``clip_by_global_norm`` when a norm clip is set). ``sgd_state_layout``
names that tree's leaves in optax's flatten order: one ``trace`` leaf per
parameter (torch's ``momentum_buffer``, in Flax layout;
``convert.momentum_to_flax``) and the schedule's ``count`` (the updates
applied, ``TrainStep.step``). Weight decay and the clip hold no state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional, Union

import torch

from mgwfbp_tpu_torch.optim import schedules
from mgwfbp_tpu_torch.optim.schedules import as_step_fn, resolve


@dataclasses.dataclass(frozen=True)
class OptimSpec:
    """An elementwise optimizer chain, field for field the JAX package's
    ``OptimSpec``:

      * kind 'sgd': optional coupled weight decay (added to the gradient
        before the momentum trace), the momentum trace (optionally
        Nesterov), the learning rate;
      * kind 'adam': Adam's moments with bias correction by count and,
        with ``decoupled_wd``, decay added after the preconditioner
        (AdamW);
      * ``mask_ndim_gt1``: weight decay only on parameters with ndim > 1;
      * ``norm_clip``: the global-norm clip threshold, already scaled by
        sqrt(1/P) when distributed (``scaled_clip_threshold``);
      * ``lr``: a float or a ``count -> lr`` function, ``count`` being the
        optimizer updates completed before this one."""

    lr: Union[float, Callable[[int], float]]
    kind: str = "sgd"  # sgd | adam
    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0
    decoupled_wd: bool = False  # adamw: decay after the preconditioner
    mask_ndim_gt1: bool = True
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    norm_clip: Optional[float] = None

    def __post_init__(self):
        if self.kind not in ("sgd", "adam"):
            raise ValueError(f"unknown OptimSpec.kind {self.kind!r}")
        if self.kind == "sgd" and self.decoupled_wd:
            raise ValueError("decoupled weight decay requires kind='adam'")

    def learning_rate(self, count: int) -> float:
        """The learning rate of the update after ``count`` completed ones."""
        return self.lr(count) if callable(self.lr) else self.lr

    @property
    def num_slots(self) -> int:
        """Parameter-shaped state buffers: the momentum trace (sgd with
        momentum), the first and second moments (adam)."""
        if self.kind == "adam":
            return 2
        return 1 if self.momentum else 0


def sgd_state_layout(
    param_paths: list[str], *, momentum: float, weight_decay: float,
    norm_clip: Optional[float] = None,
) -> tuple[list[str], str]:
    """(the ``trace`` leaf's ``keystr`` path for each dotted Flax parameter
    path, empty without momentum; the ``count`` leaf's path) of the optax
    tree the JAX package's ``make_optimizer`` builds for these settings."""
    prefix = "[1]" if norm_clip is not None else ""
    i = 1 if weight_decay else 0
    trace = []
    if momentum:
        trace = [
            f"{prefix}[{i}].trace" + "".join(f"['{k}']" for k in p.split("."))
            for p in param_paths
        ]
        i += 1
    return trace, f"{prefix}[{i}].count"


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
    step_offset: int = 0,
    epoch_offset: float = 0.0,
    norm_clip: Optional[float] = None,
    world_size: int = 1,
    return_spec: bool = False,
):
    """(optimizer, step -> lr, epoch -> lr) for ``params``, and with
    ``return_spec`` the ``OptimSpec`` of the same optimizer appended.
    ``step_offset`` and ``epoch_offset`` anchor the step -> epoch
    conversion, so that a resumed run continues its schedule
    (``as_step_fn``). ``norm_clip`` is the unscaled clip threshold; the
    spec holds it scaled to ``world_size`` (the step clips, not the
    ``torch.optim.SGD``)."""
    epoch_schedule = resolve(
        lr_schedule, base_lr, dataset=dataset, max_epochs=max_epochs,
        warmup_epochs=warmup_epochs,
    )
    step_fn = as_step_fn(epoch_schedule, num_batches_per_epoch,
                         step_offset=step_offset, epoch_offset=epoch_offset)
    params = list(params)
    groups = [
        {"params": [p for p in params if p.ndim > 1],
         "weight_decay": weight_decay},
        {"params": [p for p in params if p.ndim <= 1], "weight_decay": 0.0},
    ]
    opt = torch.optim.SGD(
        [g for g in groups if g["params"]], lr=step_fn(0), momentum=momentum,
    )
    if not return_spec:
        return opt, step_fn, epoch_schedule
    spec = OptimSpec(
        lr=step_fn, kind="sgd", momentum=momentum, weight_decay=weight_decay,
        norm_clip=(scaled_clip_threshold(norm_clip, world_size)
                   if norm_clip is not None else None),
    )
    return opt, step_fn, epoch_schedule, spec


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


@torch.no_grad()
def sgd_update_(optimizer: torch.optim.Optimizer, lr: torch.Tensor,
                ok: Optional[torch.Tensor] = None) -> None:
    """``optimizer.step()`` of a ``torch.optim.SGD`` from its parameters'
    ``.grad``, with the learning rate a 0-dim tensor on the parameters'
    device (each group's own ``lr`` is not read) and no host read: the
    train step's update, which must not wait for the device. Every term
    is torch's (``_multi_tensor_sgd``: the coupled decay, the momentum
    trace, Nesterov, dampening) and rounds as torch's does: the last,
    ``p + (-lr) * u``, is ``addcmul`` by the 0-dim rate, which rounds as
    ``add(u, alpha=-lr)`` does (one rounding where the kernel fuses the
    product), one launch per parameter.

    ``ok`` (a 0-dim bool tensor) makes a bad step an exact no-op on the
    device: the decay term and the learning rate are multiplied by it and
    the momentum becomes 1, so parameters and momentum buffers keep their
    values. That needs every term finite, so the caller zeroes the
    gradients of a bad step first (``torch.where`` over its flat buckets).
    A parameter without a momentum buffer gets a zero one, which the first
    update turns into the gradient, as torch's ``clone`` does."""
    if not isinstance(optimizer, torch.optim.SGD):
        raise TypeError(
            "the train step runs SGD's update on the device; got "
            f"{type(optimizer).__name__}")
    lr_eff = lr if ok is None else lr * ok
    for group in optimizer.param_groups:
        params = [p for p in group["params"] if p.grad is not None]
        wd, mom = group["weight_decay"], group["momentum"]
        for dtype in dict.fromkeys(p.dtype for p in params):
            ps = [p for p in params if p.dtype == dtype]
            gs = [p.grad for p in ps]
            if group.get("maximize", False):
                gs = torch._foreach_neg(gs)
            if wd:
                gs = torch._foreach_add(gs, ps, alpha=wd)
                if ok is not None:  # the decay term of a bad step
                    torch._foreach_mul_(gs, ok.to(dtype))
            if mom:
                bufs = []
                for p in ps:
                    st = optimizer.state[p]
                    if st.get("momentum_buffer") is None:
                        st["momentum_buffer"] = torch.zeros_like(p)
                    bufs.append(st["momentum_buffer"])
                if ok is None:
                    torch._foreach_mul_(bufs, mom)
                else:
                    keep = torch.full((), mom, dtype=dtype, device=ok.device)
                    torch._foreach_mul_(bufs, keep.masked_fill_(~ok, 1.0))
                torch._foreach_add_(bufs, gs, alpha=1 - group["dampening"])
                gs = (torch._foreach_add(gs, bufs, alpha=mom)
                      if group["nesterov"] else bufs)
            neg = -lr_eff.to(dtype)
            torch._foreach_addcmul_(ps, gs, [neg.expand_as(p) for p in ps])


__all__ = [
    "OptimSpec",
    "as_step_fn",
    "clip_by_global_norm_",
    "make_optimizer",
    "resolve",
    "scaled_clip_threshold",
    "schedules",
    "set_lr",
    "sgd_state_layout",
    "sgd_update_",
]
