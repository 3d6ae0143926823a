"""The data-parallel train step with MG-WFBP merged all-reduce (counterpart
of the ``all_reduce`` path of ``mgwfbp_tpu/train/step.py``, classify task).

One ``TrainStep`` call is one optimizer step:

  * ``nsteps_update`` micro-steps of forward + backward, gradients summed
    in ``.grad`` and averaged (scaled by 1/n before the reduction, as the
    JAX step scales before its pmean). Only the last micro-step's backward
    carries communication: the reducer's hooks launch each merge group's
    all-reduce as its gradients land; ``synchronize`` waits and unpacks.
    Without a reducer (policy 'none', several workers) each leaf is
    all-reduced on its own after the backward; one worker reduces nothing;
  * the non-finite guard: the reduced gradients' non-finite values are
    counted and, when the count is not zero, the WHOLE pre-step state is
    kept: parameters, momentum buffers and the step counter (the optimizer
    does not run) and the batch-norm running statistics, which torch
    updates in place during the forward and the step therefore restores
    from a snapshot taken before it;
  * the learning rate is set from ``lr_fn(step)`` before every update;
  * batch-norm running statistics and the metrics (mean loss, accuracy,
    non-finite count) are averaged across ranks.

The model's buffers are re-seated as views of one flat tensor, so the
snapshot, the restore and the cross-rank average are one operation each.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from mgwfbp_tpu_torch.optim import clip_by_global_norm_, set_lr
from mgwfbp_tpu_torch.parallel.allreduce import MergedAllreduce
from mgwfbp_tpu_torch.parallel.mesh import world_size


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels, in float32."""
    return F.cross_entropy(logits.float(), labels.long())


def flatten_buffers(module: nn.Module) -> Optional[torch.Tensor]:
    """Re-seat every floating buffer of ``module`` as a view of one flat
    tensor and return it (None when there are none). In-place updates of
    the buffers then land in the flat tensor; ``load_state_dict`` copies
    into the views. Moving the module afterwards (``.to``) would replace
    the views, so call this once the module is on its device."""
    owners = [
        (mod, name, buf)
        for mod in module.modules()
        for name, buf in mod.named_buffers(recurse=False)
        if buf.is_floating_point()
    ]
    if not owners:
        return None
    flat = torch.cat([buf.reshape(-1) for _, _, buf in owners])
    off = 0
    for mod, name, buf in owners:
        mod._buffers[name] = flat[off:off + buf.numel()].view_as(buf)
        off += buf.numel()
    return flat


def nonfinite_count(tensors) -> torch.Tensor:
    """Number of non-finite elements over ``tensors``, as a float32 scalar
    (one concatenation and one count, not a handful of kernels per leaf)."""
    tensors = [t.reshape(-1) for t in tensors]
    if not tensors:
        return torch.zeros(())
    flat = torch.cat(tensors) if len(tensors) > 1 else tensors[0]
    return torch.count_nonzero(~torch.isfinite(flat)).float()


class TrainStep:
    """``step(x, y) -> metrics``: x (n, B, C, H, W) and y (n, B) tensors on
    the model's device, n = ``nsteps_update`` micro-batches."""

    def __init__(
        self,
        model: nn.Module,
        optimizer: torch.optim.Optimizer,
        lr_fn: Callable[[int], float],
        *,
        reducer: Optional[MergedAllreduce] = None,
        nsteps_update: int = 1,
        grad_guard: bool = True,
        norm_clip: Optional[float] = None,
    ):
        self.model = model
        self.optimizer = optimizer
        self.lr_fn = lr_fn
        self.reducer = reducer
        self.nsteps_update = int(nsteps_update)
        self.grad_guard = grad_guard
        self.norm_clip = norm_clip
        self.world = world_size()
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.buffers = flatten_buffers(model)
        self.step = 0  # optimizer updates applied: the schedule's count

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> dict[str, float]:
        n = self.nsteps_update
        if x.shape[0] != n or y.shape[0] != n:
            raise ValueError(
                f"expected {n} micro-batches, got x {tuple(x.shape)}, "
                f"y {tuple(y.shape)}"
            )
        model, reducer = self.model, self.reducer
        model.train()
        snapshot = (
            self.buffers.clone()
            if self.grad_guard and self.buffers is not None else None
        )
        for p in self.params:
            p.grad = None
        loss_sum = torch.zeros((), device=x.device)
        acc_sum = torch.zeros((), device=x.device)
        for i in range(n):
            if reducer is not None:
                reducer.begin(active=i == n - 1, scale=1.0 / n)
            logits = model(x[i])
            loss = cross_entropy(logits, y[i])
            loss.backward()
            with torch.no_grad():
                loss_sum += loss.detach()
                acc_sum += (logits.argmax(-1) == y[i]).float().mean()
        if reducer is not None:
            reduced = reducer.synchronize()
        else:
            grads = [p.grad for p in self.params]
            if n > 1:
                torch._foreach_mul_(grads, 1.0 / n)
            if self.world > 1:
                for g in grads:  # one flat mean per leaf, no hooks
                    dist.all_reduce(g)
                    g.div_(self.world)
            reduced = grads
        metrics = torch.stack([
            loss_sum / n, acc_sum / n,
            nonfinite_count(reduced) if self.grad_guard
            else torch.zeros((), device=x.device),
        ])
        if self.world > 1:
            dist.all_reduce(metrics)
            metrics.div_(self.world)
        loss_v, acc_v, bad = metrics.tolist()
        if bad == 0.0:
            if self.norm_clip is not None:
                clip_by_global_norm_([p.grad for p in self.params],
                                     self.norm_clip)
            set_lr(self.optimizer, self.lr_fn(self.step))
            self.optimizer.step()
            self.step += 1
            if self.world > 1 and self.buffers is not None:
                dist.all_reduce(self.buffers)
                self.buffers.div_(self.world)
        elif snapshot is not None:
            # a skipped step never happened: the forward's running
            # statistics go back too
            self.buffers.copy_(snapshot)
        for p in self.params:
            p.grad = None
        return {"loss": loss_v, "accuracy": acc_v, "grads_nonfinite": bad}


@torch.no_grad()
def eval_sums(model: nn.Module, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[loss, top1, top5, count] summed over one eval batch (the JAX eval
    step's classify sums; every sample counts)."""
    logits = model(x).float()
    y = y.long()
    per = F.cross_entropy(logits, y, reduction="none")
    top1 = (logits.argmax(-1) == y).float()
    k = min(5, logits.shape[-1])
    top5 = (logits.topk(k, dim=-1).indices == y[:, None]).any(-1).float()
    return torch.stack([
        per.sum(), top1.sum(), top5.sum(),
        torch.tensor(float(y.shape[0]), device=logits.device),
    ])
