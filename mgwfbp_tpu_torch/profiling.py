"""Layer-wise backward benchmark (counterpart of the ``benchmark_backward``
part of ``mgwfbp_tpu/profiling.py``).

The merge solver's input ``tb``: seconds of backward compute attributed to
each gradient, in arrival order. The original reference timestamps each
gradient from an autograd hook; so does this module: a post-accumulate-grad
hook on every parameter marks when its gradient lands (a CUDA event on the
card, the host clock on the CPU), and each leaf is charged the time since
the previous mark (the first since the backward began). The JAX package
attributes a profiler trace instead, which XLA's fused program needs.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn


class TbProfile(list):
    """Arrival-ordered per-leaf backward seconds plus ``source``: 'hooks'
    (measured per leaf) or 'volume-prior' (a measured total split by
    parameter volume, used only when the hooks measure nothing)."""

    def __init__(self, values, source: str = "volume-prior"):
        super().__init__(float(v) for v in values)
        self.source = source


def backward_cost_weights(
    params: Sequence[torch.Tensor], perm: Sequence[int]
) -> np.ndarray:
    """Per-leaf parameter volume in arrival order, normalized to sum 1."""
    w = np.asarray([float(max(params[j].numel(), 1)) for j in perm])
    return w / max(w.sum(), 1e-12)


def benchmark_backward(
    module: nn.Module,
    loss_of: Callable[[], torch.Tensor],
    params: Sequence[torch.Tensor],
    perm: Sequence[int],
    warmup: int = 2,
    iters: int = 10,
) -> TbProfile:
    """``tb`` in arrival order (``perm[k]`` is the leaf at position k),
    averaged over ``iters`` backward passes after ``warmup``. ``loss_of()``
    runs one forward and returns the scalar loss. The module's buffers
    (batch-norm running statistics) and gradients are left as they were."""
    cuda = params[0].device.type == "cuda"
    saved = [b.detach().clone() for b in module.buffers()]
    stamps: list = []

    def mark():
        if not cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def seconds(a, b) -> float:
        return a.elapsed_time(b) * 1e-3 if cuda else b - a

    handles = [
        p.register_post_accumulate_grad_hook(
            lambda _p, j=j: stamps.append((j, mark()))
        )
        for j, p in enumerate(params)
    ]
    per_leaf = np.zeros(len(params))
    totals = []
    try:
        for it in range(warmup + iters):
            for p in params:
                p.grad = None
            loss = loss_of()
            stamps.clear()
            t0 = time.perf_counter()
            start = mark()
            loss.backward()
            if cuda:
                torch.cuda.synchronize()
            totals.append(time.perf_counter() - t0)
            if it < warmup:
                continue
            prev = start
            for j, m in stamps:
                per_leaf[j] += seconds(prev, m)
                prev = m
    finally:
        for h in handles:
            h.remove()
        for p in params:
            p.grad = None
        with torch.no_grad():
            for b, s in zip(module.buffers(), saved):
                b.copy_(s)
    per_leaf /= max(iters, 1)
    if per_leaf.sum() > 0:
        return TbProfile((per_leaf[j] for j in perm), source="hooks")
    total = float(np.mean(totals[warmup:] or totals))
    weights = backward_cost_weights(params, perm)
    return TbProfile((total * w for w in weights), source="volume-prior")
