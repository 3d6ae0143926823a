"""A plain ImageNet ResNet in float32, the yardstick the program's training
step is held against.

Written from He et al., "Deep Residual Learning for Image Recognition"
(arXiv:1512.03385, Table 1: the 7x7/2 stem, the 3x3/2 max pool, bottleneck
stages of [3, 4, 6, 3] or [3, 8, 36, 3] blocks at widths 64-512 with 4x
expansion, the global average pool and the 1000-way classifier) and the
layout of torchvision's ``resnet50``/``resnet152`` (batch norm after every
convolution, a 1x1 projection shortcut where the shape changes, the
stride on the 3x3 convolution). Departures, each stated by the
configuration file: ``SAME`` padding (the odd pixel after, where torchvision
pads symmetrically) and the classifier's bias.

Plain torch operations only, on parameters passed in as a dict keyed by
``benchmark.work.resnet.params`` names. It imports nothing of the program
under test. Batch norm normalises by the batch's own statistics (training
mode); running statistics do not enter a training step's result.

``quant="fp8"`` is the control: every convolution's and the classifier's
operands rounded to float8 e4m3 in the forward and their output gradients
to e5m2 in the backward, each with a per-tensor scale from its largest
magnitude (the usual fp8 training recipe), the step below bfloat16 that a
change might take. ``quant="bf16"`` rounds the same operands and
gradients to bfloat16: the program's own precision, a witness of what
rounding alone moves.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round_fp8(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = top / t.detach().abs().amax().clamp_min(1e-30)
    return (t * scale).to(dtype).to(t.dtype) / scale


class _FP8(torch.autograd.Function):
    """e4m3 in the forward; the incoming gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, t):
        return _round_fp8(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, E5M2_MAX)


class _BF16(torch.autograd.Function):
    """bfloat16 rounding in the forward and of the incoming gradient."""

    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def _q(t: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    if quant is None:
        return t
    if quant == "fp8":
        return _FP8.apply(t)
    if quant == "bf16":
        return _BF16.apply(t)
    raise ValueError(f"quant {quant!r}: None, 'bf16' or 'fp8'")


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(before, after) of ``SAME`` padding along one dimension."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, stride: int,
         quant: Optional[str] = None) -> torch.Tensor:
    k = w.shape[-1]
    top, bottom = same_pads(x.shape[-2], k, stride)
    left, right = same_pads(x.shape[-1], k, stride)
    x = F.pad(x, (left, right, top, bottom))
    return _q(F.conv2d(_q(x, quant), _q(w, quant), None, stride), quant)


def conv_bn(p: dict, name: str, x: torch.Tensor, stride: int, relu: bool,
            eps: float, quant: Optional[str]) -> torch.Tensor:
    y = conv(x, p[f"{name}.conv.weight"], stride, quant)
    y = F.batch_norm(y, None, None, p[f"{name}.bn.weight"],
                     p[f"{name}.bn.bias"], True, 0.0, eps)
    return F.relu(y) if relu else y


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    top, bottom = same_pads(x.shape[-2], 3, 2)
    left, right = same_pads(x.shape[-1], 3, 2)
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


def forward(config: dict, p: dict, x: torch.Tensor,
            quant: Optional[str] = None) -> torch.Tensor:
    """Logits (N, classes) of images x (N, C, H, W)."""
    eps = float(config["bn_epsilon"])
    x = max_pool_same(conv_bn(p, "stem", x, 2, True, eps, quant))
    expansion = int(config["expansion"])
    ch, i = int(config["stem_width"]), 0
    for stage, (n, width) in enumerate(zip(config["stage_sizes"],
                                           config["widths"])):
        for j in range(n):
            stride = 2 if (stage > 0 and j == 0) else 1
            out = width * expansion
            b = f"blocks.{i}"
            y = conv_bn(p, f"{b}.conv1", x, 1, True, eps, quant)
            y = conv_bn(p, f"{b}.conv2", y, stride, True, eps, quant)
            y = conv_bn(p, f"{b}.conv3", y, 1, False, eps, quant)
            if ch != out or stride != 1:
                x = conv_bn(p, f"{b}.shortcut", x, stride, False, eps, quant)
            x = F.relu(y + x)
            ch, i = out, i + 1
    pooled = x.mean(dim=(2, 3))
    logits = F.linear(_q(pooled, quant), _q(p["fc.weight"], quant),
                      p["fc.bias"])
    return logits


def loss_and_grads(config: dict, p: dict, x: torch.Tensor, y: torch.Tensor,
                   quant: Optional[str] = None) -> tuple[torch.Tensor, dict]:
    """Mean softmax cross-entropy of one batch and its gradient for every
    leaf of ``p``."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    loss = F.cross_entropy(forward(config, leaves, x, quant), y)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


@torch.no_grad()
def sgd_step(p: dict, bufs: dict, grads: dict, optimizer: dict) -> None:
    """SGD with momentum and coupled weight decay, in place:
    d = g + wd * p (decay on leaves of rank 2 and more), buf = momentum *
    buf + d (buf = d on the first step), p = p - lr * buf."""
    lr, mom = float(optimizer["lr"]), float(optimizer["momentum"])
    wd = float(optimizer["weight_decay"])
    for k, g in grads.items():
        d = g + wd * p[k] if p[k].dim() > 1 else g.clone()
        bufs[k] = d if k not in bufs else bufs[k].mul_(mom).add_(d)
        p[k].sub_(lr * bufs[k])
