"""Shared CNN building blocks (counterpart of ``mgwfbp_tpu/models/common.py``).

NCHW ``nn.Module``s that compute what the JAX package's Flax modules
compute, where Flax and PyTorch defaults differ:

  * ``SameConv2d``: Flax ``padding="SAME"`` pads ``(k - 1 + (out - 1) * s
    + k - in)`` in total, the odd pixel AFTER. With stride 2 on an even
    input that is (0, 1), not the (1, 1) of ``nn.Conv2d(padding=1)``,
    which would sample other pixels.
  * ``BatchNorm``: Flax ``momentum=0.9`` is the weight of the OLD running
    statistic (torch's ``momentum=0.1``), epsilon 1e-5, and the running
    variance is updated with the BIASED batch variance (``nn.BatchNorm2d``
    uses the unbiased one, n/(n-1) larger).
  * initializers: He fan-out truncated normal for convs, LeCun truncated
    normal for dense kernels (``init_weights``), from a seeded generator.

Each module records its children's Flax names in ``FLAX_NAMES`` so that
``convert`` maps parameters and batch statistics leaf by leaf.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM = 0.9  # Flax: weight of the old running statistic
BN_EPSILON = 1e-5
# std of a standard normal truncated to [-2, 2] (Flax's variance_scaling
# divides the target std by it)
_TRUNC_STD = 0.87962566103423978


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(before, after) padding of Flax/XLA ``SAME`` along one dimension."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """Bias-free convolution with Flax ``SAME`` padding."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=0, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        ph = same_pads(x.shape[-2], kh, sh)
        pw = same_pads(x.shape[-1], kw, sw)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, self.weight, None, self.stride, (ph[0], pw[0]))
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, self.weight, None, self.stride)


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm`` over the channel dim of NCHW input."""

    def __init__(self, num_features: int, momentum: float = BN_MOMENTUM,
                 epsilon: float = BN_EPSILON):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight,
                self.bias, False, 0.0, self.epsilon,
            )
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            m = self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        # the output normalizes by the batch statistics; no running buffers
        # are passed, so torch updates nothing behind the update above
        return F.batch_norm(
            x, None, None, self.weight, self.bias, True, 0.0, self.epsilon
        )


class ConvBN(nn.Module):
    """Conv (``SAME``, no bias) + BatchNorm (+ ReLU)."""

    FLAX_NAMES = {"conv": "Conv_0", "bn": "BatchNorm_0"}

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 1, use_relu: bool = True):
        super().__init__()
        self.conv = SameConv2d(in_channels, features, kernel, stride)
        self.bn = BatchNorm(features)
        self.use_relu = use_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x) if self.use_relu else x


class BasicBlock(nn.Module):
    """Post-activation residual block: conv-bn-relu, conv-bn, add, relu,
    with a 1x1 ConvBN shortcut where the shape changes."""

    FLAX_NAMES = {"conv1": "ConvBN_0", "conv2": "ConvBN_1"}

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = ConvBN(in_channels, features, 3, stride)
        self.conv2 = ConvBN(features, features, 3, 1, use_relu=False)
        self.shortcut: Optional[ConvBN] = None
        if in_channels != features or stride != 1:
            self.shortcut = ConvBN(in_channels, features, 1, stride,
                                   use_relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        residual = x if self.shortcut is None else self.shortcut(x)
        return F.relu(y + residual)


@torch.no_grad()
def init_weights(module: nn.Module,
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """Flax's initializers from a seeded generator: convs
    ``variance_scaling(2, fan_out, truncated_normal)``, dense kernels
    LeCun truncated normal, biases zero, BatchNorm scale one and bias zero,
    running mean zero and variance one."""
    for sub in module.modules():
        if isinstance(sub, nn.Conv2d):
            o, _, kh, kw = sub.weight.shape
            std = math.sqrt(2.0 / (kh * kw * o)) / _TRUNC_STD
            nn.init.trunc_normal_(sub.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if sub.bias is not None:
                sub.bias.zero_()
        elif isinstance(sub, nn.Linear):
            std = math.sqrt(1.0 / sub.in_features) / _TRUNC_STD
            nn.init.trunc_normal_(sub.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            sub.bias.zero_()
        elif isinstance(sub, BatchNorm):
            sub.weight.fill_(1.0)
            sub.bias.zero_()
            sub.running_mean.zero_()
            sub.running_var.fill_(1.0)
    return module
