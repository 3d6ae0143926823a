"""CIFAR ResNets (counterpart of ``mgwfbp_tpu/models/resnet_cifar.py``):
post-activation ``resnet20/32/44/56/110`` and pre-activation
``preresnet20/110`` (registered in ``models``).

conv3x3(widths[0]) -> 3 stages of n blocks at ``widths``, strides (1, 2, 2),
n = (depth - 2) // 6 -> global average pool -> fc. Input NCHW.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mgwfbp_tpu_torch.models.common import (
    BasicBlock,
    BatchNorm,
    ConvBN,
    Dense,
    SameConv2d,
)


class PreActBlock(nn.Module):
    """bn-relu-conv twice; a 1x1 conv shortcut taken after the first
    activation where the shape changes."""

    FLAX_NAMES = {"bn1": "BatchNorm_0", "conv1": "Conv_0",
                  "bn2": "BatchNorm_1", "conv2": "Conv_1"}

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.bn1 = BatchNorm(in_channels)
        self.shortcut: Optional[SameConv2d] = None
        if in_channels != features or stride != 1:
            self.shortcut = SameConv2d(in_channels, features, 1, stride)
        self.conv1 = SameConv2d(in_channels, features, 3, stride)
        self.bn2 = BatchNorm(features)
        self.conv2 = SameConv2d(features, features, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pre = F.relu(self.bn1(x))
        residual = x if self.shortcut is None else self.shortcut(pre)
        y = F.relu(self.bn2(self.conv1(pre)))
        return self.conv2(y) + residual


class CifarResNet(nn.Module):
    """depth = 6n + 2 CIFAR ResNet."""

    def __init__(self, depth: int = 20, num_classes: int = 10,
                 widths: Sequence[int] = (16, 32, 64), preact: bool = False,
                 in_channels: int = 3):
        super().__init__()
        if (depth - 2) % 6 != 0:
            raise ValueError(f"CIFAR ResNet depth must be 6n+2, got {depth}")
        self.depth = depth
        self.num_classes = num_classes
        self.widths = tuple(widths)
        self.preact = preact
        n = (depth - 2) // 6
        if preact:
            self.stem = SameConv2d(in_channels, widths[0], 3)
            self.FLAX_NAMES = {"stem": "Conv_0", "bn": "BatchNorm_0"}
        else:
            self.stem = ConvBN(in_channels, widths[0], 3)
            self.FLAX_NAMES = {"stem": "ConvBN_0"}
        block = PreActBlock if preact else BasicBlock
        blocks = []
        ch = widths[0]
        for stage, width in enumerate(widths):
            for i in range(n):
                blocks.append(block(ch, width, 2 if (stage > 0 and i == 0) else 1))
                ch = width
        self.blocks = nn.ModuleList(blocks)
        self.bn = BatchNorm(ch) if preact else None
        self.fc = Dense(ch, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for block in self.blocks:
            x = block(x)
        if self.bn is not None:
            x = F.relu(self.bn(x))
        return self.fc(x.mean(dim=(2, 3)))

