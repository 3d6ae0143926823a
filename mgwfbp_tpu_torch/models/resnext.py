"""ResNeXt-29 for CIFAR (counterpart of ``mgwfbp_tpu/models/resnext.py``):
ConvBN 64 stem, three stages of three aggregated bottlenecks at widths
256 / 512 / 1024 (the first block of stages 1-2 at stride 2), global
average pool, fc. Input NCHW; the 3x3 conv of each block is grouped
(cardinality 8), whose kernel (O, I / 8, 3, 3) converts by the same rule as
any conv.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mgwfbp_tpu_torch.models.common import ConvBN, global_avg_pool


class ResNeXtBlock(nn.Module):
    """1x1 reduce -> 3x3 grouped (strided) -> 1x1 expand, a 1x1 ConvBN
    shortcut where the shape changes; relu after the add. The grouped width
    is ``cardinality * int(base_width * features / 256)``."""

    FLAX_NAMES = {"conv1": "ConvBN_0", "conv2": "ConvBN_1", "conv3": "ConvBN_2"}

    def __init__(self, in_channels: int, features: int, cardinality: int = 8,
                 base_width: int = 64, stride: int = 1):
        super().__init__()
        d = cardinality * int(base_width * features / 256)
        self.conv1 = ConvBN(in_channels, d, 1)
        self.conv2 = ConvBN(d, d, 3, stride, groups=cardinality)
        self.conv3 = ConvBN(d, features, 1, use_relu=False)
        self.shortcut: Optional[ConvBN] = None
        if in_channels != features or stride != 1:
            self.shortcut = ConvBN(in_channels, features, 1, stride,
                                   use_relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv3(self.conv2(self.conv1(x)))
        residual = x if self.shortcut is None else self.shortcut(x)
        return F.relu(y + residual)


class ResNeXt29(nn.Module):
    FLAX_NAMES = {"stem": "ConvBN_0"}

    def __init__(self, num_classes: int = 10, cardinality: int = 8,
                 base_width: int = 64, widths: Sequence[int] = (256, 512, 1024),
                 in_channels: int = 3):
        super().__init__()
        self.stem = ConvBN(in_channels, 64, 3)
        blocks, ch = [], 64
        for stage, width in enumerate(widths):
            for i in range(3):
                stride = 2 if (stage > 0 and i == 0) else 1
                blocks.append(ResNeXtBlock(ch, width, cardinality, base_width,
                                           stride))
                ch = width
        self.blocks = nn.ModuleList(blocks)
        self.fc = nn.Linear(ch, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for block in self.blocks:
            x = block(x)
        return self.fc(global_avg_pool(x))
