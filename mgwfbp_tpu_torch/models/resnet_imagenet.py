"""ImageNet ResNets 18/34/50/101/152 (counterpart of
``mgwfbp_tpu/models/resnet_imagenet.py``; registered in ``models``).

7x7/2 ConvBN stem (Flax ``SAME``: (2, 3) at 224) -> max pool 3x3/2
(``SAME``: (0, 1) at 112) -> four stages of blocks at widths 64 * 2^s, the
first block of stages 1-3 at stride 2 -> global average pool -> fc. Input
NCHW. Blocks are numbered across stages, as Flax auto-names them
(``Bottleneck_0`` .. ``Bottleneck_15`` for ResNet-50).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mgwfbp_tpu_torch.models.common import (
    BasicBlock,
    ConvBN,
    Dense,
    global_avg_pool,
    max_pool,
)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 at 4x the width, with a 1x1 ConvBN
    shortcut where the shape changes; relu after the add."""

    FLAX_NAMES = {"conv1": "ConvBN_0", "conv2": "ConvBN_1", "conv3": "ConvBN_2"}
    expansion = 4

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        out = features * self.expansion
        self.conv1 = ConvBN(in_channels, features, 1)
        self.conv2 = ConvBN(features, features, 3, stride)
        self.conv3 = ConvBN(features, out, 1, use_relu=False)
        self.shortcut: Optional[ConvBN] = None
        if in_channels != out or stride != 1:
            self.shortcut = ConvBN(in_channels, out, 1, stride, use_relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv3(self.conv2(self.conv1(x)))
        residual = x if self.shortcut is None else self.shortcut(x)
        return F.relu(y + residual)


_CONFIGS = {
    18: ((2, 2, 2, 2), BasicBlock),
    34: ((3, 4, 6, 3), BasicBlock),
    50: ((3, 4, 6, 3), Bottleneck),
    101: ((3, 4, 23, 3), Bottleneck),
    152: ((3, 8, 36, 3), Bottleneck),
}


class ResNet(nn.Module):
    """The standard ImageNet ResNet."""

    FLAX_NAMES = {"stem": "ConvBN_0"}

    def __init__(self, stage_sizes: Sequence[int], block: type,
                 num_classes: int = 1000, in_channels: int = 3):
        super().__init__()
        self.stem = ConvBN(in_channels, 64, 7, 2)
        expansion = getattr(block, "expansion", 1)
        blocks = []
        ch = 64
        for stage, n in enumerate(stage_sizes):
            width = 64 * 2 ** stage
            for i in range(n):
                blocks.append(block(ch, width, 2 if (stage > 0 and i == 0) else 1))
                ch = width * expansion
        self.blocks = nn.ModuleList(blocks)
        self.fc = Dense(ch, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool(self.stem(x), 3, 2)
        for block in self.blocks:
            x = block(x)
        return self.fc(global_avg_pool(x))


def imagenet_resnet(depth: int, num_classes: int = 1000,
                    in_channels: int = 3) -> ResNet:
    if depth not in _CONFIGS:
        raise ValueError(f"unsupported ImageNet ResNet depth {depth}")
    sizes, block = _CONFIGS[depth]
    return ResNet(sizes, block, num_classes=num_classes,
                  in_channels=in_channels)
