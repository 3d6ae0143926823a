"""DenseNets (counterpart of ``mgwfbp_tpu/models/densenet.py``):
DenseNet-BC 100-12 for CIFAR (``densenet``) and DenseNet-121/161/201 for
ImageNet. Input NCHW.

Layers are pre-activation bottlenecks, BN-ReLU-Conv1x1(4k)-BN-ReLU-
Conv3x3(k), whose output is concatenated to their input; between blocks a
transition BN-ReLU-Conv1x1 halves the channels and a 2x2 average pool the
map. The ImageNet stem is a 7x7/2 conv (Flax ``SAME``: (2, 3) at 224), BN,
ReLU and a ``SAME`` 3x3/2 max pool; the CIFAR stem one 3x3 conv. Every
conv is bias-free with He fan-out init. Layers and transitions sit in one
list, so their Flax names count per type (``DenseLayer_0..``,
``Transition_0..``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mgwfbp_tpu_torch.models.common import (
    BatchNorm,
    SameConv2d,
    avg_pool,
    global_avg_pool,
    max_pool,
)


class DenseLayer(nn.Module):
    """BN-ReLU-Conv1x1(4k) -> BN-ReLU-Conv3x3(k), concatenated after x."""

    FLAX_NAMES = {"bn1": "BatchNorm_0", "conv1": "Conv_0",
                  "bn2": "BatchNorm_1", "conv2": "Conv_1"}

    def __init__(self, in_channels: int, growth_rate: int):
        super().__init__()
        self.bn1 = BatchNorm(in_channels)
        self.conv1 = SameConv2d(in_channels, 4 * growth_rate, 1)
        self.bn2 = BatchNorm(4 * growth_rate)
        self.conv2 = SameConv2d(4 * growth_rate, growth_rate, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.relu(self.bn1(x)))
        y = self.conv2(F.relu(self.bn2(y)))
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    """BN-ReLU-Conv1x1(features) + 2x2 average pool."""

    FLAX_NAMES = {"bn": "BatchNorm_0", "conv": "Conv_0"}

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.bn = BatchNorm(in_channels)
        self.conv = SameConv2d(in_channels, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool(self.conv(F.relu(self.bn(x))), 2)


class DenseNet(nn.Module):
    def __init__(self, block_config: Sequence[int], growth_rate: int = 32,
                 num_init_features: int = 64, compression: float = 0.5,
                 num_classes: int = 1000, imagenet_stem: bool = True,
                 in_channels: int = 3):
        super().__init__()
        self.imagenet_stem = imagenet_stem
        if imagenet_stem:
            self.stem = SameConv2d(in_channels, num_init_features, 7, 2)
            self.stem_bn = BatchNorm(num_init_features)
            self.FLAX_NAMES = {"stem": "Conv_0", "stem_bn": "BatchNorm_0",
                               "bn": "BatchNorm_1"}
        else:
            self.stem = SameConv2d(in_channels, num_init_features, 3)
            self.FLAX_NAMES = {"stem": "Conv_0", "bn": "BatchNorm_0"}
        layers, ch = [], num_init_features
        for bi, nlayers in enumerate(block_config):
            for _ in range(nlayers):
                layers.append(DenseLayer(ch, growth_rate))
                ch += growth_rate
            if bi != len(block_config) - 1:
                layers.append(Transition(ch, int(ch * compression)))
                ch = int(ch * compression)
        self.layers = nn.ModuleList(layers)
        self.bn = BatchNorm(ch)
        self.fc = nn.Linear(ch, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        if self.imagenet_stem:
            x = max_pool(F.relu(self.stem_bn(x)), 3, 2, "SAME")
        for layer in self.layers:
            x = layer(x)
        x = F.relu(self.bn(x))
        return self.fc(global_avg_pool(x))


def densenet_bc_100_12(num_classes: int = 10, in_channels: int = 3) -> DenseNet:
    """CIFAR DenseNet-BC, depth 100, growth 12: 3 blocks of 16 layers."""
    return DenseNet(block_config=(16, 16, 16), growth_rate=12,
                    num_init_features=24, num_classes=num_classes,
                    imagenet_stem=False, in_channels=in_channels)


_IMAGENET_CONFIGS = {
    121: ((6, 12, 24, 16), 32, 64),
    161: ((6, 12, 36, 24), 48, 96),
    201: ((6, 12, 48, 32), 32, 64),
}


def imagenet_densenet(depth: int, num_classes: int = 1000,
                      in_channels: int = 3) -> DenseNet:
    if depth not in _IMAGENET_CONFIGS:
        raise ValueError(f"unsupported ImageNet DenseNet depth {depth}")
    cfg, growth, init = _IMAGENET_CONFIGS[depth]
    return DenseNet(block_config=cfg, growth_rate=growth,
                    num_init_features=init, num_classes=num_classes,
                    in_channels=in_channels)
