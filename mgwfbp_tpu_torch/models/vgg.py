"""VGG (counterpart of ``mgwfbp_tpu/models/vgg.py``): ``VGGCifar``
(vgg11/13/16/19 with batch norm and one linear classifier) and
``VGGImageNet`` (``vgg16i``: plain convs with bias, three Dense layers
with dropout). Input NCHW; "M" in a layer table is a 2x2 max pool. The
flatten before the first Dense layer is in NHWC order (``common.flatten``;
7x7x512 -> 25088 for ``vgg16i`` at 224).
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from mgwfbp_tpu_torch.models.common import (
    ConvBN,
    Dense,
    SameConv2d,
    flatten,
    max_pool,
    valid_out,
)

CFGS: dict[str, Sequence[Union[int, str]]] = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"),
    "vgg19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}


def _features(cfg: str, input_hwc, conv) -> tuple[nn.ModuleList, int]:
    """The convs of a layer table (``conv(cin, cout)`` each) and the size
    of the flattened map after the last pool."""
    h, w, ch = input_hwc
    convs = []
    for item in CFGS[cfg]:
        if item == "M":
            h, w = valid_out(h, 2, 2), valid_out(w, 2, 2)
        else:
            convs.append(conv(ch, int(item)))
            ch = int(item)
    return nn.ModuleList(convs), h * w * ch


class VGGCifar(nn.Module):
    """CIFAR VGG: ConvBN 3x3 layers and 2x2 max pools, then one Dense
    layer on the flattened map (512 at 32x32)."""

    FLAX_NAMES = {"fc": "Dense_0"}

    def __init__(self, cfg: str = "vgg16", num_classes: int = 10,
                 input_hwc=(32, 32, 3)):
        super().__init__()
        self.cfg = cfg
        self.convs, n = _features(cfg, input_hwc,
                                  lambda a, b: ConvBN(a, b, 3))
        self.fc = Dense(n, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = iter(self.convs)
        for item in CFGS[self.cfg]:
            x = max_pool(x, 2, 2, "VALID") if item == "M" else next(convs)(x)
        return self.fc(flatten(x))


class VGGImageNet(nn.Module):
    """ImageNet VGG (torchvision's layout): 3x3 convs with bias and ReLU,
    2x2 max pools, Dense 4096 -> dropout -> Dense 4096 -> dropout ->
    Dense."""

    def __init__(self, cfg: str = "vgg16", num_classes: int = 1000,
                 input_hwc=(224, 224, 3)):
        super().__init__()
        self.cfg = cfg
        self.convs, n = _features(cfg, input_hwc,
                                  lambda a, b: SameConv2d(a, b, 3, bias=True))
        self.fcs = nn.ModuleList([Dense(n, 4096), Dense(4096, 4096),
                                  Dense(4096, num_classes)])
        self.drop = nn.Dropout(0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = iter(self.convs)
        for item in CFGS[self.cfg]:
            x = (max_pool(x, 2, 2, "VALID") if item == "M"
                 else F.relu(next(convs)(x)))
        x = self.drop(F.relu(self.fcs[0](flatten(x))))
        x = self.drop(F.relu(self.fcs[1](x)))
        return self.fcs[2](x)
