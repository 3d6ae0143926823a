"""GoogLeNet (Inception v1) with its two auxiliary classifiers (counterpart
of ``mgwfbp_tpu/models/googlenet.py``). Input NCHW.

7x7/2 ConvBN stem (Flax ``SAME``), ``SAME`` 3x3/2 max pools between the
stages, nine inception modules, global average pool, dropout 0.4, fc. The
aux heads (``aux1`` after inception 4a, ``aux2`` after 4d) are built in
every mode, so the leaf tree is the same in training and evaluation; in
training the forward returns ``(logits, aux1, aux2)`` and the step adds
0.3 x each aux loss; in evaluation it returns the logits alone and skips
the heads, whose output nothing reads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mgwfbp_tpu_torch.models.common import (
    ConvBN,
    avg_pool,
    flatten,
    global_avg_pool,
    max_pool,
    run,
    same_out,
    valid_out,
)


class Inception(nn.Module):
    """1x1 / 1x1-3x3 / 1x1-5x5 / 3x3 max pool-1x1 branches, concatenated.
    ``convs`` holds the ConvBNs in the order Flax creates them."""

    def __init__(self, cin: int, b1: int, b2_reduce: int, b2: int,
                 b3_reduce: int, b3: int, b4: int):
        super().__init__()
        self.out_channels = b1 + b2 + b3 + b4
        self.convs = nn.ModuleList([
            ConvBN(cin, b1, 1),             # 0: branch 1
            ConvBN(cin, b2_reduce, 1),      # 1-2: branch 2
            ConvBN(b2_reduce, b2, 3),
            ConvBN(cin, b3_reduce, 1),      # 3-4: branch 3
            ConvBN(b3_reduce, b3, 5),
            ConvBN(cin, b4, 1),             # 5: after the pool
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.convs
        y4 = c[5](max_pool(x, 3, 1, "SAME"))
        return torch.cat([c[0](x), run(c[1:3], x), run(c[3:5], x), y4], dim=1)


class AuxHead(nn.Module):
    """5x5/3 average pool -> ConvBN 1x1 (128) -> flatten (NHWC order) ->
    Dense 1024 -> ReLU -> dropout 0.7 -> Dense."""

    FLAX_NAMES = {"conv": "ConvBN_0"}

    def __init__(self, cin: int, num_classes: int, hw: tuple[int, int]):
        super().__init__()
        h, w = (valid_out(n, 5, 3) for n in hw)
        self.conv = ConvBN(cin, 128, 1)
        self.fcs = nn.ModuleList([nn.Linear(h * w * 128, 1024),
                                  nn.Linear(1024, num_classes)])
        self.drop = nn.Dropout(0.7)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = flatten(self.conv(avg_pool(x, 5, 3)))
        x = self.drop(F.relu(self.fcs[0](x)))
        return self.fcs[1](x)


# (b1, b2_reduce, b2, b3_reduce, b3, b4) of inception 3a, 3b, 4a-4e, 5a, 5b
_CFG = (
    (64, 96, 128, 16, 32, 32), (128, 128, 192, 32, 96, 64),
    (192, 96, 208, 16, 48, 64), (160, 112, 224, 24, 64, 64),
    (128, 128, 256, 24, 64, 64), (112, 144, 288, 32, 64, 64),
    (256, 160, 320, 32, 128, 128),
    (256, 160, 320, 32, 128, 128), (384, 192, 384, 48, 128, 128),
)
_POOL_BEFORE = (2, 7)  # SAME 3x3/2 max pools before inception 4a and 5a
_AUX_AFTER = {2: "aux1", 5: "aux2"}  # after 4a and 4d


class GoogLeNet(nn.Module):
    FLAX_NAMES = {"stem": "ConvBN_0", "conv2": "ConvBN_1", "conv3": "ConvBN_2"}

    def __init__(self, num_classes: int = 1000, input_hwc=(224, 224, 3)):
        super().__init__()
        h, w, c = input_hwc
        self.stem = ConvBN(c, 64, 7, 2)
        self.conv2 = ConvBN(64, 64, 1)
        self.conv3 = ConvBN(64, 192, 3)
        # the stem and two pools at stride 2, SAME
        h, w = (same_out(same_out(same_out(n, 2), 2), 2) for n in (h, w))
        blocks, ch, aux = [], 192, {}
        for i, cfg in enumerate(_CFG):
            if i in _POOL_BEFORE:
                h, w = same_out(h, 2), same_out(w, 2)
            blocks.append(Inception(ch, *cfg))
            ch = blocks[-1].out_channels
            if i in _AUX_AFTER:
                aux[_AUX_AFTER[i]] = AuxHead(ch, num_classes, (h, w))
        self.blocks = nn.ModuleList(blocks)
        self.aux1, self.aux2 = aux["aux1"], aux["aux2"]
        self.drop = nn.Dropout(0.4)
        self.fc = nn.Linear(ch, num_classes)

    def forward(self, x: torch.Tensor):
        x = max_pool(self.stem(x), 3, 2, "SAME")
        x = max_pool(self.conv3(self.conv2(x)), 3, 2, "SAME")
        aux = []
        for i, block in enumerate(self.blocks):
            if i in _POOL_BEFORE:
                x = max_pool(x, 3, 2, "SAME")
            x = block(x)
            if i in _AUX_AFTER and self.training:
                aux.append(getattr(self, _AUX_AFTER[i])(x))
        logits = self.fc(self.drop(global_avg_pool(x)))
        if self.training:
            return (logits, *aux)
        return logits
