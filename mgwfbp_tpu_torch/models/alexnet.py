"""AlexNet with local response normalization (counterpart of
``mgwfbp_tpu/models/alexnet.py``). Input NCHW.

conv 64@11x11/4 with explicit (2, 2) padding -> LRN -> max pool 3x3/2
VALID -> conv 192@5x5 -> LRN -> pool -> conv 384, 256, 256 @3x3 -> pool
-> flatten (NHWC order, 6x6x256 at 224) -> dropout -> Dense 4096 ->
dropout -> Dense 4096 -> Dense. Convs have a bias and He fan-out init.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mgwfbp_tpu_torch.models.common import (
    SameConv2d,
    flatten,
    local_response_norm,
    max_pool,
    valid_out,
)


class AlexNet(nn.Module):
    def __init__(self, num_classes: int = 1000, input_hwc=(224, 224, 3)):
        super().__init__()
        h, w, c = input_hwc
        # 11x11/4 over 2 + n + 2, then three VALID 3x3/2 pools (SAME convs
        # between them keep the size)
        h, w = (valid_out(valid_out(valid_out(valid_out(n + 4, 11, 4), 3, 2),
                                    3, 2), 3, 2) for n in (h, w))
        self.convs = nn.ModuleList([
            SameConv2d(c, 64, 11, 4, padding=((2, 2), (2, 2)), bias=True),
            SameConv2d(64, 192, 5, bias=True),
            SameConv2d(192, 384, 3, bias=True),
            SameConv2d(384, 256, 3, bias=True),
            SameConv2d(256, 256, 3, bias=True),
        ])
        self.fcs = nn.ModuleList([nn.Linear(h * w * 256, 4096),
                                  nn.Linear(4096, 4096),
                                  nn.Linear(4096, num_classes)])
        self.drop = nn.Dropout(0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.convs
        x = max_pool(local_response_norm(F.relu(c[0](x))), 3, 2, "VALID")
        x = max_pool(local_response_norm(F.relu(c[1](x))), 3, 2, "VALID")
        for conv in c[2:]:
            x = F.relu(conv(x))
        x = self.drop(flatten(max_pool(x, 3, 2, "VALID")))
        x = self.drop(F.relu(self.fcs[0](x)))
        x = F.relu(self.fcs[1](x))
        return self.fcs[2](x)
