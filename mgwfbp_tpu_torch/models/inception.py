"""Inception v3 (with its auxiliary head) and Inception v4, both at 299 x
299 (counterpart of ``mgwfbp_tpu/models/inception.py``). Input NCHW.

Every conv is a ``ConvBN`` (Flax ``SAME`` unless marked VALID, including
the factorized 1x7 / 7x1 and 1x3 / 3x1 kernels); each block keeps its
ConvBNs in ``convs`` in the order Flax creates them, so that they are
``ConvBN_<i>`` there, and the blocks of a network sit in one list, whose
Flax names count per type (``InceptionA3_0..2``, ``InceptionB3_0``, ...).
The branch pools: 3x3/1 ``SAME`` average pools (pads counted in the
divisor, as Flax's ``avg_pool`` counts them) and 3x3/2 VALID max pools.
Inception v3 returns ``(logits, aux)`` in training (its head after the
last C block), the logits alone in evaluation.
"""

from __future__ import annotations

import torch
from torch import nn

from mgwfbp_tpu_torch.models.common import (
    ConvBN,
    avg_pool,
    global_avg_pool,
    max_pool,
    run,
)

V = "VALID"


def _cat(*xs: torch.Tensor) -> torch.Tensor:
    return torch.cat(xs, dim=1)


def _pool_same(x: torch.Tensor) -> torch.Tensor:
    return avg_pool(x, 3, 1, "SAME")


def _pool_down(x: torch.Tensor) -> torch.Tensor:
    return max_pool(x, 3, 2, V)


# ---------------------------------------------------------------------------
# Inception v3
# ---------------------------------------------------------------------------


class InceptionA3(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.out_channels = 64 + 64 + 96 + pool_features
        self.convs = nn.ModuleList([
            ConvBN(cin, 64, 1),
            ConvBN(cin, 48, 1), ConvBN(48, 64, 5),
            ConvBN(cin, 64, 1), ConvBN(64, 96, 3), ConvBN(96, 96, 3),
            ConvBN(cin, pool_features, 1),
        ])

    def forward(self, x):
        c = self.convs
        return _cat(c[0](x), run(c[1:3], x), run(c[3:6], x),
                    c[6](_pool_same(x)))


class InceptionB3(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.out_channels = 384 + 96 + cin
        self.convs = nn.ModuleList([
            ConvBN(cin, 384, 3, 2, padding=V),
            ConvBN(cin, 64, 1), ConvBN(64, 96, 3),
            ConvBN(96, 96, 3, 2, padding=V),
        ])

    def forward(self, x):
        c = self.convs
        return _cat(c[0](x), run(c[1:4], x), _pool_down(x))


class InceptionC3(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.out_channels = 4 * 192
        self.convs = nn.ModuleList([
            ConvBN(cin, 192, 1),
            ConvBN(cin, c7, 1), ConvBN(c7, c7, (1, 7)), ConvBN(c7, 192, (7, 1)),
            ConvBN(cin, c7, 1), ConvBN(c7, c7, (7, 1)), ConvBN(c7, c7, (1, 7)),
            ConvBN(c7, c7, (7, 1)), ConvBN(c7, 192, (1, 7)),
            ConvBN(cin, 192, 1),
        ])

    def forward(self, x):
        c = self.convs
        return _cat(c[0](x), run(c[1:4], x), run(c[4:9], x),
                    c[9](_pool_same(x)))


class InceptionD3(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.out_channels = 320 + 192 + cin
        self.convs = nn.ModuleList([
            ConvBN(cin, 192, 1), ConvBN(192, 320, 3, 2, padding=V),
            ConvBN(cin, 192, 1), ConvBN(192, 192, (1, 7)),
            ConvBN(192, 192, (7, 1)), ConvBN(192, 192, 3, 2, padding=V),
        ])

    def forward(self, x):
        c = self.convs
        return _cat(run(c[0:2], x), run(c[2:6], x), _pool_down(x))


class InceptionE3(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.out_channels = 320 + 2 * 384 + 2 * 384 + 192
        self.convs = nn.ModuleList([
            ConvBN(cin, 320, 1),
            ConvBN(cin, 384, 1), ConvBN(384, 384, (1, 3)),
            ConvBN(384, 384, (3, 1)),
            ConvBN(cin, 448, 1), ConvBN(448, 384, 3), ConvBN(384, 384, (1, 3)),
            ConvBN(384, 384, (3, 1)),
            ConvBN(cin, 192, 1),
        ])

    def forward(self, x):
        c = self.convs
        b2 = c[1](x)
        b3 = run(c[4:6], x)
        return _cat(c[0](x), c[2](b2), c[3](b2), c[6](b3), c[7](b3),
                    c[8](_pool_same(x)))


class InceptionV3Aux(nn.Module):
    """5x5/3 average pool -> ConvBN 1x1 (128) -> ConvBN 5x5 VALID (768) ->
    global average pool -> Dense."""

    FLAX_NAMES = {"fc": "Dense_0"}

    def __init__(self, cin: int, num_classes: int):
        super().__init__()
        self.convs = nn.ModuleList([ConvBN(cin, 128, 1),
                                    ConvBN(128, 768, 5, padding=V)])
        self.fc = nn.Linear(768, num_classes)

    def forward(self, x):
        x = run(self.convs, avg_pool(x, 5, 3))
        return self.fc(global_avg_pool(x))


class InceptionV3(nn.Module):
    AUX_AFTER = 8  # blocks before the aux head: 3 A, 1 B, 4 C

    def __init__(self, num_classes: int = 1000, in_channels: int = 3):
        super().__init__()
        self.stem = nn.ModuleList([
            ConvBN(in_channels, 32, 3, 2, padding=V),
            ConvBN(32, 32, 3, padding=V), ConvBN(32, 64, 3),
            ConvBN(64, 80, 1), ConvBN(80, 192, 3, padding=V),
        ])
        blocks = [InceptionA3(192, 32)]
        blocks.append(InceptionA3(blocks[-1].out_channels, 64))
        blocks.append(InceptionA3(blocks[-1].out_channels, 64))
        blocks.append(InceptionB3(blocks[-1].out_channels))
        for c7 in (128, 160, 160, 192):
            blocks.append(InceptionC3(blocks[-1].out_channels, c7))
        self.aux = InceptionV3Aux(blocks[-1].out_channels, num_classes)
        blocks.append(InceptionD3(blocks[-1].out_channels))
        blocks.append(InceptionE3(blocks[-1].out_channels))
        blocks.append(InceptionE3(blocks[-1].out_channels))
        self.blocks = nn.ModuleList(blocks)
        self.drop = nn.Dropout(0.5)
        self.fc = nn.Linear(blocks[-1].out_channels, num_classes)

    def forward(self, x):
        s = self.stem
        x = _pool_down(run(s[0:3], x))
        x = _pool_down(run(s[3:5], x))
        x = run(self.blocks[:self.AUX_AFTER], x)
        aux = self.aux(x) if self.training else None
        x = run(self.blocks[self.AUX_AFTER:], x)
        logits = self.fc(self.drop(global_avg_pool(x)))
        return (logits, aux) if self.training else logits


# ---------------------------------------------------------------------------
# Inception v4
# ---------------------------------------------------------------------------


class StemV4(nn.Module):
    def __init__(self, cin: int = 3):
        super().__init__()
        self.out_channels = 384
        self.convs = nn.ModuleList([
            ConvBN(cin, 32, 3, 2, padding=V), ConvBN(32, 32, 3, padding=V),
            ConvBN(32, 64, 3),
            ConvBN(64, 96, 3, 2, padding=V),
            ConvBN(160, 64, 1), ConvBN(64, 96, 3, padding=V),
            ConvBN(160, 64, 1), ConvBN(64, 64, (1, 7)), ConvBN(64, 64, (7, 1)),
            ConvBN(64, 96, 3, padding=V),
            ConvBN(192, 192, 3, 2, padding=V),
        ])

    def forward(self, x):
        c = self.convs
        x = run(c[0:3], x)
        x = _cat(_pool_down(x), c[3](x))
        x = _cat(run(c[4:6], x), run(c[6:10], x))
        return _cat(c[10](x), _pool_down(x))


class InceptionA4(nn.Module):
    def __init__(self, cin: int = 384):
        super().__init__()
        self.out_channels = 4 * 96
        self.convs = nn.ModuleList([
            ConvBN(cin, 96, 1),
            ConvBN(cin, 64, 1), ConvBN(64, 96, 3),
            ConvBN(cin, 64, 1), ConvBN(64, 96, 3), ConvBN(96, 96, 3),
            ConvBN(cin, 96, 1),
        ])

    def forward(self, x):
        c = self.convs
        return _cat(c[0](x), run(c[1:3], x), run(c[3:6], x),
                    c[6](_pool_same(x)))


class ReductionA4(nn.Module):
    def __init__(self, cin: int = 384):
        super().__init__()
        self.out_channels = 384 + 256 + cin
        self.convs = nn.ModuleList([
            ConvBN(cin, 384, 3, 2, padding=V),
            ConvBN(cin, 192, 1), ConvBN(192, 224, 3),
            ConvBN(224, 256, 3, 2, padding=V),
        ])

    def forward(self, x):
        c = self.convs
        return _cat(c[0](x), run(c[1:4], x), _pool_down(x))


class InceptionB4(nn.Module):
    def __init__(self, cin: int = 1024):
        super().__init__()
        self.out_channels = 384 + 256 + 256 + 128
        self.convs = nn.ModuleList([
            ConvBN(cin, 384, 1),
            ConvBN(cin, 192, 1), ConvBN(192, 224, (1, 7)),
            ConvBN(224, 256, (7, 1)),
            ConvBN(cin, 192, 1), ConvBN(192, 192, (7, 1)),
            ConvBN(192, 224, (1, 7)), ConvBN(224, 224, (7, 1)),
            ConvBN(224, 256, (1, 7)),
            ConvBN(cin, 128, 1),
        ])

    def forward(self, x):
        c = self.convs
        return _cat(c[0](x), run(c[1:4], x), run(c[4:9], x),
                    c[9](_pool_same(x)))


class ReductionB4(nn.Module):
    def __init__(self, cin: int = 1024):
        super().__init__()
        self.out_channels = 192 + 320 + cin
        self.convs = nn.ModuleList([
            ConvBN(cin, 192, 1), ConvBN(192, 192, 3, 2, padding=V),
            ConvBN(cin, 256, 1), ConvBN(256, 256, (1, 7)),
            ConvBN(256, 320, (7, 1)), ConvBN(320, 320, 3, 2, padding=V),
        ])

    def forward(self, x):
        c = self.convs
        return _cat(run(c[0:2], x), run(c[2:6], x), _pool_down(x))


class InceptionC4(nn.Module):
    def __init__(self, cin: int = 1536):
        super().__init__()
        self.out_channels = 256 + 2 * 256 + 2 * 256 + 256
        self.convs = nn.ModuleList([
            ConvBN(cin, 256, 1),
            ConvBN(cin, 384, 1), ConvBN(384, 256, (1, 3)),
            ConvBN(384, 256, (3, 1)),
            ConvBN(cin, 384, 1), ConvBN(384, 448, (3, 1)),
            ConvBN(448, 512, (1, 3)), ConvBN(512, 256, (1, 3)),
            ConvBN(512, 256, (3, 1)),
            ConvBN(cin, 256, 1),
        ])

    def forward(self, x):
        c = self.convs
        b2 = c[1](x)
        b3 = run(c[4:7], x)
        return _cat(c[0](x), c[2](b2), c[3](b2), c[7](b3), c[8](b3),
                    c[9](_pool_same(x)))


class InceptionV4(nn.Module):
    """Stem, 4 x A, reduction A, 7 x B, reduction B, 3 x C, global
    average pool, dropout 0.2, fc."""

    def __init__(self, num_classes: int = 1000, in_channels: int = 3):
        super().__init__()
        blocks = [StemV4(in_channels)]
        for kind, n in ((InceptionA4, 4), (ReductionA4, 1), (InceptionB4, 7),
                        (ReductionB4, 1), (InceptionC4, 3)):
            for _ in range(n):
                blocks.append(kind(blocks[-1].out_channels))
        self.blocks = nn.ModuleList(blocks)
        self.drop = nn.Dropout(0.2)
        self.fc = nn.Linear(blocks[-1].out_channels, num_classes)

    def forward(self, x):
        x = run(self.blocks, x)
        return self.fc(self.drop(global_avg_pool(x)))
