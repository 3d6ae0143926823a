"""Seeded weights and batches, made on the device in a few large calls and
handed alike to the program and to the reference.

Weights: one normal draw of every leaf at once from a generator on the
device, scaled and shifted per leaf (``kind`` from the family's ``params``):
convolutions He fan-out, batch-norm scale 1 + 0.1 n and shift 0.1 n, the
classifier LeCun fan-in and its bias 0.01 n. Batches: NCHW float32 images
(standard normal, as normalised pixels) and int64 labels, a pool of
distinct batches per rank, from a generator seeded by (seed, rank).
"""

from __future__ import annotations

import math

import torch


def generator(device: torch.device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integers of ``key``."""
    seed = 0
    for k in key:
        seed = (seed * 1_000_003 + int(k)) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(seed)


def _scale_shift(shape: tuple[int, ...], kind: str) -> tuple[float, float]:
    if kind == "conv":
        out, _, kh, kw = shape
        return math.sqrt(2.0 / (kh * kw * out)), 0.0
    if kind == "scale":
        return 0.1, 1.0
    if kind == "shift":
        return 0.1, 0.0
    if kind == "fc":
        return math.sqrt(1.0 / shape[1]), 0.0
    if kind == "fc_bias":
        return 0.01, 0.0
    raise ValueError(f"unknown leaf kind {kind!r}")


def make_weights(leaves: list, seed: int, device: torch.device) -> dict:
    """{name: float32 tensor} for ``leaves`` = [(name, shape, kind)]: views
    of one flat tensor drawn on ``device``."""
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    pairs = [_scale_shift(shape, kind) for _, shape, kind in leaves]
    counts = torch.tensor(sizes, device=device)
    scale = torch.repeat_interleave(
        torch.tensor([s for s, _ in pairs], device=device), counts)
    shift = torch.repeat_interleave(
        torch.tensor([m for _, m in pairs], device=device), counts)
    flat = torch.randn(sum(sizes), generator=generator(device, seed, 0),
                       device=device)
    flat = torch.addcmul(shift, flat, scale)
    return {name: view.view(shape) for (name, shape, _), view in
            zip(leaves, flat.split(sizes))}


def make_batches(n: int, batch: int, channels: int, size: int, classes: int,
                 seed: int, rank: int, device: torch.device
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``n`` batches for one rank: images (n, 1, batch, C, H, W) float32
    and labels (n, 1, batch) int64 (the axis of 1 is the train step's
    micro-batch axis)."""
    g = generator(device, seed, 1, rank)
    x = torch.randn((n, 1, batch, channels, size, size), generator=g,
                    device=device)
    y = torch.randint(0, classes, (n, 1, batch), generator=g, device=device)
    return x, y
