"""Training augmentation (counterpart of ``mgwfbp_tpu/data/augment.py``):
for CIFAR, RandomCrop(32, padding=4) + horizontal flip + normalize in one
transform (the native kernel where it is loaded); for ImageNet,
RandomResizedCrop (vectorised bilinear, float32 out) + horizontal flip,
then normalize. Each draws its randomness in the JAX package's call order,
so the same generator gives the same bytes."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def random_hflip(x: np.ndarray, rng: np.random.Generator,
                 p: float = 0.5) -> np.ndarray:
    """Flip each sample left-right with probability p. x: (B, H, W, C)."""
    flip = rng.random(x.shape[0]) < p
    if not flip.any():
        return x
    out = x.copy()
    out[flip] = out[flip, :, ::-1]
    return out


def random_resized_crop(
    x: np.ndarray,
    rng: np.random.Generator,
    scale: tuple[float, float] = (0.08, 1.0),
    ratio: tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
    attempts: int = 10,
) -> np.ndarray:
    """torchvision RandomResizedCrop over a batch: per sample an area
    fraction and an aspect ratio (the first of ``attempts`` candidates that
    fits, else a centre crop of the short side), a uniform offset, then a
    bilinear resize back to the input size with half-pixel centres, as one
    batched gather. Output float32."""
    b, h, w, c = x.shape
    area = h * w * rng.uniform(scale[0], scale[1], size=(attempts, b))
    ar = np.exp(
        rng.uniform(np.log(ratio[0]), np.log(ratio[1]), size=(attempts, b))
    )
    tw = np.round(np.sqrt(area * ar)).astype(np.int64)
    th = np.round(np.sqrt(area / ar)).astype(np.int64)
    valid = (tw > 0) & (tw <= w) & (th > 0) & (th <= h)
    first = np.argmax(valid, axis=0)
    any_valid = valid[first, np.arange(b)]
    cw = np.where(any_valid, tw[first, np.arange(b)], min(w, h))
    ch = np.where(any_valid, th[first, np.arange(b)], min(w, h))
    top = np.floor(rng.random(b) * (h - ch + 1)).astype(np.int64)
    left = np.floor(rng.random(b) * (w - cw + 1)).astype(np.int64)
    top = np.where(any_valid, top, (h - ch) // 2)
    left = np.where(any_valid, left, (w - cw) // 2)

    yy = top[:, None] + (np.arange(h)[None, :] + 0.5) * ch[:, None] / h - 0.5
    xx = left[:, None] + (np.arange(w)[None, :] + 0.5) * cw[:, None] / w - 0.5
    y0f = np.floor(yy)
    x0f = np.floor(xx)
    wy = (yy - y0f).astype(np.float32)[:, :, None, None]  # (B, h, 1, 1)
    wx = (xx - x0f).astype(np.float32)[:, None, :, None]  # (B, 1, w, 1)
    ylo, yhi = top[:, None], (top + ch - 1)[:, None]
    xlo, xhi = left[:, None], (left + cw - 1)[:, None]
    y0 = np.clip(y0f.astype(np.int64), ylo, yhi)
    y1 = np.clip(y0 + 1, ylo, yhi)
    x0 = np.clip(x0f.astype(np.int64), xlo, xhi)
    x1 = np.clip(x0 + 1, xlo, xhi)
    bi = np.arange(b)[:, None, None]
    f = x.astype(np.float32)
    y0e, y1e = y0[:, :, None], y1[:, :, None]  # (B, h, 1)
    x0e, x1e = x0[:, None, :], x1[:, None, :]  # (B, 1, w)
    top_row = f[bi, y0e, x0e] * (1 - wx) + f[bi, y0e, x1e] * wx
    bot_row = f[bi, y1e, x0e] * (1 - wx) + f[bi, y1e, x1e] * wx
    return top_row * (1 - wy) + bot_row * wy


def crop_at_offsets(
    x: np.ndarray, ys: np.ndarray, xs: np.ndarray, pad: int
) -> np.ndarray:
    """Zero-pad by `pad`, crop back to the original size at the given
    per-sample offsets (0..2*pad)."""
    b, h, w, c = x.shape
    padded = np.pad(
        x, ((0, 0), (pad, pad), (pad, pad), (0, 0)), mode="constant"
    )
    out = np.empty_like(x)
    for i in range(b):
        out[i] = padded[i, ys[i] : ys[i] + h, xs[i] : xs[i] + w]
    return out


class FusedCropFlipNormalize:
    """Crop + flip + normalize (``px * scale - shift`` in float32): a uint8
    batch goes through the native kernel (``mgwfbp_tpu_torch.native``) when
    it is loaded, else the numpy path; both draw the same randomness in the
    same order and give the same bytes."""

    wants_rng = True

    def __init__(self, mean, std, pad: int = 4, p_flip: float = 0.5):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.pad = pad
        self.p_flip = p_flip

    def __call__(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        b = x.shape[0]
        ys = rng.integers(0, 2 * self.pad + 1, size=b)
        xs = rng.integers(0, 2 * self.pad + 1, size=b)
        flips = rng.random(b) < self.p_flip
        if x.dtype == np.uint8:
            from mgwfbp_tpu_torch import native

            out = native.fused_crop_flip_normalize(
                x, ys, xs, flips.astype(np.uint8), self.mean, self.std,
                self.pad,
            )
            if out is not None:
                return out
        x = crop_at_offsets(x, ys, xs, self.pad)
        x[flips] = x[flips, :, ::-1]
        scale = (1.0 / (255.0 * self.std)).astype(np.float32)
        shift = (self.mean / self.std).astype(np.float32)
        return x.astype(np.float32) * scale - shift


class Augment:
    """Seeded stages in order, each given the loader's per-batch
    generator."""

    wants_rng = True

    def __init__(self, *stages: Callable):
        self.stages = stages

    def __call__(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        for stage in self.stages:
            x = stage(x, rng)
        return x


def train_augment(dataset: str) -> Optional[Augment]:
    """ImageNet's training augmentation (RandomResizedCrop + flip); None
    where the JAX package chains none (CIFAR takes the fused transform)."""
    if dataset.lower() == "imagenet":
        return Augment(random_resized_crop, random_hflip)
    return None


def chain(*transforms) -> Callable:
    """Left-to-right composition; stages that want the generator get it."""
    members = [t for t in transforms if t is not None]

    class _Chain:
        wants_rng = any(getattr(t, "wants_rng", False) for t in members)

        def __call__(self, x, rng=None):
            for t in members:
                x = t(x, rng) if getattr(t, "wants_rng", False) else t(x)
            return x

    return _Chain()
