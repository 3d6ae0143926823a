"""CIFAR training augmentation (counterpart of the numpy path of
``mgwfbp_tpu/data/augment.py``): RandomCrop(32, padding=4) + horizontal
flip + normalize in one transform, drawing its randomness in the JAX
package's call order so the same generator gives the same bytes."""

from __future__ import annotations

import numpy as np


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
    """Crop + flip + normalize (``px * scale - shift`` in float32)."""

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
        x = crop_at_offsets(x, ys, xs, self.pad)
        x[flips] = x[flips, :, ::-1]
        scale = (1.0 / (255.0 * self.std)).astype(np.float32)
        shift = (self.mean / self.std).astype(np.float32)
        return x.astype(np.float32) * scale - shift
