"""Image datasets (counterpart of the MNIST, CIFAR and ImageNet parts of
``mgwfbp_tpu/data/datasets.py``): the real MNIST idx files, CIFAR-10
pickle batches or ImageNet HDF5 file, when they are under ``data_dir``,
else a deterministic synthetic twin with the same shapes, type and
cardinality. The generators are copies of the JAX package's, so the same
seed gives the same bytes in both packages. ``h5py`` is imported only
when an ImageNet file is there. Nothing is downloaded.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from typing import Optional

import numpy as np

from mgwfbp_tpu_torch.data.loader import ArrayDataset

CIFAR_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR_STD = (0.2470, 0.2435, 0.2616)
MNIST_MEAN = (0.1307,)
MNIST_STD = (0.3081,)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
IMAGENET_FILES = ("imagenet.hdf5", "imagenet-shuffled.hdf5")


def synthetic_images(
    n: int, hwc: tuple[int, int, int], num_classes: int, seed: int = 0
) -> ArrayDataset:
    """Fake image set whose intensity shifts with the class, so that a
    model can fit it."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=n).astype(np.int32)
    base = rng.randint(0, 256, size=(n,) + hwc)
    shift = np.round(labels * (128.0 / max(num_classes - 1, 1))).astype(np.int64)
    data = np.clip(base // 2 + shift[:, None, None, None], 0, 255).astype(np.uint8)
    return ArrayDataset(data=data, labels=labels, num_classes=num_classes)


def _smooth_field(rng: np.random.RandomState, hwc, low: int = 8) -> np.ndarray:
    """Low-frequency random field: white noise at `low` resolution,
    bilinearly upsampled to (H, W, C), unit RMS."""
    h, w, c = hwc
    coarse = rng.randn(low, low, c)
    ys = np.linspace(0, low - 1, h)
    xs = np.linspace(0, low - 1, w)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, low - 1)
    x1 = np.minimum(x0 + 1, low - 1)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    field = (
        coarse[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
        + coarse[np.ix_(y1, x0)] * fy * (1 - fx)
        + coarse[np.ix_(y0, x1)] * (1 - fy) * fx
        + coarse[np.ix_(y1, x1)] * fy * fx
    )
    return field / max(float(np.sqrt((field**2).mean())), 1e-8)


def synthetic_images_hard(
    n: int,
    hwc: tuple[int, int, int],
    num_classes: int,
    seed: int = 0,
    world_seed: int = 1234,
    n_styles: int = 64,
    class_amp: float = 4.0,
    style_amp: float = 24.0,
    noise_std: float = 40.0,
    max_shift: int = 4,
) -> ArrayDataset:
    """Held-out-generalization twin: a weak class basis under a strong
    class-independent style factor and noise, randomly shifted and
    flipped. The basis and styles come from ``world_seed`` (shared by the
    train and val builds), the samples from ``seed``."""
    h, w, c = hwc
    wrng = np.random.RandomState(world_seed)
    basis = np.stack([_smooth_field(wrng, hwc) for _ in range(num_classes)])
    styles = np.stack([_smooth_field(wrng, hwc) for _ in range(n_styles)])
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=n).astype(np.int32)
    style_ix = rng.randint(0, n_styles, size=n)
    x = (
        128.0
        + class_amp * basis[labels]
        + style_amp * styles[style_ix]
        + noise_std * rng.randn(n, h, w, c)
    )
    dy = rng.randint(-max_shift, max_shift + 1, size=n)
    dx = rng.randint(-max_shift, max_shift + 1, size=n)
    flip = rng.rand(n) < 0.5
    for i in range(n):
        if dy[i] or dx[i]:
            x[i] = np.roll(x[i], (dy[i], dx[i]), axis=(0, 1))
        if flip[i]:
            x[i] = x[i, :, ::-1]
    data = np.clip(x, 0, 255).astype(np.uint8)
    return ArrayDataset(data=data, labels=labels, num_classes=num_classes)


def _read_idx(path: str) -> np.ndarray:
    """One idx-ubyte file (optionally gzipped): a big-endian magic whose low
    byte is the rank, the dims, then uint8 data."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def load_mnist(data_dir: str, split: str = "train") -> Optional[ArrayDataset]:
    """MNIST from ``{train,t10k}-{images-idx3,labels-idx1}-ubyte[.gz]``
    under ``data_dir`` (N x 28 x 28 x 1 uint8), or None when they are not
    there."""
    prefix = "train" if split == "train" else "t10k"
    for suffix in ("", ".gz"):
        img = os.path.join(data_dir, f"{prefix}-images-idx3-ubyte{suffix}")
        lbl = os.path.join(data_dir, f"{prefix}-labels-idx1-ubyte{suffix}")
        if os.path.exists(img) and os.path.exists(lbl):
            data = _read_idx(img)[..., None]
            labels = _read_idx(lbl).astype(np.int32)
            return ArrayDataset(data=data, labels=labels, num_classes=10)
    return None


def load_cifar10(data_dir: str, split: str = "train") -> Optional[ArrayDataset]:
    """CIFAR-10 from its python-pickle batches under
    ``<data_dir>/cifar-10-batches-py``, or None when they are not there."""
    root = os.path.join(data_dir, "cifar-10-batches-py")
    if not os.path.isdir(root):
        return None
    files = (
        [f"data_batch_{i}" for i in range(1, 6)] if split == "train" else ["test_batch"]
    )
    xs, ys = [], []
    for fn in files:
        path = os.path.join(root, fn)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        ys.append(np.asarray(d[b"labels"], dtype=np.int32))
    return ArrayDataset(
        data=np.concatenate(xs), labels=np.concatenate(ys), num_classes=10
    )


class HDF5ImageDataset:
    """An HDF5 file in the reference's layout (``train_img``/``train_labels``,
    ``val_img``/``val_labels``; N x S x S x 3 uint8), read on demand.
    The class count is inferred over both splits' labels."""

    def __init__(self, path: str, split: str = "train",
                 num_classes: Optional[int] = None):
        import h5py

        self._f = h5py.File(path, "r", libver="latest", swmr=True)
        key = "train" if split == "train" else "val"
        self.data = self._f[f"{key}_img"]
        self.labels = np.asarray(self._f[f"{key}_labels"], dtype=np.int32)
        if num_classes is None:
            num_classes = 1
            for k in ("train_labels", "val_labels"):
                if k in self._f:
                    arr = np.asarray(self._f[k])
                    if arr.size:
                        num_classes = max(num_classes, int(arr.max()) + 1)
        self.num_classes = num_classes

    def __len__(self) -> int:
        return len(self.labels)


def load_imagenet_hdf5(data_dir: str,
                       split: str = "train") -> Optional[HDF5ImageDataset]:
    """The ImageNet file under ``data_dir`` (``imagenet.hdf5``, else
    ``imagenet-shuffled.hdf5``), or None when neither is there."""
    for name in IMAGENET_FILES:
        path = os.path.join(data_dir, name)
        if os.path.exists(path):
            return HDF5ImageDataset(path, split)
    return None
