"""In-memory array dataset + sharded epoch loader (counterpart of
``mgwfbp_tpu/data/loader.py``).

Datasets are indexable numpy arrays; the loader owns the epoch permutation
(``sharding.shard_indices``), batching and the transform, and yields host
numpy batches (images NHWC). Batches are a pure function of (seed, epoch,
rank, batch index), bit-identical to the JAX package's loader; the JAX
package's native C++ kernels and background prefetch are not ported (their
numpy fallbacks are the bit-identical reference), see ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional

import numpy as np

from mgwfbp_tpu_torch.data.sharding import ShardInfo, shard_indices


@dataclasses.dataclass
class ArrayDataset:
    """data[N, ...], labels[N]."""

    data: np.ndarray
    labels: np.ndarray
    num_classes: int

    def __post_init__(self):
        if len(self.data) != len(self.labels):
            raise ValueError("data/labels length mismatch")

    def __len__(self) -> int:
        return len(self.data)


class ShardedLoader:
    """Epoch-based sharded batch iterator; ``set_epoch`` reshuffles
    deterministically. Batches are per process (weak scaling)."""

    def __init__(
        self,
        dataset: ArrayDataset,
        batch_size: int,
        shard: ShardInfo = ShardInfo(),
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        transform: Optional[Callable[..., np.ndarray]] = None,
    ):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shard = shard
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.transform = transform
        self.epoch = 0
        self._idx_epoch: Optional[int] = None
        self._idx = np.empty((0,), np.int64)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    @property
    def num_batches(self) -> int:
        per_rank = len(self._epoch_indices(self.epoch))
        if self.drop_last:
            return per_rank // self.batch_size
        return (per_rank + self.batch_size - 1) // self.batch_size

    def __len__(self) -> int:
        return self.num_batches

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        if self._idx_epoch != epoch:
            self._idx = shard_indices(
                len(self.dataset), self.shard, epoch, self.shuffle,
                self.seed, self.drop_last,
            )
            self._idx_epoch = epoch
        return self._idx

    def load_batch(self, epoch: int, b: int) -> tuple[np.ndarray, np.ndarray]:
        """Batch ``b`` of ``epoch``: gather + transform. A transform that
        wants randomness gets a generator seeded by (seed, epoch, rank, b)."""
        idx = self._epoch_indices(epoch)
        sel = idx[b * self.batch_size : (b + 1) * self.batch_size]
        x = _gather(self.dataset.data, sel)
        y = self.dataset.labels[sel]
        if self.transform is not None:
            if getattr(self.transform, "wants_rng", False):
                rng = np.random.default_rng(
                    [self.seed, epoch, self.shard.rank, b]
                )
                x = self.transform(x, rng)
            else:
                x = self.transform(x)
        return x, y

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        for b in range(self.num_batches):
            yield self.load_batch(self.epoch, b)


def _gather(data, sel: np.ndarray) -> np.ndarray:
    """``data[sel]`` for a numpy array or an h5py dataset. h5py takes only
    strictly increasing index lists without repeats: read the sorted unique
    set once and scatter it back."""
    if isinstance(data, np.ndarray):
        return data[sel]
    usel, inverse = np.unique(sel, return_inverse=True)
    return np.asarray(data[usel.tolist()])[inverse]


def normalize_images(
    mean: tuple[float, ...], std: tuple[float, ...]
) -> Callable[[np.ndarray], np.ndarray]:
    """uint8 HWC images -> normalized float32 as ``px * scale - shift``
    (the JAX package's factorization, so both round alike)."""
    mean_a = np.asarray(mean, dtype=np.float32)
    std_a = np.asarray(std, dtype=np.float32)
    scale = (1.0 / (255.0 * std_a)).astype(np.float32)
    shift = (mean_a / std_a).astype(np.float32)

    def _t(x: np.ndarray) -> np.ndarray:
        return x.astype(np.float32) * scale - shift

    return _t
