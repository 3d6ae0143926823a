"""In-memory array dataset, sharded epoch loader and background prefetch
(counterpart of ``mgwfbp_tpu/data/loader.py``).

Datasets are indexable numpy arrays; the loader owns the epoch permutation
(``sharding.shard_indices``), batching and the transform, and yields host
numpy batches (images NHWC). Batches are a pure function of (seed, epoch,
rank, batch index), bit-identical to the JAX package's loader. uint8
normalization runs through the native kernel (``mgwfbp_tpu_torch.native``)
where it is loaded, else numpy, with the same bytes. ``PrefetchLoader``
assembles the train batches ahead of the step in a thread pool.
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
        # (epoch, this rank's indices), replaced whole: prefetch threads of
        # one epoch may read it while another thread loads another epoch's
        # batches (a /profile window's, the autotuner's)
        self._idx_cache: tuple = (None, np.empty((0,), np.int64))

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def set_batch_size(self, batch_size: int) -> None:
        """Re-batch the same shard (a larger eval batch,
        ``MGWFBP_EVAL_BATCH``); batching is lazy, so the attribute is the
        behaviour."""
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.batch_size = batch_size

    @property
    def num_batches(self) -> int:
        per_rank = len(self._epoch_indices(self.epoch))
        if self.drop_last:
            return per_rank // self.batch_size
        return (per_rank + self.batch_size - 1) // self.batch_size

    def __len__(self) -> int:
        return self.num_batches

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        cached = self._idx_cache
        if cached[0] != epoch:
            cached = (epoch, shard_indices(
                len(self.dataset), self.shard, epoch, self.shuffle,
                self.seed, self.drop_last,
            ))
            self._idx_cache = cached
        return cached[1]

    def prime_epoch(self, epoch: int) -> None:
        """Compute and cache ``epoch``'s indices on this thread, so that
        prefetch workers only read the cache."""
        self._epoch_indices(epoch)

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

    def batches(self, epoch: int, start: int = 0,
                stop: Optional[int] = None) -> Iterator[tuple]:
        """Batches ``start`` .. ``stop`` (default: the last) of ``epoch``."""
        self.set_epoch(epoch)
        stop = self.num_batches if stop is None else min(stop, self.num_batches)
        for b in range(start, stop):
            yield self.load_batch(epoch, b)


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
        if x.dtype == np.uint8:
            from mgwfbp_tpu_torch import native

            out = native.normalize_u8(x, mean_a, std_a)
            if out is not None:
                return out
        return x.astype(np.float32) * scale - shift

    return _t


class PrefetchLoader:
    """Background prefetch around an epoch loader (the JAX package's
    ``PrefetchLoader``; the reference's ``DataLoader(num_workers,
    pin_memory=True)``). Batch assembly (gather, augmentation, normalize)
    runs in threads AHEAD of the step; numpy and the native kernels release
    the GIL, so threads give real parallelism without pickling.

    Two modes:
      * the inner loader has ``load_batch(epoch, b)``: ``workers`` threads
        assemble batches concurrently, consumed IN ORDER, so the batches are
        bit-identical to the inner loader's at any worker count;
        ``batches(epoch, start, stop)`` starts at a resume's batch index;
      * otherwise one background thread runs the inner iterator ``depth``
        batches ahead.

    ``pin_memory`` (opt-in, the analogue of the JAX package's
    ``device_put``): each ready batch's arrays become pinned host tensors,
    so the step's copy to the card is a true ``non_blocking`` copy. On a
    machine without a card they become plain CPU tensors of the same bytes.

    Abandoning an epoch (a capped epoch's last step, the SIGTERM drain's
    exception) closes the generator: the pool cancels what has not started,
    waits for what has, and no thread is left behind or blocked.
    """

    def __init__(self, inner, workers: int = 2, depth: int = 2,
                 pin_memory: bool = False):
        self.inner = inner
        self.workers = max(int(workers), 0)
        self.depth = max(int(depth), 1)
        self.pin_memory = pin_memory

    # the epoch, the batch size, the length and the dataset pass through to
    # the inner loader
    def set_epoch(self, epoch: int) -> None:
        self.inner.set_epoch(epoch)

    def set_batch_size(self, batch_size: int) -> None:
        self.inner.set_batch_size(batch_size)

    @property
    def epoch(self) -> int:
        return self.inner.epoch

    @property
    def batch_size(self) -> int:
        return self.inner.batch_size

    @property
    def dataset(self):
        return self.inner.dataset

    @property
    def num_batches(self) -> int:
        return len(self.inner)

    def __len__(self) -> int:
        return len(self.inner)

    def load_batch(self, epoch: int, b: int):
        """One batch, assembled on the calling thread."""
        return self.inner.load_batch(epoch, b)

    def _finalize(self, batch):
        if not self.pin_memory:
            return batch
        import torch

        pin = torch.cuda.is_available()

        def host(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.pin_memory() if pin else t

        if isinstance(batch, dict):
            return {k: host(v) for k, v in batch.items()}
        return type(batch)(host(a) for a in batch)

    def __iter__(self):
        if self.workers == 0:
            for batch in self.inner:
                yield self._finalize(batch)
        elif hasattr(self.inner, "load_batch"):
            yield from self.batches(self.inner.epoch)
        else:
            yield from self._iter_thread()

    def batches(self, epoch: int, start: int = 0,
                stop: Optional[int] = None) -> Iterator:
        """Batches ``start`` .. ``stop`` (default: the last) of ``epoch``,
        in order, from the pool."""
        import collections
        from concurrent.futures import ThreadPoolExecutor

        self.inner.set_epoch(epoch)
        nb = len(self.inner)
        stop = nb if stop is None else min(stop, nb)
        if start >= stop:
            return
        if hasattr(self.inner, "prime_epoch"):
            self.inner.prime_epoch(epoch)
        if self.workers == 0:
            for b in range(start, stop):
                yield self._finalize(self.inner.load_batch(epoch, b))
            return

        def job(b):
            return self._finalize(self.inner.load_batch(epoch, b))

        ex = ThreadPoolExecutor(max_workers=self.workers,
                                thread_name_prefix="mgwfbp-prefetch")
        try:
            ahead = self.workers + self.depth
            futs = collections.deque(
                ex.submit(job, b) for b in range(start, min(start + ahead, stop))
            )
            next_b = start + len(futs)
            while futs:
                out = futs.popleft().result()  # in-order consumption
                if next_b < stop:
                    futs.append(ex.submit(job, next_b))
                    next_b += 1
                yield out
        finally:
            ex.shutdown(wait=True, cancel_futures=True)

    def _iter_thread(self):
        import queue
        import threading

        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        end = object()

        def put(item) -> bool:
            # a bounded put that gives up once the consumer has left, so an
            # abandoned iterator never leaves this thread blocked on a full
            # queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def feed():
            try:
                for batch in self.inner:
                    if not put(self._finalize(batch)):
                        return
                put(end)
            except BaseException as e:  # raised again in the consumer
                put(e)

        t = threading.Thread(target=feed, daemon=True,
                             name="mgwfbp-prefetch-iter")
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=5)
