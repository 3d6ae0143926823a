"""Distributed data sharding (a copy of ``mgwfbp_tpu/data/sharding.py``).

The `DistributedSampler` contract as a pure index computation: a
deterministic epoch-seeded permutation, padded to a multiple of the world
size, sliced `rank::nranks`. In the port one process drives one card, so
`rank` is the process's rank in the torch.distributed world.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    rank: int = 0
    nranks: int = 1

    def __post_init__(self):
        if not (0 <= self.rank < self.nranks):
            raise ValueError(f"rank {self.rank} outside [0, {self.nranks})")


def shard_indices(
    n: int,
    shard: ShardInfo,
    epoch: int = 0,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = False,
) -> np.ndarray:
    """Indices this rank owns for one epoch.

    Matches DistributedSampler semantics: epoch-seeded global permutation,
    wrap-around padding so every rank gets the same count, stride slicing.
    With drop_last, truncates instead of padding (all ranks equal length
    either way — a collective-deadlock-free guarantee).
    """
    if n <= 0:
        return np.empty((0,), dtype=np.int64)
    if shuffle:
        rng = np.random.RandomState((seed * 1_000_003 + epoch) % (2**31 - 1))
        order = rng.permutation(n)
    else:
        order = np.arange(n)
    if drop_last:
        total = (n // shard.nranks) * shard.nranks
        order = order[:total]
    else:
        total = ((n + shard.nranks - 1) // shard.nranks) * shard.nranks
        if total > n:
            order = np.concatenate([order, order[: total - n]])
    return order[shard.rank :: shard.nranks]


def per_process_batch(global_batch: int, nprocs: int) -> int:
    if global_batch % nprocs != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by {nprocs} processes"
        )
    return global_batch // nprocs
