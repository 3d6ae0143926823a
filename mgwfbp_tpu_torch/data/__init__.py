"""Data subsystem (counterpart of the image branch of
``mgwfbp_tpu/data/__init__.py``): ``data_prepare`` resolves a dataset name
to sharded train/val loaders, from real files when present, else from the
synthetic twin. Only CIFAR-10 is ported; the other datasets are listed in
ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from mgwfbp_tpu_torch.data.datasets import (
    CIFAR_MEAN,
    CIFAR_STD,
    load_cifar10,
    synthetic_images,
    synthetic_images_hard,
)
from mgwfbp_tpu_torch.data.loader import (
    ArrayDataset,
    ShardedLoader,
    normalize_images,
)
from mgwfbp_tpu_torch.data.sharding import ShardInfo

# synthetic sizes, as in the JAX package; MGWFBP_SYNTH_TRAIN_N /
# MGWFBP_SYNTH_VAL_N override them and MGWFBP_SYNTH_MODE=hard selects the
# held-out-generalization generator
_SYNTH_TRAIN = {"cifar10": 4096}
_SYNTH_VAL = {"cifar10": 512}


def _synth_size(split: str, name: str) -> int:
    table = _SYNTH_TRAIN if split == "train" else _SYNTH_VAL
    env = os.environ.get(f"MGWFBP_SYNTH_{split.upper()}_N")
    return int(env) if env else table[name]


@dataclasses.dataclass
class DataBundle:
    train: ShardedLoader
    val: ShardedLoader
    num_classes: int
    synthetic: bool
    # batches per epoch of one rank = dataset / (batch * nranks)
    num_batches_per_epoch: int


def data_prepare(
    dataset: str,
    data_dir: str = "./data",
    batch_size: int = 32,
    shard: ShardInfo = ShardInfo(),
    seed: int = 0,
    synthetic: Optional[bool] = None,
    augment: bool = True,
) -> DataBundle:
    """Sharded train/val loaders; ``batch_size`` is per process.
    ``synthetic=True`` forces the synthetic twin, None looks for files."""
    name = dataset.lower()
    if name != "cifar10":
        raise ValueError(
            f"dataset {dataset!r} is not ported yet (cifar10 only; see "
            "ROADMAP.md)"
        )
    train = val = None
    if not synthetic:
        train = load_cifar10(data_dir, "train")
        val = load_cifar10(data_dir, "test")
    is_synth = train is None or val is None
    if is_synth:
        if synthetic is False:
            raise FileNotFoundError(f"real {name} data not found under {data_dir!r}")
        gen = synthetic_images
        if os.environ.get("MGWFBP_SYNTH_MODE", "easy") == "hard":
            gen = synthetic_images_hard
        train = gen(_synth_size("train", name), (32, 32, 3), 10, seed)
        val = gen(_synth_size("val", name), (32, 32, 3), 10, seed + 1)
    normalize = normalize_images(CIFAR_MEAN, CIFAR_STD)
    train_tf = normalize
    if augment:
        from mgwfbp_tpu_torch.data.augment import FusedCropFlipNormalize

        train_tf = FusedCropFlipNormalize(CIFAR_MEAN, CIFAR_STD, pad=4)
    train_loader = ShardedLoader(
        train, batch_size, shard, shuffle=True, seed=seed, transform=train_tf,
    )
    val_loader = ShardedLoader(
        val, batch_size, shard, shuffle=False, seed=seed, drop_last=False,
        transform=normalize,
    )
    return DataBundle(
        train=train_loader,
        val=val_loader,
        num_classes=train.num_classes,
        synthetic=is_synth,
        num_batches_per_epoch=len(train_loader),
    )


__all__ = [
    "ArrayDataset",
    "DataBundle",
    "ShardInfo",
    "ShardedLoader",
    "data_prepare",
]
