"""Data subsystem (counterpart of ``mgwfbp_tpu/data/__init__.py``):
``data_prepare`` resolves a dataset name (mnist, cifar10, imagenet, ptb,
an4) to sharded train/val loaders, from real files when present, else from
the synthetic twin. The train loader is wrapped in ``PrefetchLoader``
(``_wrap_prefetch``), as the JAX package wraps it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from mgwfbp_tpu_torch.data.datasets import (
    CIFAR_MEAN,
    CIFAR_STD,
    IMAGENET_MEAN,
    IMAGENET_STD,
    MNIST_MEAN,
    MNIST_STD,
    load_cifar10,
    load_imagenet_hdf5,
    load_mnist,
    synthetic_images,
    synthetic_images_hard,
)
from mgwfbp_tpu_torch.data.loader import (
    ArrayDataset,
    PrefetchLoader,
    ShardedLoader,
    normalize_images,
)
from mgwfbp_tpu_torch.data.ptb import (
    NUM_STEPS,
    VOCAB_SIZE,
    carry_layout,
    load_ptb_stream,
    synthetic_ptb_stream,
)
from mgwfbp_tpu_torch.data.sharding import ShardInfo

# synthetic sizes, as in the JAX package; MGWFBP_SYNTH_TRAIN_N /
# MGWFBP_SYNTH_VAL_N override them and MGWFBP_SYNTH_MODE=hard selects the
# held-out-generalization generator
_SYNTH_TRAIN = {"mnist": 4096, "cifar10": 4096, "imagenet": 512, "ptb": 512}
_SYNTH_VAL = {"mnist": 512, "cifar10": 512, "imagenet": 128, "ptb": 64}
_IMAGES = {  # name: (default H x W, channels, mean, std, loader, val split)
    "mnist": ((28, 28), 1, MNIST_MEAN, MNIST_STD, load_mnist, "test"),
    "cifar10": ((32, 32), 3, CIFAR_MEAN, CIFAR_STD, load_cifar10, "test"),
    "imagenet": ((224, 224), 3, IMAGENET_MEAN, IMAGENET_STD,
                 load_imagenet_hdf5, "val"),
}


def _wrap_prefetch(train_loader):
    """Background prefetch of the train batches. MGWFBP_DATA_WORKERS sets
    the pool (default 2; 0 returns the bare loader); MGWFBP_DATA_DEVICE_PUT=1
    also pins each batch in the workers, so that its copy to the card is
    asynchronous (opt-in, as the JAX package's device_put is)."""
    workers = int(os.environ.get("MGWFBP_DATA_WORKERS", "2"))
    if workers <= 0:
        return train_loader
    return PrefetchLoader(
        train_loader, workers=workers,
        pin_memory=os.environ.get("MGWFBP_DATA_DEVICE_PUT", "0") == "1",
    )


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
    num_steps: Optional[int] = None,
    image_hw: Optional[tuple[int, int]] = None,
) -> DataBundle:
    """Sharded train/val loaders; ``batch_size`` is per process.
    ``synthetic=True`` forces the synthetic twin, None looks for files.
    ``augment=False`` leaves the train split normalize-only. ``num_steps``
    overrides the LM window length (default 35), ``image_hw`` the image
    size (real files must store that size)."""
    name = dataset.lower()
    if name == "ptb":
        return _ptb_prepare(data_dir, batch_size, shard, seed, synthetic,
                            num_steps)
    if name == "an4":
        from mgwfbp_tpu_torch.data.audio import an4_prepare

        bundle = an4_prepare(data_dir, batch_size, shard, seed, synthetic)
        bundle.train = _wrap_prefetch(bundle.train)
        return bundle
    if name not in _IMAGES:
        raise ValueError(f"unknown dataset {dataset!r}")
    hw_default, c, mean, std, load, val_split = _IMAGES[name]
    h, w = image_hw or hw_default
    train = val = None
    if not synthetic:
        train = load(data_dir, "train")
        val = load(data_dir, val_split)
    is_synth = train is None or val is None
    if is_synth:
        if synthetic is False:
            raise FileNotFoundError(f"real {name} data not found under {data_dir!r}")
        gen = synthetic_images
        if os.environ.get("MGWFBP_SYNTH_MODE", "easy") == "hard":
            gen = synthetic_images_hard
        nc = 1000 if name == "imagenet" else 10
        train = gen(_synth_size("train", name), (h, w, c), nc, seed)
        val = gen(_synth_size("val", name), (h, w, c), nc, seed + 1)
    elif image_hw is not None and tuple(train.data.shape[1:3]) != tuple(image_hw):
        raise ValueError(
            f"requested image_hw {image_hw} but real {name} files under "
            f"{data_dir!r} store {tuple(train.data.shape[1:3])} images"
        )
    normalize = normalize_images(mean, std)
    train_tf = normalize
    if augment and name == "cifar10":
        from mgwfbp_tpu_torch.data.augment import FusedCropFlipNormalize

        train_tf = FusedCropFlipNormalize(mean, std, pad=4)
    elif augment and name == "imagenet":
        from mgwfbp_tpu_torch.data.augment import chain, train_augment

        train_tf = chain(train_augment(name), normalize)
    train_loader = ShardedLoader(
        train, batch_size, shard, shuffle=True, seed=seed, transform=train_tf,
    )
    val_loader = ShardedLoader(
        val, batch_size, shard, shuffle=False, seed=seed, drop_last=False,
        transform=normalize,
    )
    return DataBundle(
        train=_wrap_prefetch(train_loader),
        val=val_loader,
        num_classes=train.num_classes,
        synthetic=is_synth,
        num_batches_per_epoch=len(train_loader),
    )


def _ptb_prepare(data_dir: str, batch_size: int, shard: ShardInfo, seed: int,
                 synthetic: Optional[bool],
                 num_steps: Optional[int]) -> DataBundle:
    """PTB in the stateful-BPTT layout: one contiguous sub-stream per batch
    element and per rank (``ptb.carry_layout``), no shuffling and no sample
    sharding, so the carry sees textually consecutive windows every step.
    The synthetic sizes are fixed, as in the JAX package (no environment
    override)."""
    nsteps = num_steps or NUM_STEPS
    streams = None
    if not synthetic:
        streams = (load_ptb_stream(data_dir, "train"),
                   load_ptb_stream(data_dir, "valid"))
        if streams[0] is None or streams[1] is None:
            streams = None
    is_synth = streams is None
    if is_synth:
        if synthetic is False:
            raise FileNotFoundError(f"PTB files not found under {data_dir!r}")
        vocab_size = VOCAB_SIZE
        train_stream = synthetic_ptb_stream(_SYNTH_TRAIN["ptb"], seed=seed)
        val_stream = synthetic_ptb_stream(_SYNTH_VAL["ptb"], seed=seed + 1)
    else:
        (train_stream, vocab_size), (val_stream, _) = streams
    train, val = (
        carry_layout(stream, nsteps, batch_size, shard.rank, shard.nranks,
                     vocab_size)
        for stream in (train_stream, val_stream)
    )
    train_loader = ShardedLoader(train, batch_size, shuffle=False, seed=seed)
    return DataBundle(
        train=_wrap_prefetch(train_loader),
        val=ShardedLoader(val, batch_size, shuffle=False, seed=seed),
        num_classes=vocab_size,
        synthetic=is_synth,
        num_batches_per_epoch=len(train_loader),
    )


__all__ = [
    "ArrayDataset",
    "DataBundle",
    "PrefetchLoader",
    "ShardInfo",
    "ShardedLoader",
    "data_prepare",
]
