"""Port vs reference: the data path (mgwfbp_tpu_torch.data vs
mgwfbp_tpu.data). For the same seed, rank and epoch the port's CIFAR-10
loaders hand over batches BIT-IDENTICAL to the JAX package's: the synthetic
twin, the epoch permutation and its rank slice, the crop/flip draws and
the float32 normalization."""

import numpy as np
import pytest

from mgwfbp_tpu.data import ShardInfo as JaxShardInfo
from mgwfbp_tpu.data import data_prepare as jax_data_prepare
from mgwfbp_tpu.data.datasets import synthetic_images_hard as jax_hard
from mgwfbp_tpu_torch.data import ShardInfo, data_prepare
from mgwfbp_tpu_torch.data.datasets import synthetic_images_hard


def _batches(loader, epoch, n):
    loader.set_epoch(epoch)
    out = []
    for i, (x, y) in enumerate(loader):
        if i == n:
            break
        out.append((np.asarray(x), np.asarray(y)))
    return out


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("rank", [0, 1])
def test_loader_batches_bit_identical(seed, rank):
    kw = dict(batch_size=8, seed=seed, synthetic=True, augment=True)
    want = jax_data_prepare("cifar10", shard=JaxShardInfo(rank, 2), **kw)
    got = data_prepare("cifar10", shard=ShardInfo(rank, 2), **kw)
    assert got.num_batches_per_epoch == want.num_batches_per_epoch == 256
    assert got.num_classes == want.num_classes and got.synthetic
    for epoch in (0, 1):
        for (gx, gy), (wx, wy) in zip(_batches(got.train, epoch, 3),
                                      _batches(want.train, epoch, 3)):
            assert gx.dtype == wx.dtype == np.float32
            assert gx.shape == (8, 32, 32, 3)
            assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
    val_got, val_want = list(got.val), list(want.val)
    assert len(val_got) == len(val_want) == 32
    for (gx, gy), (wx, wy) in zip(val_got, val_want):
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)


def test_unaugmented_and_hard_twins_bit_identical():
    kw = dict(batch_size=4, seed=1, synthetic=True, augment=False)
    got = data_prepare("cifar10", shard=ShardInfo(0, 1), **kw)
    want = jax_data_prepare("cifar10", shard=JaxShardInfo(0, 1), **kw)
    (gx, gy), = _batches(got.train, 2, 1)
    (wx, wy), = _batches(want.train, 2, 1)
    assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
    a, b = synthetic_images_hard(16, (32, 32, 3), 10, seed=5), jax_hard(
        16, (32, 32, 3), 10, seed=5
    )
    assert np.array_equal(a.data, b.data) and np.array_equal(a.labels, b.labels)
    with pytest.raises(ValueError, match="not ported"):
        data_prepare("imagenet", synthetic=True)
