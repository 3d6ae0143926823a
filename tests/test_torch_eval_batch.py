"""``MGWFBP_EVAL_BATCH`` in the port against the JAX package: the trainer
sets the validation loader's batch apart from the training batch, for
carry-free models only (a carry's batch is its layout), through the
loaders' ``set_batch_size`` (``ShardedLoader``, ``PrefetchLoader``, the
speech model's ``AudioBatchLoader``).

On a narrow ResNet-20 and synthetic CIFAR-10 (the same bytes in both
packages), with the JAX trainer's weights installed in the port's: the
evaluation at an eval batch of 96 (512 validation samples: five full
batches and a tail of 32) has the JAX evaluation's count and its loss
within 1e-5, and equals the port's own evaluation at the training batch
within 1e-5 (the mean does not depend on the batching). The narrow LSTM
keeps its batch. The loaders re-batch as the JAX loaders do."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgwfbp_tpu import models as jzoo
from mgwfbp_tpu.config import make_config as jax_make_config
from mgwfbp_tpu.data import audio as jax_audio
from mgwfbp_tpu.data import loader as jax_loader
from mgwfbp_tpu.models import ModelMeta as JaxMeta
from mgwfbp_tpu.parallel import mesh as jax_mesh
from mgwfbp_tpu.train import trainer as jax_trainer_mod
from mgwfbp_tpu_torch import models as pzoo
from mgwfbp_tpu_torch.config import make_config
from mgwfbp_tpu_torch.convert import state_from_flax
from mgwfbp_tpu_torch.data import audio
from mgwfbp_tpu_torch.data.loader import (
    ArrayDataset,
    PrefetchLoader,
    ShardedLoader,
)
from mgwfbp_tpu_torch.models import ModelMeta
from mgwfbp_tpu_torch.train import Trainer

TOL = 1e-5
EVAL_BATCH = 96


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def narrow(monkeypatch, tmp_path):
    """Narrow resnet20 and lstm in both registries, the JAX trainer's mesh
    at one device (the port evaluates at one), no fault plan."""
    from mgwfbp_tpu.models.lstm import PTBLSTM as JaxLSTM
    from mgwfbp_tpu.models.resnet_cifar import CifarResNet as JaxResNet
    from mgwfbp_tpu_torch.models.lstm import PTBLSTM
    from mgwfbp_tpu_torch.models.resnet_cifar import CifarResNet

    monkeypatch.setitem(jzoo._REGISTRY, "resnet20", lambda nc: (
        JaxResNet(depth=8, widths=(4, 8, 16), num_classes=nc or 10),
        JaxMeta("resnet20", "cifar10", nc or 10, (32, 32, 3))))
    monkeypatch.setitem(jzoo._REGISTRY, "lstm", lambda nc: (
        JaxLSTM(vocab_size=nc or 10000, hidden_size=16, num_layers=1,
                dropout=0.0),
        JaxMeta("lstm", "ptb", nc or 10000, (35,), input_dtype=jnp.int32,
                task="lm", has_carry=True)))
    monkeypatch.setitem(pzoo._REGISTRY, "resnet20", lambda nc: (
        CifarResNet(depth=8, widths=(4, 8, 16), num_classes=nc or 10),
        ModelMeta("resnet20", "cifar10", nc or 10, (32, 32, 3))))
    monkeypatch.setitem(pzoo._REGISTRY, "lstm", lambda nc: (
        PTBLSTM(nc or 10000, 16, 1, 0.0),
        ModelMeta("lstm", "ptb", nc or 10000, (35,), input_dtype=np.int32,
                  task="lm", has_carry=True)))
    one = jax_mesh.make_mesh(jax_mesh.MeshSpec(data=1),
                             devices=jax.devices()[:1])
    monkeypatch.setattr(jax_trainer_mod, "make_mesh", lambda spec: one)
    monkeypatch.delenv("MGWFBP_FAULT_PLAN", raising=False)
    monkeypatch.chdir(tmp_path)


def _kw(tmp_path, name):
    kw = dict(num_batches_per_epoch=2, seed=4, logdir=str(tmp_path),
              checkpoint_dir=None, max_epochs=1)
    kw.update(batch_size=2, lr=1.0) if name == "lstm" else kw.update(
        batch_size=4, lr=0.05)
    return kw


def _trainers(tmp_path, name):
    jt = jax_trainer_mod.Trainer(
        jax_make_config(name, **_kw(tmp_path / "jax", name)),
        synthetic_data=True, profile_backward=False)
    pt = Trainer(make_config(name, **_kw(tmp_path / "port", name)),
                 device="cpu", synthetic_data=True, profile_backward=False)
    params = jax.tree_util.tree_map(np.asarray, jt.state.params)
    bstats = jax.tree_util.tree_map(np.asarray, jt.state.batch_stats)
    pt.model.load_state_dict(state_from_flax(pt.model, params, bstats),
                             strict=True)
    return jt, pt


def test_eval_batch_gives_the_jax_count_and_mean(narrow, tmp_path,
                                                 monkeypatch):
    monkeypatch.setenv("MGWFBP_EVAL_BATCH", str(EVAL_BATCH))
    jt, pt = _trainers(tmp_path, "resnet20")
    try:
        assert jt.bundle.val.batch_size == EVAL_BATCH
        assert pt.bundle.val.batch_size == EVAL_BATCH
        assert pt.bundle.train.batch_size == 4
        assert len(pt.bundle.val) == len(jt.bundle.val) == 6
        want, got = jt.evaluate(), pt.evaluate()
        assert got["count"] == want["count"] == 512
        assert got["loss"] == pytest.approx(want["loss"], rel=TOL)
        for k in ("top1", "top5"):  # an argmax may flip on a near tie
            assert abs(got[k] - want[k]) * got["count"] <= 1.0 + 1e-9
        # the same mean at the training batch
        pt.bundle.val.set_batch_size(4)
        assert len(pt.bundle.val) == 128
        again = pt.evaluate()
        assert again["count"] == got["count"]
        assert again["loss"] == pytest.approx(got["loss"], rel=TOL)
    finally:
        jt.close()
        pt.close()


def test_a_carry_model_keeps_its_eval_batch(narrow, tmp_path, monkeypatch):
    monkeypatch.setenv("MGWFBP_EVAL_BATCH", str(EVAL_BATCH))
    jt, pt = _trainers(tmp_path, "lstm")
    try:
        assert pt.meta.has_carry
        assert pt.bundle.val.batch_size == jt.bundle.val.batch_size == 2
    finally:
        jt.close()
        pt.close()


def test_loaders_rebatch_as_the_jax_loaders():
    rs = np.random.RandomState(0)
    data = rs.randn(50, 3).astype(np.float32)
    labels = rs.randint(0, 4, 50)
    ours = ShardedLoader(ArrayDataset(data, labels, 4), 8, shuffle=False,
                         drop_last=False)
    theirs = jax_loader.ShardedLoader(
        jax_loader.ArrayDataset(data, labels, 4), 8, shuffle=False,
        drop_last=False)
    wrapped = PrefetchLoader(ours, workers=2)
    wrapped.set_batch_size(12)
    theirs.set_batch_size(12)
    assert wrapped.batch_size == ours.batch_size == 12
    got, want = list(wrapped), list(theirs)
    assert len(got) == len(want) == 5
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(gx), np.asarray(wx))
        np.testing.assert_array_equal(np.asarray(gy), np.asarray(wy))
    for loader in (ours, wrapped):
        with pytest.raises(ValueError, match="positive"):
            loader.set_batch_size(0)


def test_audio_loader_rebatches_as_the_jax_loader():
    rs = np.random.RandomState(1)
    feats, labels = [], []
    for i in range(13):
        t = int(rs.randint(20, 60))
        feats.append(rs.randn(t, 161).astype(np.float32))
        labels.append(rs.randint(1, 29, int(rs.randint(2, 8))).astype(
            np.int32))

    def utts(mod):
        return [mod.Utterance(spect=f, labels=lab)
                for f, lab in zip(feats, labels)]

    ours = audio.AudioBatchLoader(utts(audio), 3, seed=2)
    theirs = jax_audio.AudioBatchLoader(utts(jax_audio), 3, seed=2)
    for size in (5, 100):
        ours.set_batch_size(size)
        theirs.set_batch_size(size)
        assert ours.batch_size == theirs.batch_size == min(size, 13)
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]))
