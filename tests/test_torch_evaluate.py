"""The port's offline evaluator (``mgwfbp_tpu_torch.evaluate``) on the CPU.

  * on a checkpoint the JAX trainer committed, the port's ``evaluate``
    equals the JAX package's ``evaluate`` (both at one device): loss
    within the cross-program bound (rtol 2e-5, atol 1e-6), the same count,
    and top-1 / top-5 within one sample (an argmax may flip on a near tie)
    or the perplexity within rtol 2e-5, for a narrow ResNet-20 and the
    small LSTM;
  * on the port's own run, ``evaluate`` equals the trainer's evaluation
    at the end of the run, and ``--all-epochs`` reports every boundary;
  * ``model_average_evaluate`` of one run twice equals that run;
  * ``lstman4``'s WER evaluation is ported: with no checkpoint to read,
    the evaluator says "no checkpoint under".
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgwfbp_tpu import evaluate as jax_evaluate
from mgwfbp_tpu import models as jzoo
from mgwfbp_tpu.config import make_config as jax_make_config
from mgwfbp_tpu.models import ModelMeta as JaxMeta
from mgwfbp_tpu.parallel import mesh as jax_mesh
from mgwfbp_tpu.train import trainer as jax_trainer_mod
from mgwfbp_tpu_torch import evaluate as port_evaluate
from mgwfbp_tpu_torch import models as pzoo
from mgwfbp_tpu_torch.config import make_config
from mgwfbp_tpu_torch.models import ModelMeta
from mgwfbp_tpu_torch.train import Trainer

RTOL, ATOL = 2e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs beside other test workers: two intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def narrow(monkeypatch, tmp_path):
    """Narrow resnet20 and lstm in both registries, and the JAX trainer's
    default mesh at one device (the port evaluates at one)."""
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
    # the JAX evaluator's trainer logs under ./logs
    monkeypatch.chdir(tmp_path)


def _kw(name: str) -> dict:
    kw = dict(num_batches_per_epoch=3, seed=4, logdir="")
    kw.update(batch_size=2, lr=1.0) if name == "lstm" else kw.update(
        batch_size=4, lr=0.05)
    return kw


def _close_metrics(got: dict, want: dict) -> None:
    assert got["count"] == want["count"] > 0
    assert got["loss"] == pytest.approx(want["loss"], rel=RTOL, abs=ATOL)
    if "perplexity" in want:
        assert got["perplexity"] == pytest.approx(want["perplexity"],
                                                  rel=RTOL)
    else:
        for k in ("top1", "top5"):
            assert abs(got[k] - want[k]) <= 1.0 / want["count"] + 1e-12


@pytest.mark.parametrize("name", ["resnet20", "lstm"])
def test_evaluate_on_a_jax_checkpoint_equals_jax_evaluate(narrow, tmp_path,
                                                          name):
    cfg = jax_make_config(name, checkpoint_dir=str(tmp_path), **_kw(name))
    jt = jax_trainer_mod.Trainer(cfg, profile_backward=False,
                                 synthetic_data=True)
    jt.fit(1)
    jt.checkpointer.wait()
    root = os.path.join(str(tmp_path), cfg.tag())
    jt.close()
    bs = _kw(name)["batch_size"]
    want = jax_evaluate.evaluate(name, root, synthetic=True, batch_size=bs)
    got = port_evaluate.evaluate(name, root, synthetic=True, batch_size=bs,
                                 device="cpu")
    assert got["epoch"] == want["epoch"] == 0
    _close_metrics(got, want)


def test_evaluate_equals_the_trainers_own_and_all_epochs(narrow, tmp_path,
                                                         capsys):
    cfg = make_config("lstm", checkpoint_dir=str(tmp_path), **_kw("lstm"))
    t = Trainer(cfg, device="cpu", synthetic_data=True)
    metrics = t.fit(2)
    root = t.ckpt_dir
    t.close()
    # the synthetic validation text is drawn from the seed: evaluate with
    # the run's
    got = port_evaluate.evaluate("lstm", root, synthetic=True, batch_size=2,
                                 seed=4, device="cpu")
    assert got["epoch"] == 1
    assert got["perplexity"] == pytest.approx(
        metrics["eval"]["perplexity"], rel=1e-6)
    assert port_evaluate.main(["--dnn", "lstm", "--checkpoint-dir", root,
                               "--synthetic", "--batch-size", "2",
                               "--device", "cpu", "--all-epochs"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["epoch"] for x in lines[:-1]] == [0, 1]
    assert set(lines[-1]["best"]) == {"perplexity", "epoch"}
    avg = port_evaluate.model_average_evaluate(
        "lstm", [root, root], synthetic=True, batch_size=2, seed=4,
        device="cpu")
    assert avg["averaged_over"] == 2
    assert avg["perplexity"] == pytest.approx(got["perplexity"], rel=1e-6)


def test_wer_evaluation_reports_no_checkpoint_under():
    """lstman4's WER evaluation is ported: the evaluator builds the speech
    model's trainer and, with no checkpoint to read, says so."""
    with pytest.raises(FileNotFoundError, match="no checkpoint under"):
        port_evaluate.evaluate("lstman4", "/nonexistent", device="cpu",
                               synthetic=True, batch_size=4)
