"""The port's AN4 tools (``mgwfbp_tpu_torch/tools/an4_report.py`` and
``an4_trainmode_wer.py``) against the JAX package's ``tools/an4_report.py``
and ``tools/an4_trainmode_wer.py`` on the same inputs.

  * ``an4_report`` on a fixed ``train.log`` of the port trainer's eval lines
    gives the JAX tool's trajectory and summary, written to a ``tmp_path``
    artifact (the one difference: ``log`` is relative to the artifact's
    directory, where the JAX tool makes it relative to the repo root); the
    JAX package's ``profiles/an4_real_audio.json`` is left as it is;
  * ``an4_trainmode_wer`` on a small DeepSpeech (both registries patched to
    hidden 32, 2 layers) committed by the port's trainer on the real
    utterances of ``data/an4_memcheck``: the same train-mode WER, utterance
    count, epoch and decoded strings as the JAX tool on the same checkpoint
    (the shard-native format both packages read). The JAX tool runs in a
    subprocess with one CPU device, the device count the port runs at;
  * without a card, the port tool's default ``--device cuda`` fails.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import an4_report as jax_an4_report
from mgwfbp_tpu_torch import models
from mgwfbp_tpu_torch.config import make_config
from mgwfbp_tpu_torch.models.deepspeech import DeepSpeech
from mgwfbp_tpu_torch.tools import an4_report, an4_trainmode_wer
from mgwfbp_tpu_torch.train import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEMCHECK = os.path.join(ROOT, "data", "an4_memcheck")
JAX_ARTIFACT = os.path.join(ROOT, "profiles", "an4_real_audio.json")
SMALL_H, SMALL_LAYERS = 32, 2


def _eval_line(epoch: int, metrics: dict) -> str:
    """One eval line as the port trainer logs it (``Trainer.fit``)."""
    body = ", ".join(f"{k} {v:.4f}" for k, v in metrics.items())
    return f"2026-10-18 10:00:00 INFO mgwfbp: epoch {epoch} eval: {body}\n"


def _same(a, b) -> bool:
    """Equal as JSON (a NaN row equals a NaN row)."""
    return json.dumps(a) == json.dumps(b)


def test_an4_report_gives_the_jax_tools_trajectory(tmp_path, capsys):
    log = tmp_path / "logs" / "train.log"
    log.parent.mkdir()
    rows = [(242.2308, 1.0), (83.7092, 1.0192), (40.1, 0.45),
            (float("nan"), float("nan")), (12.5, 0.3125), (1e-5, 0.25)]
    with open(log, "w") as f:
        for epoch, (loss, w) in enumerate(rows):
            f.write(_eval_line(epoch, {"loss": loss, "count": 44.0,
                                       "wer": w}))
            f.write("noise line\n")
    parsed = an4_report.parse_log(str(log))
    assert _same(parsed, jax_an4_report.parse_log(str(log)))
    assert [r["epoch"] for r in parsed] == list(range(len(rows)))
    for stride in (0, 2, 10):
        assert _same(an4_report.summarize(parsed, stride),
                     jax_an4_report.summarize(parsed, stride))
    with open(JAX_ARTIFACT, "rb") as f:
        jax_artifact = f.read()
    args = ["--log", str(log), "--label", "cpu run", "--stride", "2",
            "--val-wer", "0.5"]
    assert jax_an4_report.main(args) == 0
    want = json.loads(capsys.readouterr().out)
    art = tmp_path / "out" / "an4.json"
    art.parent.mkdir()
    assert an4_report.main(args + ["--artifact", str(art), "--save"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert want.pop("log") == os.path.relpath(str(log), ROOT)
    assert got.pop("log") == os.path.join("..", "logs", "train.log")
    assert _same(got, want)
    assert json.loads(art.read_text())["memorization_run"]["evals"] == 6
    assert an4_report.main(args + ["--artifact", str(art), "--key", "b",
                                   "--save"]) == 0
    capsys.readouterr()
    assert sorted(json.loads(art.read_text())) == ["b", "memorization_run"]
    with open(JAX_ARTIFACT, "rb") as f:
        assert f.read() == jax_artifact  # the JAX artifact is untouched
    with pytest.raises(SystemExit):
        an4_report.main(["--log", str(log), "--label", "x"])  # no artifact
    capsys.readouterr()


@pytest.fixture
def small_lstman4(monkeypatch):
    monkeypatch.delenv("MGWFBP_FAULT_PLAN", raising=False)

    def port(nc=None, hwc=None):
        nc = nc or 29
        return (DeepSpeech(num_classes=nc, hidden_size=SMALL_H,
                           num_layers=SMALL_LAYERS),
                models.ModelMeta("lstman4", "an4", nc, (201, 161),
                                 task="ctc"))

    monkeypatch.setitem(models._REGISTRY, "lstman4", port)


# the JAX tool in a process of its own at one CPU device, with its
# registry's lstman4 at the small width
_JAX_TOOL = f"""
import sys
sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, "tools")!r}]
import jax
jax.config.update("jax_platforms", "cpu")
import mgwfbp_tpu.models as jm
from mgwfbp_tpu.models import ModelMeta
from mgwfbp_tpu.models.deepspeech import DeepSpeech

def small(nc=None):
    nc = nc or 29
    return (DeepSpeech(num_classes=nc, hidden_size={SMALL_H},
                       num_layers={SMALL_LAYERS}),
            ModelMeta("lstman4", "an4", nc, (201, 161), task="ctc"))

jm._REGISTRY["lstman4"] = small
import an4_trainmode_wer
sys.exit(an4_trainmode_wer.main(sys.argv[1:]))
"""


def test_an4_trainmode_wer_matches_the_jax_tool(tmp_path, small_lstman4,
                                                 capsys):
    cfg = make_config("lstman4", logdir="", data_dir=MEMCHECK,
                      checkpoint_dir=str(tmp_path / "ckpt"),
                      num_batches_per_epoch=3, batch_size=4, lr=0.01, seed=2,
                      max_epochs=1)
    t = Trainer(cfg, device="cpu")
    try:
        t.fit(1)
        ckpt_dir = t.ckpt_dir
    finally:
        t.close()
    args = ["--checkpoint-dir", ckpt_dir, "--data-dir", MEMCHECK]
    assert an4_trainmode_wer.main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    proc = subprocess.run([sys.executable, "-c", _JAX_TOOL, *args],
                          capture_output=True, text=True, env=env,
                          cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout[proc.stdout.index("{"):])
    assert got["utterances"] == want["utterances"] == 44
    assert got["epoch"] == want["epoch"] == 0
    assert got["samples"] == want["samples"] and len(got["samples"]) == 5
    assert got["train_mode_wer"] == want["train_mode_wer"]
    assert np.isfinite(got["train_mode_wer"])


def test_an4_trainmode_wer_needs_a_card_by_default(tmp_path, small_lstman4):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    with pytest.raises(RuntimeError):
        an4_trainmode_wer.main(["--checkpoint-dir", str(tmp_path),
                                "--data-dir", MEMCHECK])
