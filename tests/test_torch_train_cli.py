"""The port's trainer end to end on the CPU, and checkpoint interchange
with the JAX package's trainer.

  * ``python -m mgwfbp_tpu_torch.train_cli --dnn resnet20 --synthetic
    --device cpu`` for 1 epoch of 8 batches runs to its JSON result line
    and the loss falls;
  * the step the port's trainer commits (params + batch statistics,
    shard-native, manifest last) reads back equal to its live state, and
    the JAX package's ``Checkpointer`` restores it bit for bit;
  * the port restores a step the JAX trainer committed, bit for bit;
  * without a card the trainer raises instead of moving to the CPU.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgwfbp_tpu.checkpoint import Checkpointer
from mgwfbp_tpu.config import make_config as jax_make_config
from mgwfbp_tpu.models import create_model as jax_create_model
from mgwfbp_tpu.optim import make_optimizer as jax_make_optimizer
from mgwfbp_tpu.parallel.mesh import MeshSpec, make_mesh
from mgwfbp_tpu.train.step import create_train_state
from mgwfbp_tpu.train.trainer import Trainer as JaxTrainer
from mgwfbp_tpu_torch import models
from mgwfbp_tpu_torch.checkpoint import read_step
from mgwfbp_tpu_torch.config import make_config
from mgwfbp_tpu_torch.convert import flatten_flax, state_from_flax, variables_to_flax
from mgwfbp_tpu_torch.train import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs beside other test workers: two intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_cli_trains_resnet20_on_the_cpu(tmp_path):
    ckpt = tmp_path / "ckpt"
    # two intra-op threads: the suite runs beside other test workers
    env = dict(os.environ, PYTHONPATH=ROOT, MGWFBP_LOG_INTERVAL="4",
               OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "mgwfbp_tpu_torch.train_cli", "--dnn",
         "resnet20", "--synthetic", "--device", "cpu", "--epochs", "1",
         "--num-batches-per-epoch", "8", "--logdir", str(tmp_path / "logs"),
         "--checkpoint-dir", str(ckpt)],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env=env,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    doc = json.loads(res.stdout.strip().splitlines()[-1])
    train, ev = doc["train"], doc["eval"]
    assert np.isfinite([train["loss"], train["first_loss"], ev["loss"]]).all()
    assert train["loss"] < train["first_loss"]
    assert ev["count"] == 512.0 and 0.0 <= ev["top1"] <= ev["top5"] <= 1.0
    assert "single device: skipping merged-allreduce" in res.stderr
    # the committed step: 8 optimizer steps, restorable by the JAX package
    (tag,) = os.listdir(ckpt)
    assert tag == "resnet20-cifar10-n1-bs32-lr0.1-auto-th0-s0"
    params, bstats, meta = read_step(str(ckpt / tag), 8)
    assert meta["iteration"] == 8 and meta["epoch"] == 0
    jm, _ = jax_create_model("resnet20")
    tx, _ = jax_make_optimizer(0.1)
    target = create_train_state(jax.random.PRNGKey(0), jm,
                                jnp.zeros((1, 32, 32, 3)), tx)
    snap = Checkpointer(str(ckpt / tag)).restore(target, step=8)
    assert snap is not None and snap.iteration == 8
    for got, want in ((snap.state.params, params),
                      (snap.state.batch_stats, bstats)):
        got = flatten_flax(jax.tree_util.tree_map(np.asarray, got))
        assert list(got) == list(want)
        assert all(np.array_equal(got[k], want[k]) for k in want)


def test_cli_two_processes_over_gloo(tmp_path):
    """Two CLI processes form a gloo world from the launch flags: rank 0's
    weights and measured tb are broadcast, both solve the same mgwfbp
    schedule, and the metrics they print (averaged across ranks) agree."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "mgwfbp_tpu_torch.train_cli", "--dnn",
             "resnet20", "--synthetic", "--device", "cpu", "--epochs", "1",
             "--num-batches-per-epoch", "3", "--batch-size", "8",
             "--policy", "mgwfbp", "--connection", "10GbE",
             "--logdir", str(tmp_path / f"logs{r}"),
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
             "--process-id", str(r)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=str(tmp_path), env=env,
        )
        for r in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            outs.append((out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    docs = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    assert docs[0] == docs[1]
    assert docs[0]["eval"]["count"] == 512.0  # 256 per rank, summed
    for _, err in outs:
        assert "merge schedule:" in err and "source=hooks" in err


def test_committed_step_reads_back_equal_to_live_state(tmp_path):
    cfg = make_config("resnet20", batch_size=4, num_batches_per_epoch=2,
                      checkpoint_dir=str(tmp_path), logdir=str(tmp_path))
    tr = Trainer(cfg, device="cpu", synthetic_data=True)
    tr.train_epoch(0)
    step_dir = tr.save_step(0, 2)
    assert step_dir.endswith("sharded/00000002")
    params, bstats, meta = read_step(tr.ckpt_dir, 2)
    assert meta["mid_epoch"] and meta["train_step"] == 2
    live_p, live_b = variables_to_flax(tr.model)
    for live, saved in ((live_p, params), (live_b, bstats)):
        live = flatten_flax(live)
        assert list(live) == list(saved)
        assert all(np.array_equal(live[k], saved[k]) for k in live)
    assert len(tr.losses) == 2 and tr.train_step.step == 2


def test_port_restores_a_step_the_jax_trainer_committed(tmp_path):
    cfg = jax_make_config("resnet20", checkpoint_dir=str(tmp_path / "ckpt"),
                          logdir=str(tmp_path), batch_size=4,
                          num_batches_per_epoch=1)
    mesh = make_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    jt = JaxTrainer(cfg, mesh=mesh, profile_backward=False,
                    synthetic_data=True)
    try:
        jt.save(0)
        jt.checkpointer.wait()
        tag_dir = os.path.join(str(tmp_path / "ckpt"), cfg.tag())
        want_p = flatten_flax(jax.tree_util.tree_map(np.asarray,
                                                     jt.state.params))
        want_b = flatten_flax(jax.tree_util.tree_map(np.asarray,
                                                     jt.state.batch_stats))
    finally:
        jt.close()
    params, bstats, _ = read_step(tag_dir, 0)
    module, _ = models.create_model("resnet20")
    module.load_state_dict(state_from_flax(module, params, bstats), strict=True)
    got_p, got_b = variables_to_flax(module)
    for got, want in ((got_p, want_p), (got_b, want_b)):
        got = flatten_flax(got)
        assert list(got) == list(want)
        assert all(np.array_equal(got[k], want[k]) for k in want)


def test_trainer_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(make_config("resnet20"), synthetic_data=True)
