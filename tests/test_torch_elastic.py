"""Elastic cross-world resume and ``update_nworker`` of the port's trainer,
on the CPU.

  * port to port: a 2-process gloo group (``train_cli`` under the
    supervisor) commits under its ``n2`` tag; a world-1 trainer with
    ``MGWFBP_ELASTIC_RESUME=1`` resumes from it: a ``resize`` event 2 -> 1,
    the committed iteration, parameters, batch statistics and momentum
    equal to the snapshot bit for bit, the LR schedule continued from the
    manifest's anchor (the steps per epoch double at half the world), then
    training to the end with finite losses; and ``n1`` -> ``n2``: a world-1
    run's commit resumed by a supervised 2-process group (``resize`` 1 -> 2
    on both ranks, the first step after the commit, rc 0);
  * from the JAX package: a checkpoint written by a 2-device CPU mesh at
    ``n2`` resumed by the port at world 1 gives the iteration, parameters
    and next-step learning rate of the JAX trainer's own
    ``_resume_cross_world`` at one device;
  * without ``MGWFBP_ELASTIC_RESUME`` a sibling tag is left alone;
  * ``update_nworker``: a no-op at the running world, ``ResizeUnsupported``
    with the supervisor's recipe at any other.

lenet on the synthetic MNIST twin, shrunk to 64 training and 32 validation
images (``MGWFBP_SYNTH_TRAIN_N``) so an epoch is 8 steps at world 2 and 16
at world 1 (batch 4 per worker).
"""

import os

import jax
import numpy as np
import pytest
import torch

from mgwfbp_tpu.config import make_config as jax_make_config
from mgwfbp_tpu.optim.schedules import as_step_fn as jax_as_step_fn
from mgwfbp_tpu.parallel.mesh import MeshSpec, make_mesh
from mgwfbp_tpu.train.trainer import Trainer as JaxTrainer
from mgwfbp_tpu_torch.checkpoint import peek_steps, read_step
from mgwfbp_tpu_torch.config import make_config
from mgwfbp_tpu_torch.convert import flatten_flax, momentum_to_flax, variables_to_flax
from mgwfbp_tpu_torch.runtime import ResizeUnsupported
from mgwfbp_tpu_torch.runtime.supervisor import Supervisor, default_train_cmd
from mgwfbp_tpu_torch.telemetry import events_of, read_events
from mgwfbp_tpu_torch.train import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = {"MGWFBP_SYNTH_TRAIN_N": "64", "MGWFBP_SYNTH_VAL_N": "32"}
KW = dict(batch_size=4, lr=0.05, max_epochs=3, seed=7, lr_schedule="cosine",
          warmup_epochs=1)


@pytest.fixture(autouse=True)
def _small_twin(monkeypatch):
    """Two intra-op threads beside other test workers; the shrunk twin;
    no fault plan."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    for k, v in SYNTH.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("MGWFBP_FAULT_PLAN", raising=False)
    monkeypatch.delenv("MGWFBP_ELASTIC_RESUME", raising=False)
    yield
    torch.set_num_threads(before)


def _cfg(root, **kw):
    base = dict(logdir=str(root / "logs"), checkpoint_dir=str(root / "ckpt"),
                telemetry=True, **KW)
    return make_config("lenet", **{**base, **kw})


def _port(root, **kw) -> Trainer:
    return Trainer(_cfg(root, **kw), device="cpu", synthetic_data=True,
                   profile_backward=False)


def _supervised(root, processes: int) -> Supervisor:
    """``train_cli`` for one more epoch in a gloo group of ``processes``."""
    args = ["--dnn", "lenet", "--synthetic", "--device", "cpu",
            "--epochs", "1", "--no-profile-backward", "--telemetry",
            "--ckpt-every-steps", "3", "--batch-size", "4", "--lr", "0.05",
            "--max-epochs", "3", "--seed", "7", "--lr-schedule", "cosine",
            "--checkpoint-dir", str(root / "ckpt"),
            "--logdir", str(root / "logs")]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               MGWFBP_WARMUP_EPOCHS="1", **SYNTH)
    s = Supervisor(default_train_cmd(args), processes, env=env,
                   log_dir=str(root / f"sup_n{processes}"))
    assert s.run() == 0, open(root / f"sup_n{processes}" / "p0.i0.log").read()
    return s


def _state(t: Trainer) -> dict:
    params, bstats = variables_to_flax(t.model)
    return {**{f"params/{k}": v for k, v in flatten_flax(params).items()},
            **{f"batch_stats/{k}": v for k, v in flatten_flax(bstats).items()},
            **{f"trace/{k}": v for k, v in
               momentum_to_flax(t.model, t.optimizer).items()}}


def _snapshot(ckdir: str, step: int) -> tuple[dict, dict]:
    """The committed step's params, batch statistics and momentum trace
    (``opt.l<j>`` in parameter order), and its manifest's meta."""
    params, bstats, meta = read_step(ckdir, step)
    out = {f"params/{k}": v for k, v in params.items()}
    out.update({f"batch_stats/{k}": v for k, v in bstats.items()})
    pdir = os.path.join(ckdir, "sharded", f"{step:08d}", "p00000")
    for j, k in enumerate(params):
        out[f"trace/{k}"] = np.load(os.path.join(pdir, f"opt.l{j}.npy"))
    return out, meta


def _tag_dir(root, world: int) -> str:
    (name,) = [n for n in os.listdir(root / "ckpt") if f"-n{world}-" in n]
    return str(root / "ckpt" / name)


def test_port_n2_gloo_resumes_at_world_1(tmp_path, monkeypatch):
    _supervised(tmp_path, 2)
    n2 = _tag_dir(tmp_path, 2)
    step = peek_steps(n2)[-1]
    assert step == 8  # one epoch of 64 images at 2 x 4
    want, meta = _snapshot(n2, step)
    assert meta["steps_per_epoch"] == 8
    monkeypatch.setenv("MGWFBP_ELASTIC_RESUME", "1")
    t = _port(tmp_path)
    try:
        assert t.iteration == step and t.start_epoch == 1
        got = _state(t)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        # the schedule continues from epoch 1.0 at the new 16 steps per
        # epoch (without the anchor step 9 would be read as epoch 0.5625)
        assert (t._sched_step_offset, t._sched_epoch_offset) == (8, 1.0)
        assert t.lr_fn(9) == t.epoch_schedule(1.0 + 1 / 16)
        assert t.lr_fn(9) != t.epoch_schedule(9 / 16)
        m = t.fit(1)
        assert t.iteration == 24 and np.isfinite(m["train"]["loss"])
    finally:
        t.close()
    recs = read_events(os.path.join(str(tmp_path / "logs"), t.config.tag(),
                                    "telemetry.jsonl"))
    (resize,) = events_of(recs, "resize")
    assert (resize["old_world"], resize["new_world"]) == (2, 1)
    assert resize["schedule_source"] == "relaunch-reshard"
    assert resize["iteration"] == step and resize["restore_s"] > 0
    assert all(np.isfinite(e["dur_s"]) for e in events_of(recs, "step"))


def test_port_n1_resumed_by_a_gloo_group_at_world_2(tmp_path):
    t = _port(tmp_path)
    try:
        t.fit(1)
        assert t.iteration == 16
    finally:
        t.close()
    s = _supervised(tmp_path, 2)  # MGWFBP_ELASTIC_RESUME=1 from the
    # supervisor
    assert s.results[0].returncodes == [0, 0]
    tag = os.path.basename(_tag_dir(tmp_path, 2))
    for p in (0, 1):
        recs = read_events(str(tmp_path / "logs" / tag /
                               f"telemetry.p{p}.jsonl"))
        (resize,) = events_of(recs, "resize")
        assert (resize["old_world"], resize["new_world"],
                resize["iteration"]) == (1, 2, 16)
        steps = [e["step"] for e in events_of(recs, "step")]
        assert steps[0] == 17 and steps[-1] == 16 + 8
    assert peek_steps(_tag_dir(tmp_path, 2))[-1] == 24


def test_a_sibling_is_ignored_without_elastic_resume(tmp_path, monkeypatch):
    _supervised(tmp_path, 2)
    t = _port(tmp_path)
    try:
        assert t.iteration == 0 and t.start_epoch == 0
    finally:
        t.close()


def test_jax_n2_checkpoint_resumes_in_the_port_as_jax_does(tmp_path,
                                                          monkeypatch):
    jkw = dict(logdir="", checkpoint_dir=str(tmp_path / "ckpt"), **KW)

    def jax_trainer(world: int) -> JaxTrainer:
        return JaxTrainer(
            jax_make_config("lenet", **jkw), synthetic_data=True,
            profile_backward=False,
            mesh=make_mesh(MeshSpec(data=world), devices=jax.devices()[:world]),
        )

    j2 = jax_trainer(2)
    j2.fit(1)
    assert j2.iteration == 8
    j2.close()
    monkeypatch.setenv("MGWFBP_ELASTIC_RESUME", "1")
    j1 = jax_trainer(1)
    t = Trainer(make_config("lenet", **jkw), device="cpu",
                synthetic_data=True, profile_backward=False)
    try:
        assert t.iteration == j1.iteration == 8
        assert t.start_epoch == j1.start_epoch == 1
        assert (t._sched_step_offset, t._sched_epoch_offset) == (
            j1._sched_step_offset, j1._sched_epoch_offset)
        got = flatten_flax(variables_to_flax(t.model)[0])
        want = flatten_flax(jax.tree_util.tree_map(np.asarray,
                                                   j1.state.params))
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        step = int(j1.state.step)
        assert int(t.train_step.step) == step
        jax_lr = float(jax_as_step_fn(
            j1.epoch_schedule, max(j1._steps_per_epoch(), 1),
            j1._sched_step_offset, j1._sched_epoch_offset)(step))
        # float32 (JAX) against float64 (the port) of one cosine value
        np.testing.assert_allclose(t.lr_fn(step), jax_lr, rtol=1e-6)
    finally:
        t.close()
        j1.close()


def test_update_nworker_resizes_only_by_relaunch(tmp_path):
    t = _port(tmp_path, checkpoint_dir="")
    try:
        t.update_nworker(1)  # the running world: nothing to do
        with pytest.raises(ResizeUnsupported) as e:
            t.update_nworker(4)
        assert e.value.nworkers == 4
        assert "mgwfbp_tpu_torch.runtime.supervise --processes <N> " \
               "--resize-to <M>" in str(e.value)
        assert "MGWFBP_ELASTIC_RESUME=1" in str(e.value)
    finally:
        t.close()
