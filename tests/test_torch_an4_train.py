"""Port vs reference: the speech model on the training path (the ctc form of
mgwfbp_tpu_torch.train.step.TrainStep, the trainer's ctc batches and WER
evaluation, checkpoints, the evaluator, the CLI, serving's refusal, vs
mgwfbp_tpu).

  * one ctc ``TrainStep`` of a small DeepSpeech (hidden 24, 2 layers) with
    the an4 preset's optimizer (momentum SGD, ``anneal``, norm clip 400)
    against ``make_train_step`` on a 1-device JAX mesh, at nsteps_update 1
    and 2: parameters and batch statistics after 1 step within the TRAJ_*
    bounds of tests/test_torch_train_dist.py, after 3 steps within DRIFT_*
    (below);
  * the same at 2 gloo ranks (the mgwfbp merged all-reduce from hooks)
    against a 2-device JAX mesh, the replicas bit-identical;
  * the trainer at a small width (both packages' registries patched to
    hidden 32, 2 layers) on the real utterances of data/an4_memcheck: it
    trains, evaluates a finite CTC loss and a WER, and commits; the JAX
    package restores that step and its trainer's evaluation gives the same
    loss (EVAL_RTOL) and WER; a JAX step restores in the port; the offline
    evaluator's WER and loss equal the trainer's; the CLI prints them;
  * serving refuses the registered model, as the JAX package does.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgwfbp_tpu.models as jax_models
from mgwfbp_tpu.checkpoint import Checkpointer as JaxCheckpointer
from mgwfbp_tpu.config import make_config as jax_make_config
from mgwfbp_tpu.models import ModelMeta as JaxMeta
from mgwfbp_tpu.models.deepspeech import DeepSpeech as JaxDeepSpeech
from mgwfbp_tpu.optim import make_optimizer as jax_make_optimizer
from mgwfbp_tpu.parallel.allreduce import make_merged_allreduce as jax_reducer
from mgwfbp_tpu.parallel.costmodel import lookup_alpha_beta as jax_lookup
from mgwfbp_tpu.parallel.mesh import MeshSpec, make_mesh
from mgwfbp_tpu.serving import model as jax_serving
from mgwfbp_tpu.train.step import TrainState, make_train_step
from mgwfbp_tpu.train.trainer import Trainer as JaxTrainer
from mgwfbp_tpu_torch import evaluate as port_evaluate
from mgwfbp_tpu_torch import models, train_cli
from mgwfbp_tpu_torch.config import make_config
from mgwfbp_tpu_torch.convert import (
    flatten_flax,
    momentum_to_flax,
    state_from_flax,
    variables_to_flax,
)
from mgwfbp_tpu_torch.data import audio
from mgwfbp_tpu_torch.models.common import init_weights
from mgwfbp_tpu_torch.models.deepspeech import DeepSpeech
from mgwfbp_tpu_torch.optim import make_optimizer, scaled_clip_threshold
from mgwfbp_tpu_torch.serving.model import ServingModel
from mgwfbp_tpu_torch.train import Trainer, TrainStep

from test_torch_train_dist import TRAJ_ATOL, TRAJ_RTOL, _spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEMCHECK = os.path.join(ROOT, "data", "an4_memcheck")
H, LAYERS, B, STEPS = 24, 2, 2, 3  # the step tests' model, per-rank batch
OPT = dict(lr=2e-4, norm_clip=400.0, batches_per_epoch=4)
EVAL_RTOL = 1e-5  # the two packages' eval loss over the val set
# after 3 steps, relative to max(1, the leaf's largest magnitude): float32
# rounding of the LSTM's backward through ~100 frames (the JAX package's own
# float32 LSTM gradients drift from float64, ROADMAP Queue 3) compounds over
# the momentum steps; measured at most 2.5e-5 on the params (MaskConv's
# second conv kernel) and 1.4e-4 on the batch statistics (the batch norm
# after it), at nsteps_update 2
DRIFT_PARAMS, DRIFT_BSTATS = 1e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs beside other test workers: two intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _small_model(seed: int = 4):
    m = DeepSpeech(hidden_size=H, num_layers=LAYERS)
    return init_weights(m, torch.Generator().manual_seed(seed))


def _batches(world: int, n: int) -> dict:
    """STEPS global ctc batches of n micro-steps x world * B utterances of
    the synthetic twin (unequal lengths), as arrays (STEPS, n, world*B, ...)."""
    rows = world * B
    loader = audio.AudioBatchLoader(audio.synthetic_an4(64, seed=9), rows,
                                    seed=1)
    out = {k: [] for k in ("x", "y", "ilen", "llen")}
    for k in range(STEPS):
        got = [loader.load_batch(0, k * n + i) for i in range(n)]
        for key, field in (("x", "x"), ("y", "y"), ("ilen", "input_lengths"),
                           ("llen", "label_lengths")):
            out[key].append(np.stack([g[field] for g in got]))
    return {k: np.stack(v) for k, v in out.items()}


def _jax_run(params, bstats, batches, world: int, n: int) -> dict:
    jm = JaxDeepSpeech(hidden_size=H, num_layers=LAYERS)
    meta = JaxMeta("lstman4", "an4", 29, (batches["x"].shape[3], 161),
                   task="ctc")
    tx, _ = jax_make_optimizer(
        OPT["lr"], momentum=0.9, weight_decay=1e-4, lr_schedule="anneal",
        dataset="an4", max_epochs=100,
        num_batches_per_epoch=OPT["batches_per_epoch"],
        norm_clip=OPT["norm_clip"], world_size=world,
    )
    mesh = make_mesh(MeshSpec(data=world), devices=jax.devices()[:world])
    reducer = (jax_reducer(params, axis_name="data", policy="mgwfbp",
                           cost_model=jax_lookup("10GbE", world))
               if world > 1 else None)
    step = make_train_step(jm, meta, tx, mesh, reducer, nsteps_update=n,
                           donate=False)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=bstats, opt_state=tx.init(params),
                       rng=jax.random.PRNGKey(0))
    saved = {}
    for k in range(STEPS):
        state, _ = step(state, {
            "x": batches["x"][k], "y": batches["y"][k],
            "input_lengths": batches["ilen"][k],
            "label_lengths": batches["llen"][k]})
        if k + 1 in (1, 3):
            saved[k + 1] = state
    return saved


def _assert_state_close(got: dict, state, what: str) -> None:
    """After 1 step within TRAJ_RTOL / TRAJ_ATOL, later within DRIFT_*."""
    after = int(state.step)
    assert int(got["step"]) == after, what
    for part, tree in (("params", state.params),
                       ("bstats", state.batch_stats)):
        for k, w in flatten_flax(_np(tree)).items():
            g = got[f"{part}/{k}"]
            if after == 1:
                np.testing.assert_allclose(g, w, rtol=TRAJ_RTOL,
                                           atol=TRAJ_ATOL,
                                           err_msg=f"{what} {k}")
                continue
            bound = DRIFT_PARAMS if part == "params" else DRIFT_BSTATS
            err = float(np.abs(g - w).max()) / max(1.0, float(np.abs(w).max()))
            assert err <= bound, f"{what} {k}: {err:.3e} > {bound:.0e}"


def _port_state(model, step) -> dict:
    params, bstats = variables_to_flax(model)
    out = {f"params/{k}": v for k, v in flatten_flax(params).items()}
    out.update({f"bstats/{k}": v for k, v in flatten_flax(bstats).items()})
    out["step"] = step.step
    return out


@pytest.mark.parametrize("n", [1, 2])
def test_ctc_step_matches_jax_one_device_mesh(n):
    model = _small_model()
    params, bstats = variables_to_flax(model)
    batches = _batches(1, n)
    want = _jax_run(params, bstats, batches, 1, n)
    opt, lr_fn, _ = make_optimizer(
        model.parameters(), OPT["lr"], momentum=0.9, weight_decay=1e-4,
        lr_schedule="anneal", dataset="an4", max_epochs=100,
        num_batches_per_epoch=OPT["batches_per_epoch"])
    step = TrainStep(model, opt, lr_fn, nsteps_update=n, task="ctc",
                     norm_clip=scaled_clip_threshold(OPT["norm_clip"], 1))
    with pytest.raises(ValueError, match="lengths"):
        step(torch.from_numpy(batches["x"][0]),
             torch.from_numpy(batches["y"][0]))
    for k in range(STEPS):
        m = step(*(torch.from_numpy(batches[f][k]) for f in ("x", "y")),
                 lengths=(torch.from_numpy(batches["ilen"][k]),
                          torch.from_numpy(batches["llen"][k])))
        assert np.isfinite(m["loss"]) and m["grads_nonfinite"] == 0
        assert set(m) == {"loss", "grads_nonfinite"}
        if k + 1 in (1, 3):
            _assert_state_close(_port_state(model, step), want[k + 1],
                                f"n={n} after {k + 1}")


def test_two_rank_ctc_step_matches_two_device_jax_mesh(tmp_path):
    model = _small_model(seed=6)
    params, bstats = variables_to_flax(model)
    batches = _batches(2, 1)
    arrays = {f"an4_{k}": v for k, v in batches.items()}
    arrays.update({f"an4_params/{k}": v
                   for k, v in flatten_flax(params).items()})
    arrays.update({f"an4_bstats/{k}": v
                   for k, v in flatten_flax(bstats).items()})
    spec = dict(tasks=["an4"], an4=dict(hidden=H, layers=LAYERS, batch=B,
                                        **OPT))
    ranks = _spawn(2, str(tmp_path), spec, arrays)
    want = _jax_run(params, bstats, batches, 2, 1)
    for after in (1, 3):
        prefix = f"an4/s{after}/"
        for r, out in enumerate(ranks):
            got = {k[len(prefix):]: v for k, v in out.items()
                   if k.startswith(prefix)}
            _assert_state_close(got, want[after], f"rank {r} after {after}")
        for key in ranks[0]:
            if key.startswith(prefix):
                assert np.array_equal(ranks[0][key], ranks[1][key]), key


# -- the trainer, checkpoints, the evaluator, the CLI ---------------------

SMALL_H, SMALL_LAYERS = 32, 2


@pytest.fixture
def small_lstman4(monkeypatch):
    """Both registries' lstman4 at hidden 32, 2 layers (the data, the
    loss, the trainer and the checkpoint layout are the full model's)."""
    monkeypatch.delenv("MGWFBP_FAULT_PLAN", raising=False)

    def port(nc=None, hwc=None):
        nc = nc or 29
        return (DeepSpeech(num_classes=nc, hidden_size=SMALL_H,
                           num_layers=SMALL_LAYERS),
                models.ModelMeta("lstman4", "an4", nc, (201, 161),
                                 task="ctc"))

    def jax_factory(nc=None):
        nc = nc or 29
        return (JaxDeepSpeech(num_classes=nc, hidden_size=SMALL_H,
                              num_layers=SMALL_LAYERS),
                JaxMeta("lstman4", "an4", nc, (201, 161), task="ctc"))

    monkeypatch.setitem(models._REGISTRY, "lstman4", port)
    monkeypatch.setitem(jax_models._REGISTRY, "lstman4", jax_factory)


def _kw(root, **extra) -> dict:
    kw = dict(logdir="", checkpoint_dir=str(root), data_dir=MEMCHECK,
              num_batches_per_epoch=3, batch_size=4, lr=0.01, seed=2,
              max_epochs=4)
    kw.update(extra)
    return kw


def _jax_trainer(cfg):
    mesh = make_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    return JaxTrainer(cfg, mesh=mesh, profile_backward=False)


def test_trainer_step_evaluation_and_commit_agree_with_jax(tmp_path,
                                                           small_lstman4):
    t = Trainer(make_config("lstman4", **_kw(tmp_path)), device="cpu")
    assert not t.bundle.synthetic and t.bundle.num_batches_per_epoch == 11
    metrics = t.fit(1)
    ev = metrics["eval"]
    assert len(t.losses) == 3 and np.isfinite(t.losses).all()
    assert ev["count"] == 44 and np.isfinite(ev["loss"]) and ev["wer"] >= 0
    params, bstats = variables_to_flax(t.model)
    trace = momentum_to_flax(t.model, t.optimizer)
    root, step = t.ckpt_dir, t.iteration
    t.close()
    jt = _jax_trainer(jax_make_config("lstman4", **_kw(tmp_path)))
    ck = JaxCheckpointer(root)
    try:
        snap = ck.restore(jt.state)
        assert snap.iteration == step == 3
        for got, want in ((snap.state.params, params),
                          (snap.state.batch_stats, bstats)):
            got, want = flatten_flax(_np(got)), flatten_flax(want)
            assert list(got) == list(want)
            assert all(np.array_equal(got[k], want[k]) for k in want)
        opt_leaves = [np.asarray(a) for a in
                      jax.tree_util.tree_leaves(snap.state.opt_state)]
        for k, v in trace.items():
            assert any(a.shape == v.shape and np.array_equal(a, v)
                       for a in opt_leaves), k
        jt.state = snap.state
        jev = jt.evaluate()
    finally:
        ck.close()
        jt.close()
    assert jev["count"] == ev["count"]
    assert jev["loss"] == pytest.approx(ev["loss"], rel=EVAL_RTOL)
    assert jev["wer"] == pytest.approx(ev["wer"], abs=1e-12)
    # the offline evaluator on the committed step: the trainer's numbers
    got = port_evaluate.evaluate("lstman4", root, data_dir=MEMCHECK,
                                 batch_size=4, seed=2, device="cpu")
    assert got["count"] == ev["count"] and got["wer"] == ev["wer"]
    assert got["loss"] == pytest.approx(ev["loss"], rel=1e-6)


def test_jax_step_restores_in_the_port(tmp_path, small_lstman4):
    cfg = jax_make_config("lstman4", **_kw(tmp_path, num_batches_per_epoch=2))
    jt = _jax_trainer(cfg)
    jt.fit(1)
    jt.checkpointer.wait()
    want = flatten_flax(_np(jt.state.params))
    want_b = flatten_flax(_np(jt.state.batch_stats))
    root = os.path.join(cfg.checkpoint_dir, cfg.tag())
    jt.close()
    t = Trainer(make_config("lstman4", **_kw(tmp_path,
                                             num_batches_per_epoch=2)),
                device="cpu")
    try:
        assert t.ckpt_dir == root and t.iteration == 2  # resumed
        params, bstats = variables_to_flax(t.model)
        for got, w in ((flatten_flax(params), want),
                       (flatten_flax(bstats), want_b)):
            assert list(got) == list(w)
            assert all(np.array_equal(got[k], w[k]) for k in w)
        metrics = t.fit(1)  # and it trains on from there
        assert np.isfinite(metrics["train"]["loss"]) and t.iteration == 4
    finally:
        t.close()


def test_evaluator_all_epochs_keeps_the_lowest_wer(tmp_path, small_lstman4,
                                                   capsys):
    t = Trainer(make_config("lstman4", **_kw(tmp_path,
                                             num_batches_per_epoch=2)),
                device="cpu")
    wers = [t.fit(1)["eval"]["wer"] for _ in range(2)]
    root = t.ckpt_dir
    t.close()
    assert port_evaluate.main(["--dnn", "lstman4", "--checkpoint-dir", root,
                               "--data-dir", MEMCHECK, "--batch-size", "4",
                               "--device", "cpu", "--all-epochs"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [x["epoch"] for x in lines[:-1]] == [0, 1]
    assert [x["wer"] for x in lines[:-1]] == wers
    assert lines[-1]["best"] == {"wer": min(wers),
                                 "epoch": int(np.argmin(wers))}


def test_train_cli_trains_lstman4_on_an4_memcheck(tmp_path, small_lstman4,
                                                  capsys):
    rc = train_cli.main([
        "--dnn", "lstman4", "--data-dir", MEMCHECK, "--device", "cpu",
        "--num-batches-per-epoch", "2", "--max-epochs", "1",
        "--logdir", str(tmp_path / "logs"), "--telemetry",
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["train"]["loss"])
    assert np.isfinite(out["eval"]["loss"]) and out["eval"]["wer"] >= 0


def test_serving_refuses_the_registered_ctc_model_as_jax_does():
    module, meta = models.create_model("lstman4")
    with pytest.raises(ValueError, match="CTC audio model"):
        ServingModel(module, meta, device="cpu")
    jm, jmeta = jax_models.create_model("lstman4")
    with pytest.raises(ValueError, match="CTC audio model"):
        jax_serving.ServingModel(jm, jmeta)
    state = state_from_flax(module, *variables_to_flax(module))
    assert set(state) == set(module.state_dict())
