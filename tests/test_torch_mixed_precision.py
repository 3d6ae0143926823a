"""Port vs reference: the bfloat16 mixed-precision policy
(mgwfbp_tpu_torch.train.step / models.common.BatchNorm vs
``make_loss_fn(..., compute_dtype=bfloat16)`` of mgwfbp_tpu.train.step),
the precision setting, the CLI flags of this slice and the port's bench.

What a bfloat16 step can be held to. bfloat16 keeps 8 bits, and a
batch-normalized ResNet at its init amplifies a rounding difference layer
after layer in train mode: the JAX package's own bfloat16 gradients differ
from its float32 ones by 29 % (ResNet-20, batch 8) to 41 % (ResNet-50,
64 x 64, batch 2) in relative L2, and the port's bfloat16 differs from its
float32 by the same amounts, layer for layer. Two programs that round in
other orders therefore cannot agree on those gradients to 2e-2. So:

  * the pieces of the policy are held exactly where they are exact:
    ``BatchNorm`` against Flax's on the same bfloat16 input, its merged
    float32 statistics within rtol 1e-6 (measured 2.4e-7; a copy-back of
    Flax's new statistics would miss by 3e-3 to 1e-2) and its output
    within one bfloat16 ulp; and where the casts sit (every convolution
    and dense layer sees bfloat16 operands, the loss, the masters, their
    gradients, the batch statistics and the optimizer state stay float32);
  * a whole step is held against the JAX step at bfloat16: the loss within
    the bfloat16 bound 2e-2 (tests/test_flashattn.py; measured 6e-4 and
    1.7e-4 relative), and the gradients and the merged batch statistics,
    each as one vector, within 1.5 x the JAX package's own bfloat16
    rounding at that point (the L2 distance between its bfloat16 and its
    float32 step; measured ratios 1.08-1.18 for the gradients, below 1 for
    the statistics);
  * evaluation at bfloat16 (no batch statistics, no amplification) within
    2e-2 relative L2 of the JAX eval forward at bfloat16.

ResNet-50 runs at the damped init of tests/test_torch_resnet_imagenet.py
(each residual branch's last batch-norm scale 0.2): at the plain init its
float32 gradients are themselves accurate to only a few per cent at this
size.
"""

import json
import logging
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from flax import linen as nn

from mgwfbp_tpu.models import ModelMeta
from mgwfbp_tpu.models.resnet_cifar import CifarResNet as JaxCifarResNet
from mgwfbp_tpu.models.resnet_imagenet import imagenet_resnet as jax_resnet
from mgwfbp_tpu.optim import make_optimizer as jax_make_optimizer
from mgwfbp_tpu.parallel.allreduce import make_merged_allreduce as jax_reducer
from mgwfbp_tpu.parallel.costmodel import lookup_alpha_beta as jax_lookup
from mgwfbp_tpu.parallel.mesh import MeshSpec, make_mesh
from mgwfbp_tpu.train.step import TrainState, make_loss_fn, make_train_step
from mgwfbp_tpu_torch.config import make_config
from mgwfbp_tpu_torch.convert import (
    flatten_flax,
    flax_leaves,
    state_from_flax,
    variables_to_flax,
)
from mgwfbp_tpu_torch.models.common import BatchNorm
from mgwfbp_tpu_torch.models.resnet_cifar import CifarResNet
from mgwfbp_tpu_torch.models.resnet_imagenet import imagenet_resnet
from mgwfbp_tpu_torch.optim import make_optimizer
from mgwfbp_tpu_torch.train.step import TrainStep, eval_sums, model_forward
from mgwfbp_tpu_torch.utils.device import set_matmul_precision

import torch_dist_worker

BF16 = 2e-2  # the bfloat16 bound of tests/test_flashattn.py
MERGE_RTOL = 1e-6
ENVELOPE = 1.5
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs beside other test workers: two intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nest(flat):
    out: dict = {}
    for path, a in flat.items():
        *mods, leaf = path.split(".")
        node = out
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = a
    return out


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous()


def _flax_layout(g: torch.Tensor) -> np.ndarray:
    g = g.permute(2, 3, 1, 0) if g.dim() == 4 else g.t() if g.dim() == 2 else g
    return g.double().numpy()


def _vec(flat: dict) -> np.ndarray:
    return np.concatenate([np.asarray(flat[k], np.float64).ravel()
                           for k in sorted(flat)])


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# -- the precision setting ------------------------------------------------

def test_precision_setting_sets_both_flags_and_the_trainer_logs_it():
    for dtype in (None, "float32", "bfloat16", torch.bfloat16):
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        assert set_matmul_precision(dtype) is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        set_matmul_precision("float16")
    from mgwfbp_tpu_torch.train import Trainer

    lines: list[str] = []
    handler = logging.Handler()
    handler.emit = lambda rec: lines.append(rec.getMessage())
    logger = logging.getLogger("mgwfbp.trainer")
    logger.addHandler(handler)
    try:
        torch.backends.cudnn.allow_tf32 = True
        cfg = make_config("resnet20", dtype="bfloat16", batch_size=4,
                          logdir="", num_batches_per_epoch=1)
        tr = Trainer(cfg, device="cpu", synthetic_data=True)
        tr.close()
    finally:
        logger.removeHandler(handler)
    assert tr.compute_dtype == torch.bfloat16
    assert tr.train_step.compute_dtype == torch.bfloat16
    assert torch.backends.cudnn.allow_tf32 is False
    assert [ln for ln in lines if ln.startswith("precision:")] == [
        "precision: compute dtype bfloat16; TF32 off for float32 matmuls "
        "and convolutions"]


# -- the batch norm's float32 statistics and delta merge ------------------

def _bn_case(seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(8, 6, 6, 16) * 2 + 1.5).astype(np.float32)
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    master = {"mean": (rs.randn(16) * 1.2345).astype(np.float32),
              "var": (1 + rs.rand(16) * 3.777).astype(np.float32)}
    scale = (1 + rs.randn(16) * 0.3).astype(np.float32)
    bias = (rs.randn(16) * 0.3).astype(np.float32)
    port = BatchNorm(16)
    with torch.no_grad():
        port.running_mean.copy_(torch.from_numpy(master["mean"]))
        port.running_var.copy_(torch.from_numpy(master["var"]))
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
    cast = {"params": {"scale": jnp.asarray(scale, jnp.bfloat16),
                       "bias": jnp.asarray(bias, jnp.bfloat16)},
            "batch_stats": {k: jnp.asarray(v, jnp.bfloat16)
                            for k, v in master.items()}}
    return x, master, port, cast


def _bf16_call(module, x):
    params = {n: p.to(torch.bfloat16) for n, p in module.named_parameters()}
    xb = _nchw(x).to(torch.bfloat16)
    return torch.func.functional_call(module, params, (xb,))


def test_bf16_batch_norm_merges_the_delta_like_flax():
    x, master, port, cast = _bn_case()
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    y, upd = jax.jit(lambda v, a: bn.apply(v, a, mutable=["batch_stats"]))(
        cast, jnp.asarray(x, jnp.bfloat16))
    got = _bf16_call(port.train(), x)
    assert got.dtype == torch.bfloat16
    assert port.running_mean.dtype == port.running_var.dtype == torch.float32
    want_y = np.asarray(y.astype(jnp.float32))
    ulp = 2.0 ** -8 * np.abs(want_y).max()
    assert np.abs(got.float().permute(0, 2, 3, 1).detach().numpy()
                  - want_y).max() <= ulp
    for k, buf in (("mean", port.running_mean), ("var", port.running_var)):
        new = np.asarray(upd["batch_stats"][k], np.float32)
        q = np.asarray(jnp.asarray(master[k], jnp.bfloat16), np.float32)
        merged = master[k] + (new - q)  # the JAX step's restate
        np.testing.assert_allclose(buf.numpy(), merged, rtol=MERGE_RTOL,
                                   atol=0, err_msg=k)
        # a copy of Flax's new statistic would miss by far more
        assert np.abs(new - merged).max() > 100 * MERGE_RTOL * np.abs(
            merged).max()


def test_bf16_batch_norm_evaluates_on_the_cast_statistics():
    x, _, port, cast = _bn_case(seed=1)
    bn = nn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5)
    want = np.asarray(bn.apply(cast, jnp.asarray(x, jnp.bfloat16))
                      .astype(jnp.float32))
    with torch.no_grad():
        got = _bf16_call(port.eval(), x).float().permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= BF16 * np.abs(want).max()


def test_bf16_policy_casts_the_program_and_keeps_the_state():
    """bfloat16 operands at every convolution and dense layer, float32
    loss, masters, gradients, batch statistics and optimizer state; every
    gradient hook fires once per micro-step; a non-finite step restores
    the merged statistics, parameters and momentum exactly."""
    torch.manual_seed(0)
    model = CifarResNet(depth=8, widths=(4, 8, 16)).train()
    seen = []
    for mod in model.modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
            mod.register_forward_pre_hook(
                lambda m, args: seen.append((args[0].dtype, m.weight.dtype)))
    params = [t for _, t in flax_leaves(model)]
    fired = [0] * len(params)

    def count(t, j):
        fired[j] += 1
        seen.append(("grad", t.grad.dtype))

    for j, p in enumerate(params):
        p.register_post_accumulate_grad_hook(lambda t, j=j: count(t, j))
    opt, lr_fn, _ = make_optimizer(model.parameters(), 0.1,
                                   num_batches_per_epoch=4)
    step = TrainStep(model, opt, lr_fn, nsteps_update=2,
                     compute_dtype=torch.bfloat16)
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(2, 4, 3, 16, 16).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 10, (2, 4)))
    out = step(x, y)
    assert fired == [2] * len(params)
    assert {d for d in seen if d[0] != "grad"} == {(torch.bfloat16,) * 2}
    assert {d for d in seen if d[0] == "grad"} == {("grad", torch.float32)}
    # the metrics stay on the device: 0-dim float32 tensors, read by the
    # caller when it needs them
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0
               and v.dtype == torch.float32 for v in out.values())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers())
    assert all(s["momentum_buffer"].dtype == torch.float32
               for s in opt.state.values())
    state = {k: v.clone() for k, v in model.state_dict().items()}
    mom = [s["momentum_buffer"].clone() for s in opt.state.values()]
    x_bad = x.clone()
    x_bad[1, 2, 0, 0, 0] = float("nan")
    bad = step(x_bad, y)
    assert bad["grads_nonfinite"] > 0 and step.step == 1
    assert all(torch.equal(state[k], v) for k, v in model.state_dict().items())
    assert all(torch.equal(a, s["momentum_buffer"])
               for a, s in zip(mom, opt.state.values()))


# -- one step of a whole model against the JAX step -----------------------

def _resnet20():
    jm = JaxCifarResNet(depth=20)
    v = jax.jit(partial(jm.init, train=False))(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 32, 32, 3)))
    return jm, CifarResNet(depth=20), _np(v["params"]), _np(v["batch_stats"]), 32, 8


def _resnet50():
    jm = jax_resnet(50, 10)
    v = jax.jit(partial(jm.init, train=False))(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 64, 64, 3)))
    flat = flatten_flax(_np(v["params"]))
    for k in flat:
        if ".ConvBN_2.BatchNorm_0.scale" in k:
            flat[k] = flat[k] * np.float32(0.2)
    return jm, imagenet_resnet(50, 10), _nest(flat), _np(v["batch_stats"]), 64, 2


@pytest.mark.parametrize("build", [_resnet20, _resnet50],
                         ids=["resnet20", "resnet50"])
def test_bf16_step_matches_the_jax_step(build):
    jm, model, params, bstats, hw, b = build()
    # float32 masters that bfloat16 does not hold exactly
    bstats = jax.tree_util.tree_map(lambda a: a + np.float32(0.3), bstats)
    meta = ModelMeta(name="r", dataset="imagenet", num_classes=10,
                     input_shape=(hw, hw, 3))
    rs = np.random.RandomState(1)
    x = rs.randn(b, hw, hw, 3).astype(np.float32)
    y = rs.randint(0, 10, b).astype(np.int32)
    want = {}
    for dt in (jnp.bfloat16, None):
        g, (nb, _, metrics) = jax.jit(jax.grad(
            make_loss_fn(jm, meta, compute_dtype=dt), has_aux=True))(
            params, bstats, {"x": x, "y": y}, jax.random.PRNGKey(0), None)
        want[dt] = (flatten_flax(_np(g)), flatten_flax(_np(nb)),
                    float(metrics["loss"]))
    model.load_state_dict(state_from_flax(model, params, bstats))
    leaves = flax_leaves(model)
    grads = {}

    def keep(t, path):
        grads[path] = _flax_layout(t.grad)

    for path, p in leaves:
        p.register_post_accumulate_grad_hook(lambda t, path=path: keep(t, path))
    opt, lr_fn, _ = make_optimizer(model.parameters(), 0.1,
                                   num_batches_per_epoch=1)
    step = TrainStep(model, opt, lr_fn, compute_dtype=torch.bfloat16)
    out = step(_nchw(x)[None], torch.from_numpy(y)[None])
    g16, b16, loss16 = want[jnp.bfloat16]
    g32, b32, _ = want[None]
    assert abs(out["loss"] - loss16) <= BF16 * abs(loss16)
    assert sorted(grads) == sorted(g16)
    got_b = flatten_flax(variables_to_flax(model)[1])
    for got, w16, w32 in ((grads, g16, g32), (got_b, b16, b32)):
        err, noise = _rel(_vec(got), _vec(w16)), _rel(_vec(w16), _vec(w32))
        assert err <= ENVELOPE * noise, (err, noise)


def test_bf16_eval_matches_the_jax_eval_forward():
    jm, model, params, bstats, hw, b = _resnet20()
    # running statistics off their init, and not exact in bfloat16
    rs = np.random.RandomState(3)
    bstats = _nest({k: (a + np.float32(0.05) * rs.randn(*a.shape).astype(
        np.float32)) if k.endswith("mean") else a * np.float32(
        1.1 + 0.3 * rs.rand()) for k, a in flatten_flax(bstats).items()})
    x = np.random.RandomState(2).randn(4, hw, hw, 3).astype(np.float32)
    cast = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                  {"params": params, "batch_stats": bstats})
    want = np.asarray(jax.jit(partial(jm.apply, train=False))(
        cast, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    model.load_state_dict(state_from_flax(model, params, bstats))
    model.eval()
    with torch.no_grad():
        got = model_forward(model, _nchw(x), None, torch.bfloat16).numpy()
    print(f"eval forward at bfloat16: relative L2 {_rel(got, want):.3e}")
    assert _rel(got, want) <= BF16
    y = torch.from_numpy(np.argmax(want, -1))
    sums = eval_sums(model, _nchw(x), y, torch.bfloat16)
    assert sums[3].item() == 4 and sums[1].item() >= 3  # top-1 of JAX's argmax


# -- two ranks over gloo against a two-device JAX mesh --------------------

DEPTH, WIDTHS, NC, HW, B, STEPS = 8, (4, 8, 16), 10, 16, 4, 5


def test_two_rank_bf16_trajectory_matches_a_jax_mesh(tmp_path):
    model = JaxCifarResNet(depth=DEPTH, widths=WIDTHS, num_classes=NC)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)),
                   train=False)
    params, bstats = _np(v["params"]), _np(v["batch_stats"])
    world = 2
    rng = np.random.RandomState(0)
    arrays = {f"params/{k}": a for k, a in flatten_flax(params).items()}
    arrays.update({f"bstats/{k}": a for k, a in flatten_flax(bstats).items()})
    arrays["x_n1"] = rng.randn(STEPS, 1, world * B, HW, HW, 3).astype(np.float32)
    arrays["y_n1"] = rng.randint(0, NC, (STEPS, 1, world * B)).astype(np.int32)
    spec = dict(depth=DEPTH, widths=list(WIDTHS), num_classes=NC, batch=B,
                threshold=2000, lr=0.1, batches_per_epoch=2, tasks=[],
                train_nsteps=[1], dtype="bfloat16")
    with open(tmp_path / "spec.json", "w") as f:
        json.dump(spec, f)
    np.savez(tmp_path / "spec.npz", **arrays)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=torch_dist_worker.run,
                         args=(r, world, str(tmp_path / "rendezvous"),
                               str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(150)
            assert not p.is_alive(), "a rank hung"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert [p.exitcode for p in procs] == [0] * world
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
    meta = ModelMeta(name="resnet8", dataset="cifar10", num_classes=NC,
                     input_shape=(HW, HW, 3))
    tx, _ = jax_make_optimizer(
        0.1, momentum=0.9, weight_decay=1e-4, lr_schedule="auto",
        dataset="cifar10", max_epochs=141, warmup_epochs=5,
        num_batches_per_epoch=2,
    )
    mesh = make_mesh(MeshSpec(data=world), devices=jax.devices()[:world])
    reducer = jax_reducer(params, axis_name="data", policy="mgwfbp",
                          cost_model=jax_lookup("10GbE", world))
    runs = {}
    for dt in (jnp.bfloat16, None):
        stepf = make_train_step(model, meta, tx, mesh, reducer,
                                compute_dtype=dt, donate=False)
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=bstats, opt_state=tx.init(params),
                           rng=jax.random.PRNGKey(0))
        saved = {}
        for k in range(STEPS):
            state, _ = stepf(state, {"x": arrays["x_n1"][k],
                                     "y": arrays["y_n1"][k]})
            if k + 1 in (1, 5):
                saved[k + 1] = state
        runs[dt] = saved
    for after in (1, 5):
        w16, w32 = runs[jnp.bfloat16][after], runs[None][after]
        prefix = f"train_n1/s{after}/"
        for sec, tree16, tree32 in (("params", w16.params, w32.params),
                                    ("bstats", w16.batch_stats,
                                     w32.batch_stats)):
            f16, f32 = flatten_flax(_np(tree16)), flatten_flax(_np(tree32))
            got = {k: ranks[0][f"{prefix}{sec}/{k}"] for k in f16}
            start = flatten_flax(params if sec == "params" else bstats)
            # the step's change against the JAX step's change
            d = {k: got[k] - start[k] for k in f16}
            d16 = {k: f16[k] - start[k] for k in f16}
            d32 = {k: f32[k] - start[k] for k in f16}
            err, noise = _rel(_vec(d), _vec(d16)), _rel(_vec(d16), _vec(d32))
            assert err <= ENVELOPE * noise, (sec, after, err, noise)
        assert int(ranks[0][prefix + "step"]) == after
        for key in ranks[0]:
            if key.startswith(prefix):
                assert np.array_equal(ranks[0][key], ranks[1][key]), key


# -- the CLI of this slice -------------------------------------------------

def test_cli_print_config_resolves_the_new_flags():
    res = subprocess.run(
        [sys.executable, "-m", "mgwfbp_tpu_torch.train_cli", "--dnn",
         "resnet50", "--dtype", "bfloat16", "--lr-schedule", "cosine",
         "--norm-clip", "0.5", "--print-config"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=_ROOT),
    )
    assert res.returncode == 0, res.stderr[-2000:]
    cfg = json.loads(res.stdout)
    assert (cfg["dnn"], cfg["dataset"], cfg["batch_size"], cfg["dtype"],
            cfg["lr_schedule"], cfg["norm_clip"]) == (
        "resnet50", "imagenet", 128, "bfloat16", "cosine", 0.5)
    assert cfg["momentum"] == 0.875  # the ImageNet SGD constants
    bad = subprocess.run(
        [sys.executable, "-m", "mgwfbp_tpu_torch.train_cli", "--dtype",
         "float16", "--print-config"], capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=_ROOT))
    assert bad.returncode == 2 and "invalid choice" in bad.stderr


def test_cli_trains_at_bfloat16_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=_ROOT, OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "mgwfbp_tpu_torch.train_cli", "--dnn",
         "resnet20", "--synthetic", "--device", "cpu", "--dtype", "bfloat16",
         "--epochs", "1", "--num-batches-per-epoch", "4", "--batch-size",
         "8", "--lr-schedule", "const", "--norm-clip", "5.0", "--logdir",
         str(tmp_path / "logs")],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env=env,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    doc = json.loads(res.stdout.strip().splitlines()[-1])
    assert np.isfinite([doc["train"]["loss"], doc["eval"]["loss"]]).all()
    assert "precision: compute dtype bfloat16; TF32 off" in res.stderr


# -- the port's bench on the CPU ------------------------------------------

PAYLOAD_KEYS = {
    "metric", "value", "unit", "vs_baseline", "policy", "n_devices",
    "device_kind", "batch_per_device", "batch_fallback", "compute_dtype",
    "iters", "sec_per_iter", "merge_groups", "policies", "tb_total_s",
    "cost_profile", "mfu", "flops_per_step",
}


def test_bench_on_the_cpu_prints_the_schema_and_refuses_mfu_above_one(
        monkeypatch, capsys):
    from mgwfbp_tpu_torch import bench
    from mgwfbp_tpu_torch.utils import platform

    monkeypatch.setenv("MGWFBP_BENCH_MODEL", "resnet20")
    monkeypatch.setenv("MGWFBP_BENCH_BATCH", "4")
    monkeypatch.setenv("MGWFBP_BENCH_ITERS", "2")
    monkeypatch.setattr(bench, "WARMUP", 1)
    assert bench.main(["--device", "cpu"]) == 0
    payload = json.loads(capsys.readouterr().out.strip())
    assert PAYLOAD_KEYS <= set(payload) and "error" not in payload
    assert set(payload["policies"]) == set(bench.POLICIES)
    assert payload["policy"] == "none" and payload["n_devices"] == 1
    assert payload["device_kind"].startswith("cpu")
    assert payload["policies"]["single"]["merge_groups"] == 1
    assert payload["policies"]["wfbp"]["merge_groups"] == 65
    assert payload["value"] > 0 and 0 < payload["mfu"] < 1
    # 3 x the forward's multiply-adds of ResNet-20 (41 M per image) x 2
    assert abs(payload["flops_per_step"] / (4 * 3 * 2 * 40.8e6) - 1) < 0.05
    monkeypatch.setattr(platform, "peak_flops", lambda kind, dtype: 1.0)
    assert bench.main(["--device", "cpu"]) == 1
    refused = json.loads(capsys.readouterr().out.strip())
    assert refused["value"] is None and "MFU" in refused["error"]
    if not torch.cuda.is_available():
        assert bench.main([]) == 1  # no card: an error line, no CPU run
        doc = json.loads(capsys.readouterr().out.strip())
        assert doc["value"] is None and "no CUDA device" in doc["error"]
