"""Port vs reference: the small and CIFAR models of the zoo and their
shared pieces (mgwfbp_tpu_torch.models.{common,simple,vgg,alexnet,resnext}
vs mgwfbp_tpu.models's).

  * every registered name of this family has the JAX tree: leaf paths,
    shapes and parameter counts equal ``jax.eval_shape`` of the JAX model
    at full width, and its meta equals the JAX registry's;
  * the shared pieces against Flax: rectangular, grouped, biased and
    explicitly padded convs, VALID pools, the ``SAME`` average pool that
    counts its pads, local response normalization (k = 2), the NHWC
    flatten (a case that fails with an NCHW flatten);
  * train-mode logits, batch statistics and every gradient against
    ``jax.grad`` of the JAX ``make_loss_fn``, at full width and batch 2,
    dropout off on both sides: within rel 1e-4 of max(1, |leaf|) (the same
    float32 math in another order); AlexNet and vgg16i (ImageNet models) at
    a smaller input, 127 and 64, whose flatten still has a spatial map;
    ResNeXt-29 (at 16 x 16) against float64 ``jax.grad``: its float32
    gradients at batch 2 are ill-conditioned in both packages (about 1 %
    from float64), so the port in float64 is held within 1e-6 of it and the
    port in float32 no further than twice the JAX package's float32 is;
  * the port's dropout: its rate, the 1 / (1 - p) scaling, off in eval;
  * a 2-rank gloo ``mgwfbp`` trajectory over 3 steps on ``caffe_cifar`` and
    ``mnistnet`` (dropout off) equals the 1-rank one on the global batch and
    the JAX step on a 2-device mesh (rtol 2e-5, atol 1e-6).
"""

import json
import math
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from flax import linen as fnn

from mgwfbp_tpu.models import common as jcommon
from mgwfbp_tpu.models import create_model as jax_create_model
from mgwfbp_tpu.models.alexnet import AlexNet as JaxAlexNet
from mgwfbp_tpu.models.vgg import VGGImageNet as JaxVGGImageNet
from mgwfbp_tpu.optim import make_optimizer as jax_make_optimizer
from mgwfbp_tpu.parallel.allreduce import make_merged_allreduce as jax_reducer
from mgwfbp_tpu.parallel.costmodel import lookup_alpha_beta as jax_lookup
from mgwfbp_tpu.parallel.mesh import MeshSpec, make_mesh
from mgwfbp_tpu.train.step import TrainState, make_loss_fn, make_train_step
from mgwfbp_tpu_torch import models
from mgwfbp_tpu_torch.convert import (
    flatten_flax,
    flax_shapes,
    state_from_flax,
    variables_to_flax,
)
from mgwfbp_tpu_torch.models import common
from mgwfbp_tpu_torch.models.alexnet import AlexNet
from mgwfbp_tpu_torch.models.vgg import VGGImageNet
from mgwfbp_tpu_torch.train.step import forward_loss

import torch_dist_worker
from torch_zoo_util import (
    assert_grads_close,
    f64_parity,
    images,
    jax_dropout_off,
    labels,
    nchw,
    nhwc,
    np_tree,
    port_dropout_off,
    port_model,
    seeded,
)

RTOL, ATOL = 2e-5, 1e-6  # one op, or a logit, across the two programs
GRAD_REL = 1e-4
SMALL = ["mnistnet", "lenet", "fcn5net", "lr", "caffe_cifar", "vgg11",
         "vgg13", "vgg16", "vgg19"]
FAMILY = SMALL + ["resnext29", "vgg16i", "alexnet"]
TRAJ_STEPS, TRAJ_B = 3, 4
JOIN_TIMEOUT_S = 150


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs beside other test workers: two intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_tree(name):
    jm, jmeta = jax_create_model(name)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1,) + tuple(jmeta.input_shape)), train=False))
    return shapes, jmeta


@pytest.mark.parametrize("name", FAMILY)
def test_registered_model_has_the_jax_tree(name):
    shapes, jmeta = _jax_tree(name)
    with torch.device("meta"):
        module, meta = models.create_model(name)
    for coll in ("params", "batch_stats"):
        want = {p: tuple(s.shape)
                for p, s in flatten_flax(shapes.get(coll, {})).items()}
        got = flax_shapes(module, coll)
        assert list(got) == list(want) and got == want, coll
    n = sum(math.prod(s.shape) for s in jax.tree_util.tree_leaves(
        shapes["params"]))
    assert sum(p.numel() for p in module.parameters()) == n
    assert (meta.name, meta.dataset, meta.num_classes, meta.input_shape,
            meta.task, meta.has_aux_logits) == (
        jmeta.name, jmeta.dataset, jmeta.num_classes,
        tuple(jmeta.input_shape), jmeta.task, jmeta.has_aux_logits)
    canonical = {"alexnet": 61_100_840, "mnistnet": 21_840,
                 "caffe_cifar": 145_578, "vgg16": 14_724_042,
                 "vgg16i": 138_357_544, "resnext29": 34_426_698,
                 "fcn5net": 40_983_562}
    if name in canonical:
        assert n == canonical[name]


def test_every_jax_model_is_registered_but_the_audio_one():
    """Every name of the JAX registry, the speech model lstman4 included."""
    from mgwfbp_tpu.models import model_names as jax_names

    assert sorted(jax_names()) == models.model_names()
    assert "lstman4" in models.model_names()


def test_dataset_override_retargets_the_input_and_the_module():
    """lenet on CIFAR-10: meta.input_shape becomes (32, 32, 3), as the JAX
    registry retargets it, and the module is built for it."""
    module, meta = models.create_model("lenet", dataset="cifar10")
    _, jmeta = jax_create_model("lenet", dataset="cifar10")
    assert meta.input_shape == tuple(jmeta.input_shape) == (32, 32, 3)
    jm, _ = jax_create_model("lenet", dataset="cifar10")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 32, 32, 3))))
    want = {p: tuple(s.shape) for p, s in flatten_flax(shapes["params"]).items()}
    assert flax_shapes(module) == want
    assert module(torch.zeros(2, 3, 32, 32)).shape == (2, 10)


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel,stride,padding,groups,bias,size,cin", [
    ((1, 7), (1, 1), "SAME", 1, False, 9, 16),
    ((7, 1), (1, 1), "SAME", 1, False, 9, 16),
    ((3, 1), (1, 1), "SAME", 1, False, 6, 16),
    ((3, 3), (2, 2), "SAME", 8, False, 8, 16),
    ((3, 3), (2, 2), "VALID", 1, False, 11, 16),
    ((11, 11), (4, 4), ((2, 2), (2, 2)), 1, True, 31, 3),  # AlexNet's first
    ((5, 5), (1, 1), "SAME", 1, True, 7, 16),
])
def test_conv_matches_flax(kernel, stride, padding, groups, bias, size, cin):
    cout = 8
    x = images(2, (size, size, cin), seed=size)
    conv = fnn.Conv(cout, kernel, stride, padding=padding, use_bias=bias,
                    feature_group_count=groups)
    v = conv.init(jax.random.PRNGKey(0), x)
    if bias:
        v = {"params": dict(v["params"], bias=jnp.asarray(
            np.random.RandomState(1).randn(cout).astype(np.float32)))}
    want = np.asarray(conv.apply(v, x))
    port = common.SameConv2d(cin, cout, kernel, stride, padding=padding,
                             groups=groups, bias=bias)
    port.load_state_dict(state_from_flax(port, np_tree(v["params"])))
    with torch.no_grad():
        got = nhwc(port(nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("window,stride,padding,size", [
    (2, 2, "VALID", 9), (3, 2, "VALID", 13), (3, 2, "SAME", 8),
    (3, 1, "SAME", 7), (5, 3, "VALID", 14), (2, 2, "VALID", 8),
])
@pytest.mark.parametrize("kind", ["max", "avg"])
def test_pools_match_flax(kind, window, stride, padding, size):
    """Max and average pools; the SAME average pool divides by the whole
    window at the border too (Flax's count_include_pad=True)."""
    x = images(2, (size, size, 3), seed=size)
    pool = jcommon.max_pool if kind == "max" else jcommon.avg_pool
    want = np.asarray(pool(jnp.asarray(x), (window, window), (stride, stride),
                           padding))
    port = common.max_pool if kind == "max" else common.avg_pool
    got = nhwc(port(nchw(x), window, stride, padding))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if kind == "avg" and padding == "SAME" and stride == 1:
        # the corner window holds 2 x 2 pixels and 5 pads: divided by 9
        corner = x[:, :2, :2].sum(axis=(1, 2)) / window ** 2
        np.testing.assert_allclose(got[:, 0, 0], corner, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("size,channels", [(5, 16), (3, 8), (4, 6)])
def test_local_response_norm_matches_jax(size, channels):
    x = 3.0 * images(2, (5, 5, channels), seed=size)
    want = np.asarray(jcommon.local_response_norm(jnp.asarray(x), size=size))
    got = nhwc(common.local_response_norm(nchw(x), size=size))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # k = 2, not torch's 1
    other = torch.nn.functional.local_response_norm(nchw(x), size, k=1.0)
    assert not np.allclose(nhwc(other), want, rtol=1e-3)


def test_flatten_is_nhwc_and_an_nchw_flatten_fails(monkeypatch):
    """caffe_cifar flattens a 4x4x64 map into its first Dense layer: the
    port's logits equal JAX's, and with an NCHW flatten they do not."""
    m, meta = port_model("caffe_cifar")
    params, _ = variables_to_flax(m)
    jm, _ = jax_create_model("caffe_cifar")
    x = images(2, meta.input_shape, seed=3)
    want = np.asarray(jax.jit(partial(jm.apply, train=False))(
        {"params": params}, x))
    m.eval()
    with torch.no_grad():
        np.testing.assert_allclose(m(nchw(x)).numpy(), want, rtol=RTOL,
                                   atol=ATOL)
        monkeypatch.setattr("mgwfbp_tpu_torch.models.simple.flatten",
                            lambda t: t.reshape(t.shape[0], -1))
        wrong = m(nchw(x)).numpy()
    assert np.abs(wrong - want).max() > 1e-2


# ---------------------------------------------------------------------------
# whole models, train mode
# ---------------------------------------------------------------------------


def _train_parity(monkeypatch, m, jm, jmeta, x, y):
    """Port forward_loss + backward against jax.grad(make_loss_fn) on the
    same weights, dropout off: loss, updated batch stats, gradients."""
    jax_dropout_off(monkeypatch)
    params, bstats = variables_to_flax(m)
    grads, (new_b, _, metrics) = jax.jit(jax.grad(
        make_loss_fn(jm, jmeta), has_aux=True))(
        params, bstats, {"x": x, "y": y}, jax.random.PRNGKey(0), None)
    m.train()
    loss, acc, _ = forward_loss(m, "classify", nchw(x), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(metrics["loss"]), rtol=RTOL)
    assert acc.item() == pytest.approx(float(metrics["accuracy"]))
    want_b = flatten_flax(np_tree(new_b))
    for k, v in flatten_flax(variables_to_flax(m)[1]).items():
        np.testing.assert_allclose(v, want_b[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    return assert_grads_close(m, np_tree(grads), GRAD_REL)


@pytest.mark.parametrize("name", SMALL)
def test_full_width_train_step_matches_jax(monkeypatch, name):
    m, meta = port_model(name, seed=1)
    jm, jmeta = jax_create_model(name)
    x, y = images(2, meta.input_shape, seed=4), labels(2, meta.num_classes, 4)
    _train_parity(monkeypatch, m, jm, jmeta, x, y)


@pytest.mark.parametrize("name,hw", [("alexnet", 127), ("vgg16i", 64)])
def test_imagenet_plain_models_match_jax_at_a_smaller_input(monkeypatch, name,
                                                            hw):
    """AlexNet (3x3x256 flattened at 127) and vgg16i (2x2x512 at 64): the
    first Dense layer sized for the input, on both sides."""
    from mgwfbp_tpu.models import ModelMeta

    port_cls, jax_cls = {"alexnet": (AlexNet, JaxAlexNet),
                         "vgg16i": (VGGImageNet, JaxVGGImageNet)}[name]
    nc = 10
    m = port_dropout_off(seeded(port_cls(num_classes=nc,
                                         input_hwc=(hw, hw, 3)), 2))
    jm = jax_cls(num_classes=nc)
    jmeta = ModelMeta(name=name, dataset="imagenet", num_classes=nc,
                      input_shape=(hw, hw, 3))
    x, y = images(2, (hw, hw, 3), seed=5), labels(2, nc, 5)
    _train_parity(monkeypatch, m, jm, jmeta, x, y)


def test_resnext29_gradients_match_jax_in_float64(tmp_path):
    """Full width, batch 2, at 16 x 16 (the leaves do not depend on the
    input's size; a quarter of the 32 x 32 work in float64)."""
    m, _ = port_model("resnext29", seed=1)
    x, y = images(2, (16, 16, 3), seed=6), labels(2, 10, 6)
    errs = f64_parity(
        tmp_path, "resnext29", m, x, y,
        lambda mod, xt: forward_loss(mod, "classify", xt,
                                     torch.from_numpy(y))[0])
    print(f"resnext29 vs float64 jax.grad: {errs}")


def test_eval_logits_match_jax(monkeypatch):
    """Eval mode (running statistics, dropout off by mode) on resnext29 with
    statistics off their init."""
    m, meta = port_model("resnext29", seed=2)
    x = images(2, meta.input_shape, seed=7)
    m.train()
    with torch.no_grad():
        m(nchw(images(4, meta.input_shape, seed=8)))
    params, bstats = variables_to_flax(m)
    jm, _ = jax_create_model("resnext29")
    want = np.asarray(jax.jit(partial(jm.apply, train=False))(
        {"params": params, "batch_stats": bstats}, x))
    m.eval()
    with torch.no_grad():
        got = m(nchw(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=2e-5)


def test_dropout_rate_scaling_and_eval():
    """mnistnet's dropout (0.5): about half of the units zeroed, the rest
    scaled by 2, all of them kept in eval; googlenet's rates."""
    m, _ = models.create_model("mnistnet")
    assert [d.p for d in m.modules() if isinstance(d, torch.nn.Dropout)] == [
        0.5]
    drop = m.drop.train()
    x = torch.ones(64, 1000)
    torch.manual_seed(0)
    y = drop(x)
    kept = y != 0
    assert 0.45 < kept.float().mean().item() < 0.55
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0))
    assert torch.equal(drop.eval()(x), x)
    g, _ = models.create_model("googlenet")
    rates = sorted(d.p for d in g.modules() if isinstance(d, torch.nn.Dropout))
    assert rates == [0.4, 0.7, 0.7]


# ---------------------------------------------------------------------------
# 2-rank gloo trajectory
# ---------------------------------------------------------------------------

TRAJ_MODELS = ("caffe_cifar", "mnistnet")
TRAJ_LR, TRAJ_BPE = 0.05, 2


def _spawn(world: int, out_dir: str, arrays: dict) -> list[dict]:
    spec = {"tasks": ["zoo"], "zoo": {
        "models": list(TRAJ_MODELS), "batch": TRAJ_B * 2 // world,
        "lr": TRAJ_LR, "batches_per_epoch": TRAJ_BPE}}
    with open(os.path.join(out_dir, "spec.json"), "w") as f:
        json.dump(spec, f)
    np.savez(os.path.join(out_dir, "spec.npz"), **arrays)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=torch_dist_worker.run,
                         args=(r, world, os.path.join(out_dir, "rdv"), out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
            assert not p.is_alive(), f"rank {procs.index(p)} hung"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert [p.exitcode for p in procs] == [0] * world
    out = []
    for r in range(world):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    arrays = {}
    for name in TRAJ_MODELS:
        m, meta = port_model(name, seed=3)
        for k, v in flatten_flax(variables_to_flax(m)[0]).items():
            arrays[f"{name}/params/{k}"] = v
        rs = np.random.RandomState(9)
        arrays[f"{name}/x"] = rs.randn(
            TRAJ_STEPS, 2 * TRAJ_B, *meta.input_shape).astype(np.float32)
        arrays[f"{name}/y"] = rs.randint(
            0, 10, (TRAJ_STEPS, 2 * TRAJ_B)).astype(np.int32)
    runs = {w: _spawn(w, str(tmp_path_factory.mktemp(f"zoo{w}")), arrays)
            for w in (1, 2)}
    return runs, arrays


def _jax_trajectory(monkeypatch, name, arrays):
    jax_dropout_off(monkeypatch)
    jm, jmeta = jax_create_model(name)
    params = {}
    for k in arrays:
        if k.startswith(f"{name}/params/"):
            *mods, leaf = k[len(f"{name}/params/"):].split(".")
            node = params
            for part in mods:
                node = node.setdefault(part, {})
            node[leaf] = arrays[k]
    tx, _ = jax_make_optimizer(
        TRAJ_LR, momentum=0.9, weight_decay=1e-4, lr_schedule="auto",
        dataset=jmeta.dataset, max_epochs=141, warmup_epochs=5,
        num_batches_per_epoch=TRAJ_BPE)
    mesh = make_mesh(MeshSpec(data=2), devices=jax.devices()[:2])
    reducer = jax_reducer(params, axis_name="data", policy="mgwfbp",
                          cost_model=jax_lookup("10GbE", 2))
    step = make_train_step(jm, jmeta, tx, mesh, reducer, donate=False)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats={}, opt_state=tx.init(params),
                       rng=jax.random.PRNGKey(0))
    out = []
    for k in range(TRAJ_STEPS):
        state, _ = step(state, {"x": arrays[f"{name}/x"][k][None],
                                "y": arrays[f"{name}/y"][k][None]})
        out.append(flatten_flax(np_tree(state.params)))
    return out


@pytest.mark.parametrize("name", TRAJ_MODELS)
def test_two_rank_trajectory_matches_one_rank_and_jax(monkeypatch,
                                                      trajectories, name):
    runs, arrays = trajectories
    want = _jax_trajectory(monkeypatch, name, arrays)
    one, two = runs[1][0], runs[2]
    for k in range(TRAJ_STEPS):
        prefix = f"{name}/s{k + 1}/"
        for r in (one, *two):  # each step launched every merge group
            assert int(r[prefix + "launches"]) == int(r[f"{name}/groups"]) >= 1
        for key, w in want[k].items():
            for r in (one, *two):
                np.testing.assert_allclose(
                    r[prefix + key], w, rtol=RTOL, atol=ATOL,
                    err_msg=f"{name} {key} after {k + 1} step(s)")
            # replicas stay bit-identical across ranks
            assert np.array_equal(two[0][prefix + key], two[1][prefix + key])
