"""Port vs reference: GoogLeNet and Inception v3/v4
(mgwfbp_tpu_torch.models.{googlenet,inception} vs mgwfbp_tpu.models's).

  * googlenet, inceptionv3 and inceptionv4 have the JAX tree (leaf paths,
    shapes and counts through ``jax.eval_shape`` at full width; the aux
    heads' leaves are there in every mode) and the JAX registry's meta
    (aux logits for googlenet and inceptionv3, 299 x 299 inputs for the
    inceptions);
  * every building block in training mode at a small spatial size and its
    real channel counts, from the JAX block's own init: the inception
    module, the aux head (its NHWC flatten of 4x4x128), the V3 blocks A-E
    and the V3 aux head, the V4 stem, A/B/C blocks and both reductions:
    outputs within 2e-5 of max(1, |output|), batch statistics within rtol
    2e-5 / atol 1e-5, gradients within rel 1e-4 of max(1, |leaf|);
  * GoogLeNet whole at 224, batch 1, dropout off: the three train-mode
    outputs within 1e-4 of max(1, |logit|) (57 train-mode batch norms over
    one image; measured 4.8e-5), the loss with its two aux
    terms (0.3 each) against the JAX ``make_loss_fn`` (rtol 2e-5), the
    updated batch statistics (each leaf within 1e-4 of max(1, |leaf|)),
    the accuracy from the main logits; eval mode
    returns the main logits alone; gradients against float64 ``jax.grad``
    (batch 1 leaves float32 gradients about 2 % from float64 in both
    packages, so the port in float64 is held within 1e-6 and the port in
    float32 no further than twice the JAX package's float32 is);
  * Inception v3 (train mode: logits and aux) and v4 (eval mode) whole at
    299, batch 1, within 1e-4 of max(1, |logit|).
"""

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgwfbp_tpu.models import create_model as jax_create_model
from mgwfbp_tpu.models import googlenet as jgoog
from mgwfbp_tpu.models import inception as jinc
from mgwfbp_tpu.train.step import make_loss_fn
from mgwfbp_tpu_torch import models
from mgwfbp_tpu_torch.convert import flatten_flax, flax_shapes, variables_to_flax
from mgwfbp_tpu_torch.models import googlenet, inception
from mgwfbp_tpu_torch.train.step import forward_loss

from torch_zoo_util import (
    block_parity,
    f64_parity,
    images,
    jax_dropout_off,
    labels,
    nchw,
    np_tree,
    port_model,
)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs beside other test workers: two intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name,leaves,bn_leaves,params", [
    ("googlenet", 187, 118, 13_385_816),
    ("inceptionv3", 292, 192, 27_161_264),
    ("inceptionv4", 449, 298, 42_679_816),
])
def test_registered_inception_has_the_jax_tree(name, leaves, bn_leaves,
                                               params):
    jm, jmeta = jax_create_model(name)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + tuple(jmeta.input_shape)),
        train=False))
    with torch.device("meta"):
        module, meta = models.create_model(name)
    for coll in ("params", "batch_stats"):
        want = {p: tuple(s.shape) for p, s in flatten_flax(shapes[coll]).items()}
        got = flax_shapes(module, coll)
        assert list(got) == list(want) and got == want, coll
    n = sum(math.prod(s) for s in flax_shapes(module).values())
    assert (len(flax_shapes(module)), len(flax_shapes(module, "batch_stats")),
            n) == (leaves, bn_leaves, params)
    assert (meta.input_shape, meta.has_aux_logits) == (
        tuple(jmeta.input_shape), jmeta.has_aux_logits)
    assert meta.input_shape == ((224, 224, 3) if name == "googlenet"
                                else (299, 299, 3))


BLOCKS = {
    "Inception": (lambda: jgoog.Inception(64, 96, 128, 16, 32, 32),
                  lambda: googlenet.Inception(192, 64, 96, 128, 16, 32, 32),
                  (8, 8, 192)),
    "AuxHead": (lambda: jgoog.AuxHead(10),
                lambda: googlenet.AuxHead(512, 10, (14, 14)), (14, 14, 512)),
    "InceptionA3": (lambda: jinc.InceptionA3(32),
                    lambda: inception.InceptionA3(192, 32), (7, 7, 192)),
    "InceptionB3": (lambda: jinc.InceptionB3(),
                    lambda: inception.InceptionB3(288), (9, 9, 288)),
    "InceptionC3": (lambda: jinc.InceptionC3(128),
                    lambda: inception.InceptionC3(768, 128), (5, 5, 768)),
    "InceptionD3": (lambda: jinc.InceptionD3(),
                    lambda: inception.InceptionD3(768), (9, 9, 768)),
    "InceptionE3": (lambda: jinc.InceptionE3(),
                    lambda: inception.InceptionE3(1280), (3, 3, 1280)),
    # its second ConvBN normalizes a 1x1 map over the batch alone: batch 8
    # (at 2 each channel's two values normalize to +-1, and the gradients
    # through them are ill-conditioned in both packages)
    "InceptionV3Aux": (lambda: jinc.InceptionV3Aux(10),
                       lambda: inception.InceptionV3Aux(768, 10),
                       (17, 17, 768), 8),
    "StemV4": (lambda: jinc.StemV4(), lambda: inception.StemV4(3),
               (75, 75, 3)),
    "InceptionA4": (lambda: jinc.InceptionA4(),
                    lambda: inception.InceptionA4(384), (5, 5, 384)),
    "ReductionA4": (lambda: jinc.ReductionA4(),
                    lambda: inception.ReductionA4(384), (9, 9, 384)),
    "InceptionB4": (lambda: jinc.InceptionB4(),
                    lambda: inception.InceptionB4(1024), (5, 5, 1024)),
    "ReductionB4": (lambda: jinc.ReductionB4(),
                    lambda: inception.ReductionB4(1024), (9, 9, 1024)),
    "InceptionC4": (lambda: jinc.InceptionC4(),
                    lambda: inception.InceptionC4(1536), (3, 3, 1536)),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(monkeypatch, name):
    jax_dropout_off(monkeypatch)
    make_jax, make_port, hwc, *batch = BLOCKS[name]
    block = make_port()
    for m in block.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    block_parity(make_jax(), block,
                 images(batch[0] if batch else 2, hwc, seed=len(name)))


def _scaled_close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= rel * scale


def test_googlenet_train_outputs_and_aux_loss_match_jax(monkeypatch):
    jax_dropout_off(monkeypatch)
    m, meta = port_model("googlenet", seed=1)
    jm, jmeta = jax_create_model("googlenet")
    x, y = images(1, meta.input_shape, seed=2), labels(1, 1000, 2)
    params, bstats = variables_to_flax(m)
    variables = {"params": params, "batch_stats": bstats}
    (want, new_b) = jax.jit(partial(jm.apply, train=True,
                                    mutable=["batch_stats"]))(variables, x)
    _, (_, _, metrics) = jax.jit(make_loss_fn(jm, jmeta))(
        params, bstats, {"x": x, "y": y}, jax.random.PRNGKey(0), None)
    m.train()
    with torch.no_grad():
        got = m(nchw(x))
    assert isinstance(got, tuple) and len(got) == len(want) == 3
    for g, w in zip(got, want):
        _scaled_close(g.numpy(), w)
    want_b = flatten_flax(np_tree(new_b["batch_stats"]))
    for k, v in flatten_flax(variables_to_flax(m)[1]).items():
        _scaled_close(v, want_b[k])
    # the loss with its aux terms, from the updated model's fresh pass on
    # the same weights (batch statistics do not enter a train-mode output)
    loss, acc, _ = forward_loss(m, "classify", nchw(x), torch.from_numpy(y))
    np.testing.assert_allclose(loss.item(), float(metrics["loss"]), rtol=2e-5)
    assert acc.item() == float(metrics["accuracy"])
    main_only = torch.nn.functional.cross_entropy(got[0], torch.from_numpy(y)
                                                  .long())
    assert loss.item() > main_only.item()  # the aux terms count
    # eval: the main logits alone
    m.eval()
    with torch.no_grad():
        ev = m(nchw(x))
    assert isinstance(ev, torch.Tensor)
    want_ev = jax.jit(partial(jm.apply, train=False))(
        {"params": params, "batch_stats": variables_to_flax(m)[1]}, x)
    _scaled_close(ev.numpy(), want_ev)


def test_googlenet_gradients_match_jax_in_float64(tmp_path):
    m, meta = port_model("googlenet", seed=1)
    x, y = images(1, meta.input_shape, seed=3), labels(1, 1000, 3)
    errs = f64_parity(
        tmp_path, "googlenet", m, x, y,
        lambda mod, xt: forward_loss(mod, "classify", xt,
                                     torch.from_numpy(y))[0])
    print(f"googlenet vs float64 jax.grad: {errs}")


@pytest.mark.parametrize("name", ["inceptionv3", "inceptionv4"])
def test_inception_whole_matches_jax_at_299(monkeypatch, name):
    jax_dropout_off(monkeypatch)
    m, meta = port_model(name, seed=4)
    jm, _ = jax_create_model(name)
    x = images(1, meta.input_shape, seed=5)
    params, bstats = variables_to_flax(m)
    variables = {"params": params, "batch_stats": bstats}
    train = name == "inceptionv3"  # its aux head; v4 in eval mode
    want = jax.jit(partial(jm.apply, train=train, mutable=["batch_stats"]))(
        variables, x)[0]
    m.train(train)
    with torch.no_grad():
        got = m(nchw(x))
    if train:
        assert isinstance(got, tuple) and len(got) == len(want) == 2
        for g, w in zip(got, want):
            _scaled_close(g.numpy(), w)
    else:
        _scaled_close(got.numpy(), want)
