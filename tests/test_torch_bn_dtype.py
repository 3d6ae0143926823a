"""``MGWFBP_BN_DTYPE`` in the port's batch norm (``models/common.BatchNorm``)
against the JAX package's ``bn_kwargs``, which every Flax batch norm of
the CNNs and of DeepSpeech takes: with ``bfloat16`` the statistics reduce
in bfloat16 (Flax's ``force_float32_reductions=False``) and the output is
rounded to it.

On the same numpy-seeded inputs and weights: one batch norm over NCHW
maps and over (N, C) rows (DeepSpeech's sequence-wise batch norm), in
training and evaluation, its output, its running statistics and, in
training, the gradients of its input, scale and bias; a small CIFAR
ResNet's loss and batch statistics of one training forward
(``make_loss_fn``), at float32 and under the bfloat16 compute policy, and
its evaluation logits. Every comparison holds at 2e-2 (relative L2, and
elementwise against 2e-2 of the largest magnitude): the bfloat16 rounding
of two implementations' statistics may differ by one unit in the last
place. A whole network's gradients are not held at 2e-2: Flax keeps a
float32 model's batch-norm output in bfloat16 into the residual sum, which
the port's float32 layers take as float32 (the same rounded values, summed
without rounding), and the backward of a bfloat16 network amplifies such a
difference (tests/test_torch_mixed_precision.py holds a bfloat16 step
against its envelope).
Unset (or empty), the switch changes nothing: every output is bit-identical
to the default path's."""

from __future__ import annotations

from functools import partial

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgwfbp_tpu.models import ModelMeta
from mgwfbp_tpu.models.common import bn_kwargs
from mgwfbp_tpu.models.resnet_cifar import CifarResNet as JaxResNet
from mgwfbp_tpu.train.step import make_loss_fn
from mgwfbp_tpu_torch.convert import (
    flatten_flax,
    state_from_flax,
    variables_to_flax,
)
from mgwfbp_tpu_torch.models.common import BatchNorm, bn_dtype
from mgwfbp_tpu_torch.models.resnet_cifar import CifarResNet
from mgwfbp_tpu_torch.train.step import forward_loss

TOL = 2e-2
SMALL = dict(depth=8, widths=(4, 8, 16))


@pytest.fixture
def bf16(monkeypatch):
    monkeypatch.setenv("MGWFBP_BN_DTYPE", "bfloat16")


def _close(got, want, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert rel <= TOL, (what, rel)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


def _bn_case(shape, seed):
    """x (channels last), scale, bias, running mean, running var."""
    rs = np.random.RandomState(seed)
    c = shape[-1]
    x = (rs.randn(*shape) * 1.5 + rs.randn(c)).astype(np.float32)
    return (x, (1.0 + 0.3 * rs.randn(c)).astype(np.float32),
            (0.2 * rs.randn(c)).astype(np.float32),
            (0.5 * rs.randn(c)).astype(np.float32),
            (1.0 + rs.rand(c)).astype(np.float32))


@pytest.mark.parametrize("shape", [(6, 5, 5, 4), (40, 8)],
                         ids=["nchw", "rows"])
@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_flax_at_bf16(bf16, shape, train):
    assert bn_dtype() == torch.bfloat16
    x, scale, bias, mean, var = _bn_case(shape, seed=len(shape) + train)
    kw = bn_kwargs()
    assert kw == {"dtype": jnp.bfloat16, "force_float32_reductions": False}
    jbn = fnn.BatchNorm(use_running_average=not train, momentum=0.9, **kw)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    want, upd = jbn.apply(variables, x, mutable=["batch_stats"])
    assert want.dtype == jnp.bfloat16

    bn = BatchNorm(shape[-1]).train(train)
    assert bn.stat_dtype == torch.bfloat16
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    xt = torch.from_numpy(x)
    if len(shape) == 4:
        xt = xt.permute(0, 3, 1, 2).contiguous()
    if train:
        xt.requires_grad_(True)
    got = bn(xt)
    assert got.dtype == torch.float32  # rounded to bf16, promoted back
    assert torch.equal(got, got.to(torch.bfloat16).float())
    if len(shape) == 4:
        got = got.permute(0, 2, 3, 1)
    _close(got.detach().numpy(), np.asarray(want, np.float32), "output")
    stats = upd["batch_stats"]
    _close(bn.running_mean.numpy(), stats["mean"], "mean")
    _close(bn.running_var.numpy(), stats["var"], "var")
    if not train:
        return
    assert not np.allclose(bn.running_mean.numpy(), mean)  # they moved
    # gradients of sum(w * out) by the input, the scale and the bias
    w = np.random.RandomState(7).randn(*shape).astype(np.float32)

    def f(x, p):
        out = jbn.apply({"params": p, "batch_stats": variables[
            "batch_stats"]}, x, mutable=["batch_stats"])[0]
        return (out.astype(jnp.float32) * w).sum()

    gx, gp = jax.grad(f, argnums=(0, 1))(x, variables["params"])
    (got * torch.from_numpy(w)).sum().backward()
    gxt = xt.grad
    if len(shape) == 4:
        gxt = gxt.permute(0, 2, 3, 1)
    _close(gxt.numpy(), np.asarray(gx), "input gradient")
    _close(bn.weight.grad.numpy(), np.asarray(gp["scale"]), "scale gradient")
    _close(bn.bias.grad.numpy(), np.asarray(gp["bias"]), "bias gradient")


def _jax_init(seed=0):
    jm = JaxResNet(**SMALL)
    v = jax.jit(partial(jm.init, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 3)))
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    bstats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    # running statistics away from their init, so that eval reads them
    rs = np.random.RandomState(seed + 1)
    bstats = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rs.rand(*a.shape)).astype(np.float32), bstats)
    return jm, params, bstats


def _port(params, bstats) -> CifarResNet:
    m = CifarResNet(**SMALL)
    m.load_state_dict(state_from_flax(m, params, bstats), strict=True)
    return m


def _batch(seed=3):
    rs = np.random.RandomState(seed)
    x = rs.randn(4, 16, 16, 3).astype(np.float32)
    y = rs.randint(0, 10, 4).astype(np.int32)
    return x, y


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("compute", [None, "bfloat16"])
def test_resnet_training_forward_matches_jax_at_bf16_stats(bf16, compute):
    """Loss and merged batch statistics of one training forward, the
    port's ``forward_loss`` against the JAX ``make_loss_fn``, both with
    MGWFBP_BN_DTYPE=bfloat16, at float32 and under the bfloat16 compute
    policy."""
    jm, params, bstats = _jax_init()
    meta = ModelMeta(name="resnet8", dataset="cifar10", num_classes=10,
                     input_shape=(16, 16, 3))
    x, y = _batch()
    cdt = None if compute is None else jnp.bfloat16
    _, (new_b, _, metrics) = jax.jit(
        make_loss_fn(jm, meta, compute_dtype=cdt))(
        params, bstats, {"x": x, "y": y}, jax.random.PRNGKey(0), None)
    m = _port(params, bstats).train()
    with torch.no_grad():
        loss, _, _ = forward_loss(
            m, "classify", _nchw(x), torch.from_numpy(y).long(), None,
            None if compute is None else torch.bfloat16)
    _close(loss.item(), float(metrics["loss"]), "loss")
    _, got_b = variables_to_flax(m)
    want_b = flatten_flax(jax.tree_util.tree_map(np.asarray, new_b))
    for k, v in flatten_flax(got_b).items():
        _close(v, want_b[k], k)


def test_resnet_eval_matches_jax_at_bf16_stats(bf16):
    jm, params, bstats = _jax_init(seed=2)
    x, _ = _batch(seed=4)
    want = jax.jit(partial(jm.apply, train=False))(
        {"params": params, "batch_stats": bstats}, x)
    m = _port(params, bstats).eval()
    with torch.no_grad():
        got = m(_nchw(x))
    _close(got.numpy(), np.asarray(want, np.float32), "logits")


def _run_default(monkeypatch, value):
    """Logits, loss, gradients and buffers of one training forward of the
    port's small ResNet with MGWFBP_BN_DTYPE set to ``value`` (None:
    unset), from fixed weights."""
    if value is None:
        monkeypatch.delenv("MGWFBP_BN_DTYPE", raising=False)
    else:
        monkeypatch.setenv("MGWFBP_BN_DTYPE", value)
    torch.manual_seed(0)
    m = CifarResNet(**SMALL)
    assert all(b.stat_dtype is None for b in m.modules()
               if isinstance(b, BatchNorm))
    x, y = _batch()
    loss, _, _ = forward_loss(m.train(), "classify", _nchw(x),
                              torch.from_numpy(y).long())
    loss.backward()
    with torch.no_grad():
        logits = m.eval()(_nchw(x))
    return ([loss.detach(), logits] + [p.grad for p in m.parameters()]
            + list(m.buffers()))


def test_unset_changes_nothing(monkeypatch):
    """Unset and empty give the default path bit for bit (the statistics in
    float32 by ``torch.var_mean``, torch's batch norm for the output)."""
    a = _run_default(monkeypatch, None)
    b = _run_default(monkeypatch, "")
    assert len(a) == len(b)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    bn = BatchNorm(3).train()
    x = torch.from_numpy(np.random.RandomState(5).randn(4, 3, 2, 2)
                         .astype(np.float32))
    out = bn(x)
    var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
    assert torch.equal(bn.running_mean, torch.zeros(3).mul_(0.9)
                       .add_(mean, alpha=0.1))
    assert torch.equal(out, torch.batch_norm(
        x, bn.weight, bn.bias, None, None, True, 0.0, bn.epsilon,
        torch.backends.cudnn.enabled))


def test_a_non_floating_dtype_is_refused(monkeypatch):
    monkeypatch.setenv("MGWFBP_BN_DTYPE", "int8")
    with pytest.raises(ValueError, match="MGWFBP_BN_DTYPE"):
        BatchNorm(3)
