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
its evaluation logits; and, on nine data draws, one training step's
parameter gradients of a float32 small ResNet against ``jax.grad`` of
``make_loss_fn`` (where a draw misses, the witness that XLA's ``rsqrt``
alone separates the two: see the test). Every
comparison holds at 2e-2 (relative L2, and elementwise against 2e-2 of
the largest magnitude; the gradients by relative L2 per parameter): the
bfloat16 rounding of two implementations' statistics may differ by one
unit in the last place. The batch norm hands its output on in bfloat16,
as Flax does, so a residual sum of two batch-norm branches is rounded to
bfloat16 on both sides and the next conv or dense layer computes in
float32 on the promoted input (``models.common.promote``).
Unset (or empty), the switch changes nothing: every output is bit-identical
to the default path's."""

from __future__ import annotations

import functools
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
    assert got.dtype == torch.bfloat16  # handed on in bf16, as Flax does
    if len(shape) == 4:
        got = got.permute(0, 2, 3, 1)
    _close(got.detach().float().numpy(), np.asarray(want, np.float32),
           "output")
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


# nine data draws: (init seed, batch seed)
DRAWS = [(i, b) for i in (0, 1, 5) for b in (3, 4, 6)]


@functools.lru_cache(maxsize=None)
def _jax_step_grad():
    """``jax.grad`` of the JAX ``make_loss_fn`` of the small ResNet, jitted
    once for every draw (the batch norm's dtype is read when it traces, so
    only the bfloat16 test calls it)."""
    jm = JaxResNet(**SMALL)
    meta = ModelMeta(name="resnet8", dataset="cifar10", num_classes=10,
                     input_shape=(16, 16, 3))
    loss_fn = make_loss_fn(jm, meta)

    def f(params, bstats, x, y):
        return loss_fn(params, bstats, {"x": x, "y": y},
                       jax.random.PRNGKey(0), None)

    return jax.jit(jax.grad(f, has_aux=True))


_xla_rsqrt = jax.jit(jax.lax.rsqrt)  # XLA's float32 rsqrt on the CPU


def _port_step_grads(params, bstats, x, y) -> dict:
    """The port's float32 small ResNet's parameter gradients of one
    training step, by Flax path."""
    from mgwfbp_tpu_torch.convert import _param_rules

    m = _port(params, bstats).train()
    m.zero_grad()
    loss, _, _ = forward_loss(m, "classify", _nchw(x),
                              torch.from_numpy(y).long())
    assert loss.dtype == torch.float32
    loss.backward()
    return {path: to_flax(p.grad).double().numpy()
            for path, (p, to_flax, _) in _param_rules(m).items()}


def _rel_l2(got: dict, want: dict) -> dict:
    assert sorted(got) == sorted(want)
    return {k: float(np.linalg.norm(got[k] - want[k])
                     / max(np.linalg.norm(want[k]), 1e-30)) for k in want}


@pytest.mark.parametrize("init_seed,batch_seed", DRAWS)
def test_resnet_step_gradients_match_jax_at_bf16_stats(bf16, monkeypatch,
                                                       init_seed, batch_seed):
    """One training step of a float32 small ResNet: every parameter's
    gradient against ``jax.grad`` of the JAX ``make_loss_fn``, both with
    MGWFBP_BN_DTYPE=bfloat16, at 2e-2 relative L2 each, on nine draws. The
    residual sums of bfloat16 batch-norm outputs round to bfloat16 on both
    sides.

    The comparison is one of rounding: the batch norm's backward cancels
    nearly all its terms in bfloat16, so a last-bit change of one float32
    value can move a gradient by percents (a 1e-7 relative change of the
    input moves ResNet-20's by 13-15 %). Both sides round at the same
    places (``models.common._StatDtypeNorm``) but compute ``rsqrt`` by
    different float32 approximations, which differ in the last bit on
    about a third of inputs; where such a bit lands on a bfloat16 rounding
    boundary, a draw misses (init seed 5, batch seed 6: the stem's scale,
    2.02 %). The witness: fed XLA's own ``rsqrt`` values, the port's step
    is within the tolerance on every draw, that one included."""
    jm, params, bstats = _jax_init(init_seed)
    x, y = _batch(batch_seed)
    want = flatten_flax(jax.tree_util.tree_map(
        np.asarray, _jax_step_grad()(params, bstats, x, y)[0]))
    want = {k: np.asarray(v, np.float64) for k, v in want.items()}
    m = _port(params, bstats).train()
    with torch.no_grad():
        block = m.blocks[0]
        branch = block.conv2(block.conv1(m.stem(_nchw(x))))
    assert branch.dtype == torch.bfloat16  # as Flax hands it on
    own = _rel_l2(_port_step_grads(params, bstats, x, y), want)

    torch_rsqrt = torch.rsqrt
    differing = []

    def rsqrt(v):
        r = torch.from_numpy(np.asarray(_xla_rsqrt(v.detach().numpy())))
        differing.append(int((r != torch_rsqrt(v)).sum()))
        return r

    monkeypatch.setattr(torch, "rsqrt", rsqrt)
    fed = _rel_l2(_port_step_grads(params, bstats, x, y), want)
    monkeypatch.undo()
    assert len(differing) == sum(isinstance(b, BatchNorm)
                                 for b in m.modules())
    bad = {k: r for k, r in fed.items() if r > TOL}
    assert not bad, ("fed XLA's rsqrt", bad)
    missed = {k: r for k, r in own.items() if r > TOL}
    # a miss of the port's own step is the rsqrt's last bit alone: the two
    # rsqrt differ on this draw's inputs, and fed XLA's, each missed
    # parameter agrees a hundred times closer than the tolerance
    assert not missed or sum(differing) > 0, missed
    assert all(fed[k] <= TOL / 100 for k in missed), (missed, fed)


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
