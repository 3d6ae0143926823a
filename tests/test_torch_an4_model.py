"""Port vs reference: the speech model ``lstman4`` (mgwfbp_tpu_torch.models.
deepspeech vs mgwfbp_tpu.models.deepspeech) and its CTC loss
(mgwfbp_tpu_torch.train.step.ctc_loss vs optax.ctc_loss).

  * the trees: the full-width model's 78 parameter and 14 batch-statistic
    leaves (27,553,504 parameters) and the bidirectional model's have the
    names and shapes of ``jax.eval_shape``'s;
  * a small DeepSpeech (hidden 24, 2 layers, T 48, three unequal lengths in
    one batch), unidirectional and bidirectional, on the port's seeded
    init carried to the JAX module: eval and train-mode logits within
    OUT_TOL of max(1, the largest logit), the output lengths equal, the
    updated batch statistics within STAT_TOL;
  * its CTC-loss gradients against float64 ``jax.grad`` of the JAX
    package's loss (``make_loss_fn``, task ctc) in a subprocess: the port
    in float64 within 1e-6, in float32 no further than twice the JAX
    package's own float32 gradients plus 1e-5 (tests/torch_zoo_util.py's
    rule; the float32 LSTM gradients of both packages drift from float64);
  * ``ctc_loss`` and its gradient against ``optax.ctc_loss``, with one
    sequence that has no alignment: optax floors log(0) at -1e5 and returns
    a large finite loss; the port returns the same value (float32 within
    CTC_TOL relative; float64 within 1e-9), never torch's inf.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mgwfbp_tpu.models import create_model as jax_create_model
from mgwfbp_tpu.models.deepspeech import DeepSpeech as JaxDeepSpeech
from mgwfbp_tpu_torch import models
from mgwfbp_tpu_torch.convert import (
    _leaf_map,
    flatten_flax,
    flax_leaves,
    flax_shapes,
    state_from_flax,
    variables_to_flax,
)
from mgwfbp_tpu_torch.models.common import init_weights
from mgwfbp_tpu_torch.models.deepspeech import DeepSpeech, flip_sequences
from mgwfbp_tpu_torch.train.step import (
    ctc_impossible,
    ctc_loss,
    ctc_loss_plain,
    forward_loss,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, LAYERS, B, T = 24, 2, 3, 48  # the small model and its batch
LENGTHS = np.array([48, 40, 23], np.int32)
OUT_TOL = 2e-5  # of max(1, largest logit): one float32 program in two orders
STAT_TOL = 1e-6  # batch statistics after one train-mode forward
CTC_TOL = 1e-6  # relative: float32 loss of each sequence


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs beside other test workers: two intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _small(bidirectional: bool, seed: int = 1) -> DeepSpeech:
    m = DeepSpeech(hidden_size=H, num_layers=LAYERS,
                   bidirectional=bidirectional)
    return init_weights(m, torch.Generator().manual_seed(seed))


def _spect(seed: int = 0) -> np.ndarray:
    x = np.random.RandomState(seed).randn(B, T, 161).astype(np.float32)
    for j, n in enumerate(LENGTHS):
        x[j, n:] = 0.0  # padded frames, as the loader pads them
    return x


def _labels(seed: int = 2) -> tuple[np.ndarray, np.ndarray]:
    rs = np.random.RandomState(seed)
    y = rs.randint(1, 29, (B, 6)).astype(np.int32)
    llen = np.array([6, 4, 3], np.int32)
    for j, n in enumerate(llen):
        y[j, n:] = 0
    return y, llen


# -- trees ----------------------------------------------------------------


@pytest.mark.parametrize("bidirectional", [False, True])
def test_full_width_tree_equals_eval_shape(bidirectional):
    m, meta = models.create_model("lstman4")
    jm, jmeta = jax_create_model("lstman4")
    if bidirectional:
        m = DeepSpeech(bidirectional=True)
        jm = JaxDeepSpeech(bidirectional=True)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 201, 161)), train=False))
    for coll in ("params", "batch_stats"):
        want = {
            ".".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                shapes[coll])[0]
        }
        got = flax_shapes(m, coll)
        assert list(got) == list(want) and got == want
    # two cells of 12 leaves per layer and no Lookahead: 137 leaves
    assert len(flax_shapes(m, "params")) == (137 if bidirectional else 78)
    assert len(flax_shapes(m, "batch_stats")) == 14
    if not bidirectional:
        assert sum(p.numel() for p in m.parameters()) == 27_553_504
        assert (meta.task, meta.input_shape, meta.num_classes) == (
            jmeta.task, tuple(jmeta.input_shape), jmeta.num_classes)


def test_flip_sequences_is_flax():
    from flax.linen.recurrent import flip_sequences as flax_flip

    x = np.random.RandomState(3).randn(B, T, 5).astype(np.float32)
    want = flax_flip(jnp.asarray(x), jnp.asarray(LENGTHS), num_batch_dims=1,
                     time_major=False)
    got = flip_sequences(torch.from_numpy(x), torch.from_numpy(LENGTHS))
    assert np.array_equal(got.numpy(), np.asarray(want))


# -- forward --------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_forward_matches_jax_with_unequal_lengths(bidirectional, train):
    m = _small(bidirectional)
    params, bstats = variables_to_flax(m)
    # batch statistics away from their init, so eval mode reads them
    bstats = jax.tree_util.tree_map(
        lambda a: a + np.float32(0.1) * np.arange(a.size, dtype=np.float32)
        .reshape(a.shape) / a.size, bstats)
    m.load_state_dict(state_from_flax(m, params, bstats))
    jm = JaxDeepSpeech(hidden_size=H, num_layers=LAYERS,
                       bidirectional=bidirectional)
    x = _spect()
    m.train(train)
    with torch.no_grad():
        logits, out_len = m(torch.from_numpy(x), torch.from_numpy(LENGTHS))
    res = jm.apply({"params": params, "batch_stats": bstats}, jnp.asarray(x),
                   jnp.asarray(LENGTHS), train=train,
                   mutable=["batch_stats"] if train else False)
    (jlogits, jlen), upd = res if train else (res, None)
    jlogits = np.asarray(jlogits)
    assert logits.shape == jlogits.shape == (B, 24, 29)
    assert out_len.tolist() == np.asarray(jlen).tolist() == [24, 20, 12]
    scale = max(1.0, float(np.abs(jlogits).max()))
    assert np.abs(logits.numpy() - jlogits).max() <= OUT_TOL * scale
    if train:
        got = flatten_flax(variables_to_flax(m)[1])
        for k, w in flatten_flax(_np(upd["batch_stats"])).items():
            np.testing.assert_allclose(got[k], w, rtol=0, atol=STAT_TOL,
                                       err_msg=k)


# -- gradients against float64 jax.grad -----------------------------------

_JAX_F64 = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
from flax import linen as fnn
from mgwfbp_tpu.models import ModelMeta
from mgwfbp_tpu.models.deepspeech import DeepSpeech
from mgwfbp_tpu.train.step import make_loss_fn
from mgwfbp_tpu_torch.convert import flatten_flax
# Flax's nn.RNN starts the LSTM from a float32 zero carry; the float64 pass
# needs it in the pass's dtype
DT = [np.float32]
_carry = fnn.OptimizedLSTMCell.initialize_carry
fnn.OptimizedLSTMCell.initialize_carry = lambda self, rng, shape: tuple(
    c.astype(DT[0]) for c in _carry(self, rng, shape))
z = np.load(sys.argv[1])
model = DeepSpeech(hidden_size=int(z["h"]), num_layers=int(z["layers"]),
                   bidirectional=bool(z["bi"]))
meta = ModelMeta("lstman4", "an4", 29, (int(z["t"]), 161), task="ctc")
lf = make_loss_fn(model, meta)
def nest(prefix, dt):
    out = {}
    for k in z.files:
        if k.startswith(prefix):
            *mods, leaf = k[len(prefix):].split(".")
            node = out
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = z[k].astype(dt)
    return out
out = {}
for tag, dt in (("f64", np.float64), ("f32", np.float32)):
    DT[0] = dt
    batch = {"x": z["x"].astype(dt), "y": z["y"],
             "input_lengths": z["ilen"], "label_lengths": z["llen"]}
    g, _ = jax.jit(jax.grad(lf, has_aux=True))(
        nest("params/", dt), nest("bstats/", dt), batch,
        jax.random.PRNGKey(0), None)
    out.update({f"{tag}/{k}": np.asarray(v)
                for k, v in flatten_flax(g).items()})
np.savez(sys.argv[2], **out)
"""


def _rel_errs(module, want: dict) -> dict:
    """Each leaf's gradient, in Flax layout by convert's own rules, against
    ``want`` relative to max(1, the leaf's largest magnitude)."""
    params = dict(module.named_parameters())
    out = {}
    for (coll, path), (key, to_flax, _) in _leaf_map(module).items():
        if coll != "params":
            continue
        g = to_flax(params[key].grad).double().numpy()
        w = np.asarray(want[path], np.float64)
        out[path] = float(np.abs(g - w).max()) / max(1.0, float(np.abs(w).max()))
    return out


@pytest.mark.parametrize("bidirectional", [False, True])
def test_gradients_match_float64_jax_grad(tmp_path, bidirectional):
    m = _small(bidirectional, seed=5)
    params, bstats = variables_to_flax(m)
    x = _spect(seed=6)
    y, llen = _labels()
    arrays = {f"params/{k}": v for k, v in flatten_flax(params).items()}
    arrays.update({f"bstats/{k}": v for k, v in flatten_flax(bstats).items()})
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, x=x, y=y, ilen=LENGTHS, llen=llen, h=H, layers=LAYERS,
             bi=bidirectional, t=T, **arrays)
    res = subprocess.run(
        [sys.executable, "-c", _JAX_F64, str(src), str(dst)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu"),
    )
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(dst) as z:
        want64 = {k[4:]: z[k] for k in z.files if k.startswith("f64/")}
        want32 = {k[4:]: z[k] for k in z.files if k.startswith("f32/")}
    assert list(flatten_flax(want64)) == [p for p, _ in flax_leaves(m)]
    state = {k: v.clone() for k, v in m.state_dict().items()}
    errs = {}
    for dtype in (torch.float64, torch.float32):
        m.load_state_dict(state)
        mm = m.to(dtype).train()
        mm.zero_grad(set_to_none=True)
        loss, _, _ = forward_loss(
            mm, "ctc", torch.from_numpy(x).to(dtype), torch.from_numpy(y),
            lengths=(torch.from_numpy(LENGTHS), torch.from_numpy(llen)))
        loss.backward()
        errs[dtype] = max(_rel_errs(mm, want64).values())
    jax32 = max(
        float(np.abs(want32[k] - w).max()) / max(1.0, float(np.abs(w).max()))
        for k, w in want64.items())
    assert errs[torch.float64] <= 1e-6, errs
    assert errs[torch.float32] <= 2 * jax32 + 1e-5, (errs, jax32)


# -- the CTC loss ---------------------------------------------------------


def _ctc_case():
    """Four sequences: three with an alignment (one with a repeated label),
    one without (3 frames for 3 labels of which two repeat: 4 needed)."""
    rs = np.random.RandomState(7)
    logits = rs.randn(4, 20, 29).astype(np.float32) * 2
    olen = np.array([20, 12, 17, 3], np.int32)
    lab = np.array([[3, 4, 5, 5, 6], [1, 2, 3, 0, 0], [9, 9, 2, 0, 0],
                    [7, 7, 8, 0, 0]], np.int32)
    llen = np.array([5, 3, 3, 3], np.int32)
    return logits, olen, lab, llen


def _optax(logits, olen, lab, llen):
    t, n = logits.shape[1], lab.shape[1]
    lpad = (jnp.arange(t)[None] >= olen[:, None]).astype(logits.dtype)
    ypad = (jnp.arange(n)[None] >= llen[:, None]).astype(logits.dtype)
    return optax.ctc_loss(logits, lpad, jnp.asarray(lab), ypad)


def test_ctc_impossible_is_where_torch_has_no_alignment():
    logits, olen, lab, llen = _ctc_case()
    bad = ctc_impossible(torch.from_numpy(lab), torch.from_numpy(llen),
                         torch.from_numpy(olen))
    assert bad.tolist() == [False, False, False, True]
    raw = torch.nn.functional.ctc_loss(
        torch.from_numpy(logits).log_softmax(-1).transpose(0, 1),
        torch.from_numpy(lab).long(), torch.from_numpy(olen).long(),
        torch.from_numpy(llen).long(), reduction="none")
    assert torch.isinf(raw).tolist() == bad.tolist()


def test_ctc_loss_and_gradient_match_optax_with_an_impossible_alignment():
    logits, olen, lab, llen = _ctc_case()
    want = np.asarray(_optax(jnp.asarray(logits), olen, lab, llen))
    lt = torch.from_numpy(logits).requires_grad_()
    per = ctc_loss(lt, torch.from_numpy(olen), torch.from_numpy(lab),
                   torch.from_numpy(llen))
    assert torch.isfinite(per).all() and want[3] > 1e5  # optax's floor
    np.testing.assert_allclose(per.detach().numpy(), want, rtol=CTC_TOL)
    per.mean().backward()
    g32 = np.asarray(jax.grad(
        lambda lg: _optax(lg, olen, lab, llen).mean())(jnp.asarray(logits)))
    # the sequences with an alignment: torch's CTC gradient is exact to
    # float32 rounding, as optax's is
    np.testing.assert_allclose(lt.grad.numpy()[:3], g32[:3], rtol=0,
                               atol=5e-6)
    # the impossible one: both packages compute the same float32 recursion
    # at magnitude 1e5 (ulp 7.8e-3); the port's plain recursion in float64
    # against optax's in float64 (below) is the exact check, and in float32
    # each lies within 2e-3 of it
    assert np.abs(lt.grad.numpy()[3] - g32[3]).max() <= 4e-3


def test_ctc_plain_recursion_is_optax_in_float64():
    logits, olen, lab, llen = _ctc_case()
    jax.config.update("jax_enable_x64", True)
    try:
        want = np.asarray(_optax(jnp.asarray(logits, jnp.float64), olen, lab,
                                 llen))
        g64 = np.asarray(jax.grad(lambda lg: _optax(lg, olen, lab, llen).sum())(
            jnp.asarray(logits, jnp.float64)))
    finally:
        jax.config.update("jax_enable_x64", False)
    lt = torch.from_numpy(logits.astype(np.float64)).requires_grad_()
    per = ctc_loss_plain(lt, torch.from_numpy(olen), torch.from_numpy(lab),
                         torch.from_numpy(llen))
    np.testing.assert_allclose(per.detach().numpy(), want, rtol=1e-12)
    per.sum().backward()
    np.testing.assert_allclose(lt.grad.numpy(), g64, rtol=0, atol=1e-9)
    # and torch's CTC in float64 where an alignment exists
    full = ctc_loss(lt.detach(), torch.from_numpy(olen),
                    torch.from_numpy(lab), torch.from_numpy(llen))
    np.testing.assert_allclose(full.numpy(), want, rtol=1e-12)
