"""Port vs reference: the transformer LM and its weight carry-over
(mgwfbp_tpu_torch.models / convert vs mgwfbp_tpu.models).

Weights are made by the JAX module's own init (or the port's seeded
init), carried across with ``convert``, and the same integer tokens (numpy,
from a seed) go through ``TransformerLM.apply(train=False)`` and the port's
module in eval mode. On the CPU the JAX flash path runs the Pallas kernel in
interpret mode and the port's runs its plain PyTorch version.

Tolerance: logits within 1e-5 (rtol and atol) in float32. Both sides do the
same float32 arithmetic in a different order (XLA's fused dots vs torch's
GEMMs, two attention recurrences); at this size the logits are O(1) and
differ by a few float32 ulps after two residual layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgwfbp_tpu import models as jax_models
from mgwfbp_tpu.models.transformer import TransformerLM as JaxLM
from mgwfbp_tpu_torch import models
from mgwfbp_tpu_torch.convert import (
    flatten_flax,
    flax_path,
    keystr,
    params_from_flax,
    params_to_flax,
    torch_key,
)
from mgwfbp_tpu_torch.models import transformer as port_tf
from mgwfbp_tpu_torch.models.transformer import Block, TransformerLM, init_weights

SMALL = dict(d_model=32, num_heads=2, num_layers=2, d_ff=64, max_len=64)
VOCAB = 50
TOL = 1e-5


def _jax_params(impl: str, t: int = 64, seed: int = 0):
    jm = JaxLM(vocab_size=VOCAB, dropout=0.1, attn_impl=impl, **SMALL)
    params = jm.init(
        jax.random.PRNGKey(seed), jnp.zeros((2, t), jnp.int32)
    )["params"]
    return jm, jax.tree_util.tree_map(np.asarray, params)


def _tokens(b: int, t: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, VOCAB, (b, t)).astype(np.int32)


def _port(impl: str, params) -> TransformerLM:
    m = TransformerLM(vocab_size=VOCAB, attn_impl=impl, **SMALL)
    m.load_state_dict(params_from_flax(params), strict=True)
    return m.eval()


def test_params_roundtrip_is_identity():
    """params_to_flax . params_from_flax and the reverse are exact."""
    _, jparams = _jax_params("dense")
    back = flatten_flax(params_to_flax(_port("dense", jparams)))
    want = flatten_flax(jparams)
    assert list(back) == list(want)
    for path in want:
        np.testing.assert_array_equal(back[path], want[path], err_msg=path)

    m = init_weights(TransformerLM(vocab_size=VOCAB, **SMALL),
                     torch.Generator().manual_seed(1))
    again = TransformerLM(vocab_size=VOCAB, **SMALL)
    again.load_state_dict(params_from_flax(params_to_flax(m)), strict=True)
    for key, val in m.state_dict().items():
        assert torch.equal(again.state_dict()[key], val), key


def test_flax_tree_layout_matches_jax_init():
    """The port's Flax-form tree has the JAX module's leaf paths, in jax's
    flattening order, with the same shapes."""
    _, jparams = _jax_params("dense")
    m = init_weights(TransformerLM(vocab_size=VOCAB, **SMALL),
                     torch.Generator().manual_seed(0))
    ours = flatten_flax(params_to_flax(m))
    theirs = flatten_flax(jparams)
    assert list(ours) == list(theirs)
    assert [v.shape for v in ours.values()] == [v.shape for v in theirs.values()]
    # manifest spelling of the paths (jax.tree_util.keystr) round-trips
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    for (kp, _), path in zip(flat, theirs):
        ks = jax.tree_util.keystr(kp)
        assert keystr(path) == ks and flax_path(ks) == path


def test_torch_key_layout_rules():
    assert torch_key("Block_3.qkv.kernel") == "blocks.3.qkv.weight"
    assert torch_key("['ln_out']['scale']") == "ln_out.weight"
    assert torch_key("tok_embed.embedding") == "tok_embed.weight"
    with pytest.raises(KeyError):
        torch_key("Block_0.qkv.mean")


@pytest.mark.parametrize("t", [64, 35])
@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_transformer_matches_jax(impl, t):
    jm, jparams = _jax_params(impl, t)
    x = _tokens(3, t, seed=t)
    want = np.asarray(
        jm.apply({"params": jparams}, jnp.asarray(x), train=False)
    )
    with torch.inference_mode():
        got = _port(impl, jparams)(torch.from_numpy(x)).numpy()
    assert got.shape == (3, t, VOCAB) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_flash_and_dense_ports_agree():
    _, jparams = _jax_params("dense")
    x = torch.from_numpy(_tokens(2, 64, seed=9))
    with torch.inference_mode():
        a = _port("flash", jparams)(x)
        b = _port("dense", jparams)(x)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)


def test_block_outside_flash_contract_falls_back_to_dense(monkeypatch):
    """T=130 is not a whole number of 128-blocks: the flash Block takes the
    dense path, as the JAX Block does, and never calls flash_attention."""
    gen = torch.Generator().manual_seed(2)
    flash = init_weights(Block(32, 2, 64, 0.0, "flash"), gen).eval()
    dense = Block(32, 2, 64, 0.0, "dense").eval()
    dense.load_state_dict(flash.state_dict())

    def boom(*a, **k):
        raise AssertionError("flash_attention called outside its contract")

    monkeypatch.setattr(port_tf, "flash_attention", boom)
    h = torch.from_numpy(np.random.RandomState(4).randn(1, 130, 32).astype(np.float32))
    with torch.inference_mode():
        np.testing.assert_array_equal(flash(h).numpy(), dense(h).numpy())
    with pytest.raises(ValueError):
        Block(32, 2, 64, 0.0, "ring")


def test_dropout_is_off_in_eval_and_on_in_train():
    _, jparams = _jax_params("dense")
    m = _port("dense", jparams)
    x = torch.from_numpy(_tokens(2, 16, seed=3))
    with torch.no_grad():
        e1, e2 = m(x), m(x)
        m.train()
        torch.manual_seed(0)
        t1 = m(x)
    assert torch.equal(e1, e2) and not torch.equal(e1, t1)


def test_registry_transformer_is_the_published_width():
    module, meta = models.create_model("transformer")
    jmodule, jmeta = jax_models.create_model("transformer")
    for field in ("name", "dataset", "num_classes", "input_shape", "task",
                  "has_aux_logits", "has_carry"):
        assert getattr(meta, field) == getattr(jmeta, field), field
    assert np.dtype(meta.input_dtype) == np.dtype(jmeta.input_dtype)
    assert module.attn_impl == "flash"
    for field in ("vocab_size", "d_model", "num_heads", "num_layers", "d_ff",
                  "max_len", "dropout"):
        assert getattr(module, field) == getattr(jmodule, field), field
    assert (module.vocab_size, module.d_model, module.num_heads,
            module.num_layers, module.d_ff, module.max_len) == (
        10000, 256, 4, 4, 1024, 4096)
    # every leaf of the full-width JAX tree has its counterpart, same shape
    shapes = jax.eval_shape(
        lambda: jmodule.init(jax.random.PRNGKey(0),
                             jnp.zeros((1, 35), jnp.int32))
    )["params"]
    theirs = {p: tuple(s.shape) for p, s in flatten_flax(shapes).items()}
    ours = {p: a.shape for p, a in flatten_flax(params_to_flax(module)).items()}
    assert ours == theirs
    # num_classes retargets the vocabulary, as in the JAX registry
    small, smeta = models.create_model("transformer", num_classes=77)
    assert small.vocab_size == 77 and smeta.num_classes == 77
    with pytest.raises(ValueError):
        models.create_model("no_such_model")
