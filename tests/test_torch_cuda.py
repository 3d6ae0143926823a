"""The port's CUDA kernels on the card (marker ``cuda``; skipped without one).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch: from the root of a checkout,

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py sets JAX up). Tolerances are
tests/test_flashattn.py's: float32 2e-5, bfloat16 2e-2.
"""

import numpy as np
import pytest
import torch

from mgwfbp_tpu_torch.models.transformer import TransformerLM, init_weights
from mgwfbp_tpu_torch.ops import flashattn as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape,causal,dtype,tol", [
    ((8, 35, 4, 64), True, torch.float32, 2e-5),
    ((2, 100, 3, 40), False, torch.float32, 2e-5),
    ((1, 256, 2, 256), False, torch.float32, 2e-5),
    ((1, 128, 2, 64), True, torch.bfloat16, 2e-2),
])
def test_kernel_matches_plain(card, shape, causal, dtype, tol):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen).to(card, dtype)
               for _ in range(3))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == shape
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_kernel_reads_strided_qkv_views(card):
    """The transformer hands the kernel views of its fused qkv product
    (B, T, H, D) with a row stride of 3 * H * D."""
    b, t, h, d = 4, 35, 4, 64
    qkv = torch.randn((b, t, 3 * h * d), generator=torch.Generator().manual_seed(1)).to(card)
    q, k, v = (x.reshape(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    assert not q.is_contiguous()
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention(*(x.contiguous() for x in (q, k, v)))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_kernel_refuses_what_it_cannot_run(card):
    q = torch.zeros((1, 16, 1, 8), device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)
    f = torch.zeros((1, 16, 1, 8), device=card)
    with pytest.raises(ValueError):
        fa.flash_attention(f, f, f.cpu())
    with pytest.raises(ValueError):
        fa.flash_attention(f.transpose(1, 3).contiguous().transpose(1, 3), f, f)


def test_transformer_flash_on_card_matches_dense(card):
    gen = torch.Generator().manual_seed(2)
    flash = init_weights(
        TransformerLM(vocab_size=100, d_model=64, num_heads=2, num_layers=2,
                      d_ff=128, max_len=64, attn_impl="flash"), gen
    ).to(card).eval()
    dense = TransformerLM(vocab_size=100, d_model=64, num_heads=2,
                          num_layers=2, d_ff=128, max_len=64).to(card).eval()
    dense.load_state_dict(flash.state_dict())
    x = torch.from_numpy(
        np.random.RandomState(0).randint(0, 100, (3, 35))
    ).to(card)
    before = fa.flash_attention.launches
    with torch.inference_mode():
        a, b = flash(x), dense(x)
    assert fa.flash_attention.launches == before + 2
    assert (a - b).abs().max().item() <= 1e-4
