"""Port vs reference: flash attention (mgwfbp_tpu_torch.ops.flashattn vs
mgwfbp_tpu.ops.flashattn).

On the CPU the port runs its plain PyTorch version and the JAX function
runs the Pallas kernel in interpret mode, as tests/test_flashattn.py runs
it. Inputs are made with numpy from a seed and handed to both. Tolerances
are tests/test_flashattn.py's: float32 2e-5 (two orders of float32
summation); bfloat16 2e-2 (both sides round inputs and output to bfloat16).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgwfbp_tpu.ops import flash_attention as jax_flash
from mgwfbp_tpu.ops import flash_supported as jax_supported
from mgwfbp_tpu_torch.ops import flashattn as port
from mgwfbp_tpu_torch.parallel.ringattn import local_attention

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _qkv(b=2, t=64, h=2, d=16, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, t, h, d).astype(np.float32) for _ in range(3)]


def _both(arrays, causal, block, dtype="float32"):
    jx = [jnp.asarray(a, dtype) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    want = jax_flash(*jx, causal=causal, block_q=block, block_k=block)
    got = port.flash_attention(*tx, causal=causal, block_q=block, block_k=block)
    return np.asarray(want, np.float32), got.float().numpy(), got


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("d", [16, 32])
def test_plain_matches_jax_f32(d, block, causal):
    want, got, _ = _both(_qkv(d=d, seed=d + block), causal, block)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_jax_bf16(causal):
    want, got, out = _both(_qkv(seed=5), causal, 32, dtype="bfloat16")
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_serve_length_single_block(causal):
    # T=35 (the transformer's serving window): min(128, 35) = 35, one block
    assert port.flash_supported(35, 64) and jax_supported(35, 64)
    want, got, _ = _both(_qkv(b=2, t=35, h=2, d=32, seed=7), causal, 128)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_plain_matches_dense_local_attention():
    q, k, v = (torch.from_numpy(a) for a in _qkv(t=64, d=16, seed=11))
    for causal in (True, False):
        got = port.flash_attention_reference(q, k, v, causal=causal,
                                             block_q=16, block_k=16)
        want = local_attention(q, k, v, causal=causal)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                                   atol=2e-5)


def test_supported_and_value_error_parity():
    for t in (1, 16, 24, 35, 64, 100, 128, 130, 256, 384):
        for d in (8, 64, 256, 300):
            for bq, bk in ((128, 128), (16, 16), (16, 32), (64, 128)):
                assert port.flash_supported(t, d, bq, bk) == jax_supported(
                    t, d, bq, bk
                ), (t, d, bq, bk)
    for t, d, block in ((24, 300, 128), (100, 16, 16), (130, 16, 128)):
        arrays = _qkv(b=1, t=t, h=1, d=d)
        with pytest.raises(ValueError):
            jax_flash(*(jnp.asarray(a) for a in arrays), block_q=block,
                      block_k=block)
        with pytest.raises(ValueError):
            port.flash_attention(*(torch.from_numpy(a) for a in arrays),
                                 block_q=block, block_k=block)


def test_cpu_tensor_never_touches_kernel_loader(monkeypatch):
    from mgwfbp_tpu_torch.ops import _build

    def boom(*a, **k):
        raise AssertionError("the CUDA kernel loader was called for a CPU tensor")

    monkeypatch.setattr(_build, "load", boom)
    monkeypatch.setattr(_build, "build", boom)
    monkeypatch.setattr(port.flash_attention, "launches", 0)
    q, k, v = (torch.from_numpy(a) for a in _qkv())
    port.flash_attention(q, k, v)
    assert port.flash_attention.launches == 0


def test_other_devices_raise_instead_of_falling_back():
    q = torch.empty((1, 16, 1, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port.flash_attention(q, q, q)


def test_port_imports_no_jax_flax_or_reference():
    """Every module of the port, chip_smoke.py and chip_compare.py import
    without pulling jax, flax or mgwfbp_tpu into the interpreter."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mgwfbp_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "mgwfbp_tpu_torch.__path__, 'mgwfbp_tpu_torch.')]\n"
        "for n in names + ['chip_smoke', 'chip_compare']:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'mgwfbp_tpu'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 15, names\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=_ROOT)
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=_ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr



# -- the CUDA kernel's float32 numerics, emulated on the CPU -----------------
# The kernel computes both float32 products on the tensor cores in TF32
# (10 mantissa bits). csrc/flash_attn_fwd.cu splits every operand as
# x = hi + lo, hi = x truncated to TF32, lo = x - hi rounded to TF32 to
# nearest (ties away from zero), and accumulates hi*lo + lo*hi + hi*hi in
# float32. The helpers below round exactly as its `split_tf32` does.

def _tf32_trunc(x):
    return (np.asarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_rna(x):
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    hi = _tf32_trunc(x)
    return hi, _tf32_rna(x - hi)


def _mm_3xtf32(a, b):
    """a @ b as the kernel's three TF32 products, summed in float32 (the
    products of two TF32 values are exact in float32)."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def _mm_1xtf32(a, b):
    return _tf32_rna(a) @ _tf32_rna(b)


def _attention(q, k, v, causal, mm):
    """(B, T, H, D) attention with both products through `mm`, the
    softmax in float32 with the scale folded into log2(e), as the kernel
    does (exp2 of scores * scale * log2(e) minus the row max)."""
    b, t, h, d = q.shape
    sl2 = np.float32(d ** -0.5 * np.log2(np.e))
    out = np.empty_like(q)
    for bi in range(b):
        for hi in range(h):
            s = mm(q[bi, :, hi], k[bi, :, hi].T) * sl2
            if causal:
                s = np.where(np.tril(np.ones((t, t), bool)), s, -np.inf)
            p = np.exp2(s - s.max(axis=1, keepdims=True)).astype(np.float32)
            out[bi, :, hi] = mm(p, v[bi, :, hi]) / p.sum(axis=1, keepdims=True)
    return out


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [40, 64])
@pytest.mark.parametrize("t", [35, 128])
def test_3xtf32_split_keeps_float32_accuracy(t, d, causal):
    """The kernel's float32 arithmetic meets the 2e-5 bound of the JAX
    kernel (interpret mode); a single TF32 product does not, which is why
    the kernel pays for three."""
    q, k, v = _qkv(b=2, t=t, h=2, d=d, seed=t + d)
    want = np.asarray(
        jax_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=causal),
        np.float32,
    )
    three = _attention(q, k, v, causal, _mm_3xtf32)
    np.testing.assert_allclose(three, want, rtol=2e-5, atol=2e-5)
    one = _attention(q, k, v, causal, _mm_1xtf32)
    assert np.abs(one - want).max() > 2e-5


def test_tf32_split_is_exact_where_it_must_be():
    x = np.random.RandomState(3).randn(10000).astype(np.float32) * 100
    hi, lo = _split(x)
    # both halves are TF32 values (13 low mantissa bits clear) ...
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    # ... hi + lo recovers x to about 21 bits, and hi alone only to 10
    assert np.abs((hi.astype(np.float64) + lo - x) / x).max() < 2.0 ** -20
    assert np.abs((hi.astype(np.float64) - x) / x).max() > 2.0 ** -12


def test_aligned_path_follows_pointers_and_strides():
    """The wrapper's choice between the kernel's two load paths, from the
    views' base addresses, strides and D (CPU tensors suffice: no launch)."""
    x = torch.zeros((2, 65, 3, 64))
    assert port.aligned_path(x, x, x)
    flat = torch.zeros(2 * 65 * 3 * 64 + 1)
    shifted = flat[1:].view(2, 65, 3, 64)  # 4 bytes off 16-byte alignment
    assert not port.aligned_path(shifted, x, x)
    odd = torch.zeros((2, 100, 3, 33))  # float32 needs D % 4 == 0
    assert not port.aligned_path(odd, odd, odd)
    qkv = torch.zeros((8, 35, 3 * 256))  # the transformer's strided views
    views = [y.reshape(8, 35, 4, 64) for y in qkv.split(256, dim=-1)]
    assert port.aligned_path(*views)
    assert port.aligned_path(*(y.to(torch.bfloat16) for y in views))
    # bfloat16 (TMA): strides must be multiples of 8 elements; a length-1
    # dimension's stride does not matter
    b40 = torch.zeros((2, 100, 3, 40), dtype=torch.bfloat16)
    assert port.aligned_path(b40, b40, b40)
    b36 = torch.zeros((2, 100, 3, 36), dtype=torch.bfloat16)
    assert not port.aligned_path(b36, b36, b36)
    one = torch.zeros((1, 1, 1, 36), dtype=torch.bfloat16)
    assert port.aligned_path(one, one, one)
    # a broadcast (zero-stride) view: cp.async reads it, TMA does not
    wide = torch.zeros((1, 100, 1, 64)).expand(2, 100, 3, 64)
    assert port.aligned_path(wide, wide, wide)
    wide16 = torch.zeros((1, 100, 1, 64), dtype=torch.bfloat16).expand(2, 100, 3, 64)
    assert not port.aligned_path(wide16, wide16, wide16)


def test_chip_smoke_bound_uses_the_3xtf32_rate():
    """chip_smoke.attention_bound states the float32 peak as a third of the
    495 TFLOP/s TF32 rate (3xTF32), and the bf16 peak as 989 TFLOP/s."""
    sys.path.insert(0, _ROOT)
    import chip_smoke

    assert chip_smoke.PEAK_FLOPS[torch.float32] == pytest.approx(165e12)
    assert chip_smoke.PEAK_FLOPS[torch.bfloat16] == pytest.approx(989e12)
    ms, by = chip_smoke.attention_bound((1, 4096, 4, 64), True, torch.float32)
    flops = 4 * 64 * (4096 * 4097 // 2) * 4
    assert by == "operations"
    assert ms == pytest.approx(flops / 165e12 * 1e3)
    ms, by = chip_smoke.attention_bound((8, 35, 4, 64), True, torch.float32)
    assert by == "bytes" and ms == pytest.approx(4 * 8 * 35 * 4 * 64 * 4 / 3.35e12 * 1e3)
