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
    """Every module of the port, and chip_smoke.py, import without pulling
    jax, flax or mgwfbp_tpu into the interpreter."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mgwfbp_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "mgwfbp_tpu_torch.__path__, 'mgwfbp_tpu_torch.')]\n"
        "for n in names + ['chip_smoke']:\n"
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

