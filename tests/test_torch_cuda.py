"""The port's CUDA kernels on the card (marker ``cuda``; skipped without one).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch: from the root of a checkout,

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py sets JAX up). Tolerances are
tests/test_flashattn.py's: float32 2e-5 (3xTF32 keeps float32 accuracy),
bfloat16 2e-2 (inputs and output in bfloat16; P is rounded to bfloat16 for
the second product, about 2^-9 relative).
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


F32, BF16 = torch.float32, torch.bfloat16
TOL = {F32: 2e-5, BF16: 2e-2}


def _qkv(shape, dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(device, dtype) for _ in range(3)]


@pytest.mark.parametrize("shape,causal,dtype,tol", [
    ((8, 35, 4, 64), True, F32, 2e-5),     # the serving shape
    ((2, 100, 3, 40), False, F32, 2e-5),   # D not a power of two
    ((1, 256, 2, 256), False, F32, 2e-5),  # the largest D
    ((1, 128, 2, 64), True, BF16, 2e-2),
    ((8, 35, 4, 64), True, BF16, 2e-2),
    ((2, 100, 3, 40), True, BF16, 2e-2),
    ((2, 256, 4, 256), True, BF16, 2e-2),
    ((2, 256, 4, 256), False, BF16, 2e-2),
    ((2, 256, 4, 256), True, F32, 2e-5),
    ((2, 100, 3, 33), True, F32, 2e-5),    # misaligned: odd D
    ((2, 100, 3, 33), False, BF16, 2e-2),
    ((3, 1, 2, 64), True, F32, 2e-5),      # T = 1
    ((3, 1, 2, 64), False, BF16, 2e-2),
    ((2, 65, 2, 64), True, F32, 2e-5),     # one row past a tile
    ((2, 65, 2, 64), True, BF16, 2e-2),
    ((2, 65, 2, 64), False, F32, 2e-5),
    ((1, 4096, 2, 64), True, F32, 2e-5),   # the model's max_len
    ((1, 4096, 2, 64), True, BF16, 2e-2),
    ((64, 35, 4, 64), True, F32, 2e-5),    # B * H = 256
    ((64, 35, 4, 64), True, BF16, 2e-2),
])
def test_kernel_matches_plain(card, shape, causal, dtype, tol):
    q, k, v = _qkv(shape, dtype, card)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == shape
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_kernel_reads_strided_qkv_views(card, dtype):
    """The transformer hands the kernel views of its fused qkv product
    (B, T, H, D) with a row stride of 3 * H * D; the kernel reads them in
    place and gives the contiguous inputs' result bit for bit."""
    b, t, h, d = 4, 35, 4, 64
    gen = torch.Generator().manual_seed(1)
    qkv = torch.randn((b, t, 3 * h * d), generator=gen).to(card, dtype)
    q, k, v = (x.reshape(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    assert not q.is_contiguous() and fa.aligned_path(q, k, v)
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention(*(x.contiguous() for x in (q, k, v)))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("causal", [True, False])
def test_both_load_paths_agree_and_count(card, dtype, causal):
    """A view shifted off 16-byte alignment takes the misaligned load path
    of the same kernel; it loads the same values, so the result is the
    aligned path's bit for bit, and each path counts one launch."""
    shape = (2, 65, 3, 64)
    n = 2 * 65 * 3 * 64
    gen = torch.Generator().manual_seed(3)
    flat = [torch.randn(n + 1, generator=gen).to(card, dtype) for _ in range(3)]
    shifted = [x[1:].view(shape) for x in flat]
    aligned = [x.clone() for x in shifted]
    assert not fa.aligned_path(*shifted) and fa.aligned_path(*aligned)
    before = fa.flash_attention.launches
    a = fa.flash_attention(*aligned, causal=causal)
    m = fa.flash_attention(*shifted, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 2
    assert torch.equal(a, m)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_kernel_reads_broadcast_views(card, dtype):
    """k and v shared by every head (zero head stride), as in multi-query
    attention: float32 reads them on its aligned path, bfloat16 on its
    misaligned one (TMA refuses a zero stride)."""
    q, k, v = _qkv((2, 65, 3, 64), dtype, card, seed=4)
    k, v = (x[:, :, :1].expand(2, 65, 3, 64) for x in (k, v))
    assert fa.aligned_path(q, k, v) == (dtype == F32)
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


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


def test_flash_backward_refuses_on_card(card):
    q, k, v = (t.requires_grad_() for t in _qkv((1, 64, 2, 32), F32, card))
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v)
    assert out.requires_grad and fa.flash_attention.launches == before + 1
    with pytest.raises(NotImplementedError, match="backward"):
        out.sum().backward()


def _small_resnet(seed=3):
    from mgwfbp_tpu_torch.models.common import init_weights as cnn_init
    from mgwfbp_tpu_torch.models.resnet_cifar import CifarResNet

    return cnn_init(CifarResNet(depth=8, widths=(4, 8, 16)),
                    torch.Generator().manual_seed(seed))


def test_train_step_on_card_matches_cpu(card):
    """One optimizer step of the small ResNet from the same weights and
    batch on the card and on the CPU (TF32 off): the same float32 math in
    another order, within rtol 1e-4 / atol 1e-5."""
    from mgwfbp_tpu_torch.optim import make_optimizer
    from mgwfbp_tpu_torch.train import TrainStep

    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(1, 8, 3, 16, 16).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 10, (1, 8)))
    states = []
    for dev in (torch.device("cpu"), card):
        model = _small_resnet().to(dev)
        opt, lr_fn, _ = make_optimizer(model.parameters(), 0.1,
                                       lr_schedule="const")
        m = TrainStep(model, opt, lr_fn)(x.to(dev), y.to(dev))
        assert m["grads_nonfinite"] == 0.0
        states.append({k: v.cpu() for k, v in model.state_dict().items()})
    for k in states[0]:
        torch.testing.assert_close(states[1][k], states[0][k], rtol=1e-4,
                                   atol=1e-5, msg=k)


def test_merged_allreduce_over_nccl_at_one_worker(card, tmp_path):
    """At one worker over NCCL every merge group launches once per step and
    the reduced gradients equal the pre-reduction gradients bit for bit."""
    import torch.distributed as dist

    from mgwfbp_tpu_torch.convert import flax_leaves
    from mgwfbp_tpu_torch.parallel.allreduce import make_merged_allreduce
    from mgwfbp_tpu_torch.parallel.costmodel import lookup_alpha_beta
    from mgwfbp_tpu_torch.parallel.mesh import init_distributed
    from mgwfbp_tpu_torch.train import cross_entropy

    init_distributed(card, num_processes=1, process_id=0,
                     init_method=f"file://{tmp_path / 'rdv'}")
    try:
        model = _small_resnet().to(card).train()
        params = [t for _, t in flax_leaves(model)]
        reducer = make_merged_allreduce(
            model, policy="threshold", threshold=600,
            cost_model=lookup_alpha_beta("ici", 1),
        )
        copies = {}
        hooks = [p.register_post_accumulate_grad_hook(
            lambda t, j=j: copies.__setitem__(j, t.grad.clone()))
            for j, p in enumerate(params)]
        rs = np.random.RandomState(5)
        x = torch.from_numpy(rs.randn(8, 3, 16, 16).astype(np.float32)).to(card)
        y = torch.from_numpy(rs.randint(0, 10, 8)).to(card)
        reducer.begin(active=True)
        cross_entropy(model(x), y).backward()
        reducer.synchronize()
        assert 1 < reducer.num_groups < len(params)
        assert reducer.launch_log == list(range(reducer.num_groups))
        assert all(torch.equal(p.grad, copies[j]) for j, p in enumerate(params))
        for h in hooks:
            h.remove()
        reducer.detach()
    finally:
        dist.destroy_process_group()
