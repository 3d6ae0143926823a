"""Flash attention: a hand-written CUDA kernel for Hopper and its plain
PyTorch version.

Counterpart of ``mgwfbp_tpu/ops/flashattn.py`` (the Pallas TPU kernel).
``flash_attention`` keeps the JAX function's contract: (B, T, H, D) in and
out, ``scale`` defaulting to ``1/sqrt(D)``, float32 compute for any input
type, and a ``ValueError`` for the shapes the TPU kernel refuses
(``flash_supported``), so the transformer's flash -> dense fallback takes
the same branch in both packages.

Dispatch is by the tensors' device, never by a fallback: a CUDA tensor
launches ``csrc/flash_attn_fwd.cu`` (built with nvcc on first use, see
``_build``) or raises; a CPU tensor runs ``flash_attention_reference``, the
same block-by-block online-softmax recurrence written in PyTorch, which is
also what ``chip_smoke.py`` holds the kernel against on the card.
``flash_attention.launches`` counts kernel launches.

The kernel computes both products on the tensor cores: 3xTF32 ``mma.sync``
for float32, ``wgmma`` fed by TMA for bfloat16 (the source's header says
why). Each type has an aligned load path (16-byte ``cp.async``; TMA) and a
misaligned one inside the same kernel; ``aligned_path`` chooses from the
pointers and strides, and both count as launches. The kernel tiles the
sequence its own way (64-row query tiles, ragged edges masked) and ignores
``block_q``/``block_k`` beyond the shape check; the online softmax is exact
up to rounding whatever the tiling.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

_NEG_INF = -1e30

_KERNEL = "flash_attn_fwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_bound = None  # (C entry point, error-string function), set on first launch


def flash_supported(t: int, d: int, block_q: int = 128, block_k: int = 128) -> bool:
    """Shapes the kernel handles: sequence divisible into whole blocks and
    a head dim that fits a lane tile (the TPU kernel's contract)."""
    bq = min(block_q, t)
    bk = min(block_k, t)
    return t % bq == 0 and t % bk == 0 and d <= 256


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           block_q: int, block_k: int) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "flash_attention: q, k, v must share one (B, T, H, D) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    _, t, _, d = q.shape
    if not flash_supported(t, d, block_q, block_k):
        raise ValueError(
            f"flash_attention: unsupported shape T={t}, D={d} for blocks "
            f"({block_q}, {block_k})"
        )


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """The plain PyTorch version: the TPU kernel's grid written as loops.
    For each (batch*head, q-block) it sweeps the K blocks with running
    (m, l, acc) in float32, skipping K blocks strictly above the diagonal
    when causal, and returns ``acc / max(l, 1e-30)`` in the input type."""
    _check(q, k, v, block_q, block_k)
    b, t, h, d = q.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    bq = min(block_q, t)
    bk = min(block_k, t)

    def to_bhtd(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, t, d).float()

    qf = to_bhtd(q) * scale
    kf = to_bhtd(k)
    vf = to_bhtd(v)
    out = torch.empty((b * h, t, d), dtype=torch.float32, device=q.device)
    for qi in range(t // bq):
        q_blk = qf[:, qi * bq:(qi + 1) * bq]
        acc = torch.zeros((b * h, bq, d), dtype=torch.float32, device=q.device)
        m = torch.full((b * h, bq, 1), _NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b * h, bq, 1), dtype=torch.float32, device=q.device)
        for j in range(t // bk):
            if causal and j * bk > qi * bq + bq - 1:
                continue  # a K block strictly above the diagonal
            k_blk = kf[:, j * bk:(j + 1) * bk]
            v_blk = vf[:, j * bk:(j + 1) * bk]
            s = torch.matmul(q_blk, k_blk.transpose(1, 2))  # (bh, bq, bk)
            if causal:
                q_pos = qi * bq + torch.arange(bq, device=q.device)[:, None]
                k_pos = j * bk + torch.arange(bk, device=q.device)[None, :]
                mask = k_pos <= q_pos
                s = torch.where(mask, s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            if causal:
                p = torch.where(mask, p, 0.0)
            a_old = torch.exp(m - m_new)
            l = l * a_old + p.sum(dim=-1, keepdim=True)
            acc = acc * a_old + torch.matmul(p, v_blk)
            m = m_new
        out[:, qi * bq:(qi + 1) * bq] = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(b, h, t, d).permute(0, 2, 1, 3).to(q.dtype)


def _bind():
    global _bound
    if _bound is None:
        from mgwfbp_tpu_torch.ops import _build

        lib = _build.load(_KERNEL)
        fn = lib.mgwfbp_flash_attn_fwd
        fn.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 9
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        err_str = lib.mgwfbp_cuda_error_string
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _bound = (fn, err_str)
    return _bound


def _aligned(code: int, shape, ptrs, strides) -> bool:
    """Whether the kernel may take its aligned load path: every base
    address 16-byte aligned and every batch, time and head stride (of a
    dimension longer than 1) a multiple of 16 bytes; float32 also needs
    D % 4 == 0 (16-byte ``cp.async`` of whole column groups). bfloat16's
    aligned path is TMA, which needs exactly the 16-byte rule and refuses
    a zero stride (a broadcast view)."""
    if (ptrs[0] | ptrs[1] | ptrs[2]) & 15:
        return False
    if code == 0 and shape[3] & 3:
        return False
    bits = 0
    for i in range(3):
        if shape[i] > 1:
            st = strides[0][i], strides[1][i], strides[2][i]
            if code == 1 and 0 in st:
                return False
            bits |= st[0] | st[1] | st[2]
    return not bits & (3 if code == 0 else 7)


def aligned_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether ``flash_attention`` launches these views on the kernel's
    aligned load path (``_aligned``) rather than its misaligned one."""
    return _aligned(
        _DTYPE_CODES.get(q.dtype, 1), q.shape,
        (q.data_ptr(), k.data_ptr(), v.data_ptr()),
        (q.stride(), k.stride(), v.stride()),
    )


def _launch(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    dev = q.device
    for name, x in (("k", k), ("v", v)):
        if x.device != dev or x.dtype != q.dtype:
            raise ValueError(
                f"flash_attention: {name} is {x.dtype} on {x.device}, q is "
                f"{q.dtype} on {dev}"
            )
    code = _DTYPE_CODES.get(q.dtype)
    if code is None:
        raise TypeError(
            f"flash_attention: the CUDA kernel takes float32 or bfloat16, "
            f"got {q.dtype}"
        )
    strides = sq, sk, sv = q.stride(), k.stride(), v.stride()
    if sq[3] != 1 or sk[3] != 1 or sv[3] != 1:
        raise ValueError(
            "flash_attention: q, k, v must have a unit stride along D, got "
            f"strides {sq}, {sk}, {sv}"
        )
    shape = b, t, h, d = q.shape
    ptrs = q.data_ptr(), k.data_ptr(), v.data_ptr()
    fn, err_str = _bound or _bind()
    o = torch.empty(shape, dtype=q.dtype, device=dev)
    args = (
        *ptrs, o.data_ptr(), code, b, t, h, d,
        sq[0], sq[1], sq[2], sk[0], sk[1], sk[2], sv[0], sv[1], sv[2],
        float(scale), int(bool(causal)), int(_aligned(code, shape, ptrs, strides)),
    )
    # the raw handle of the current stream: torch.cuda.current_stream()
    # builds a Stream object per call, which costs more than the launch
    if dev.index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err} "
            f"({err_str(err).decode()}) for shape {(b, t, h, d)} "
            f"{q.dtype}"
        )
    flash_attention.launches += 1
    return o


def _dispatch(q, k, v, causal, scale, block_q, block_k) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, causal=causal, scale=scale, block_q=block_q,
            block_k=block_k,
        )
    _check(q, k, v, block_q, block_k)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, causal, scale)


class _FlashAttention(torch.autograd.Function):
    """The forward on either device; a backward that refuses, as
    ``jax.grad`` through the JAX package's Pallas kernel does (it has no
    reverse-mode rule). Without this the card's output would carry no
    graph and a backward would silently drop dL/dq, dL/dk and dL/dv."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q, block_k):
        return _dispatch(q, k, v, causal, scale, block_q, block_k)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "flash_attention has no backward kernel yet (ROADMAP.md Queue 2, "
            "the flash-attention backward); train through dense attention "
            "(attn_impl='dense')"
        )


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Blockwise-softmax attention over (B, T, H, D) tensors.

    Drop-in equivalent of ``ringattn.local_attention`` for the forward;
    raises ValueError for unsupported shapes (callers guard with
    ``flash_supported``). A CUDA tensor runs the hand-written kernel (or
    raises); a CPU tensor runs ``flash_attention_reference``. A backward
    through the result raises NotImplementedError on both devices."""
    return _FlashAttention.apply(q, k, v, causal, scale, block_q, block_k)


flash_attention.launches = 0
