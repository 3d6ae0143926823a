"""Dense attention: the single-device semantics of ring attention.

Counterpart of ``mgwfbp_tpu/parallel/ringattn.py``. Only ``local_attention``
(the full sequence resident on one device) is ported so far: it is the
transformer's dense path and the fallback for shapes outside the flash
kernel's contract. ``ring_attention`` over a ``seq`` process group is
still to be ported (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30  # finite mask value: keeps exp()-arithmetic NaN-free


def _block_attention(q, k, v, mask, scale):
    """One (Q-block x K-block) attention partial.

    q: (B, Tq, H, D), k/v: (B, Tk, H, D), mask: (Tq, Tk) bool (True = keep).
    Returns (partial_acc (B, Tq, H, D), row_max (B, H, Tq), row_sum)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    s = torch.where(mask[None, None], s, _NEG_INF)
    m = s.amax(dim=-1)  # (B, H, Tq)
    # rows with no visible keys: keep exp at 0, not exp(-inf - -inf)
    p = torch.exp(s - m[..., None])
    p = torch.where(mask[None, None], p, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return acc, m, l


def local_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = True, scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal (or full) softmax attention over (B, T, H, D) tensors,
    computed in float32 and returned in q's type. Any shape, any device."""
    t = q.shape[1]
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    pos = torch.arange(t, device=q.device)
    mask = (
        pos[None, :] <= pos[:, None]
        if causal
        else torch.ones((t, t), dtype=torch.bool, device=q.device)
    )
    # the reference keeps q in its own type and lifts k, v to float32; the
    # einsum then promotes, so the scores are float32 either way
    acc, m, l = _block_attention(q.float(), k.float(), v.float(), mask, scale)
    l_q = l.permute(0, 2, 1)[..., None]  # (B, Tq, H, 1)
    return (acc / torch.clamp_min(l_q, 1e-30)).to(q.dtype)
