"""Ring attention: sequence parallelism over a ring of processes
(counterpart of ``mgwfbp_tpu/parallel/ringattn.py``).

The sequence dimension is sharded over the ranks of a ``seq`` process group
(``parallel.mesh.seq_groups``): each rank holds one contiguous block of Q,
K and V, (B, T_local, H, D). Q stays in place; K and V, lifted to float32
and stacked into one tensor, rotate around the ring S-1 times (the rotation
comes first, so the last block is never sent), and each resident block's
partial attention is merged by the online softmax (m, l, acc) in float32.
Causal masking is by global position: rank s's queries occupy positions
[s * T_local, (s + 1) * T_local), and after i rotations its resident block
came from ring position (s - i) mod S. Every block is computed, the fully
masked blocks of a causal ring included (the JAX package computes them
too, and skipping them would make the ranks' graphs differ).

The rotation is one ``torch.autograd.Function``, ``_RingShift``: its
forward sends to ring position (s + 1) mod S and receives from (s - 1) mod
S with ``dist.batch_isend_irecv`` on the seq group (peers named by their
global ranks); its backward is the reverse shift, which routes dK and dV
back to the ranks they came from through autograd (what JAX gets by
transposing ``ppermute``). Over NCCL device tensors move directly; over a
gloo group, whose point-to-point operations take host tensors, a tensor on
the card is staged through a host copy each way (``dist.get_backend``
decides, not an exception). ``p2p_ops`` counts the operations launched
(one send and one receive per rotation, forward or backward).

``local_attention`` is the single-device semantics (the full sequence
resident): the transformer's dense path, the fallback for shapes outside
the flash kernel's contract, and the ring's reference in the tests.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

_NEG_INF = -1e30  # finite mask value: keeps exp()-arithmetic NaN-free

# point-to-point operations launched by ``_RingShift`` in this process
p2p_ops = 0


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


def staged(group: dist.ProcessGroup, t: torch.Tensor) -> bool:
    """True where the ring's point-to-point moves ``t`` through a host copy:
    a tensor on the card over a gloo group."""
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


def _shift(group: dist.ProcessGroup, t: torch.Tensor,
           direction: int) -> torch.Tensor:
    """``t`` sent ``direction`` places along the ring, and the tensor that
    arrives from ``-direction`` places (the same shape and type)."""
    global p2p_ops
    ranks = dist.get_process_group_ranks(group)
    size, me = len(ranks), dist.get_rank(group)
    dst = ranks[(me + direction) % size]
    src = ranks[(me - direction) % size]
    host = staged(group, t)
    send = t.detach().to("cpu") if host else t.detach().contiguous()
    recv = torch.empty_like(send)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, dst, group),
        dist.P2POp(dist.irecv, recv, src, group),
    ])
    p2p_ops += 2
    for w in works:
        w.wait()
    return recv.to(t.device) if host else recv


class _RingShift(torch.autograd.Function):
    """One rotation of the ring: forward to the next rank, the gradient
    back to the previous one."""

    @staticmethod
    def forward(ctx, kv: torch.Tensor, group: dist.ProcessGroup):
        ctx.group = group
        return _shift(group, kv, +1)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _shift(ctx.group, grad.contiguous(), -1), None


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group: dist.ProcessGroup,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Ring self-attention over a sequence-sharded (B, T_local, H, D)
    shard; T_global = T_local * S over the S ranks of ``group``, this
    rank's block at ring position ``dist.get_rank(group)``. Returns the
    attention output shard (B, T_local, H, D) in q's type."""
    p_size, my = dist.get_world_size(group), dist.get_rank(group)
    t_local = q.shape[1]
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    dev = q.device
    ar = torch.arange(t_local, device=dev)
    q_pos = my * t_local + ar  # global query positions
    # the reference keeps q in its own type and lifts k, v to float32; the
    # einsum then promotes, so the scores are float32 either way
    q32 = q.float()

    def partial_step(i, kv):
        src = (my - i) % p_size  # ring origin of the resident K/V block
        k_pos = src * t_local + ar
        if causal:
            mask = k_pos[None, :] <= q_pos[:, None]
        else:
            mask = torch.ones((t_local, t_local), dtype=torch.bool,
                              device=dev)
        return _block_attention(q32, kv[0], kv[1], mask, scale)

    def merge(acc, m, l, part, m_i, l_i):
        # online-softmax merge of (acc, m, l) with the new partial
        m_new = torch.maximum(m, m_i)
        a_old = torch.exp(m - m_new)
        a_new = torch.exp(m_i - m_new)
        l = l * a_old + l_i * a_new
        acc = (acc * a_old.permute(0, 2, 1)[..., None]
               + part * a_new.permute(0, 2, 1)[..., None])
        return acc, m_new, l

    b, _, h, d = q.shape
    acc = torch.zeros((b, t_local, h, d), dtype=torch.float32, device=dev)
    m = torch.full((b, h, t_local), _NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, h, t_local), dtype=torch.float32, device=dev)
    kv = torch.stack([k.float(), v.float()])
    # step 0: the resident block, no rotation
    acc, m, l = merge(acc, m, l, *partial_step(0, kv))
    for i in range(1, p_size):
        # rotate FIRST (steps 1..S-1): S-1 rotations, the last block's K/V
        # never sent on
        kv = _RingShift.apply(kv, group)
        acc, m, l = merge(acc, m, l, *partial_step(i, kv))
    l_q = l.permute(0, 2, 1)[..., None]  # (B, Tq, H, 1)
    return (acc / torch.clamp_min(l_q, 1e-30)).to(q.dtype)


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
