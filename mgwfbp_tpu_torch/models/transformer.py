"""Decoder-only transformer LM (counterpart of
``mgwfbp_tpu/models/transformer.py``).

Architecture: Pre-LN blocks (LN -> causal MHA -> residual, LN -> GELU MLP ->
residual), learned position embeddings, final LN + untied output head.
Submodule names follow the Flax module's (``Block_i`` becomes
``blocks.i``), so ``convert`` maps parameters leaf by leaf.

Flax defaults are kept where they differ from torch's: LayerNorm epsilon
1e-6 and the tanh-approximated GELU.

Sequence parallelism: with a ``seq_group`` (a ring of ``parallel.mesh.
seq_groups``; the counterpart of Flax's ``model.clone(seq_axis=...)``) the
input is this rank's time slice (B, T_local), every block attends through
``ring_attention`` whatever ``attn_impl`` says, all other ops are
token-local, and positions start at ``dist.get_rank(seq_group) * T_local``,
so the embeddings see global positions. The parameters are the same, so
``convert`` maps them leaf by leaf either way.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from mgwfbp_tpu_torch.models.common import init_weights  # noqa: F401
from mgwfbp_tpu_torch.ops.flashattn import flash_attention, flash_supported
from mgwfbp_tpu_torch.parallel.ringattn import local_attention, ring_attention

_LN_EPS = 1e-6  # flax.linen.LayerNorm default


def take_fill(embed: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
    """``embed(ids)`` with the semantics of ``flax.linen.Embed``, which is
    ``jnp.take(table, ids, axis=0)`` in mode "fill": ids in [-V, -1] wrap
    to ``id + V``, ids outside [-V, V) give rows of NaN. The index is
    clamped before the gather, so an id outside the table never reaches
    the card's gather as an out-of-bounds index."""
    v = embed.num_embeddings
    ids = torch.where(ids < 0, ids + v, ids)
    valid = (ids >= 0) & (ids < v)
    rows = embed(ids.clamp(0, v - 1))
    return rows.masked_fill(~valid.unsqueeze(-1), float("nan"))


class Block(nn.Module):
    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 dropout: float, attn_impl: str = "dense"):
        super().__init__()
        if attn_impl not in ("dense", "flash"):
            raise ValueError(f"attn_impl must be dense or flash, got {attn_impl!r}")
        self.d_model = d_model
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.ln_attn = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.qkv = nn.Linear(d_model, 3 * d_model)
        self.proj = nn.Linear(d_model, d_model)
        self.ln_mlp = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.up = nn.Linear(d_model, d_ff)
        self.down = nn.Linear(d_ff, d_model)
        self.drop = nn.Dropout(dropout)
        self.seq_group: Optional[dist.ProcessGroup] = None

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        b, t, d = h.shape
        dh = self.d_model // self.num_heads
        qkv = self.qkv(self.ln_attn(h))
        # [q | k | v] along the last axis, each reshaped (B, T, H, dh):
        # strided views of qkv, which the flash kernel reads in place
        q, k, v = (
            x.reshape(b, t, self.num_heads, dh)
            for x in qkv.split(self.d_model, dim=-1)
        )
        if self.seq_group is not None:
            a = ring_attention(q, k, v, self.seq_group, causal=True)
        elif self.attn_impl == "flash" and flash_supported(t, dh):
            a = flash_attention(q, k, v, causal=True)
        else:
            # shapes outside the kernel's block contract fall back to dense
            a = local_attention(q, k, v, causal=True)
        h = h + self.drop(self.proj(a.reshape(b, t, d)))
        m = F.gelu(self.up(self.ln_mlp(h)), approximate="tanh")
        return h + self.drop(self.down(m))


class TransformerLM(nn.Module):
    """Causal LM over integer tokens. Input (B, T_local); returns logits
    (B, T_local, vocab). task='lm' WITHOUT carry (windowed, not BPTT)."""

    def __init__(
        self,
        vocab_size: int,
        d_model: int = 256,
        num_heads: int = 4,
        num_layers: int = 4,
        d_ff: int = 1024,
        max_len: int = 4096,
        dropout: float = 0.1,
        attn_impl: str = "dense",  # dense | flash (csrc/flash_attn_fwd.cu)
        seq_group: Optional[dist.ProcessGroup] = None,
    ):
        super().__init__()
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.d_ff = d_ff
        self.max_len = max_len
        self.dropout = dropout
        self.attn_impl = attn_impl
        self.tok_embed = nn.Embedding(vocab_size, d_model)
        self.pos_embed = nn.Embedding(max_len, d_model)
        self.blocks = nn.ModuleList(
            Block(d_model, num_heads, d_ff, dropout, attn_impl)
            for _ in range(num_layers)
        )
        self.ln_out = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.head = nn.Linear(d_model, vocab_size)
        self.seq_group: Optional[dist.ProcessGroup] = None
        self.set_seq_group(seq_group)

    def with_max_len(self, max_len: int) -> "TransformerLM":
        """A fresh model like this one with a position table of
        ``max_len`` rows (and this one's attention and seq group)."""
        return TransformerLM(
            self.vocab_size, self.d_model, self.num_heads, self.num_layers,
            self.d_ff, max_len, self.dropout, self.attn_impl, self.seq_group,
        )

    def set_attn_impl(self, attn_impl: str) -> None:
        """Switch every block between dense and flash attention."""
        if attn_impl not in ("dense", "flash"):
            raise ValueError(f"attn_impl must be dense or flash, got {attn_impl!r}")
        for block in self.blocks:
            block.attn_impl = attn_impl
        self.attn_impl = attn_impl

    def set_seq_group(self, group: Optional[dist.ProcessGroup]) -> None:
        """Shard the time dimension over the ring ``group`` (None: the
        whole sequence resident, dense or flash attention)."""
        for block in self.blocks:
            block.seq_group = group
        self.seq_group = group

    @contextlib.contextmanager
    def seq_free(self):
        """The model without its seq group for the block: positions from 0
        and no ring traffic (the trainer's profiles time the T/S slice so,
        as the JAX trainer times its axis-free model)."""
        group = self.seq_group
        self.set_seq_group(None)
        try:
            yield self
        finally:
            self.set_seq_group(group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(x.shape[1], device=x.device)
        if self.seq_group is not None:
            # global positions: offset by this shard's place on the ring
            pos = pos + dist.get_rank(self.seq_group) * x.shape[1]
        h = take_fill(self.tok_embed, x) + self.pos_embed(pos)
        for block in self.blocks:
            h = block(h)
        return self.head(self.ln_out(h))
