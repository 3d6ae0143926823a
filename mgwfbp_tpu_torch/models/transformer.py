"""Decoder-only transformer LM (counterpart of
``mgwfbp_tpu/models/transformer.py``).

Architecture: Pre-LN blocks (LN -> causal MHA -> residual, LN -> GELU MLP ->
residual), learned position embeddings, final LN + untied output head.
Submodule names follow the Flax module's (``Block_i`` becomes
``blocks.i``), so ``convert`` maps parameters leaf by leaf.

Flax defaults are kept where they differ from torch's: LayerNorm epsilon
1e-6 and the tanh-approximated GELU. Sequence parallelism (``seq_axis``,
ring attention) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mgwfbp_tpu_torch.ops.flashattn import flash_attention, flash_supported
from mgwfbp_tpu_torch.parallel.ringattn import local_attention

_LN_EPS = 1e-6  # flax.linen.LayerNorm default


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
        if self.attn_impl == "flash" and flash_supported(t, dh):
            a = flash_attention(q, k, v, causal=True)
        else:
            # shapes outside the kernel's block contract fall back to dense
            a = local_attention(q, k, v, causal=True)
        h = h + self.drop(self.proj(a.reshape(b, t, d)))
        m = F.gelu(self.up(self.ln_mlp(h)), approximate="tanh")
        return h + self.drop(self.down(m))


class TransformerLM(nn.Module):
    """Causal LM over integer tokens. Input (B, T); returns logits
    (B, T, vocab). task='lm' WITHOUT carry (windowed, not BPTT)."""

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(x.shape[1], device=x.device)
        h = self.tok_embed(x) + self.pos_embed(pos)
        for block in self.blocks:
            h = block(h)
        return self.head(self.ln_out(h))


@torch.no_grad()
def init_weights(module: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Flax-style initialization from a seeded generator: dense kernels
    LeCun-normal (std 1/sqrt(fan_in)), biases zero, embeddings normal with
    std 1/sqrt(d), LayerNorm scale one and bias zero."""
    for sub in module.modules():
        if isinstance(sub, nn.Linear):
            sub.weight.normal_(0.0, sub.in_features ** -0.5, generator=generator)
            sub.bias.zero_()
        elif isinstance(sub, nn.Embedding):
            sub.weight.normal_(0.0, sub.embedding_dim ** -0.5, generator=generator)
        elif isinstance(sub, nn.LayerNorm):
            sub.weight.fill_(1.0)
            sub.bias.zero_()
    return module
