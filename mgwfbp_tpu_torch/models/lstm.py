"""PTB word-level language model: a 2-layer LSTM, 1500-d hidden
(counterpart of ``mgwfbp_tpu/models/lstm.py``).

Embedding 10000 -> 1500, dropout, two stacked LSTM layers each followed by
dropout, a linear decoder. The BPTT carry is threaded through the train
step as explicit state and detached between windows (``repackage_carry``).

Parameters. Each of the JAX model's 27 leaves is its own ``nn.Parameter``:
the merged all-reduce hangs one post-accumulate-grad hook on every leaf,
and a hook cannot sit on a view. Per layer, Flax's ``OptimizedLSTMCell``
has the input kernels ``ii``/``if``/``ig``/``io`` (no bias) and the
recurrent kernels ``hi``/``hf``/``hg``/``ho`` with their biases; the port
stores each kernel as (out, in), the layout of ``nn.Linear.weight``
(``convert`` transposes). The gates are Flax's: i, f and o through the
sigmoid and g through tanh, with no forget bias,
``c' = f * c + i * g`` and ``h' = o * tanh(c')``.

Compute. Each forward concatenates a layer's gate kernels into the
(4H, in) layout of torch's fused LSTM, whose gate order (i, f, g, o) is
Flax's, and runs one single-layer ``torch.lstm`` call over the whole window
(cuDNN on the card) instead of a loop over time steps; the concatenation's
backward hands every leaf its own gradient. The carry is a tuple over
layers of ``(c, h)``, Flax's order (torch's LSTM takes ``(h, c)``).
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mgwfbp_tpu_torch.models.transformer import take_fill

Carry = tuple[tuple[torch.Tensor, torch.Tensor], ...]

GATES = ("i", "f", "g", "o")  # Flax's gate names, in torch's gate order
# std of a standard normal truncated to [-2, 2] (Flax's lecun_normal
# divides the target std by it)
_TRUNC_STD = 0.87962566103423978
_COMPACT_WARNING = "RNN module weights are not part of single contiguous chunk"


class OptimizedLSTMCell(nn.Module):
    """One LSTM layer with the leaves of Flax's ``OptimizedLSTMCell`` (the
    class name gives the Flax module path ``OptimizedLSTMCell_<i>``):
    ``i<g>_weight`` (H, in), ``h<g>_weight`` (H, H) and ``h<g>_bias`` (H,)
    for each gate g."""

    def __init__(self, in_features: int, hidden_size: int):
        super().__init__()
        self.in_features = in_features
        self.hidden_size = hidden_size
        for g in GATES:
            self.register_parameter(
                f"i{g}_weight",
                nn.Parameter(torch.empty(hidden_size, in_features)),
            )
            self.register_parameter(
                f"h{g}_weight",
                nn.Parameter(torch.empty(hidden_size, hidden_size)),
            )
            self.register_parameter(
                f"h{g}_bias", nn.Parameter(torch.zeros(hidden_size))
            )

    @torch.no_grad()
    def init_flax_(self, generator: Optional[torch.Generator] = None) -> None:
        """Flax's initializers: input kernels LeCun truncated normal,
        recurrent kernels orthogonal (each gate its own matrix), biases
        zero."""
        std = math.sqrt(1.0 / self.in_features) / _TRUNC_STD
        for g in GATES:
            nn.init.trunc_normal_(getattr(self, f"i{g}_weight"), 0.0, std,
                                  -2 * std, 2 * std, generator=generator)
            nn.init.orthogonal_(getattr(self, f"h{g}_weight"),
                                generator=generator)
            getattr(self, f"h{g}_bias").zero_()

    def forward(
        self, x: torch.Tensor, carry: tuple[torch.Tensor, torch.Tensor]
    ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
        """x (B, T, in), carry (c, h) each (B, H) -> (outputs (B, T, H),
        (c, h) after the last step)."""
        c, h = carry
        w_ih = torch.cat([getattr(self, f"i{g}_weight") for g in GATES])
        w_hh = torch.cat([getattr(self, f"h{g}_weight") for g in GATES])
        b_hh = torch.cat([getattr(self, f"h{g}_bias") for g in GATES])
        with warnings.catch_warnings():
            # cuDNN copies the fresh concatenations into its own buffer
            # and says so on every call; that copy is the design
            warnings.filterwarnings("ignore", message=_COMPACT_WARNING)
            out, h_n, c_n = torch.lstm(
                x, (h.unsqueeze(0), c.unsqueeze(0)),
                (w_ih, w_hh, torch.zeros_like(b_hh), b_hh),
                True, 1, 0.0, self.training, False, True,
            )
        return out, (c_n[0], h_n[0])


class PTBLSTM(nn.Module):
    """Tokens (B, T) and a carry -> (logits (B, T, vocab), new carry)."""

    def __init__(self, vocab_size: int = 10000, hidden_size: int = 1500,
                 num_layers: int = 2, dropout: float = 0.65):
        super().__init__()
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout = dropout
        self.embedding = nn.Embedding(vocab_size, hidden_size)
        self.cells = nn.ModuleList(
            OptimizedLSTMCell(hidden_size, hidden_size)
            for _ in range(num_layers)
        )
        self.decoder = nn.Linear(hidden_size, vocab_size)

    def initial_carry(self, batch_size: int, device=None,
                      dtype: torch.dtype = torch.float32) -> Carry:
        """Zero carry for a fresh epoch, on the model's device unless
        ``device`` names one."""
        if device is None:
            device = self.decoder.weight.device
        shape = (batch_size, self.hidden_size)
        return tuple(
            (torch.zeros(shape, device=device, dtype=dtype),
             torch.zeros(shape, device=device, dtype=dtype))
            for _ in range(self.num_layers)
        )

    def forward(self, tokens: torch.Tensor,
                carry: Optional[Carry] = None) -> tuple[torch.Tensor, Carry]:
        if carry is None:
            carry = self.initial_carry(tokens.shape[0], tokens.device)
        x = F.dropout(take_fill(self.embedding, tokens), self.dropout,
                      self.training)
        new_carry = []
        for cell, layer_carry in zip(self.cells, carry):
            x, c = cell(x, layer_carry)
            new_carry.append(c)
            x = F.dropout(x, self.dropout, self.training)
        return self.decoder(x), tuple(new_carry)


def repackage_carry(carry: Carry) -> Carry:
    """The carry detached from the graph of the window that made it."""
    return tuple((c.detach(), h.detach()) for c, h in carry)
