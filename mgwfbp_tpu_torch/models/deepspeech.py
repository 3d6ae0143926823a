"""DeepSpeech-style CTC acoustic model, the reference's ``lstman4``
(counterpart of ``mgwfbp_tpu/models/deepspeech.py``).

A spectrogram (B, T, 161) goes through ``MaskConv`` (two conv + batch norm
+ hardtanh(0, 20) stages over (time, freq), each followed by a mask that
zeroes the padded time steps), the (freq, channel) features flattened in
the JAX package's NHWC order (``f * 32 + c``), ``num_layers`` x
``BatchRNN`` (sequence-wise batch norm, except in the first, then an LSTM;
bidirectional sums a forward and a reverse LSTM), ``Lookahead`` for the
unidirectional default, a sequence-wise batch norm and a bias-free dense
classifier. It returns (logits (B, T', classes), output lengths (B,)).

Where Flax and PyTorch differ:
  * the convs are NCHW on (B, 1, T, F): stage 1 kernel (11, 41), stride
    (2, 2), padding (5, 20); stage 2 kernel (11, 21), stride (1, 2),
    padding (5, 10); freq 161 -> 81 -> 41, time T -> (T - 1) // 2 + 1;
  * every batch norm's statistics include the padded frames, as the JAX
    model's do (no packed sequences);
  * the forward LSTM runs over all T steps: Flax's ``nn.RNN`` uses
    ``seq_lengths`` only to place a reverse scan. The reverse LSTM takes
    the sequence through Flax's ``flip_sequences`` (``idx[t] = (T - 1 - t +
    len) % T``) before the scan and its outputs through it again;
  * the LSTM cells are ``OptimizedLSTMCell``s named as Flax's ``nn.RNN``
    adopts them: ``rnn_<i>/OptimizedLSTMCell_0`` (``_1`` for the reverse
    direction); every batch norm's momentum is 0.9.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mgwfbp_tpu_torch.models.common import BatchNorm, SameConv2d
from mgwfbp_tpu_torch.models.lstm import OptimizedLSTMCell

BN_MOMENTUM = 0.9
CONV_CHANNELS = 32
# (kernel (time, freq), stride (time, freq)) of MaskConv's two stages; the
# padding is half of each kernel
CONV_STAGES = (((11, 41), (2, 2)), ((11, 21), (1, 2)))
LOOKAHEAD_CONTEXT = 20
_TRUNC_STD = 0.87962566103423978  # std of a standard normal cut to [-2, 2]


def conv_out_length(lengths: torch.Tensor, kernel: int, stride: int,
                    pad: int) -> torch.Tensor:
    """Output time length of a conv with explicit padding."""
    return torch.div(lengths + 2 * pad - kernel, stride,
                     rounding_mode="floor") + 1


def output_lengths(lengths: torch.Tensor) -> torch.Tensor:
    """Time lengths after MaskConv."""
    for (kt, _), (st, _) in CONV_STAGES:
        lengths = conv_out_length(lengths, kt, st, kt // 2)
    return lengths


def feature_size(num_freq: int) -> int:
    """The RNN's input width: freq after the stages x channels."""
    for (_, kf), (_, sf) in CONV_STAGES:
        num_freq = (num_freq + 2 * (kf // 2) - kf) // sf + 1
    return num_freq * CONV_CHANNELS


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) -> (B, max_len) validity mask, float32."""
    steps = torch.arange(max_len, device=lengths.device)
    return (steps[None, :] < lengths[:, None]).float()


def flip_sequences(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Flax's ``flip_sequences`` on (B, T, H): each sequence's first
    ``len`` steps reversed in place, its padding after them."""
    b, t = x.shape[:2]
    steps = torch.arange(t - 1, -1, -1, device=x.device)
    idx = (steps[None, :] + lengths.to(x.device)[:, None]) % t
    return x.gather(1, idx[:, :, None].expand(b, t, x.shape[2]))


class MaskConv(nn.Module):
    """Two conv (no bias) + batch norm + hardtanh(0, 20) stages, each
    followed by zeroing the padded time steps at its output lengths."""

    FLAX_NAMES = {"conv0": "Conv_0", "bn0": "BatchNorm_0",
                  "conv1": "Conv_1", "bn1": "BatchNorm_1"}

    def __init__(self):
        super().__init__()
        cin = 1
        for i, (kernel, stride) in enumerate(CONV_STAGES):
            pads = tuple((k // 2, k // 2) for k in kernel)
            setattr(self, f"conv{i}", SameConv2d(
                cin, CONV_CHANNELS, kernel, stride, padding=pads,
                kernel_init="lecun",
            ))
            setattr(self, f"bn{i}", BatchNorm(CONV_CHANNELS, BN_MOMENTUM))
            cin = CONV_CHANNELS

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        """x (B, 1, T, F), lengths (B,) -> (B, 32, T', F'), lengths (B,)."""
        for i, (kernel, stride) in enumerate(CONV_STAGES):
            x = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x))
            x = torch.clamp(x, 0.0, 20.0)
            lengths = conv_out_length(lengths, kernel[0], stride[0],
                                      kernel[0] // 2)
            x = x * length_mask(lengths, x.shape[2]).to(x.dtype)[:, None, :, None]
        return x, lengths


def sequence_batch_norm(bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """Batch norm over every (B * T) row of (B, T, H), padding included."""
    b, t, h = x.shape
    return bn(x.reshape(b * t, h)).reshape(b, t, h)


class BatchRNN(nn.Module):
    """Sequence-wise batch norm (optional) + an LSTM; bidirectional sums a
    forward and a reverse LSTM."""

    FLAX_NAMES = {"bn": "BatchNorm_0", "fwd": "OptimizedLSTMCell_0",
                  "bwd": "OptimizedLSTMCell_1"}

    def __init__(self, in_features: int, hidden_size: int,
                 batch_norm: bool = True, bidirectional: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        self.bn = BatchNorm(in_features, BN_MOMENTUM) if batch_norm else None
        self.fwd = OptimizedLSTMCell(in_features, hidden_size)
        self.bwd = (OptimizedLSTMCell(in_features, hidden_size)
                    if bidirectional else None)

    def _scan(self, cell: OptimizedLSTMCell, x: torch.Tensor) -> torch.Tensor:
        zero = x.new_zeros((x.shape[0], self.hidden_size))
        return cell(x, (zero, zero))[0]

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        if self.bn is not None:
            x = sequence_batch_norm(self.bn, x)
        y = self._scan(self.fwd, x)
        if self.bwd is not None:
            rev = self._scan(self.bwd, flip_sequences(x, lengths))
            y = y + flip_sequences(rev, lengths)
        return y


class Lookahead(nn.Module):
    """Right-context convolution of the unidirectional model:
    ``relu(sum_c weight[c, h] * x[t + c, h])`` over a zero pad of
    ``context`` frames after the sequence; weight (context + 1, H)."""

    def __init__(self, hidden_size: int, context: int = LOOKAHEAD_CONTEXT):
        super().__init__()
        self.context = context
        self.weight = nn.Parameter(torch.empty(context + 1, hidden_size))

    @torch.no_grad()
    def init_flax_(self, generator: Optional[torch.Generator] = None) -> None:
        """Flax's lecun_normal of a (context + 1, H) kernel (fan-in is
        context + 1)."""
        std = math.sqrt(1.0 / self.weight.shape[0]) / _TRUNC_STD
        nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.shape[2]
        xc = F.pad(x.transpose(1, 2), (0, self.context))  # (B, H, T + c)
        w = self.weight.t().unsqueeze(1)  # (H, 1, c + 1), depthwise
        return F.relu(F.conv1d(xc, w, groups=h)).transpose(1, 2)


class DeepSpeech(nn.Module):
    """MaskConv + ``num_layers`` x BatchRNN (+ Lookahead when
    unidirectional) + sequence-wise batch norm + bias-free classifier.
    Defaults: the reference's an4 model, LSTM hidden 800, 5 layers,
    unidirectional with Lookahead (27,553,504 parameters)."""

    FLAX_NAMES = {"mask_conv": "MaskConv_0", "lookahead": "Lookahead_0",
                  "bn": "BatchNorm_0", "fc": "Dense_0"}

    def __init__(self, num_classes: int = 29, hidden_size: int = 800,
                 num_layers: int = 5, bidirectional: bool = False,
                 num_freq: int = 161):
        super().__init__()
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        self.mask_conv = MaskConv()
        width = feature_size(num_freq)
        for i in range(num_layers):
            setattr(self, f"rnn_{i}", BatchRNN(
                width, hidden_size, batch_norm=i != 0,
                bidirectional=bidirectional,
            ))
            width = hidden_size
        self.lookahead = None if bidirectional else Lookahead(hidden_size)
        self.bn = BatchNorm(hidden_size, BN_MOMENTUM)
        self.fc = nn.Linear(hidden_size, num_classes, bias=False)

    def forward(self, spect: torch.Tensor,
                lengths: Optional[torch.Tensor] = None):
        """spect (B, T, F), lengths (B,) valid frames (default T) ->
        (logits (B, T', classes), output lengths (B,))."""
        b, t, _ = spect.shape
        if lengths is None:
            lengths = torch.full((b,), t, dtype=torch.int64)
        lengths = lengths.to(spect.device)
        x, lengths = self.mask_conv(spect[:, None], lengths)
        # (B, C, T', F') -> (B, T', F' * C), NHWC order
        x = x.permute(0, 2, 3, 1).reshape(b, x.shape[2], -1)
        for i in range(self.num_layers):
            x = getattr(self, f"rnn_{i}")(x, lengths)
        if self.lookahead is not None:
            x = self.lookahead(x)
        x = sequence_batch_norm(self.bn, x)
        return self.fc(x), lengths
