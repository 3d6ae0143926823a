"""Shared CNN building blocks (counterpart of ``mgwfbp_tpu/models/common.py``).

NCHW ``nn.Module``s that compute what the JAX package's Flax modules
compute, where Flax and PyTorch defaults differ:

  * ``SameConv2d``: Flax ``padding="SAME"`` pads ``(k - 1 + (out - 1) * s
    + k - in)`` in total, the odd pixel AFTER. With stride 2 on an even
    input that is (0, 1), not the (1, 1) of ``nn.Conv2d(padding=1)``,
    which would sample other pixels.
  * ``BatchNorm``: Flax ``momentum=0.9`` is the weight of the OLD running
    statistic (torch's ``momentum=0.1``), epsilon 1e-5, and the running
    variance is updated with the BIASED batch variance (``nn.BatchNorm2d``
    uses the unbiased one, n/(n-1) larger).
  * initializers: He fan-out truncated normal for convs, LeCun truncated
    normal for dense kernels (``init_weights``), from a seeded generator;
  * ``max_pool``: Flax ``padding="SAME"`` pads with -inf by ``same_pads``
    (3x3/2 at 112: (0, 1), not the (1, 1) of ``nn.MaxPool2d(padding=1)``);
    ``avg_pool``'s ``SAME`` pads with zeros and divides by the whole window
    (Flax's ``count_include_pad=True``);
  * ``local_response_norm``: Flax's LRN sums over a channel window padded
    ``(size // 2, size - 1 - size // 2)`` with k = 2 (torch's default k is
    1 and its window is centred differently for even sizes);
  * ``flatten``: the JAX package flattens NHWC activations, so a Dense
    layer after a spatial map reads (h, w, c) order; ``flatten`` permutes
    to NHWC first, and the Dense kernels convert as plain transposes;
  * dropout is ``nn.Dropout`` (torch's global generator, which the trainer
    seeds per rank); Flax's rate and 1 / (1 - rate) scaling are torch's.

Mixed precision (the JAX step's bfloat16 policy): parameters reach a
module cast to the compute dtype while the batch-norm running statistics
stay float32 masters. ``BatchNorm`` then reduces its statistics in
float32 (Flax ``force_float32_reductions``), normalizes in float32 and
returns the compute dtype, and merges its update into the master as a
delta (see ``BatchNorm.forward``).

``MGWFBP_BN_DTYPE`` (the JAX package's ``bn_kwargs``, read when a
``BatchNorm`` is built, as Flax reads it when the module is traced) sets
every batch norm's own dtype with Flax's ``force_float32_reductions=False``:
the statistics reduce in that dtype (``bn_dtype``; see
``BatchNorm._forward_stat_dtype``) and the output is rounded to it. Unset,
nothing changes.

Each module records its children's Flax names in ``FLAX_NAMES`` so that
``convert`` maps parameters and batch statistics leaf by leaf.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM = 0.9  # Flax: weight of the old running statistic
BN_EPSILON = 1e-5
# std of a standard normal truncated to [-2, 2] (Flax's variance_scaling
# divides the target std by it)
_TRUNC_STD = 0.87962566103423978


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(before, after) padding of Flax/XLA ``SAME`` along one dimension."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


Kernel = Union[int, tuple[int, int]]
# "SAME", "VALID" or Flax's explicit ((top, bottom), (left, right))
Padding = Union[str, tuple[tuple[int, int], tuple[int, int]]]


def _pair(v: Kernel) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _pads(x: torch.Tensor, kernel: tuple[int, int], stride: tuple[int, int],
          padding: Padding) -> tuple[tuple[int, int], tuple[int, int]]:
    """((top, bottom), (left, right)) padding of a Flax conv or pool."""
    if padding == "SAME":
        return (same_pads(x.shape[-2], kernel[0], stride[0]),
                same_pads(x.shape[-1], kernel[1], stride[1]))
    if padding == "VALID":
        return (0, 0), (0, 0)
    return tuple(padding[0]), tuple(padding[1])


def same_out(size: int, stride: int) -> int:
    """Output size of a ``SAME`` conv or pool."""
    return -(-size // stride)


def valid_out(size: int, window: int, stride: int = 1) -> int:
    """Output size of a ``VALID`` conv or pool."""
    return (size - window) // stride + 1


class SameConv2d(nn.Conv2d):
    """``flax.linen.Conv`` on NCHW: ``padding`` "SAME" (the default, Flax's
    pads), "VALID" or explicit ``((top, bottom), (left, right))``; square or
    rectangular kernels; ``groups`` (Flax ``feature_group_count``); no bias
    unless asked. ``kernel_init`` names the Flax initializer ``init_weights``
    draws from: "he" (the zoo's ``conv_kernel_init``, He fan-out) or
    "lecun" (``nn.Conv``'s default, LeCun fan-in)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Kernel = 3, stride: Kernel = 1,
                 padding: Padding = "SAME", groups: int = 1,
                 bias: bool = False, kernel_init: str = "he"):
        super().__init__(in_channels, out_channels, _pair(kernel),
                         stride=_pair(stride), padding=0, groups=groups,
                         bias=bias)
        self.flax_padding = padding
        self.kernel_init = kernel_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph, pw = _pads(x, self.kernel_size, self.stride, self.flax_padding)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, self.weight, self.bias, self.stride,
                            (ph[0], pw[0]), 1, self.groups)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, 1,
                        self.groups)


def bn_dtype() -> Optional[torch.dtype]:
    """``MGWFBP_BN_DTYPE`` as a torch dtype (``bfloat16``, ``float16``,
    ``float32``), None when unset: the JAX package's ``bn_kwargs``, the
    ablation switch of the batch norms' reduction dtype."""
    s = os.environ.get("MGWFBP_BN_DTYPE")
    if not s:
        return None
    dtype = getattr(torch, s, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"MGWFBP_BN_DTYPE={s!r} is not a floating dtype")
    return dtype


def _as(value: float, dtype: torch.dtype) -> float:
    """A Python scalar rounded to ``dtype``: what JAX's weak typing makes of
    a Python float that meets an array of that dtype."""
    return float(torch.tensor(value, dtype=dtype))


def _train_batch_norm(x, mean, var, weight, bias, momentum: float,
                      epsilon: float) -> torch.Tensor:
    """Training-mode batch norm by the batch statistics. torch's op itself,
    without ``F.batch_norm``'s refusal of one value per channel: Flax
    normalizes that value to 0 (the V3 aux head's 1x1 map at batch 1)."""
    return torch.batch_norm(x, weight, bias, mean, var, True, momentum,
                            epsilon, torch.backends.cudnn.enabled)


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm`` over the channel dim of NCHW input (or of
    (N, C) rows: the speech model's sequence-wise batch norm), with the
    dtype of ``MGWFBP_BN_DTYPE`` as ``stat_dtype`` when it is set."""

    def __init__(self, num_features: int, momentum: float = BN_MOMENTUM,
                 epsilon: float = BN_EPSILON):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.stat_dtype = bn_dtype()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stat_dtype is not None:
            return self._forward_stat_dtype(x)
        if x.dtype != self.running_mean.dtype:
            return self._forward_low(x)
        if not self.training:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight,
                self.bias, False, 0.0, self.epsilon,
            )
        with torch.no_grad():
            dims = (0,) + tuple(range(2, x.dim()))  # all but the channels
            var, mean = torch.var_mean(x, dim=dims, unbiased=False)
            m = self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        # the output normalizes by the batch statistics; no running buffers
        # are passed, so torch updates nothing behind the update above
        return _train_batch_norm(x, None, None, self.weight, self.bias, 0.0,
                                 self.epsilon)

    def _forward_low(self, x: torch.Tensor) -> torch.Tensor:
        """Below float32 (a bfloat16 step): torch's mixed-type batch norm
        (input and output in x's dtype, scale, bias and statistics in
        float32) reduces the statistics and normalizes in float32, as Flax
        does under ``force_float32_reductions``, without a float32 copy of
        the activations. In training its momentum-1 running update hands
        back the batch statistics of that same pass, which are merged into
        the float32 masters (``_merge_quantized``)."""
        w, b = self.weight.float(), self.bias.float()
        if not self.training:  # the JAX eval step casts the statistics too
            mean, var = (t.to(x.dtype).float()
                         for t in (self.running_mean, self.running_var))
            return F.batch_norm(x, mean, var, w, b, False, 0.0, self.epsilon)
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = _train_batch_norm(x, mean, var, w, b, 1.0, self.epsilon)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            # torch keeps the unbiased variance; Flax the biased one
            self._merge_quantized(x.dtype, mean, var * ((n - 1) / n))
        return y

    def _forward_stat_dtype(self, x: torch.Tensor) -> torch.Tensor:
        """Flax's batch norm with ``dtype=stat_dtype`` and
        ``force_float32_reductions=False``, term for term: the input cast
        to that dtype, mean and variance by E[x^2] - E[x]^2 (clipped at 0)
        with every result rounded to it (the sums accumulate in float32 on
        both sides), the running statistics updated from them (Python
        scalars rounded to the dtype, as JAX's weak typing rounds them),
        ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` with the scale
        and bias in float32, and the output rounded to the dtype. The
        output comes back in x's dtype: a later Flax layer promotes the
        rounded values to its own float32, as torch's layers need."""
        dt = self.stat_dtype
        view = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            xs = x.to(dt)
            dims = (0,) + tuple(range(2, x.dim()))  # all but the channels
            mean = xs.mean(dims)
            var = torch.clamp_min((xs * xs).mean(dims) - mean * mean, 0.0)
            with torch.no_grad():
                self._merge_stat_dtype(x.dtype, mean, var)
        else:
            mean, var = self.running_mean, self.running_var
            if x.dtype != mean.dtype:  # the JAX eval step casts them
                mean, var = (t.to(x.dtype).float() for t in (mean, var))
        eps = _as(self.epsilon, var.dtype)
        mul = torch.rsqrt(var + eps).view(view) * self.weight.float().view(view)
        y = (x - mean.view(view)) * mul + self.bias.float().view(view)
        return y.to(dt).to(x.dtype)

    def _merge_stat_dtype(self, dtype: torch.dtype, mean: torch.Tensor,
                          var: torch.Tensor) -> None:
        """The running update of ``_forward_stat_dtype``: ``m * ra + (1 -
        m) * stat`` with the statistic's product in its dtype; at a lower
        compute dtype on the cast master q, all of it in that dtype, merged
        into the float32 master as a delta (``_merge_quantized``)."""
        m = self.momentum
        c = _as(1.0 - m, mean.dtype)
        for buf, stat in ((self.running_mean, mean), (self.running_var, var)):
            if dtype == buf.dtype:
                buf.mul_(m).add_(stat * c)
            else:
                q = buf.to(dtype)
                new = q * _as(m, dtype) + (stat * c).to(dtype)
                buf.add_(new.float() - q.float())

    def _merge_quantized(self, dtype: torch.dtype, mean: torch.Tensor,
                         var: torch.Tensor) -> None:
        """The JAX step's update of a float32 master at a lower compute
        dtype: Flax updates the CAST statistic q = quantize(master) as
        ``momentum * q + (1 - momentum) * batch_stat``, where the momentum
        takes q's type (0.9 becomes 0.8984375 in bfloat16) and the sum is
        float32, and the step merges the delta, ``master + (new - q)``,
        instead of copying ``new`` back (a copy would bake the quantization
        into the accumulator every step)."""
        m = float(torch.tensor(self.momentum, dtype=dtype))
        for buf, stat in ((self.running_mean, mean), (self.running_var, var)):
            q = buf.to(dtype).float()
            buf.add_(q * m + (1.0 - self.momentum) * stat - q)


def max_pool(x: torch.Tensor, window: Kernel = 3, stride: Kernel = 2,
             padding: str = "SAME") -> torch.Tensor:
    """Flax ``max_pool`` on NCHW. ``SAME`` pads with -inf by ``same_pads``,
    then pools without padding; ``VALID`` pools as it is."""
    window, stride = _pair(window), _pair(stride)
    ph, pw = _pads(x, window, stride, padding)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


def avg_pool(x: torch.Tensor, window: Kernel = 2, stride: Optional[Kernel] = None,
             padding: str = "VALID") -> torch.Tensor:
    """Flax ``avg_pool`` on NCHW (stride defaults to the window). ``SAME``
    pads with zeros by ``same_pads`` and divides every window by its full
    size, pads included (Flax's ``count_include_pad=True``)."""
    window = _pair(window)
    stride = window if stride is None else _pair(stride)
    ph, pw = _pads(x, window, stride, padding)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.avg_pool2d(x, window, stride, (ph[0], pw[0]),
                            count_include_pad=True)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.avg_pool2d(x, window, stride)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NC global average pool."""
    return x.mean(dim=(2, 3))


def local_response_norm(x: torch.Tensor, size: int = 5, alpha: float = 1e-4,
                        beta: float = 0.75, k: float = 2.0) -> torch.Tensor:
    """The JAX package's LRN across the channels of NCHW input:
    ``x / (k + alpha / size * sum_window x^2) ^ beta``, the window over
    channels padded ``(size // 2, size - 1 - size // 2)``."""
    half = size // 2
    sq = F.pad(x * x, (0, 0, 0, 0, half, size - 1 - half))
    c = x.shape[1]
    summed = sq[:, 0:c]
    for i in range(1, size):
        summed = summed + sq[:, i:i + c]
    return x / torch.pow(k + (alpha / size) * summed, beta)


def flatten(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, H * W * C) in NHWC order, the JAX package's
    flatten of the same activations."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def run(modules, x: torch.Tensor) -> torch.Tensor:
    """Apply ``modules`` in order."""
    for m in modules:
        x = m(x)
    return x


class ConvBN(nn.Module):
    """Conv (no bias, He fan-out init; ``SAME`` unless ``padding`` says
    otherwise) + BatchNorm (+ ReLU): the JAX package's ``ConvBN``."""

    FLAX_NAMES = {"conv": "Conv_0", "bn": "BatchNorm_0"}

    def __init__(self, in_channels: int, features: int, kernel: Kernel = 3,
                 stride: Kernel = 1, use_relu: bool = True,
                 padding: Padding = "SAME", groups: int = 1):
        super().__init__()
        self.conv = SameConv2d(in_channels, features, kernel, stride,
                               padding=padding, groups=groups)
        self.bn = BatchNorm(features)
        self.use_relu = use_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x) if self.use_relu else x


class BasicBlock(nn.Module):
    """Post-activation residual block: conv-bn-relu, conv-bn, add, relu,
    with a 1x1 ConvBN shortcut where the shape changes."""

    FLAX_NAMES = {"conv1": "ConvBN_0", "conv2": "ConvBN_1"}

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = ConvBN(in_channels, features, 3, stride)
        self.conv2 = ConvBN(features, features, 3, 1, use_relu=False)
        self.shortcut: Optional[ConvBN] = None
        if in_channels != features or stride != 1:
            self.shortcut = ConvBN(in_channels, features, 1, stride,
                                   use_relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        residual = x if self.shortcut is None else self.shortcut(x)
        return F.relu(y + residual)


@torch.no_grad()
def init_weights(module: nn.Module,
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """Flax's initializers from a seeded generator: convs
    ``variance_scaling(2, fan_out, truncated_normal)`` (LeCun fan-in
    truncated normal where a conv keeps Flax's default), dense kernels
    LeCun truncated normal, biases zero, embeddings normal with std
    1/sqrt(d), LayerNorm and BatchNorm scale one and bias zero, running
    mean zero and variance one; a module with its own ``init_flax_`` (the
    LSTM cell) initializes itself."""
    for sub in module.modules():
        if hasattr(sub, "init_flax_"):
            sub.init_flax_(generator)
        elif isinstance(sub, nn.Embedding):
            sub.weight.normal_(0.0, sub.embedding_dim ** -0.5,
                               generator=generator)
        elif isinstance(sub, nn.LayerNorm):
            sub.weight.fill_(1.0)
            sub.bias.zero_()
        elif isinstance(sub, nn.Conv2d):
            o, i, kh, kw = sub.weight.shape
            if getattr(sub, "kernel_init", "he") == "lecun":
                std = math.sqrt(1.0 / (kh * kw * i)) / _TRUNC_STD
            else:
                std = math.sqrt(2.0 / (kh * kw * o)) / _TRUNC_STD
            nn.init.trunc_normal_(sub.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if sub.bias is not None:
                sub.bias.zero_()
        elif isinstance(sub, nn.Linear):
            std = math.sqrt(1.0 / sub.in_features) / _TRUNC_STD
            nn.init.trunc_normal_(sub.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if sub.bias is not None:
                sub.bias.zero_()
        elif isinstance(sub, BatchNorm):
            sub.weight.fill_(1.0)
            sub.bias.zero_()
            sub.running_mean.zero_()
            sub.running_var.fill_(1.0)
    return module
