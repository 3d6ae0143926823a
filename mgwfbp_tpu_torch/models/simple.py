"""Small dense and conv models (counterpart of ``mgwfbp_tpu/models/simple.py``):
``MnistNet``, ``LeNet``, ``FCN5Net``, ``LinearRegression`` and
``CaffeCifar`` (registered as mnistnet, lenet, fcn5net, lr, caffe_cifar).

Input NCHW. Convs keep Flax's default LeCun init and a bias; every flatten
before a Dense layer is in NHWC order (``common.flatten``), as the JAX
package flattens. Convs sit in ``convs`` and Dense layers in ``fcs``, so
that their Flax names are ``Conv_<i>`` and ``Dense_<i>``. ``input_hwc``
sizes the first Dense layer, which Flax infers from the input (a dataset
override of the registry gives another input).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from mgwfbp_tpu_torch.models.common import (
    SameConv2d,
    flatten,
    local_response_norm,
    max_pool,
    same_out,
    valid_out,
)

MNIST_HWC = (28, 28, 1)
CIFAR_HWC = (32, 32, 3)


def _conv(cin: int, cout: int, kernel: int, padding: str) -> SameConv2d:
    """A Flax ``nn.Conv`` with its defaults: bias, LeCun init."""
    return SameConv2d(cin, cout, kernel, padding=padding, bias=True,
                      kernel_init="lecun")


class MnistNet(nn.Module):
    """conv10@5x5 -> pool -> conv20@5x5 -> dropout -> pool -> fc50 ->
    dropout -> fc; 28x28x1 input."""

    def __init__(self, num_classes: int = 10, input_hwc=MNIST_HWC):
        super().__init__()
        h, w, c = input_hwc
        h, w = (valid_out(valid_out(valid_out(valid_out(n, 5), 2, 2), 5), 2, 2)
                for n in (h, w))
        self.convs = nn.ModuleList([_conv(c, 10, 5, "VALID"),
                                    _conv(10, 20, 5, "VALID")])
        self.fcs = nn.ModuleList([nn.Linear(h * w * 20, 50),
                                  nn.Linear(50, num_classes)])
        self.drop = nn.Dropout(0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(max_pool(self.convs[0](x), 2, 2, "VALID"))
        x = self.drop(self.convs[1](x))
        x = flatten(F.relu(max_pool(x, 2, 2, "VALID")))
        x = self.drop(F.relu(self.fcs[0](x)))
        return self.fcs[1](x)


class LeNet(nn.Module):
    """LeNet-5: conv6@5x5 SAME / pool / conv16@5x5 / pool / fc120 / fc84 /
    fc; 28x28x1 input."""

    def __init__(self, num_classes: int = 10, input_hwc=MNIST_HWC):
        super().__init__()
        h, w, c = input_hwc
        h, w = (valid_out(valid_out(valid_out(n, 2, 2), 5), 2, 2)
                for n in (h, w))
        self.convs = nn.ModuleList([_conv(c, 6, 5, "SAME"),
                                    _conv(6, 16, 5, "VALID")])
        self.fcs = nn.ModuleList([nn.Linear(h * w * 16, 120), nn.Linear(120, 84),
                                  nn.Linear(84, num_classes)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool(F.relu(self.convs[0](x)), 2, 2, "VALID")
        x = max_pool(F.relu(self.convs[1](x)), 2, 2, "VALID")
        x = flatten(x)
        x = F.relu(self.fcs[0](x))
        x = F.relu(self.fcs[1](x))
        return self.fcs[2](x)


class FCN5Net(nn.Module):
    """Five fully-connected layers: 3 x hidden, 1024, classes."""

    def __init__(self, num_classes: int = 10, hidden: int = 4096,
                 input_hwc=MNIST_HWC):
        super().__init__()
        widths = [math.prod(input_hwc), hidden, hidden, hidden, 1024]
        self.fcs = nn.ModuleList(
            [nn.Linear(a, b) for a, b in zip(widths, widths[1:])]
            + [nn.Linear(1024, num_classes)]
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = flatten(x)
        for fc in self.fcs[:-1]:
            x = F.relu(fc(x))
        return self.fcs[-1](x)


class LinearRegression(nn.Module):
    """One Dense layer on the flattened image (dnn ``lr``)."""

    def __init__(self, num_classes: int = 10, input_hwc=MNIST_HWC):
        super().__init__()
        self.fcs = nn.ModuleList([nn.Linear(math.prod(input_hwc), num_classes)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fcs[0](flatten(x))


class CaffeCifar(nn.Module):
    """Caffe's cifar10-quick: 3 x [conv5x5 SAME + max pool 3x3/2 SAME], LRN
    (size 3) after the first two, fc64, fc; 32x32x3 input."""

    def __init__(self, num_classes: int = 10, input_hwc=CIFAR_HWC):
        super().__init__()
        h, w, c = input_hwc
        h, w = (same_out(same_out(same_out(n, 2), 2), 2) for n in (h, w))
        self.convs = nn.ModuleList([_conv(c, 32, 5, "SAME"),
                                    _conv(32, 32, 5, "SAME"),
                                    _conv(32, 64, 5, "SAME")])
        self.fcs = nn.ModuleList([nn.Linear(h * w * 64, 64),
                                  nn.Linear(64, num_classes)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, conv in enumerate(self.convs):
            x = max_pool(F.relu(conv(x)), 3, 2, "SAME")
            if i < 2:
                x = local_response_norm(x, size=3)
        x = F.relu(self.fcs[0](flatten(x)))
        return self.fcs[1](x)
