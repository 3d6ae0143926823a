"""The analytic work of an ImageNet ResNet, from its configuration's shapes.

Every count here follows from the configuration file alone (stage sizes,
widths, expansion, image size, padding), never from what the program
runs, so a change to the program cannot move the yardstick:

  * ``layers``: every convolution, batch norm and the classifier, with
    their input and output shapes for one image;
  * ``params``: the leaves in the order and under the names the harness
    hands weights out by (``stem.conv.weight``, ``blocks.3.conv2.bn.bias``,
    ``fc.weight``, ...);
  * multiply-adds of the forward, FLOPs of a training step (2 per
    multiply-add; the backward is twice the forward: the input's gradient
    and the weights' gradient), and the bytes the batch norms must move.
"""

from __future__ import annotations

import math


def same_out(size: int, stride: int) -> int:
    """Output size of a ``SAME``-padded convolution or pool."""
    return -(-size // stride)


def layers(config: dict) -> list[dict]:
    """Convolutions (``kind`` conv, each followed by its batch norm ``bn``)
    and the classifier (``fc``), in forward order, for one image."""
    h = int(config["image_size"])
    cin = int(config["in_channels"])
    stem = int(config["stem_width"])
    k = int(config["stem_kernel"])
    out = []

    def conv(name, ci, co, kernel, stride, hin):
        hout = same_out(hin, stride)
        out.append(dict(kind="conv", name=name, cin=ci, cout=co, k=kernel,
                        stride=stride, hin=hin, hout=hout))
        out.append(dict(kind="bn", name=name, channels=co, hout=hout))
        return hout

    h = conv("stem", cin, stem, k, 2, h)
    h = same_out(h, 2)  # the 3x3/2 max pool
    ch = stem
    expansion = int(config["expansion"])
    i = 0
    for stage, (n, width) in enumerate(zip(config["stage_sizes"],
                                           config["widths"])):
        for j in range(n):
            stride = 2 if (stage > 0 and j == 0) else 1
            o = width * expansion
            name = f"blocks.{i}"
            h1 = conv(f"{name}.conv1", ch, width, 1, 1, h)
            h2 = conv(f"{name}.conv2", width, width, 3, stride, h1)
            conv(f"{name}.conv3", width, o, 1, 1, h2)
            if ch != o or stride != 1:
                conv(f"{name}.shortcut", ch, o, 1, stride, h)
            ch, h, i = o, h2, i + 1
    out.append(dict(kind="fc", name="fc", cin=ch,
                    cout=int(config["num_classes"])))
    return out


def params(config: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, kind) of every leaf: ``conv`` weights (out, in, k, k),
    batch-norm ``scale`` and ``shift``, ``fc`` weight (out, in) and
    ``fc_bias``."""
    leaves = []
    for layer in layers(config):
        name = layer["name"]
        if layer["kind"] == "conv":
            leaves.append((f"{name}.conv.weight",
                           (layer["cout"], layer["cin"], layer["k"],
                            layer["k"]), "conv"))
        elif layer["kind"] == "bn":
            leaves.append((f"{name}.bn.weight", (layer["channels"],), "scale"))
            leaves.append((f"{name}.bn.bias", (layer["channels"],), "shift"))
        else:
            leaves.append(("fc.weight", (layer["cout"], layer["cin"]), "fc"))
            leaves.append(("fc.bias", (layer["cout"],), "fc_bias"))
    return leaves


def param_count(config: dict) -> int:
    return sum(math.prod(shape) for _, shape, _ in params(config))


def conv_macs(config: dict) -> int:
    """Multiply-adds of every convolution's forward, one image."""
    return sum(l["hout"] ** 2 * l["cout"] * l["cin"] * l["k"] ** 2
               for l in layers(config) if l["kind"] == "conv")


def fc_macs(config: dict) -> int:
    return sum(l["cin"] * l["cout"] for l in layers(config)
               if l["kind"] == "fc")


def forward_macs(config: dict) -> int:
    """Multiply-adds of the forward, one image (convolutions and the
    classifier; the published count, e.g. 4.1 G for ResNet-50)."""
    return conv_macs(config) + fc_macs(config)


def train_flops(config: dict, images: int) -> float:
    """FLOPs of forward and backward over ``images`` images: 2 per
    multiply-add, three products (forward, input gradient, weight
    gradient) per convolution and classifier."""
    return 2.0 * 3.0 * forward_macs(config) * images


def conv_train_flops(config: dict, images: int) -> float:
    """The convolutions' share of ``train_flops``."""
    return 2.0 * 3.0 * conv_macs(config) * images


def bn_train_bytes(config: dict, images: int, dtype_bytes: int) -> float:
    """Bytes the batch norms must move in one training step over
    ``images`` images, at ``dtype_bytes`` per activation: the forward
    reads x and writes y, the backward reads x and dy and writes dx, each
    once (5 activation tensors per batch norm)."""
    elems = sum(l["channels"] * l["hout"] ** 2 for l in layers(config)
                if l["kind"] == "bn")
    return 5.0 * elems * images * dtype_bytes
