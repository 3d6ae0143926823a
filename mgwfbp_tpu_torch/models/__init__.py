"""Model registry (counterpart of ``mgwfbp_tpu/models/__init__.py``).

``create_model`` returns the module plus a ``ModelMeta`` describing the
canonical input, with the same fields as the JAX registry's (the input
dtype is a numpy dtype here; image inputs are NHWC, as the loaders hand
them over). Ported so far: the CIFAR ResNets, the ImageNet ResNets, the
PTB LSTM and the transformer LM; the rest of the zoo is listed in
ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np

# Dataset -> number of classes (vocabulary size for LM datasets)
DATASET_CLASSES = {
    "mnist": 10,
    "cifar10": 10,
    "imagenet": 1000,
    "ptb": 10000,
    "an4": 29,
}


@dataclasses.dataclass(frozen=True)
class ModelMeta:
    name: str
    dataset: str
    num_classes: int
    # example input shape WITHOUT batch dim; lm models: (seq_len,) tokens
    input_shape: tuple[int, ...]
    input_dtype: Any = np.float32
    task: str = "classify"  # classify | lm | ctc
    has_aux_logits: bool = False
    has_carry: bool = False


_REGISTRY: dict[str, Callable[[Optional[int]], tuple[Any, ModelMeta]]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def model_names() -> list[str]:
    return sorted(_REGISTRY)


def create_model(name: str, dataset: Optional[str] = None,
                 num_classes: Optional[int] = None):
    """Build (module, meta) for a model name. dataset/num_classes override
    the model's default, as in the JAX registry."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; known: {model_names()}")
    factory = _REGISTRY[name]
    module, meta = factory(num_classes)
    if dataset is not None and dataset != meta.dataset:
        nc = num_classes or DATASET_CLASSES.get(dataset, meta.num_classes)
        if nc != meta.num_classes:
            module, meta = factory(nc)
        meta = dataclasses.replace(meta, dataset=dataset)
    return module, meta


CIFAR_HWC = (32, 32, 3)


def _register_cifar_resnet(depth: int):
    @register(f"resnet{depth}")
    def _factory(nc, depth=depth):
        from mgwfbp_tpu_torch.models.resnet_cifar import CifarResNet

        nc = nc or 10
        return (
            CifarResNet(depth=depth, num_classes=nc),
            ModelMeta(f"resnet{depth}", "cifar10", nc, CIFAR_HWC),
        )


for _d in (20, 32, 44, 56, 110):
    _register_cifar_resnet(_d)


def _register_preresnet(depth: int):
    @register(f"preresnet{depth}")
    def _factory(nc, depth=depth):
        from mgwfbp_tpu_torch.models.resnet_cifar import CifarResNet

        nc = nc or 10
        return (
            CifarResNet(depth=depth, num_classes=nc, preact=True),
            ModelMeta(f"preresnet{depth}", "cifar10", nc, CIFAR_HWC),
        )


for _d in (20, 110):
    _register_preresnet(_d)


IMAGENET_HWC = (224, 224, 3)


def _register_imagenet_resnet(depth: int):
    @register(f"resnet{depth}")
    def _factory(nc, depth=depth):
        from mgwfbp_tpu_torch.models.resnet_imagenet import imagenet_resnet

        nc = nc or 1000
        return (
            imagenet_resnet(depth, nc),
            ModelMeta(f"resnet{depth}", "imagenet", nc, IMAGENET_HWC),
        )


for _d in (18, 34, 50, 101, 152):
    _register_imagenet_resnet(_d)


@register("transformer")
def _transformer(nc):
    from mgwfbp_tpu_torch.models.transformer import TransformerLM

    nc = nc or DATASET_CLASSES["ptb"]
    return (
        # the JAX registry defaults to dense XLA attention (its measured
        # choice on the TPU); the port serves through its flash kernel,
        # which falls back to dense outside the kernel's shape contract
        TransformerLM(vocab_size=nc, attn_impl="flash"),
        ModelMeta(
            name="transformer", dataset="ptb", num_classes=nc,
            input_shape=(35,), input_dtype=np.int32, task="lm",
            has_carry=False,
        ),
    )


@register("lstm")
def _lstm(nc):
    from mgwfbp_tpu_torch.models.lstm import PTBLSTM

    nc = nc or DATASET_CLASSES["ptb"]
    return (
        PTBLSTM(vocab_size=nc),
        ModelMeta(
            name="lstm", dataset="ptb", num_classes=nc, input_shape=(35,),
            input_dtype=np.int32, task="lm", has_carry=True,
        ),
    )


def for_training(module):
    """The module as the JAX package trains it. The registered transformer
    serves through the flash kernel, which has no backward (nor has the
    JAX package's Pallas kernel); the JAX registry trains it through dense
    attention, and so does the port."""
    from mgwfbp_tpu_torch.models.transformer import TransformerLM

    if isinstance(module, TransformerLM):
        module.set_attn_impl("dense")
    return module
