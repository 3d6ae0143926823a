"""Model registry (counterpart of ``mgwfbp_tpu/models/__init__.py``).

``create_model`` returns the module plus a ``ModelMeta`` describing the
canonical input, with the same fields as the JAX registry's (the input
dtype is a numpy dtype here; image inputs are NHWC, as the loaders hand
them over). Every name of the JAX registry is here: the MNIST models
(mnistnet, lenet, fcn5net, lr), caffe_cifar, the CIFAR ResNets
(resnet20/32/44/56/110, preresnet20/110), vgg11/13/16/19, resnext29,
densenet (BC-100-12), the ImageNet ResNets (resnet18/34/50/101/152),
vgg16i, alexnet, densenet121/161/201, googlenet and inceptionv3 (with aux
heads), inceptionv4, the PTB LSTM, the transformer LM and the speech model
lstman4 (DeepSpeech with CTC; input (time, freq) spectrograms).

A factory takes the class count and, for an image model, the input
(H, W, C): a dataset override retargets ``meta.input_shape`` (as the JAX
registry does) and the module is built for that input, since a torch
layer's width is fixed where Flax infers it from the input.
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

# canonical image input per dataset (a dataset override retargets
# meta.input_shape to it)
DATASET_INPUT_HWC = {
    "mnist": (28, 28, 1),
    "cifar10": (32, 32, 3),
    "imagenet": (224, 224, 3),
}


@dataclasses.dataclass(frozen=True)
class ModelMeta:
    name: str
    dataset: str
    num_classes: int
    # example input shape WITHOUT batch dim; image models: (H, W, C) NHWC;
    # lm models: (seq_len,) tokens
    input_shape: tuple[int, ...]
    input_dtype: Any = np.float32
    task: str = "classify"  # classify | lm | ctc
    has_aux_logits: bool = False  # googlenet/inceptionv3 style aux heads
    has_carry: bool = False


_REGISTRY: dict[str, Callable[..., tuple[Any, ModelMeta]]] = {}


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
    the model's default, as in the JAX registry; for an image model a
    dataset override also retargets meta.input_shape and builds the module
    for that input."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; known: {model_names()}")
    factory = _REGISTRY[name]
    module, meta = factory(num_classes)
    if dataset is not None and dataset != meta.dataset:
        nc = num_classes or DATASET_CLASSES.get(dataset, meta.num_classes)
        hwc = (DATASET_INPUT_HWC.get(dataset) if meta.task == "classify"
               else None)
        if hwc is not None and hwc != tuple(meta.input_shape):
            module, meta = factory(nc, hwc)
        elif nc != meta.num_classes:
            module, meta = factory(nc)
        meta = dataclasses.replace(meta, dataset=dataset)
    return module, meta


MNIST_HWC = DATASET_INPUT_HWC["mnist"]
CIFAR_HWC = DATASET_INPUT_HWC["cifar10"]
IMAGENET_HWC = DATASET_INPUT_HWC["imagenet"]
INCEPTION_HWC = (299, 299, 3)


def _image(name: str, dataset: str, default_nc: int, default_hwc, build,
           **meta_kw):
    """Register an image model: ``build(nc, hwc)`` makes the module."""

    @register(name)
    def _factory(nc=None, hwc=None):
        nc = nc or default_nc
        hwc = tuple(hwc or default_hwc)
        return build(nc, hwc), ModelMeta(name, dataset, nc, hwc, **meta_kw)


def _simple(cls_name: str):
    def build(nc, hwc):
        from mgwfbp_tpu_torch.models import simple

        return getattr(simple, cls_name)(nc, input_hwc=hwc)

    return build


for _name, _cls in (("mnistnet", "MnistNet"), ("lenet", "LeNet"),
                    ("fcn5net", "FCN5Net"), ("lr", "LinearRegression")):
    _image(_name, "mnist", 10, MNIST_HWC, _simple(_cls))
_image("caffe_cifar", "cifar10", 10, CIFAR_HWC, _simple("CaffeCifar"))


def _cifar_resnet(depth: int, preact: bool):
    def build(nc, hwc):
        from mgwfbp_tpu_torch.models.resnet_cifar import CifarResNet

        return CifarResNet(depth=depth, num_classes=nc, preact=preact,
                           in_channels=hwc[2])

    return build


for _d in (20, 32, 44, 56, 110):
    _image(f"resnet{_d}", "cifar10", 10, CIFAR_HWC, _cifar_resnet(_d, False))
for _d in (20, 110):
    _image(f"preresnet{_d}", "cifar10", 10, CIFAR_HWC, _cifar_resnet(_d, True))


def _imagenet_resnet(depth: int):
    def build(nc, hwc):
        from mgwfbp_tpu_torch.models.resnet_imagenet import imagenet_resnet

        return imagenet_resnet(depth, nc, in_channels=hwc[2])

    return build


for _d in (18, 34, 50, 101, 152):
    _image(f"resnet{_d}", "imagenet", 1000, IMAGENET_HWC, _imagenet_resnet(_d))


def _vgg(depth: int, imagenet: bool):
    def build(nc, hwc):
        from mgwfbp_tpu_torch.models.vgg import VGGCifar, VGGImageNet

        cls = VGGImageNet if imagenet else VGGCifar
        return cls(cfg=f"vgg{depth}", num_classes=nc, input_hwc=hwc)

    return build


for _d in (11, 13, 16, 19):
    _image(f"vgg{_d}", "cifar10", 10, CIFAR_HWC, _vgg(_d, False))
_image("vgg16i", "imagenet", 1000, IMAGENET_HWC, _vgg(16, True))


def _alexnet(nc, hwc):
    from mgwfbp_tpu_torch.models.alexnet import AlexNet

    return AlexNet(nc, input_hwc=hwc)


def _resnext29(nc, hwc):
    from mgwfbp_tpu_torch.models.resnext import ResNeXt29

    return ResNeXt29(num_classes=nc, in_channels=hwc[2])


def _densenet(depth: Optional[int]):
    def build(nc, hwc):
        from mgwfbp_tpu_torch.models.densenet import (
            densenet_bc_100_12,
            imagenet_densenet,
        )

        if depth is None:
            return densenet_bc_100_12(nc, in_channels=hwc[2])
        return imagenet_densenet(depth, nc, in_channels=hwc[2])

    return build


def _googlenet(nc, hwc):
    from mgwfbp_tpu_torch.models.googlenet import GoogLeNet

    return GoogLeNet(num_classes=nc, input_hwc=hwc)


def _inception(version: int):
    def build(nc, hwc):
        from mgwfbp_tpu_torch.models.inception import InceptionV3, InceptionV4

        cls = InceptionV3 if version == 3 else InceptionV4
        return cls(num_classes=nc, in_channels=hwc[2])

    return build


_image("alexnet", "imagenet", 1000, IMAGENET_HWC, _alexnet)
_image("resnext29", "cifar10", 10, CIFAR_HWC, _resnext29)
_image("densenet", "cifar10", 10, CIFAR_HWC, _densenet(None))
for _d in (121, 161, 201):
    _image(f"densenet{_d}", "imagenet", 1000, IMAGENET_HWC, _densenet(_d))
_image("googlenet", "imagenet", 1000, IMAGENET_HWC, _googlenet,
       has_aux_logits=True)
_image("inceptionv3", "imagenet", 1000, INCEPTION_HWC, _inception(3),
       has_aux_logits=True)
_image("inceptionv4", "imagenet", 1000, INCEPTION_HWC, _inception(4))


@register("transformer")
def _transformer(nc, hwc=None):
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
def _lstm(nc, hwc=None):
    from mgwfbp_tpu_torch.models.lstm import PTBLSTM

    nc = nc or DATASET_CLASSES["ptb"]
    return (
        PTBLSTM(vocab_size=nc),
        ModelMeta(
            name="lstm", dataset="ptb", num_classes=nc, input_shape=(35,),
            input_dtype=np.int32, task="lm", has_carry=True,
        ),
    )


@register("lstman4")
def _lstman4(nc, hwc=None):
    from mgwfbp_tpu_torch.models.deepspeech import DeepSpeech

    nc = nc or DATASET_CLASSES["an4"]
    return (
        DeepSpeech(num_classes=nc),
        ModelMeta(
            name="lstman4", dataset="an4", num_classes=nc,
            input_shape=(201, 161), task="ctc",  # (time, freq=161)
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
