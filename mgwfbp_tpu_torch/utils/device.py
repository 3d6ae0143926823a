"""Device resolution for the port's entry points.

The port runs on the card unless the caller asks for the CPU: ``None`` and
``"cuda"`` mean the current CUDA device, ``"cpu"`` is honoured as asked, and
asking for a card that is not there raises instead of dropping quietly to
the CPU (a CPU number must never pass for a device number).
"""

from __future__ import annotations

import platform
from typing import Optional, Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but no CUDA device is "
                "available; pass device='cpu' to run on the CPU explicitly"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


def device_kind(device: torch.device) -> str:
    """The device's name as results record it: the card's name, or
    ``cpu (<machine>)``."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return f"cpu ({platform.machine() or 'unknown'})"


def set_matmul_precision(dtype=None, log=None) -> bool:
    """The one precision setting of the port: TF32 for float32 matmuls
    (cuBLAS) and convolutions (cuDNN), set from the compute dtype (None,
    ``"float32"`` or ``"bfloat16"``, or a torch dtype), returned, and
    logged once per call when a logger is given.

    Off for every dtype. At float32 that keeps both libraries in full
    float32, which is what the CPU parity tests compare and what every
    recorded card number was taken at (torch's own defaults would run
    cuDNN in TF32 and cuBLAS in float32). At bfloat16 every convolution
    and matmul of the step runs in bfloat16 already; the float32 work left
    (batch-norm statistics, the loss) is not a product, and the JAX
    package computes any that were in float32 too."""
    name = str(dtype).replace("torch.", "") if dtype is not None else "float32"
    if name not in ("float32", "f32", "bfloat16", "bf16"):
        raise ValueError(f"compute dtype {dtype!r}: float32 or bfloat16")
    tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    if log is not None:
        log.info("precision: compute dtype %s; TF32 %s for float32 matmuls "
                 "and convolutions", name, "on" if tf32 else "off")
    return tf32
