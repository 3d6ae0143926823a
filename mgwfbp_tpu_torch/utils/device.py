"""Device resolution for the port's entry points.

The port runs on the card unless the caller asks for the CPU: ``None`` and
``"cuda"`` mean the current CUDA device, ``"cpu"`` is honoured as asked, and
asking for a card that is not there raises instead of dropping quietly to
the CPU (a CPU number must never pass for a device number).
"""

from __future__ import annotations

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
