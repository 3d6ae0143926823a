"""Platform helpers (counterpart of ``mgwfbp_tpu/utils/platform.py``):
the peak arithmetic rates by device, for MFU; environment knobs that name
the variable when its value is garbage (``env_float``, ``env_int``); a
deadline around a call that may hang (``run_with_deadline``); and the
launcher's probe of the card under a deadline (``preflight_backend``).

NVIDIA H100 (SXM, data sheet, dense, at the 700 W limit): 989 TFLOP/s in
bfloat16, 495 in TF32, 67 in float32 outside the tensor cores. The CPU
entry is a nominal 1e13, above what a many-core host with bfloat16 matrix
units reaches, so that a CPU rehearsal still computes an MFU below 1.0
(it is not a device number; the JAX table's 1e11 is below what such a
host delivers). Unknown devices give None.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

# (device-name substring, {compute dtype: FLOP/s})
PEAK_FLOPS_BY_DEVICE = [
    ("h100", {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}),
    ("cpu", {"bfloat16": 1e13, "tf32": 1e13, "float32": 1e13}),
]


def peak_flops(device_name: str, dtype: Optional[str] = "bfloat16"):
    """Peak FLOP/s of a device for work in ``dtype`` (``bfloat16``,
    ``tf32`` or ``float32``; None is float32), or None when the device is
    not in the table."""
    name = device_name.lower()
    key = {None: "float32", "f32": "float32", "bf16": "bfloat16"}.get(
        dtype, dtype)
    for sub, rates in PEAK_FLOPS_BY_DEVICE:
        if sub in name:
            if key not in rates:
                raise ValueError(f"dtype {dtype!r}: one of {sorted(rates)}")
            return rates[key]
    return None


def env_float(name: str, default: float, environ=None) -> float:
    """A float knob from the environment; unset or empty gives
    ``default``, garbage raises ValueError naming the variable and its
    value (a typo'd timeout must fail at start-up, not fall back to a
    default that changes what the healer does)."""
    raw = ((environ if environ is not None else os.environ).get(name)
           or "").strip()
    if not raw:
        return float(default)
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not a number") from None


def env_int(name: str, default: int, environ=None) -> int:
    """``env_float``'s integer sibling."""
    raw = ((environ if environ is not None else os.environ).get(name)
           or "").strip()
    if not raw:
        return int(default)
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer") from None


class DeadlineExceeded(RuntimeError):
    """run_with_deadline hit its timeout (the worker thread is abandoned)."""


def run_with_deadline(fn, timeout_s: float, what: str = "operation"):
    """Run fn() on a daemon thread and wait at most ``timeout_s``: its
    value, DeadlineExceeded on a timeout, else fn's own exception
    unchanged. The abandoned thread cannot keep the process alive, but any
    lock it holds (a CUDA context's included) stays held: a process that
    saw DeadlineExceeded should exit soon."""
    box: dict = {}

    def work():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e

    t = threading.Thread(target=work, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise DeadlineExceeded(f"{what} exceeded {timeout_s:.0f}s deadline")
    if "error" in box:
        raise box["error"]
    return box["value"]


def _touch_cards() -> list:
    """Initialise CUDA, launch one tiny kernel on each card and wait for
    it: a card that accepts a context but runs nothing hangs here."""
    import torch

    torch.cuda.init()
    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    for dev in devices:
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize(dev)
    return devices


def preflight_backend(timeout_s: Optional[float] = None,
                      device: str = "cuda") -> list:
    """Touch the card under a deadline and return the device list; raise
    instead of hanging. A wedged driver or a card held by a dead process
    can block CUDA's initialisation indefinitely, and a launcher that
    hangs can neither report nor be retried.

    ``timeout_s`` None reads ``MGWFBP_INIT_TIMEOUT_S`` (default 300); <= 0
    probes without a deadline. ``device="cpu"`` touches no CUDA at all and
    returns ``[cpu]``. No card raises RuntimeError (never a quiet CPU
    run)."""
    import torch

    if torch.device(device).type == "cpu":
        return [torch.device("cpu")]
    if timeout_s is None:
        timeout_s = env_float("MGWFBP_INIT_TIMEOUT_S", 300.0)
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass --device cpu to run on the CPU explicitly"
        )
    if timeout_s <= 0:
        return _touch_cards()
    try:
        return run_with_deadline(_touch_cards, timeout_s,
                                 what="CUDA initialisation")
    except DeadlineExceeded:
        raise DeadlineExceeded(
            f"CUDA initialisation and a first kernel exceeded "
            f"{timeout_s:.0f}s: the card is wedged or held by another "
            "process. Check nvidia-smi, retry later, or raise "
            "MGWFBP_INIT_TIMEOUT_S."
        ) from None
