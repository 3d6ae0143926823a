"""Peak arithmetic rates by device (the port's counterpart of the
``peak_flops`` table in ``mgwfbp_tpu/utils/platform.py``), for MFU.

NVIDIA H100 (SXM, data sheet, dense, at the 700 W limit): 989 TFLOP/s in
bfloat16, 495 in TF32, 67 in float32 outside the tensor cores. The CPU
entry is a nominal 1e13, above what a many-core host with bfloat16 matrix
units reaches, so that a CPU rehearsal still computes an MFU below 1.0
(it is not a device number; the JAX table's 1e11 is below what such a
host delivers). Unknown devices give None.
"""

from __future__ import annotations

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
