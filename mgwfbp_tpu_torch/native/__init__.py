"""Native (C++) host kernels of the loader, built at first use and bound
with ctypes (counterpart of ``mgwfbp_tpu/native``).

``augment.cpp`` (the port's own copy of the JAX package's source) is
compiled with ``g++`` into ``build/mgwfbp_tpu_torch/`` at the root of the
checkout, a directory ``.gitignore`` lists, under a name carrying a hash of
the source and flags (an edited source is rebuilt). Nothing is built when
the module is imported. Every caller keeps the numpy path, the
bit-identical reference, for a machine without a compiler: ``get_lib()``
returns None there. Which path runs is logged once, at INFO.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

from mgwfbp_tpu_torch.utils.logging import get_logger

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "augment.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "mgwfbp_tpu_torch")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
MAX_CHANNELS = 16  # the kernels' per-channel tables

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
build_error: Optional[str] = None  # why the library is not loaded, if it is not


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libmgwfbp_native.{digest.hexdigest()[:16]}.so")


def _build(so: str) -> None:
    """g++ into a per-process temporary file, then an atomic rename (two
    ranks building at once never interleave their writes)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, text=True, timeout=120)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on the first call; None when it cannot be
    built or loaded (``build_error`` says why)."""
    global _LIB, _TRIED, build_error
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        log = get_logger("mgwfbp.native")
        so = library_path()
        try:
            if not os.path.exists(so):
                _build(so)
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", None) or str(e)
            build_error = f"{type(e).__name__}: {detail}".strip()
            log.info("native host augment unavailable (%s): the loader runs "
                     "its numpy path", build_error)
            return None
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        lib.fused_crop_flip_normalize.argtypes = [
            ptr, ptr, i64, i64, i64, i64, i64, ptr, ptr, ptr, ptr, ptr,
        ]
        lib.fused_crop_flip_normalize.restype = None
        lib.normalize_u8.argtypes = [ptr, ptr, i64, i64, ptr, ptr]
        lib.normalize_u8.restype = None
        log.info("native host augment loaded: %s", so)
        _LIB = lib
        return _LIB


def available() -> bool:
    return get_lib() is not None


def fused_crop_flip_normalize(
    x: np.ndarray,
    oy: np.ndarray,
    ox: np.ndarray,
    flip: np.ndarray,
    mean: np.ndarray,
    std: np.ndarray,
    pad: int,
) -> Optional[np.ndarray]:
    """Crop (offsets into the zero-padded image), flip and normalize a
    uint8 (B, H, W, C) batch in one pass; None when the library is not
    loaded or the input does not qualify."""
    if x.dtype != np.uint8 or x.ndim != 4 or x.shape[3] > MAX_CHANNELS:
        return None
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x)
    b, h, w, c = x.shape
    out = np.empty((b, h, w, c), np.float32)
    oy = np.ascontiguousarray(oy, np.int64)
    ox = np.ascontiguousarray(ox, np.int64)
    fl = np.ascontiguousarray(flip, np.uint8)
    m = np.ascontiguousarray(mean, np.float32)
    s = np.ascontiguousarray(std, np.float32)
    lib.fused_crop_flip_normalize(
        x.ctypes.data, out.ctypes.data, b, h, w, c, pad,
        oy.ctypes.data, ox.ctypes.data, fl.ctypes.data,
        m.ctypes.data, s.ctypes.data,
    )
    return out


def normalize_u8(x: np.ndarray, mean: np.ndarray,
                 std: np.ndarray) -> Optional[np.ndarray]:
    """uint8 (..., C) -> normalized float32; None when the library is not
    loaded or the input does not qualify."""
    if x.dtype != np.uint8 or x.ndim < 1 or x.shape[-1] > MAX_CHANNELS:
        return None
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x)
    out = np.empty(x.shape, np.float32)
    m = np.ascontiguousarray(mean, np.float32)
    s = np.ascontiguousarray(std, np.float32)
    lib.normalize_u8(x.ctypes.data, out.ctypes.data, x.size, x.shape[-1],
                     m.ctypes.data, s.ctypes.data)
    return out
