"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/*.cu`` source has a plain C interface and is compiled on its own
with ``nvcc`` for ``sm_90a`` into ``build/mgwfbp_tpu_torch/`` at the root of
the checkout (a directory ``.gitignore`` lists), at first use. The library's
file name carries a hash of the source and flags, so an edited source is
rebuilt and a stale library is never loaded. ``build`` starts one ``nvcc``
per source, all at once, and waits for them together.

Nothing here runs at import time: this module is imported on machines that
have no ``nvcc`` and no card (the CPU tests), where the kernels' plain
versions run instead.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Iterable, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "mgwfbp_tpu_torch")

# kernel name -> source file under csrc/
SOURCES = {"flash_attn_fwd": "flash_attn_fwd.cu"}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    name: str
    path: str
    seconds: float  # 0.0 when an up-to-date library was found
    log: str  # nvcc's output (ptxas register / shared-memory report)


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            path = os.path.join(root, "bin", "nvcc")
            if os.access(path, os.X_OK):
                return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, "
            "/usr/local/cuda and PATH): the CUDA kernels cannot be built"
        )
    return path


def library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}.{digest.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> dict[str, BuildResult]:
    """Build the named kernels (default: all) in parallel, one nvcc each.
    Raises RuntimeError naming every source that failed, with its log."""
    names = list(SOURCES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    started = {}
    results: dict[str, BuildResult] = {}
    nvcc = None
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            results[name] = BuildResult(name, out, 0.0, "")
            continue
        nvcc = nvcc or find_nvcc()
        tmp = f"{out}.tmp.{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, SOURCES[name])]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        started[name] = (proc, tmp, out, time.monotonic())
    failures = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds = time.monotonic() - t0
        if proc.returncode != 0:
            failures.append(f"{SOURCES[name]} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        results[name] = BuildResult(name, out, seconds, log)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return results


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name].path)
            _libs[name] = lib
        return lib
