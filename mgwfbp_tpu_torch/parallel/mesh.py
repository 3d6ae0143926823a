"""Process-group bootstrap (counterpart of ``mgwfbp_tpu/parallel/mesh.py``).

One process per card. ``init_distributed`` starts the torch.distributed
world from an explicit ``init_method`` or from the launcher environment
(``resolve_launch_env``, a copy of the JAX package's resolution chain:
``MGWFBP_COORDINATOR``/``MGWFBP_NUM_PROCESSES``/``MGWFBP_PROCESS_ID``, then
SLURM, then OpenMPI), with NCCL on the card and gloo on the CPU. A rank
asked for "cuda" without an index is bound to its own card on the host
(``local_device_index``).
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from mgwfbp_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


def _env_int(env, name: str) -> Optional[int]:
    """Integer env var; empty counts as unset, garbage fails naming it."""
    v = (env.get(name) or "").strip()
    if not v:
        return None
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{name}={v!r} is not an integer") from None


def resolve_launch_env(
    env=None,
) -> tuple[Optional[str], Optional[int], Optional[int]]:
    """(coordinator, num_processes, process_id) from MGWFBP_COORDINATOR /
    MGWFBP_NUM_PROCESSES / MGWFBP_PROCESS_ID, then the standard launcher
    envs (SLURM, OpenMPI) when those signal a multi-task allocation."""
    env = os.environ if env is None else env
    coordinator = (env.get("MGWFBP_COORDINATOR") or "").strip() or None
    num = _env_int(env, "MGWFBP_NUM_PROCESSES")
    pid = _env_int(env, "MGWFBP_PROCESS_ID")
    if num is None and pid is None:
        for size_var, rank_var in (
            ("SLURM_NTASKS", "SLURM_PROCID"),
            ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK"),
        ):
            n = _env_int(env, size_var)
            if n is not None and n > 1:
                num, pid = n, _env_int(env, rank_var)
                break
    return coordinator, num, pid


def local_device_index(process_id: int, env=None) -> int:
    """This process's card on its host: the launcher's local rank
    (LOCAL_RANK, SLURM_LOCALID, OMPI_COMM_WORLD_LOCAL_RANK), else
    ``process_id`` modulo the host's card count (one process per card,
    ranks packed host by host)."""
    env = os.environ if env is None else env
    for var in ("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK"):
        v = _env_int(env, var)
        if v is not None:
            return v
    return process_id % max(torch.cuda.device_count(), 1)


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed(
    device: Optional[Union[str, torch.device]] = None,
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    init_method: Optional[str] = None,
) -> torch.device:
    """Start the process group unless one is running; returns the device
    this process trains on. Arguments left None come from
    ``resolve_launch_env``; a coordinator ``host:port`` becomes
    ``tcp://host:port``. A single process with no launch signal starts
    nothing (it needs no collective). In a multi-process world "cuda"
    without an index means this rank's card (``local_device_index``),
    which becomes the current CUDA device."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dist.is_available() and dist.is_initialized():
        return resolve_device(dev)
    env_coord, env_num, env_pid = resolve_launch_env()
    coordinator = coordinator or env_coord
    num_processes = num_processes if num_processes is not None else env_num
    process_id = process_id if process_id is not None else env_pid
    if init_method is None and coordinator is None and (num_processes or 1) <= 1:
        return resolve_device(dev)
    missing = [
        what for what, v in (
            ("num_processes", num_processes), ("process_id", process_id),
            ("coordinator or init_method", coordinator or init_method),
        ) if v is None
    ]
    if missing:
        raise ValueError(
            f"init_distributed: multi-process launch incomplete, missing "
            f"{', '.join(missing)} (flags or MGWFBP_COORDINATOR / "
            "MGWFBP_NUM_PROCESSES / MGWFBP_PROCESS_ID)"
        )
    if init_method is None:
        init_method = (
            coordinator if "://" in coordinator else f"tcp://{coordinator}"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_device_index(int(process_id)))
    dev = resolve_device(dev)
    if dev.type == "cuda":
        if dev.index >= torch.cuda.device_count():
            raise ValueError(
                f"init_distributed: process {process_id} maps to {dev}, but "
                f"this host has {torch.cuda.device_count()} card(s)"
            )
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend_for(dev), init_method=init_method,
        world_size=int(num_processes), rank=int(process_id),
        **({"device_id": dev} if dev.type == "cuda" else {}),
    )
    return dev


def start_group(device_arg, rdv_dir: str) -> tuple[torch.device, bool]:
    """(device, started): the running world, else the launch environment's,
    else a one-rank group of this process alone (rendezvous in
    ``rdv_dir``), so that collectives run even at one worker; ``started``
    says this call started it."""
    running = dist.is_initialized()
    device = init_distributed(device_arg)
    if not dist.is_initialized():
        device = init_distributed(
            device, num_processes=1, process_id=0,
            init_method=f"file://{os.path.join(rdv_dir, 'rendezvous')}",
        )
    return device, not running


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0
