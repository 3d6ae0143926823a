"""Process-group bootstrap (counterpart of ``mgwfbp_tpu/parallel/mesh.py``).

One process per card. ``init_distributed`` starts the torch.distributed
world from an explicit ``init_method`` or from the launcher environment
(``resolve_launch_env``, a copy of the JAX package's resolution chain:
``MGWFBP_COORDINATOR``/``MGWFBP_NUM_PROCESSES``/``MGWFBP_PROCESS_ID``, then
SLURM, then OpenMPI), with NCCL on the card and gloo on the CPU. A rank
asked for "cuda" without an index is bound to its own card on the host
(``local_device_index``); a host with fewer cards than ranks is refused
(NCCL takes one rank per card: a group of several processes on a one-card
machine runs ``--device cpu``, over gloo). Every collective is bounded by
``MGWFBP_COORD_TIMEOUT_S`` (600 s by default); on the card NCCL's watchdog
ends a process whose collective timed out. After the timeout torch's
watchdog broadcasts a debug dump and then sleeps four times
``TORCH_NCCL_WAIT_TIMEOUT_DUMP_MILSEC`` (15 s by default: 60 s) before it
takes the process down, so a survivor of a dead peer left three timeouts of
30 s after the kill; the flight recorder's dump takes about a second, and
``init_distributed`` sets that variable to ``NCCL_DUMP_WAIT_MS`` unless the
environment sets it.

``two_level_groups`` splits the world into the two levels of the ``hier``
lowering, laid out as the JAX package's ``make_mesh`` lays a multi-slice
mesh (the slice axis leading): slice s is ranks [s * ici, (s + 1) * ici),
each rank's inner group is its slice and its outer group the ranks of every
slice at its own inner index. Every rank creates every subgroup, in one
order (``dist.new_group`` is collective over the world; on the card the
world is bound to its device, so NCCL may split the communicators), and
``runtime.coordination.release`` destroys them before the interpreter
finalizes.

``seq_groups`` splits the world into the rings of sequence parallelism,
laid out as the JAX package's ``make_mesh`` lays a (data, seq) mesh
(``np.asarray(devs).reshape(data, seq)``): rank r has data index ``r // S``
and seq index ``r % S``, and its ring is ranks [d * S, (d + 1) * S). Every
rank creates every ring, in one order, and ``release`` destroys them.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from mgwfbp_tpu_torch.runtime import coordination
from mgwfbp_tpu_torch.runtime.coordination import (
    COORD_TIMEOUT_ENV,
    DEFAULT_BARRIER_TIMEOUT_S,
)
from mgwfbp_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from mgwfbp_tpu_torch.utils.platform import env_float

# torch's NCCL watchdog waits after a collective's timeout for its debug
# dump before it takes the process down (module docstring); the port's
# default for that wait, in milliseconds
NCCL_DUMP_WAIT_ENV = "TORCH_NCCL_WAIT_TIMEOUT_DUMP_MILSEC"
NCCL_DUMP_WAIT_MS = 1000


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
    backend: Optional[str] = None,
) -> torch.device:
    """Start the process group unless one is running; returns the device
    this process trains on. Arguments left None come from
    ``resolve_launch_env``; a coordinator ``host:port`` becomes
    ``tcp://host:port``. A single process with no launch signal starts
    nothing (it needs no collective). In a multi-process world "cuda"
    without an index means this rank's card (``local_device_index``),
    which becomes the current CUDA device. ``backend`` overrides the
    device's (``backend_for``): gloo on the card lets several ranks share
    one card, which NCCL refuses."""
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
    backend = backend or backend_for(dev)
    if backend == "nccl":
        os.environ.setdefault(NCCL_DUMP_WAIT_ENV, str(NCCL_DUMP_WAIT_MS))
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=int(num_processes), rank=int(process_id),
        # the bound on every collective of the world, the side group's
        # too. A survivor blocked in an NCCL all-reduce whose peer died
        # never reaches the step boundary where a SIGTERM would drain it;
        # with this bound, NCCL's watchdog thread (torch's asynchronous
        # error handling, on by default) ends it and the supervisor
        # classifies the exit, instead of it hanging until it is SIGKILLed
        # after --drain-grace
        timeout=datetime.timedelta(seconds=env_float(
            COORD_TIMEOUT_ENV, DEFAULT_BARRIER_TIMEOUT_S)),
        **({"device_id": dev} if backend == "nccl" else {}),
    )
    return dev


def start_group(device_arg, rdv_dir: str,
                backend: Optional[str] = None) -> tuple[torch.device, bool]:
    """(device, started): the running world, else the launch environment's,
    else a one-rank group of this process alone (rendezvous in
    ``rdv_dir``), so that collectives run even at one worker; ``started``
    says this call started it. ``backend``: as in ``init_distributed``."""
    running = dist.is_initialized()
    device = init_distributed(device_arg, backend=backend)
    if not dist.is_initialized():
        device = init_distributed(
            device, num_processes=1, process_id=0,
            init_method=f"file://{os.path.join(rdv_dir, 'rendezvous')}",
            backend=backend,
        )
    return device, not running


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


@dataclasses.dataclass(frozen=True, eq=False)
class TwoLevelGroups:
    """This rank's two process groups of an (ici x dcn) world: ``inner``
    holds its slice (``ici`` ranks), ``outer`` the ``dcn`` ranks that share
    its inner index, one in each slice."""

    inner: dist.ProcessGroup
    outer: dist.ProcessGroup
    ici: int
    dcn: int


def two_level_groups(dcn: int) -> TwoLevelGroups:
    """Split the running world into ``dcn`` slices of ``world / dcn``
    consecutive ranks (a collective: every rank calls it at the same
    point). The subgroups take the world's backend and collective timeout
    and are registered with ``coordination.register_subgroups``."""
    world, me = dist.get_world_size(), dist.get_rank()
    dcn = int(dcn)
    if dcn < 1 or world % dcn:
        raise ValueError(
            f"--dcn-slices {dcn} does not divide the world of {world} "
            "rank(s)")
    ici = world // dcn
    timeout = datetime.timedelta(seconds=env_float(
        COORD_TIMEOUT_ENV, DEFAULT_BARRIER_TIMEOUT_S))
    inner = outer = None
    mine = []
    for s in range(dcn):
        ranks = list(range(s * ici, (s + 1) * ici))
        g = dist.new_group(ranks, timeout=timeout)
        if me in ranks:
            inner = g
            mine.append(g)
    for i in range(ici):
        ranks = [s * ici + i for s in range(dcn)]
        g = dist.new_group(ranks, timeout=timeout)
        if me in ranks:
            outer = g
            mine.append(g)
    coordination.register_subgroups(mine)
    return TwoLevelGroups(inner=inner, outer=outer, ici=ici, dcn=dcn)


def check_seq(seq: int, world: int, dcn: int = 1) -> None:
    """Refuse (the JAX ``make_mesh`` message) a world that ``seq * dcn``
    does not divide."""
    seq, dcn = max(int(seq), 1), max(int(dcn), 1)
    if world % (seq * dcn):
        raise ValueError(
            f"{world} devices not divisible by seq={seq} x dcn={dcn}")


def seq_groups(seq: int, dcn: int = 1) -> dist.ProcessGroup:
    """Split the running world into rings of ``seq`` consecutive ranks and
    return this rank's (a collective: every rank calls it at the same
    point). The rings take the world's backend and collective timeout and
    are registered with ``coordination.register_subgroups``."""
    world, me = dist.get_world_size(), dist.get_rank()
    seq = int(seq)
    if seq < 1:
        raise ValueError(f"--seq-parallel must be >= 1, got {seq}")
    check_seq(seq, world, dcn)
    timeout = datetime.timedelta(seconds=env_float(
        COORD_TIMEOUT_ENV, DEFAULT_BARRIER_TIMEOUT_S))
    ring = None
    for d in range(world // seq):
        ranks = list(range(d * seq, (d + 1) * seq))
        g = dist.new_group(ranks, timeout=timeout)
        if me in ranks:
            ring = g
    coordination.register_subgroups([ring])
    return ring
