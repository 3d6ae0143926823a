"""Cross-process agreement for the training loop (counterpart of
``mgwfbp_tpu/runtime/coordination.py``).

Synchronous data-parallel SGD needs every host decision that changes what
runs next (drain on a preemption signal, roll back after bad steps, commit
a checkpoint) to be identical on every process, or the processes issue
mismatched collectives and the group deadlocks:

  agree_any / agree_all   boolean consensus over one flag per process
  broadcast_flag          process ``source``'s value, everywhere
  agree_uniform           True iff every process passed the same value
  gather_values           every process's scalar, in process order
  gather_vectors          every process's vector, in process order
  all_argmin              the agreed argmin of per-candidate timings
  barrier                 named rendezvous with a real timeout

Each is decorated ``@group_op`` (the registry ``GROUP_OPS``), which is how
the SPMD lockstep checker (``analysis.spmd_check``) finds them.

Transport: a gloo side group over every rank of the running
``torch.distributed`` world, made on first use (``dist.new_group``, which
every rank reaches at the same program point because every call here is a
lockstep collective). Flags travel as float64 CPU tensors. Not over the
trainer's NCCL group on purpose: an NCCL call would enqueue on the card's
stream among the merge groups' all-reduces and make each agreement wait
for the step's device work; over gloo a flag never touches the card, and
the trainer only agrees at a step boundary, after the reducer's wait, so
no NCCL collective is in flight when it does. On the CPU the world is gloo
already; the side group keeps its own timeout.

Every primitive is a collective when ``process_count() > 1``: all
processes call the same primitives in the same order. At one process they
return on the host and issue nothing. Every multi-process call is bounded:
the side group's timeout is ``MGWFBP_COORD_TIMEOUT_S`` and the barrier's
``MGWFBP_BARRIER_TIMEOUT_S`` (600 s each by default); a miss or a transport
error raises ``CoordinationTimeout``.
"""

from __future__ import annotations

import atexit
import datetime
from typing import Optional, Sequence

import numpy as np

import torch
import torch.distributed as dist

from mgwfbp_tpu_torch.utils.platform import env_float
from mgwfbp_tpu_torch.utils.watchdog import exit_mark

BARRIER_TIMEOUT_ENV = "MGWFBP_BARRIER_TIMEOUT_S"
COORD_TIMEOUT_ENV = "MGWFBP_COORD_TIMEOUT_S"
DEFAULT_BARRIER_TIMEOUT_S = 600.0


class CoordinationTimeout(RuntimeError):
    """A lockstep group operation did not complete within its deadline, or
    its transport failed: a peer process is dead or wedged, so the
    collective can never complete. The caller must exit promptly."""

    def __init__(self, op: str, timeout_s: float, detail: str = ""):
        super().__init__(
            f"coordination op {op!r} did not complete within "
            f"{timeout_s:.0f}s{f' ({detail})' if detail else ''}; a peer "
            "process is dead or wedged"
        )
        self.op = op
        self.timeout_s = timeout_s


def _env_seconds(name: str) -> float:
    return env_float(name, DEFAULT_BARRIER_TIMEOUT_S)


# ---------------------------------------------------------------------------
# group-operation registry
# ---------------------------------------------------------------------------

# name -> {"blocking": bool, "uniform_result": bool}. Populated by the
# @group_op decorator below; the SPMD lockstep checker
# (analysis/spmd_check.py) discovers its op list from these decorations:
# the checker and the transport cannot drift, because a new primitive is
# a new decoration, and the decoration IS the registration.
GROUP_OPS: dict[str, dict] = {}


def group_op(fn=None, *, blocking: bool = True, uniform_result: bool = True):
    """Mark a function as a LOCKSTEP GROUP OPERATION: when
    ``process_count() > 1`` every process must call it, in the same
    order, with same-shaped payloads, or the group deadlocks.

    ``blocking``: the call cannot return until every process arrives (true
    for every primitive here: each is a gloo collective or a monitored
    barrier). ``uniform_result``: the return value is identical on every
    process, so host decisions branching on it keep the group in lockstep
    (the checker treats such results as group-uniform sanitizers). The
    decorator registers the function and returns it unchanged.
    """
    def register(f):
        GROUP_OPS[f.__name__] = {
            "blocking": bool(blocking),
            "uniform_result": bool(uniform_result),
        }
        return f

    if fn is not None:
        return register(fn)
    return register


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns exactly-once side effects (the
    checkpoint manifest and its sidecar index)."""
    return process_index() == 0


# (default process group, its gloo side group), remade when the default
# group is replaced (a new world). Dropped at exit by ``release``: groups
# still referenced here would only be destroyed during the interpreter's
# finalisation, where gloo's teardown can abort a process that finished
# its work (SIGABRT, "terminate called without an active exception"; one
# child in ten of a loaded two-rank run)
_side: Optional[tuple] = None
# the subgroups of a two-level world (``parallel.mesh.two_level_groups``):
# destroyed, and dropped, by ``release`` for the same reason
_subgroups: list = []


def register_subgroups(groups: Sequence) -> None:
    """Hand subgroups of the world to ``release``, which destroys them."""
    _subgroups.extend(groups)


def release() -> None:
    """Destroy the registered subgroups that are still live and drop this
    module's references to every process group, so that they are
    destroyed now or with ``destroy_process_group``, not during
    interpreter shutdown. Registered with ``atexit``."""
    global _side
    _side = None
    live = dist.distributed_c10d._world.pg_map if dist.is_available() else {}
    exit_mark(f"coordination.release: {len(_subgroups)} subgroup(s)")
    while _subgroups:
        g = _subgroups.pop()
        if dist.is_initialized() and g in live:
            dist.destroy_process_group(g)
    exit_mark("coordination.release done")


atexit.register(release)


def _group():
    global _side
    world = dist.distributed_c10d._get_default_group()
    if _side is None or _side[0] is not world:
        timeout = datetime.timedelta(seconds=_env_seconds(COORD_TIMEOUT_ENV))
        _side = (world, dist.new_group(backend="gloo", timeout=timeout))
    return _side[1]


def _all_reduce(values: list[float], op, name: str) -> list[float]:
    t = torch.tensor(values, dtype=torch.float64)
    try:
        dist.all_reduce(t, op=op, group=_group())
    except Exception as e:  # noqa: BLE001 — a timeout and a lost peer are
        # one failure: the group cannot complete this collective
        raise CoordinationTimeout(
            name, _env_seconds(COORD_TIMEOUT_ENV), detail=str(e)
        ) from e
    return t.tolist()


@group_op
def agree_any(flag: bool) -> bool:
    """True everywhere iff ANY process passed True (one signalled process
    drains the whole group)."""
    if process_count() == 1:
        return bool(flag)
    return _all_reduce([float(bool(flag))], dist.ReduceOp.MAX,
                       "agree_any")[0] > 0.0


@group_op
def agree_all(flag: bool) -> bool:
    """True everywhere iff EVERY process passed True (roll back only when
    every process can restore; promote a checkpoint only when every
    process sees it committed)."""
    if process_count() == 1:
        return bool(flag)
    return _all_reduce([float(bool(flag))], dist.ReduceOp.MIN,
                       "agree_all")[0] > 0.0


@group_op
def broadcast_flag(value: float, source: int = 0) -> float:
    """Process ``source``'s scalar, identical everywhere (the rollback's
    restore step, the derived agree interval)."""
    if process_count() == 1:
        return float(value)
    contrib = float(value) if process_index() == source else 0.0
    return _all_reduce([contrib], dist.ReduceOp.SUM, "broadcast_flag")[0]


@group_op
def agree_uniform(value: float) -> bool:
    """True iff every process passed the same scalar (the step key a
    checkpoint commit is about to write)."""
    if process_count() == 1:
        return True
    v = float(value)
    hi, neg_lo = _all_reduce([v, -v], dist.ReduceOp.MAX, "agree_uniform")
    return hi == -neg_lo


@group_op
def gather_values(value: float) -> list[float]:
    """Every process's scalar, in process order, identical everywhere
    (one-hot rows summed over the same transport)."""
    if process_count() == 1:
        return [float(value)]
    row = [0.0] * process_count()
    row[process_index()] = float(value)
    return _all_reduce(row, dist.ReduceOp.SUM, "gather_values")


@group_op
def gather_vectors(values: Sequence[float]) -> list[list[float]]:
    """Every process's float vector, in process order, identical
    everywhere. Every process must pass the same length (the lockstep
    contract every primitive here carries)."""
    row = [float(v) for v in values]
    n = process_count()
    if n == 1:
        return [row]
    k = len(row)
    if k == 0:
        return [[] for _ in range(n)]
    flat = [0.0] * (n * k)
    start = process_index() * k
    flat[start:start + k] = row
    reduced = _all_reduce(flat, dist.ReduceOp.SUM, "gather_vectors")
    return [reduced[i * k:(i + 1) * k] for i in range(n)]


@group_op
def all_argmin(values: Sequence[Optional[float]]) -> tuple[int, list[float]]:
    """Agreed argmin over per-candidate timings. ``values[i]`` is this
    process's time for candidate i (None or non-finite: not measured
    here). Each candidate is reduced to its maximum across processes (a
    synchronous group runs at its straggler's pace; unmeasured anywhere
    prices as +inf), then every process takes the same argmin (the first
    of equal minima). Returns (winner, reduced times); reduced[winner] is
    +inf iff no candidate was measured on every process."""
    vals = [float("inf") if v is None or not np.isfinite(v) else float(v)
            for v in values]
    if not vals:
        raise ValueError("all_argmin: empty candidate list")
    if process_count() > 1:
        vals = _all_reduce(vals, dist.ReduceOp.MAX, "all_argmin")
    return int(np.argmin(vals)), vals


@group_op(uniform_result=False)
def barrier(name: str, timeout_s: Optional[float] = None) -> None:
    """Named rendezvous of every process, bounded by ``timeout_s`` (default
    ``MGWFBP_BARRIER_TIMEOUT_S``); ``monitored_barrier`` names the ranks
    that did not arrive."""
    if process_count() == 1:
        return
    if timeout_s is None:
        timeout_s = _env_seconds(BARRIER_TIMEOUT_ENV)
    try:
        dist.monitored_barrier(
            group=_group(), timeout=datetime.timedelta(seconds=timeout_s),
            wait_all_ranks=True,
        )
    except Exception as e:  # noqa: BLE001 — uniform failure surface
        raise CoordinationTimeout(f"barrier:{name}", timeout_s,
                                  detail=str(e)) from e
