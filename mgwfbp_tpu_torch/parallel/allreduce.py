"""Merged-gradient all-reduce launched from gradient hooks (counterpart of
the ``all_reduce`` lowering of ``mgwfbp_tpu/parallel/allreduce.py``).

The MG-WFBP design of the original reference: every parameter carries a
post-accumulate-grad hook; when the last member of a merge group has its
gradient, the hook packs the group's flat bucket on the current stream and
launches ``dist.all_reduce(bucket, SUM, async_op=True)`` while the backward
pass goes on computing earlier layers' gradients. ``synchronize`` waits on
every group, divides by the world size (``lax.pmean`` semantics) and
unpacks the buckets into ``.grad`` before the optimizer step.

Three rules hold the collectives to the schedule:

  * groups launch strictly in group-index order: group k goes once it is
    complete AND groups 0..k-1 have launched, so every rank issues the
    same sequence of collectives (NCCL needs it; it is also the JAX
    lowering's "sequential" token chain);
  * a micro-step that is not the last of an accumulation launches nothing
    (``begin(active=False)``);
  * ``policy="none"`` builds no reducer (the train step reduces leaf by
    leaf, without hooks).

The permutation from leaves to arrival order is the JAX package's
(``arrival_order``: natural-sorted Flax paths, reversed), so both packages
solve identical schedules. The order in which hooks actually fire is
recorded in ``arrivals``.

While ``torch.profiler`` records, each group's pack and collective run
inside a ``record_function`` range named ``group_scope_name(gi)`` (the JAX
package's ``mgwfbp_groupNNNN`` scope), which ``profiling.trace_group_times``
attributes device time by; an untraced step launches exactly the same
work with no annotation.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from mgwfbp_tpu_torch.parallel import buckets as buckets_lib
from mgwfbp_tpu_torch.parallel.buckets import BucketLayout, build_layout
from mgwfbp_tpu_torch.parallel.solver import (
    LayerSpec,
    MergeSchedule,
    build_schedule,
    check_unique,
    predict_group_times,
    simulate_groups,
    size_prior_tb,
)

_DIGITS = re.compile(r"(\d+)")

GROUP_SCOPE_PREFIX = "mgwfbp_group"


def group_scope_name(gi: int) -> str:
    """Profiler-range label of merge group ``gi`` (the JAX package's
    name-scope label)."""
    return f"{GROUP_SCOPE_PREFIX}{gi:04d}"


def _natural_key(name: str) -> tuple:
    """Digit-aware sort key: 'Block_10' sorts after 'Block_2'."""
    return tuple(int(t) if t.isdigit() else t for t in _DIGITS.split(name))


def forward_order(names: Sequence[str]) -> list[int]:
    """Indices of ``names`` in natural (digit-aware) path order."""
    return sorted(range(len(names)), key=lambda i: _natural_key(names[i]))


def arrival_order(
    num_leaves: int, names: Optional[Sequence[str]] = None
) -> list[int]:
    """Gradient-arrival permutation over leaves: the reverse of the natural
    order of ``names``, else reversed leaf order."""
    if names is not None:
        return list(reversed(forward_order(names)))
    return list(reversed(range(num_leaves)))


class MergedAllreduce:
    """Schedule, bucket layout and hooks of one model's merged all-reduce.

    ``params`` are the model's parameters in leaf (tree) order and ``perm``
    maps arrival position k to leaf index ``perm[k]``; layout groups hold
    arrival positions. ``launches`` counts collectives launched (the chip
    smoke's launch counter); ``launch_log`` and ``arrivals`` record the
    group indices launched and the arrival positions whose hooks fired,
    in order, since the last ``begin``. Collectives run over ``group``
    (the default process group when None)."""

    def __init__(
        self,
        schedule: MergeSchedule,
        layout: BucketLayout,
        perm: Sequence[int],
        params: Sequence[torch.Tensor],
        *,
        mean: bool = True,
        comm_dtype: Optional[torch.dtype] = None,
        group: Optional[dist.ProcessGroup] = None,
    ):
        self.schedule = schedule
        self.layout = layout
        self.perm = tuple(perm)
        self.params = list(params)
        self.mean = mean
        self.comm_dtype = comm_dtype
        self.group = group
        self.world = dist.get_world_size(group)
        self._arr = [self.params[j] for j in self.perm]
        self._shapes = [tuple(p.shape) for p in self._arr]
        self._group_of = [0] * len(self._arr)
        for gi, members in enumerate(layout.groups):
            for k in members:
                self._group_of[k] = gi
        self.launches = 0
        self.launch_log: list[int] = []
        self.arrivals: list[int] = []
        self._active = False
        self._scale = 1.0
        self._pending: list[int] = []
        self._next = 0
        self._inflight: list[tuple[torch.Tensor, Any]] = []
        self._handles: list[Any] = []

    @property
    def num_groups(self) -> int:
        return self.layout.num_groups

    @property
    def arrival_params(self) -> list[torch.Tensor]:
        """The parameters in arrival order (position k is ``perm[k]``)."""
        return list(self._arr)

    @property
    def group_of(self) -> list[int]:
        """The merge group of each arrival position."""
        return list(self._group_of)

    def attach(self) -> "MergedAllreduce":
        """Register one post-accumulate-grad hook per parameter."""
        if not self._handles:
            for k, p in enumerate(self._arr):
                self._handles.append(p.register_post_accumulate_grad_hook(
                    lambda _p, k=k: self._on_grad(k)
                ))
        return self

    def detach(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []

    def begin(self, active: bool = True, scale: float = 1.0) -> None:
        """Arm (or, for a micro-step that is not the last, disarm) the hooks
        for the next backward; ``scale`` multiplies every gradient before
        the reduction (1 / micro-steps when accumulating)."""
        if self._inflight:
            raise RuntimeError(
                "begin() with collectives in flight: synchronize() first"
            )
        self._active = active
        self._scale = float(scale)
        self._pending = [len(g) for g in self.layout.groups]
        self._next = 0
        self.launch_log = []
        self.arrivals = []

    def _on_grad(self, k: int) -> None:
        if not self._active:
            return
        self.arrivals.append(k)
        self._pending[self._group_of[k]] -= 1
        while self._next < self.num_groups and self._pending[self._next] == 0:
            self._launch(self._next)
            self._next += 1

    def _launch(self, gi: int) -> None:
        if torch.autograd._profiler_enabled():
            with torch.profiler.record_function(group_scope_name(gi)):
                self._pack_and_reduce(gi)
        else:
            self._pack_and_reduce(gi)

    def _pack_and_reduce(self, gi: int) -> None:
        buf = buckets_lib.pack_group(
            [p.grad for p in self._arr], self.layout, gi
        )
        if self._scale != 1.0:
            buf.mul_(self._scale)
        if self.comm_dtype is not None and buf.dtype != self.comm_dtype:
            buf = buf.to(self.comm_dtype)
        work = dist.all_reduce(
            buf, op=dist.ReduceOp.SUM, group=self.group, async_op=True
        )
        self._inflight.append((buf, work))
        self.launches += 1
        self.launch_log.append(gi)

    def synchronize(self) -> list[torch.Tensor]:
        """Wait for every group's collective, take the mean and write the
        reduced gradients into ``.grad``. Returns the reduced buckets in
        the parameters' dtype."""
        if not self._active:
            raise RuntimeError("synchronize() without an active begin()")
        if self._next != self.num_groups:
            missing = [gi for gi in range(self.num_groups)
                       if self._pending[gi] != 0]
            raise RuntimeError(
                f"merge groups {missing[:8]} never completed: some "
                "parameters received no gradient in this backward"
            )
        out = []
        try:
            for gi, (buf, work) in enumerate(self._inflight):
                work.wait()
                if self.mean:
                    buf.div_(self.world)
                if buf.dtype != self.layout.dtypes[gi]:
                    buf = buf.to(self.layout.dtypes[gi])
                for k, view in buckets_lib.unpack_group(
                    buf, self.layout, gi, self._shapes
                ).items():
                    self._arr[k].grad = view
                out.append(buf)
        finally:
            self._inflight = []
            self._active = False
        return out


def make_merged_allreduce(
    module: nn.Module,
    *,
    policy: str = "mgwfbp",
    tb: Optional[Sequence[float]] = None,
    cost_model: Any = None,
    threshold: int = 0,
    mean: bool = True,
    comm_dtype: Optional[torch.dtype] = None,
) -> MergedAllreduce:
    """Solve the merge schedule for ``module``'s parameters and return the
    reducer with its hooks attached.

    ``tb`` is the per-arrival backward seconds (``profiling.
    benchmark_backward``); absent, 'mgwfbp'/'auto' fall back to the
    volume prior (``size_prior_tb``). Collectives run on the default
    process group."""
    from mgwfbp_tpu_torch.convert import flax_leaves, keystr

    leaves = flax_leaves(module)
    names = [keystr(path) for path, _ in leaves]
    params = [t for _, t in leaves]
    p = arrival_order(len(params), names=names)
    arr = [params[j] for j in p]
    names_arr = [names[j] for j in p]
    check_unique(names_arr)
    specs = [
        LayerSpec(name=nm, size=t.numel(), itemsize=t.element_size())
        for nm, t in zip(names_arr, arr)
    ]
    if policy in ("mgwfbp", "auto") and tb is None:
        tb = size_prior_tb(specs, cost_model)
    schedule = build_schedule(
        specs, tb, policy=policy, cost_model=cost_model, threshold=threshold,
    )
    layout = build_layout(arr, schedule.groups)
    if layout.groups != schedule.groups:
        # a dtype split adds real collectives: predict what is issued
        schedule = dataclasses.replace(schedule, groups=layout.groups)
        if tb is not None and cost_model is not None:
            sizes_b = [s.nbytes for s in specs]
            total, nonoverlap, comm = simulate_groups(
                layout.groups, sizes_b, tb, cost_model.predict,
                float(getattr(cost_model, "gamma", 0.0)),
                float(getattr(cost_model, "overlap", 1.0)),
                float(getattr(cost_model, "pack_beta", 0.0)),
            )
            schedule = dataclasses.replace(
                schedule,
                predicted_total_time=total,
                predicted_nonoverlap_time=nonoverlap,
                predicted_comm_time=comm,
                predicted_group_times=predict_group_times(
                    layout.groups, sizes_b, cost_model.predict
                ),
            )
    return MergedAllreduce(
        schedule, layout, p, params, mean=mean, comm_dtype=comm_dtype,
    ).attach()
