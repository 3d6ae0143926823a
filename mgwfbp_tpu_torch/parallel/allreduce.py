"""Merged-gradient collectives launched from gradient hooks (counterpart of
``mgwfbp_tpu/parallel/allreduce.py``).

The MG-WFBP design of the original reference: every parameter carries a
post-accumulate-grad hook; when the last member of a merge group has its
gradient, the hook packs the group's flat bucket on the current stream and
launches the group's collective asynchronously while the backward pass
goes on computing earlier layers' gradients. What the hook launches is the
lowering (``comm_op``):

  * ``all_reduce``: ``dist.all_reduce(bucket, SUM)``; ``synchronize``
    waits, divides by the world size (``lax.pmean`` semantics) and unpacks
    the buckets into ``.grad`` before the optimizer step;
  * ``rs_ag`` (the DeAR decomposition): the bucket padded to a multiple of
    the world (``buckets.padded_group_size``), ``reduce_scatter_tensor``
    into this rank's shard, then ``all_gather_into_tensor`` of the shard
    back into the padded bucket; ``synchronize`` waits, divides, trims the
    pad and unpacks. Over NCCL one process group runs its collectives in
    issue order on one stream, so the gather follows the scatter at once;
    gloo runs asynchronous work on a thread pool where the gather could
    overtake the scatter it reads, so there the hook waits for the
    scatter first;
  * a sparsifying compressor (``parallel.compression``, top-k, with
    ``all_reduce``): the hook selects each bucket's top k and launches the
    all-gathers of the values and the int32 indices; ``synchronize`` waits
    and scatter-adds the P rows into a dense bucket, one source rank at a
    time in rank order;
  * ``rs_opt_ag`` (the sharded optimizer, ZeRO-1): the hooks launch only
    the reduce-scatters, and ``reduce_and_update()`` replaces
    ``synchronize()`` and ``optimizer.step()``: it waits, takes the mean,
    computes the global clip norm by one all-reduce of the shards' squared
    sums (``sharded_clip_norm``) when the optimizer clips, runs the
    optimizer (``ShardedOptimStep.update_shard``) on this rank's 1/world
    shard of each group's parameters against its shard of the optimizer
    state, all-gathers the updated parameters and unpacks them into the
    parameters' data. The optimizer state lives only as this rank's shard
    (``ShardedOptState``); the reduced gradients never materialize;
  * ``rs_fwd_ag`` (the cross-step pipeline, DeAR): the hooks launch the
    reduce-scatters, and ``reduce_and_defer()`` waits, clips and updates
    this rank's shard as ``reduce_and_update`` does, but keeps the updated
    shards (``param_shards``, the JAX package's ``ShardedParams``) and
    gathers nothing. The module's parameters are then one update stale.
    The next step's forward starts with ``gather_params()``, which
    launches every group's all-gather in the gather sequence (below), and
    a forward pre-hook on every module that owns parameters waits for its
    parameters' groups and copies them into the parameters' storage
    (``torch._foreach_copy_``; ``.data`` is never rebound, since cuDNN's
    LSTM keeps views of its flat weights). Any other reader of the
    parameters calls
    ``materialize()`` first; a forward that finds the parameters stale with
    no gather in flight raises;
  * ``hier`` (two-level, over ``parallel.mesh.two_level_groups``): each
    hook reduce-scatters its bucket, padded to a multiple of the slice
    size, over the inner group; once every member of a DCN group has been
    scattered, one all-reduce over the outer group sums the members'
    concatenated shards across slices (``dcn_groups``, the schedule's
    outer partition; never two wire dtypes in one); ``synchronize`` then
    divides each shard by the world, all-gathers it over the inner group,
    trims the pad and unpacks. On the card the cross-slice all-reduce
    runs from a side stream that waits for its members' reduce-scatters
    (the backward's stream never waits); over gloo the hook waits for
    them on the host, and each all-gather waits for its all-reduce.

Three rules hold the collectives to the schedule:

  * groups launch strictly along one launch sequence (``launch_sequence``):
    the next group of the sequence goes once it is complete AND every
    group before it in the sequence has launched, so every rank issues
    the same collectives in the same order (NCCL needs it; it is also the
    JAX lowering's "sequential" token chain and the solver's serial link);
  * a micro-step that is not the last of an accumulation launches nothing
    (``begin(active=False)``);
  * ``policy="none"`` builds no reducer (the train step reduces leaf by
    leaf, without hooks).

The permutation from leaves to arrival order is the JAX package's
(``arrival_order``: natural-sorted Flax paths, reversed), so both packages
solve identical schedules. The order in which hooks actually fire is
recorded in ``arrivals``, and it is not that permutation: ResNet-20's stem
is first in the permutation and its hooks fire last, so under group-index
order every group after the stem's would wait for the end of the backward.
The launch sequence is therefore measured. The first armed backward of a
newly attached reducer launches in group-index order; from its
``arrivals`` rank 0 takes the order in which the groups completed
(``completion_order``) and, on rs_fwd_ag, from the forward before it the
order in which the modules' pre-hooks first asked for each group (groups
no module asks for last). It publishes both once in the process group's
rendezvous store, and every rank adopts them before its next armed
backward (rs_fwd_ag: before its next ``gather_params``). From then on the
hooks launch along the measured sequence, and a rank whose hooks fire in
another order waits as before: correctness never depends on the ranks'
hook orders agreeing. Neither the schedule nor any value changes, only
when each collective is issued; XLA's scheduler issues the JAX package's
collectives as their inputs exist, which is what this restores. hier's
cross-slice all-reduces follow in the order the sequence completes their
DCN groups. Measuring adds no collective and no device synchronisation:
rank 0 writes one key, the others read it. ``attach`` after ``detach``
measures again.

While ``torch.profiler`` records, each group's pack, collectives, update
and unpack run inside a ``record_function`` range named
``group_scope_name(gi)`` (the JAX package's ``mgwfbp_groupNNNN`` scope),
which ``profiling.trace_group_times`` attributes device time by, each
cross-slice all-reduce inside ``dcn_group_scope_name(di)``
(``mgwfbp_dcngroupNNNN``, beside the group ranges, never inside them), and
the clip's all-reduce inside ``CLIP_NORM_SCOPE``; an untraced step launches
exactly the same work with no annotation. While a schedule observer
watches (``watch_scopes``, armed by ``analysis.schedule_check``), the same
ranges are kept per thread (``open_scopes``), so that every collective of
a step is attributed to the range it was issued in. The ranges are
``telemetry.spans``' (``collective_scope`` is its ``span``).

On a step the span recorder has armed (``telemetry.spans``; while
torch.profiler records, or inside ``spans.recording()``) the reducer marks
each group's ready(g), on the hook's stream right after the pack and
before the collective, and done(g). On a card done(g) is an event on an
observer stream the reducer owns, recorded after that stream has waited
(on the device) for each of the group's works, so it neither blocks the
host nor reorders the NCCL stream; hier's is its all-gather's. Over gloo
it is the host clock when the wait returns in ``synchronize`` (or the
sharded lowerings' ``_reduced_shards``): an upper bound. hier's
cross-slice all-reduces have no marks of their own, and rs_fwd_ag's
parameter all-gathers in the next forward none at all.

``make_merged_allreduce`` solves the schedule by ``policy`` or takes an
explicit grouping (``groups``, and hier's ``dcn_groups``): the autotuner's
raced candidates and cache hits. ``detach`` removes every hook, so a
reducer can be swapped for another on the same module.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import threading
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from mgwfbp_tpu_torch.optim import OptimSpec
from mgwfbp_tpu_torch.parallel import buckets as buckets_lib
from mgwfbp_tpu_torch.parallel.buckets import BucketLayout, build_layout
from mgwfbp_tpu_torch.parallel.solver import (
    LayerSpec,
    MergeSchedule,
    align_dcn_groups,
    build_schedule,
    check_comm_op,
    check_dcn_partition,
    check_unique,
    cross_step_phase_costs,
    effective_cost_fn,
    forward_prior_tf,
    is_two_level,
    predict_group_times,
    remap_dcn_groups,
    simulate_cross_step,
    simulate_groups,
    simulate_groups_two_level,
    singleton_dcn_groups,
    size_prior_tb,
    two_level_leg_costs,
)
from mgwfbp_tpu_torch.telemetry import spans
# the reducer's and the step's collective scopes are the port's one span
# primitive (``telemetry.spans``), under the name the verifier and every
# caller import
from mgwfbp_tpu_torch.telemetry.spans import (  # noqa: F401
    open_scopes,
    span as collective_scope,
    watch_scopes,
)

_DIGITS = re.compile(r"(\d+)")

# torch 2.13 renames the flat collectives; older releases have only the
# *_tensor names
reduce_scatter_single = getattr(dist, "reduce_scatter_single",
                                dist.reduce_scatter_tensor)
all_gather_single = getattr(dist, "all_gather_single",
                            dist.all_gather_into_tensor)

GROUP_SCOPE_PREFIX = "mgwfbp_group"
# the hier lowering's cross-slice all-reduces, one range per DCN group
DCN_GROUP_SCOPE_PREFIX = "mgwfbp_dcngroup"

# the lowerings whose optimizer runs on the reduce-scatter's shards
SHARDED_OPS = ("rs_opt_ag", "rs_fwd_ag")

# the one extra collective of the rs_opt_ag lowering: the global clip norm,
# an all-reduce of the shards' squared sums (the JAX package's scope name)
CLIP_NORM_SCOPE = "sharded_clip_norm"


def group_scope_name(gi: int) -> str:
    """Profiler-range label of merge group ``gi`` (the JAX package's
    name-scope label)."""
    return f"{GROUP_SCOPE_PREFIX}{gi:04d}"


def dcn_group_scope_name(di: int) -> str:
    """Profiler-range label of DCN group ``di`` (hier lowering)."""
    return f"{DCN_GROUP_SCOPE_PREFIX}{di:04d}"


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


def completion_order(groups: Sequence[Sequence[int]],
                     arrivals: Sequence[int]) -> list[int]:
    """The merge groups in the order their last member's hook fired in
    ``arrivals`` (arrival positions, as the reducer records them)."""
    pos = {int(k): i for i, k in enumerate(arrivals)}
    done = [max(pos[int(k)] for k in members) for members in groups]
    return sorted(range(len(groups)), key=done.__getitem__)


def held_groups(groups: Sequence[Sequence[int]], arrivals: Sequence[int],
                sequence: Optional[Sequence[int]] = None) -> int:
    """Groups that were complete before a group ahead of them in the
    launch ``sequence`` (group-index order when None) had launched, so
    that the one chain of launches held them back, on the hook order
    ``arrivals``."""
    pos = {int(k): i for i, k in enumerate(arrivals)}
    held, launched_at = 0, -1
    for gi in range(len(groups)) if sequence is None else sequence:
        complete_at = max(pos[int(k)] for k in groups[gi])
        launched_at = max(launched_at, complete_at)
        held += launched_at > complete_at
    return held


# the launch sequences rank 0 measured, in the default process group's
# store: one key per measurement, named by the reducer's process group and
# that group's count of measurements (every rank of the group measures its
# reducers in one order, so the counts agree)
_ORDER_KEY = "mgwfbp_launch_order"
_order_counts: dict[str, int] = {}
_order_lock = threading.Lock()


def _order_key(group) -> str:
    pg = (group if group is not None
          else dist.distributed_c10d._get_default_group())
    with _order_lock:
        n = _order_counts.get(pg.group_name, 0)
        _order_counts[pg.group_name] = n + 1
    return f"{_ORDER_KEY}/{pg.group_name}/{n}"


# ---------------------------------------------------------------------------
# The sharded optimizer (comm_op='rs_opt_ag')
# ---------------------------------------------------------------------------


def _count_tensor(count: int, device=None) -> torch.Tensor:
    return torch.full((), int(count), dtype=torch.int64, device=device)


@dataclasses.dataclass
class ShardedOptState:
    """This rank's optimizer state on the rs_opt_ag path: ``slots[s][gi]``
    is slot s (the momentum trace; Adam's two moments) of merge group gi,
    a flat tensor of ``shard_size(gi)`` elements, and ``count_t`` the
    optimizer updates completed, a 0-dim int64 tensor on the device (the
    learning-rate schedule and Adam's bias correction read it; a skipped
    step does not advance it, and the step never reads it on the host).
    The JAX package holds the same buffers as global (world, shard)
    arrays; here each rank holds its own row."""

    count_t: torch.Tensor
    slots: list[list[torch.Tensor]]

    @property
    def count(self) -> int:
        """The count on the host: a read of the device counter."""
        return int(self.count_t)

    @count.setter
    def count(self, value: int) -> None:
        self.count_t.fill_(int(value))


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedOptimStep:
    """(layout, the optimizer on flat buffers) of the rs_opt_ag lowering:
    the JAX package's ``ShardedOptimStep``. It interprets an
    ``optim.OptimSpec`` on the 1/world shards the reduce-scatter leaves.
    The per-leaf weight-decay mask becomes a per-element vector over the
    padded bucket (``buckets.group_mask_vector``) sliced to the shard, so
    shard boundaries may cut leaves anywhere."""

    spec: OptimSpec
    layout: BucketLayout
    shapes: tuple[tuple[int, ...], ...]  # leaf shapes, arrival order
    perm: tuple[int, ...]  # arrival position -> tree (leaf) index
    world: int

    @property
    def num_slots(self) -> int:
        return self.spec.num_slots

    def shard_size(self, gi: int) -> int:
        return buckets_lib.shard_size(self.layout, gi, self.world)

    def padded_size(self, gi: int) -> int:
        return buckets_lib.padded_group_size(self.layout, gi, self.world)

    def decay_mask_vec(self, gi: int) -> Optional[np.ndarray]:
        """Padded per-element decay mask of group gi (None: no decay)."""
        if not self.spec.weight_decay:
            return None
        flags = [(len(s) > 1) if self.spec.mask_ndim_gt1 else True
                 for s in self.shapes]
        return buckets_lib.group_mask_vector(
            self.layout, gi, flags, self.shapes, self.world)

    def _mask_shard(self, gi: int, rank: int, like: torch.Tensor
                    ) -> torch.Tensor:
        """This rank's slice of the decay mask, as ``like``'s dtype and
        device (made once per group, dtype and device)."""
        cache = self.__dict__.setdefault("_masks", {})
        key = (gi, rank, like.dtype, like.device)
        if key not in cache:
            n = self.shard_size(gi)
            vec = self.decay_mask_vec(gi)[rank * n:(rank + 1) * n]
            cache[key] = torch.from_numpy(vec).to(like.device, like.dtype)
        return cache[key]

    # -- state and its accounting -----------------------------------------
    def init(self, device=None) -> ShardedOptState:
        """Fresh (zero) state of one rank."""
        return ShardedOptState(count_t=_count_tensor(0, device), slots=[
            [torch.zeros(self.shard_size(gi), dtype=self.layout.dtypes[gi],
                         device=device)
             for gi in range(self.layout.num_groups)]
            for _ in range(self.num_slots)
        ])

    def state_bytes_per_device(self) -> int:
        """Optimizer-state bytes each rank holds on the sharded path (the
        count as 4 bytes, as the JAX package counts its int32)."""
        per_slot = sum(
            self.shard_size(gi) * self.layout.dtypes[gi].itemsize
            for gi in range(self.layout.num_groups))
        return self.num_slots * per_slot + 4

    def replicated_state_bytes(self) -> int:
        """Bytes of the parameter-shaped state every rank holds on the
        replicated path (the 1/world comparison's baseline)."""
        per_slot = sum(
            self.layout.group_sizes[gi] * self.layout.dtypes[gi].itemsize
            for gi in range(self.layout.num_groups))
        return self.num_slots * per_slot

    # -- interchange with the replicated (per-leaf) form -------------------
    def pack_slot(self, tree_leaves: Sequence[np.ndarray]
                  ) -> list[np.ndarray]:
        """Per-leaf arrays in TREE order -> one slot's (world, shard)
        numpy buffers, one per group."""
        arr = [np.asarray(tree_leaves[j]) for j in self.perm]
        return [
            buckets_lib.pack_group_host(arr, self.layout, gi, self.world)
            .reshape(self.world, self.shard_size(gi))
            for gi in range(self.layout.num_groups)
        ]

    def unpack_slot(self, slot_bufs: Sequence[np.ndarray]) -> list[np.ndarray]:
        """One slot's (world, shard) buffers -> per-leaf arrays in TREE
        order."""
        arr: list[Any] = [None] * len(self.shapes)
        for gi in range(self.layout.num_groups):
            flat = np.asarray(slot_bufs[gi]).reshape(-1)
            for i, a in buckets_lib.unpack_group_host(
                    flat, self.layout, gi, self.shapes).items():
                arr[i] = a
        out: list[Any] = [None] * len(arr)
        for k, j in enumerate(self.perm):
            out[j] = arr[k]
        return out

    def scatter(self, slot_leaves: Sequence[Sequence[np.ndarray]], count: int,
                rank: int, device=None) -> ShardedOptState:
        """Replicated state (per slot, per-leaf arrays in tree order) ->
        this rank's ``ShardedOptState``."""
        if len(slot_leaves) != self.num_slots:
            raise ValueError(
                f"the optimizer state carries {len(slot_leaves)} "
                f"parameter-shaped slot(s), the spec expects "
                f"{self.num_slots} (kind={self.spec.kind!r}, momentum="
                f"{self.spec.momentum})")
        slots = []
        for leaves in slot_leaves:
            slots.append([
                torch.from_numpy(np.ascontiguousarray(buf[rank])).to(
                    device, self.layout.dtypes[gi])
                for gi, buf in enumerate(self.pack_slot(leaves))
            ])
        return ShardedOptState(count_t=_count_tensor(count, device),
                               slots=slots)

    def gather(self, state: ShardedOptState, group=None) -> list[list[np.ndarray]]:
        """Every rank's shards all-gathered (a collective when the world
        is larger than one) -> per slot, the per-leaf arrays in tree order
        that the replicated optimizer would hold after the same updates."""
        out = []
        for slot in state.slots:
            bufs = []
            for gi, shard in enumerate(slot):
                full = torch.empty(self.padded_size(gi), dtype=shard.dtype,
                                   device=shard.device)
                if self.world > 1:
                    all_gather_single(full, shard.contiguous(),
                                                group=group)
                else:
                    full.copy_(shard)
                bufs.append(full.cpu().numpy())
            out.append(self.unpack_slot(bufs))
        return out

    def manifest_layout(self) -> dict:
        """The shard layout a checkpoint manifest records: for every
        parameter leaf (tree order), the group and offset its elements
        pack into, and each group's shard size and dtype."""
        arrival_slot: dict[int, tuple[int, int]] = {}
        for gi, (members, offsets) in enumerate(
                zip(self.layout.groups, self.layout.offsets)):
            for k, off in zip(members, offsets):
                arrival_slot[int(k)] = (gi, int(off))
        tree_slot: list[Optional[tuple[int, int]]] = [None] * len(self.perm)
        for k, j in enumerate(self.perm):
            tree_slot[int(j)] = arrival_slot[int(k)]
        return {
            "world": int(self.world),
            "shard_sizes": [int(self.shard_size(gi))
                            for gi in range(self.layout.num_groups)],
            "group_dtypes": [str(d).replace("torch.", "")
                             for d in self.layout.dtypes],
            "leaf_slots": [list(s) for s in tree_slot],
        }

    # -- the shard update -------------------------------------------------
    def update_shard(
        self,
        gi: int,
        grad: torch.Tensor,
        param: torch.Tensor,
        slots_in: Sequence[torch.Tensor],
        count: Union[int, torch.Tensor],
        clip_scale: Optional[tuple[torch.Tensor, torch.Tensor]],
        rank: int,
        lr: Union[float, torch.Tensor, None] = None,
    ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
        """One group's optimizer step on its shard, term for term the JAX
        package's (optax's trace / scale_by_adam / add_decayed_weights /
        scale_by_learning_rate): ``count`` is the number of COMPLETED
        updates, an int or a 0-dim device tensor (the learning rate reads
        it before the increment, Adam's bias correction after).
        ``clip_scale`` is (global norm, threshold) as scalar tensors,
        applied as optax's ``select(norm < max, g, g / norm * max)``.
        ``lr`` (a float or a 0-dim device tensor) overrides
        ``spec.learning_rate(count)``, which reads a tensor count on the
        host.

        The terms a + c * b are rounded as ``torch.optim.SGD`` rounds them
        (``torch.add(a, b, alpha=c)``, one rounding where the kernel fuses
        the product; by a tensor rate ``torch.addcmul``, which rounds
        alike, as ``optim.sgd_update_`` does), so that on the same
        gradients a sharded SGD step gives the replicated one's
        parameters bit for bit; optax rounds the product and the sum
        apart, a difference of one rounding."""
        spec = self.spec
        g = grad
        if clip_scale is not None:
            g_norm, max_norm = clip_scale
            g = torch.where(g_norm < max_norm, g,
                            (g / g_norm.to(g.dtype)) * max_norm.to(g.dtype))
        mask = None
        if spec.weight_decay:
            mask = self._mask_shard(gi, rank, g)
        if lr is None:
            lr = spec.learning_rate(int(count))
        if spec.kind == "sgd":
            if spec.weight_decay:
                g = torch.add(g, param * mask, alpha=spec.weight_decay)
            if spec.momentum:
                mu = g + spec.momentum * slots_in[0]
                u = (torch.add(g, mu, alpha=spec.momentum) if spec.nesterov
                     else mu)
                new_slots: tuple[torch.Tensor, ...] = (mu,)
            else:
                u, new_slots = g, ()
        else:  # adam / adamw
            mu = spec.b1 * slots_in[0] + (1.0 - spec.b1) * g
            nu = spec.b2 * slots_in[1] + (1.0 - spec.b2) * g * g
            # optax computes the corrections in the update's dtype
            c = (torch.full((), count + 1, dtype=g.dtype, device=g.device)
                 if not isinstance(count, torch.Tensor)
                 else (count + 1).to(g.dtype))
            mu_hat = mu / (1.0 - spec.b1 ** c)
            nu_hat = nu / (1.0 - spec.b2 ** c)
            u = mu_hat / (torch.sqrt(nu_hat) + spec.eps)
            if spec.weight_decay:  # decoupled: after the preconditioner
                u = torch.add(u, param * mask, alpha=spec.weight_decay)
            new_slots = (mu, nu)
        if isinstance(lr, torch.Tensor):
            return torch.addcmul(param, u, -lr.to(u.dtype)), new_slots
        return torch.add(param, u, alpha=-float(lr)), new_slots


# ---------------------------------------------------------------------------
# The reducer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Inflight:
    """One launched group: its collectives' works and the tensors they
    fill (``out``; the top-k path adds the indices and the bucket size).
    ``keep`` holds every other tensor the collectives read or write that
    the reducer holds nowhere else (the packed bucket of the sharded
    lowerings, rs_ag's summed shard, top-k's selected values and indices)
    until the step's own waits: a wait on another stream (the observer's,
    ``MergedAllreduce._observe``) ends NCCL's hold on them, and the
    allocator could then hand their memory to the step's stream while the
    collective still reads it."""

    gi: int
    works: list
    out: torch.Tensor
    idx: Optional[torch.Tensor] = None
    n: int = 0
    keep: tuple = ()


class MergedAllreduce:
    """Schedule, bucket layout and hooks of one model's merged collectives.

    ``params`` are the model's parameters in leaf (tree) order and ``perm``
    maps arrival position k to leaf index ``perm[k]``; layout groups hold
    arrival positions. ``launches`` counts collectives launched (the chip
    smoke's launch counter: two per group for rs_ag and top-k, one
    reduce-scatter and one all-gather per group plus the clip's all-reduce
    for rs_opt_ag and rs_fwd_ag, one reduce-scatter and one all-gather per
    group plus one all-reduce per DCN group for hier); ``launch_log`` and
    ``arrivals`` record the group indices launched and the arrival
    positions whose hooks fired, in order, since the last ``begin``;
    ``launch_sequence`` and, on rs_fwd_ag, ``gather_sequence`` are the
    orders the collectives are issued in (measured once per attach,
    module docstring).
    Collectives run over ``group`` (the default process group when None),
    hier's over ``levels`` (``parallel.mesh.TwoLevelGroups``) with the
    schedule's outer partition as ``dcn_groups`` (one DCN group per group
    when it has none). ``comm_op``, ``compressor`` and
    ``optim`` (rs_opt_ag, rs_fwd_ag) select the lowering (module
    docstring); ``opt_state`` is this rank's sharded optimizer state and,
    on rs_fwd_ag, ``param_shards`` this rank's shard of each group's
    parameters, both updated in their own storage every step (the
    counterpart of the JAX step's donated state); rs_fwd_ag's forward
    pre-hooks go on ``module``'s
    submodules. With ``track_compression_error`` set, the top-k hooks keep
    each group's relative compression error ||g - topk(g)|| / ||g|| of
    the LOCAL bucket at the wire dtype (``compression_errors``, one float32
    device scalar per group, 0 where k >= n)."""

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
        comm_op: str = "all_reduce",
        compressor: Any = None,
        optim: Optional[ShardedOptimStep] = None,
        levels: Any = None,
        module: Optional[nn.Module] = None,
    ):
        check_comm_op(comm_op)
        if compressor is not None and comm_op != "all_reduce":
            raise ValueError(
                f"comm_op={comm_op!r} cannot combine with a sparsifying "
                "compressor (the compressor replaces the bucket collective)")
        if (comm_op in SHARDED_OPS) != (optim is not None):
            raise ValueError(
                f"comm_op={comm_op!r}: rs_opt_ag and rs_fwd_ag go together "
                "with a ShardedOptimStep (make_merged_allreduce(..., "
                "optim_spec=, world_size=))")
        if (comm_op == "hier") != (levels is not None):
            raise ValueError(
                "comm_op='hier' and the two-level process groups go "
                "together (parallel.mesh.two_level_groups)")
        self.schedule = schedule
        self.layout = layout
        self.perm = tuple(perm)
        self.params = list(params)
        self.mean = mean
        self.comm_dtype = comm_dtype
        self.group = group
        self.comm_op = comm_op
        self.compressor = compressor
        self.optim = optim
        self.levels = levels
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        if optim is not None and optim.world != self.world:
            raise ValueError(
                f"{comm_op}: the process group has {self.world} ranks, the "
                f"ShardedOptimStep was built for {optim.world}; rebuild the "
                "reducer for this world")
        if levels is not None and levels.ici * levels.dcn != self.world:
            raise ValueError(
                f"hier: {levels.dcn} slices of {levels.ici} ranks do not "
                f"make the world of {self.world}")
        # over NCCL one group's collectives run in issue order on one
        # stream; gloo's asynchronous work may run out of order
        self._ordered = dist.get_backend(group) == "nccl"
        self._arr = [self.params[j] for j in self.perm]
        self._shapes = [tuple(p.shape) for p in self._arr]
        self._group_of = [0] * len(self._arr)
        for gi, members in enumerate(layout.groups):
            for k in members:
                self._group_of[k] = gi
        self.opt_state: Optional[ShardedOptState] = (
            optim.init(self._arr[0].device) if optim is not None else None)
        self.dcn_groups: list[list[int]] = []
        self._dcn_of: list[int] = []
        if comm_op == "hier":
            self.dcn_groups = [list(int(i) for i in d)
                               for d in schedule.dcn_groups] or (
                singleton_dcn_groups(layout.num_groups))
            check_dcn_partition(self.dcn_groups, layout.num_groups)
            self._dcn_of = [0] * layout.num_groups
            for di, d in enumerate(self.dcn_groups):
                for gi in d:
                    self._dcn_of[gi] = di
        self._side_stream = None  # hier's cross-slice stream on the card
        # the stream each armed step's done(g) marks are recorded on
        # (``_observe``)
        self._observer_stream = None
        self.track_compression_error = False
        self._comp_errors: dict[int, torch.Tensor] = {}
        self.launches = 0
        self.launch_log: list[int] = []
        self.arrivals: list[int] = []
        self._active = False
        self._scale = 1.0
        self._pending: list[int] = []
        self._next = 0  # position in the launch sequence
        # the launch sequences: "measure" (index order; the next complete
        # armed backward measures), "adopt" (measured, taken up at the
        # next armed begin or gather), "adopted"
        self._order_state = "measure"
        self._seq: list[int] = []
        self._gather_seq: list[int] = []
        self._dcn_seq: list[int] = []
        self._first_use: dict[int, None] = {}
        self._order_key: Optional[str] = None
        self._measured: Optional[dict] = None
        self._inflight: list[_Inflight] = []
        self._handles: list[Any] = []
        # hier: each group's (shard, reduce-scatter work) and the launched
        # cross-slice all-reduces (DCN group, work, concatenated shards)
        self._hier_shard: dict[int, tuple] = {}
        self._dcn_pending: list[int] = []
        self._dcn_next = 0
        self._dcn_inflight: list[tuple] = []
        # rs_fwd_ag: the carried shards, the gathers in flight (group ->
        # (work, padded bucket)) and whether the module's parameters lag
        # the shards by one update
        self.module = module
        self.param_shards: Optional[list[torch.Tensor]] = None
        self._gathers: dict[int, tuple] = {}
        self._stale = False
        self._fwd_handles: list[Any] = []
        self._reset_order()
        if comm_op == "rs_fwd_ag":
            self.scatter_params()

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

    @property
    def sparse(self) -> bool:
        """Whether a sparsifying compressor replaces the collectives."""
        return self.compressor is not None and self.compressor.sparse()

    @property
    def launch_sequence(self) -> list[int]:
        """The order the hooks launch the groups in: group-index order
        until the measured sequence is adopted."""
        return list(self._seq)

    @property
    def gather_sequence(self) -> list[int]:
        """rs_fwd_ag: the order ``gather_params`` launches the all-gathers
        in: reverse group order until the forward's measured first-use
        order is adopted."""
        return list(self._gather_seq)

    @property
    def compression_errors(self) -> list[torch.Tensor]:
        """The top-k errors of the groups launched since ``begin``, in
        group order."""
        return [self._comp_errors[gi] for gi in sorted(self._comp_errors)]

    @property
    def stale(self) -> bool:
        """rs_fwd_ag: the module's parameters lag the carried shards by one
        update (no gather launched yet)."""
        return self._stale

    def attach(self) -> "MergedAllreduce":
        """Register one post-accumulate-grad hook per parameter and, on
        rs_fwd_ag, one forward pre-hook per submodule of ``module`` that
        owns parameters."""
        if not self._handles:
            self._reset_order()
            for k, p in enumerate(self._arr):
                self._handles.append(p.register_post_accumulate_grad_hook(
                    lambda _p, k=k: self._on_grad(k)
                ))
        if (self.comm_op == "rs_fwd_ag" and self.module is not None
                and not self._fwd_handles):
            pos = {id(p): k for k, p in enumerate(self._arr)}
            for m in self.module.modules():
                gs = sorted({self._group_of[pos[id(p)]]
                             for p in m.parameters(recurse=False)
                             if id(p) in pos})
                if gs:
                    self._fwd_handles.append(m.register_forward_pre_hook(
                        lambda _m, _a, gs=tuple(gs): self._need(gs)))
        return self

    def detach(self) -> None:
        """Remove every hook ``attach`` registered (the gradient hooks and
        rs_fwd_ag's forward pre-hooks): the module keeps none of this
        reducer's, so another reducer can be attached to it."""
        for h in self._handles + self._fwd_handles:
            h.remove()
        self._handles = []
        self._fwd_handles = []

    def _reset_order(self) -> None:
        """Back to group-index order, to be measured again."""
        g = self.num_groups
        self._order_state = "measure"
        self._seq = list(range(g))
        self._gather_seq = list(reversed(range(g)))
        self._dcn_seq = list(range(len(self.dcn_groups)))
        self._first_use = {}

    def _store(self):
        return dist.distributed_c10d._get_default_store()

    def _measure(self) -> None:
        """After the first complete armed backward: rank 0 takes the order
        its groups completed in and the forward's first-use order, and
        publishes them (one store key, no collective)."""
        if self._order_state != "measure":
            return
        self._order_key = _order_key(self.group)
        if self.rank == 0:
            g = self.num_groups
            used = list(self._first_use)
            self._measured = {
                "launch": completion_order(self.layout.groups, self.arrivals),
                "gather": used + [gi for gi in reversed(range(g))
                                  if gi not in self._first_use],
            }
            if self.world > 1:
                self._store().set(self._order_key,
                                  json.dumps(self._measured))
        self._order_state = "adopt"

    def _adopt(self) -> None:
        """Take up rank 0's measured sequences (the other ranks wait for
        its key)."""
        if self._order_state != "adopt":
            return
        found = self._measured if self.rank == 0 else json.loads(
            self._store().get(self._order_key))
        g = self.num_groups
        for name in ("launch", "gather"):
            if sorted(found[name]) != list(range(g)):
                raise RuntimeError(
                    f"the published {name} sequence {found[name][:8]}... is "
                    f"not a permutation of this reducer's {g} groups")
        self._seq = [int(gi) for gi in found["launch"]]
        self._gather_seq = [int(gi) for gi in found["gather"]]
        at = {gi: i for i, gi in enumerate(self._seq)}
        self._dcn_seq = sorted(
            range(len(self.dcn_groups)),
            key=lambda di: max(at[gi] for gi in self.dcn_groups[di]))
        self._order_state = "adopted"

    def begin(self, active: bool = True, scale: float = 1.0) -> None:
        """Arm (or, for a micro-step that is not the last, disarm) the hooks
        for the next backward; ``scale`` multiplies every gradient before
        the reduction (1 / micro-steps when accumulating). An armed begin
        takes up a measured launch sequence."""
        if self._inflight:
            raise RuntimeError(
                "begin() with collectives in flight: synchronize() first"
            )
        if active:
            self._adopt()
        self._active = active
        self._scale = float(scale)
        self._pending = [len(g) for g in self.layout.groups]
        self._next = 0
        self.launch_log = []
        self.arrivals = []
        self._hier_shard = {}
        self._dcn_pending = [len(d) for d in self.dcn_groups]
        self._dcn_next = 0
        self._dcn_inflight = []
        if self.track_compression_error:
            self._comp_errors = {}

    def _on_grad(self, k: int) -> None:
        if not self._active:
            return
        self.arrivals.append(k)
        self._pending[self._group_of[k]] -= 1
        seq, g = self._seq, self.num_groups
        while self._next < g and self._pending[seq[self._next]] == 0:
            gi = seq[self._next]
            with collective_scope(group_scope_name(gi)):
                self._pack_and_launch(gi)
            self._next += 1
            if self.comm_op == "hier":
                # beside the group ranges, not inside them
                self._launch_ready_dcn()

    def _bucket_size(self, gi: int) -> Optional[int]:
        """The packed bucket's element count: padded to the world (the
        reduce-scatter lowerings) or to the slice (hier), else None."""
        if self.comm_op == "hier":
            n = self.layout.group_sizes[gi]
            return n + (-n) % self.levels.ici
        if self.comm_op in ("rs_ag",) + SHARDED_OPS:
            return buckets_lib.padded_group_size(self.layout, gi, self.world)
        return None

    def _pack_and_launch(self, gi: int) -> None:
        buf = buckets_lib.pack_group(
            [p.grad for p in self._arr], self.layout, gi, self._bucket_size(gi))
        if self._scale != 1.0:
            buf.mul_(self._scale)
        if self.comm_dtype is not None and buf.dtype != self.comm_dtype:
            buf = buf.to(self.comm_dtype)
        step = spans.armed_step()
        if step is not None:
            step.ready[gi] = step.mark()
        if self.sparse and buf.is_floating_point():
            self._launch_topk(gi, buf)
        elif self.comm_op == "hier":
            self._launch_hier_rs(gi, buf)
        elif self.comm_op in ("rs_ag",) + SHARDED_OPS:
            self._launch_rs(gi, buf)
        else:
            self._launch_all_reduce(gi, buf)
            if self.track_compression_error:
                self._comp_errors[gi] = torch.zeros((), device=buf.device)
        self.launch_log.append(gi)
        if self._observed(step) and self.comm_op != "hier":
            self._observe(step, gi, self._inflight[-1].works)

    def _observed(self, step) -> bool:
        """Whether an armed ``step``'s done(g) marks are events on the
        observer stream (NCCL on a card); else they are taken when the
        host's wait returns (gloo: an upper bound)."""
        return step is not None and step.cuda and self._ordered

    def _observe(self, step, gi: int, works) -> None:
        """done(g): the observer stream waits for ``works`` on the device
        and records the mark; the host goes on, and the NCCL stream is
        not reordered."""
        if self._observer_stream is None:
            self._observer_stream = torch.cuda.Stream(
                device=self._arr[0].device)
        with torch.cuda.stream(self._observer_stream):
            for work in works:
                work.wait()
            step.done[gi] = step.mark()

    def _launch_all_reduce(self, gi: int, buf: torch.Tensor) -> None:
        work = dist.all_reduce(
            buf, op=dist.ReduceOp.SUM, group=self.group, async_op=True
        )
        self._inflight.append(_Inflight(gi, [work], buf))
        self.launches += 1

    def _launch_rs(self, gi: int, buf: torch.Tensor) -> None:
        """The reduce-scatter of a padded bucket and, for rs_ag, the
        all-gather of the summed shard back into the same bucket (the
        reduce-scatter has read it by then: the next collective on NCCL's
        one stream, a wait on gloo)."""
        shard = buf.new_empty(buf.shape[0] // self.world)
        work = reduce_scatter_single(
            shard, buf, op=dist.ReduceOp.SUM, group=self.group, async_op=True
        )
        self.launches += 1
        if self.comm_op in SHARDED_OPS:
            self._inflight.append(_Inflight(gi, [work], shard, keep=(buf,)))
            return
        if not self._ordered:
            work.wait()
        gather = all_gather_single(
            buf, shard, group=self.group, async_op=True
        )
        self.launches += 1
        self._inflight.append(_Inflight(gi, [work, gather], buf,
                                        keep=(shard,)))

    # -- hier -------------------------------------------------------------
    def _side(self, like: torch.Tensor):
        """The context hier's cross-slice work runs in: a side stream on
        the card over NCCL (its waits on the reduce-scatters are then
        device-side, and the backward's stream never waits), else none
        (gloo waits on the host)."""
        if not (self._ordered and like.is_cuda):
            return contextlib.nullcontext()
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(device=like.device)
        return torch.cuda.stream(self._side_stream)

    def _launch_hier_rs(self, gi: int, buf: torch.Tensor) -> None:
        """The reduce-scatter of a bucket padded to the slice size over
        the inner group."""
        shard = buf.new_empty(buf.shape[0] // self.levels.ici)
        work = reduce_scatter_single(
            shard, buf, op=dist.ReduceOp.SUM, group=self.levels.inner,
            async_op=True)
        self.launches += 1
        self._inflight.append(_Inflight(gi, [work], buf))
        self._hier_shard[gi] = (shard, work)
        self._dcn_pending[self._dcn_of[gi]] -= 1

    def _launch_ready_dcn(self) -> None:
        """Launch, in the order the launch sequence completes the DCN
        groups (DCN-group order until one is adopted), every cross-slice
        all-reduce whose members have all been scattered."""
        while (self._dcn_next < len(self.dcn_groups)
               and self._dcn_pending[self._dcn_seq[self._dcn_next]] == 0):
            di = self._dcn_seq[self._dcn_next]
            members = self.dcn_groups[di]
            shards = [self._hier_shard[gi][0] for gi in members]
            if len({t.dtype for t in shards}) > 1:
                raise ValueError(
                    f"hier dcn group {di} mixes bucket dtypes "
                    f"{[str(t.dtype) for t in shards]}; split it at dtype "
                    "boundaries (solver.align_dcn_groups)")
            with collective_scope(dcn_group_scope_name(di)), self._side(shards[0]):
                for gi in members:
                    # on the side stream: a device-side wait; gloo: the
                    # all-reduce must not read an unfinished shard
                    self._hier_shard[gi][1].wait()
                cat = shards[0] if len(shards) == 1 else torch.cat(shards)
                work = dist.all_reduce(cat, op=dist.ReduceOp.SUM,
                                       group=self.levels.outer,
                                       async_op=True)
            self.launches += 1
            self._dcn_inflight.append((di, work, cat))
            self._dcn_next += 1

    def _hier_gather(self) -> list[tuple[int, Any, torch.Tensor]]:
        """The all-gather phase of hier, in group order: each group's
        summed shard (a view of its DCN group's reduced buffer) divided by
        the world and all-gathered over the inner group into its bucket,
        once that DCN group's all-reduce has completed."""
        reduced: dict[int, torch.Tensor] = {}
        for di, work, cat in self._dcn_inflight:
            with self._side(cat):
                work.wait()
            off = 0
            for gi in self.dcn_groups[di]:
                n = self._hier_shard[gi][0].shape[0]
                reduced[gi] = cat[off:off + n]
                off += n
        out = []
        step = spans.armed_step()
        for f in self._inflight:
            shard = reduced[f.gi]
            with collective_scope(group_scope_name(f.gi)), self._side(shard):
                if self.mean:
                    shard.div_(self.world)
                work = all_gather_single(f.out, shard,
                                         group=self.levels.inner,
                                         async_op=True)
            self.launches += 1
            if self._observed(step):
                # the gather ends the group's chain (its scatter, then its
                # DCN group's all-reduce)
                self._observe(step, f.gi, [work])
            out.append((f.gi, work, f.out))
        return out

    def _launch_topk(self, gi: int, buf: torch.Tensor) -> None:
        n = buf.shape[0]
        k = self.compressor.k_for(n)
        if k >= n:
            self._launch_all_reduce(gi, buf)
            if self.track_compression_error:
                self._comp_errors[gi] = torch.zeros((), device=buf.device)
            return
        vals, idx = self.compressor.select(buf, k)
        if self.track_compression_error:
            # top-k keeps entries and zeroes the rest: the dropped energy
            # is ||g||^2 - ||topk(g)||^2, accumulated in float32
            total = torch.sum(torch.square(buf.float()))
            kept = torch.sum(torch.square(vals.float()))
            self._comp_errors[gi] = torch.sqrt(
                torch.clamp_min(total - kept, 0.0)
                / torch.clamp_min(total, 1e-30))
        g_vals = vals.new_empty(self.world * k)
        g_idx = idx.new_empty(self.world * k)
        works = [
            all_gather_single(g_vals, vals, group=self.group,
                                        async_op=True),
            all_gather_single(g_idx, idx, group=self.group,
                                        async_op=True),
        ]
        self.launches += 2
        self._inflight.append(_Inflight(gi, works, g_vals, g_idx, n,
                                        keep=(vals, idx)))

    def _check_complete(self, what: str) -> None:
        if not self._active:
            raise RuntimeError(f"{what}() without an active begin()")
        if self._next != self.num_groups:
            missing = [gi for gi in range(self.num_groups)
                       if self._pending[gi] != 0]
            raise RuntimeError(
                f"merge groups {missing[:8]} never completed: some "
                "parameters received no gradient in this backward"
            )
        self._measure()

    def _reduced_bucket(self, f: _Inflight) -> torch.Tensor:
        """A waited group's summed bucket at the wire dtype, unpadded."""
        if f.idx is not None:
            k = f.out.shape[0] // self.world
            return self.compressor.densify(
                f.out.view(self.world, k), f.idx.view(self.world, k), f.n)
        return f.out[:self.layout.group_sizes[f.gi]]

    def synchronize(self) -> list[torch.Tensor]:
        """Wait for every group's collectives, take the mean and write the
        reduced gradients into ``.grad``. Returns the reduced buckets in
        the parameters' dtype, in group order. On hier this launches the
        all-gathers first (already divided by the world)."""
        if self.comm_op in SHARDED_OPS:
            raise RuntimeError(
                f"comm_op={self.comm_op!r} folds the optimizer into the "
                "collective: call reduce_and_update() (rs_opt_ag) or "
                "reduce_and_defer() (rs_fwd_ag) instead of synchronize() "
                "and optimizer.step()")
        self._check_complete("synchronize")
        out = {}
        step = spans.armed_step()
        host_done = step is not None and not self._observed(step)
        try:
            if self.comm_op == "hier":
                waits = [(gi, [work], buf)
                         for gi, work, buf in self._hier_gather()]
                divided = True
            else:
                waits = [(f.gi, f.works, f) for f in self._inflight]
                divided = False
            for gi, works, what in waits:
                with collective_scope(group_scope_name(gi)):
                    for work in works:
                        work.wait()
                    if host_done:
                        step.done[gi] = step.mark()
                    if divided:
                        buf = what[:self.layout.group_sizes[gi]]
                    else:
                        buf = self._reduced_bucket(what)
                        if self.mean:
                            buf.div_(self.world)
                    if buf.dtype != self.layout.dtypes[gi]:
                        buf = buf.to(self.layout.dtypes[gi])
                    for k, view in buckets_lib.unpack_group(
                        buf, self.layout, gi, self._shapes
                    ).items():
                        self._arr[k].grad = view
                out[gi] = buf
        finally:
            self._inflight = []
            self._dcn_inflight = []
            self._hier_shard = {}
            self._active = False
        return [out[gi] for gi in sorted(out)]

    def discard(self) -> None:
        """Wait for the launched collectives and drop their results (a
        step whose update is skipped); the optimizer state and the carried
        shards are untouched."""
        try:
            for f in self._inflight:
                for work in f.works:
                    work.wait()
            for _, work, _ in self._dcn_inflight:
                work.wait()
        finally:
            self._inflight = []
            self._dcn_inflight = []
            self._hier_shard = {}
            self._active = False

    # -- the sharded optimizer (rs_opt_ag, rs_fwd_ag) ----------------------
    def _reduced_shards(self, what: str) -> list[torch.Tensor]:
        """Wait for the reduce-scatters and return each group's mean shard
        in the group's dtype, in group order."""
        if self.comm_op not in SHARDED_OPS:
            raise RuntimeError(
                f"{what}() requires comm_op='rs_opt_ag' or 'rs_fwd_ag' "
                "(built by make_merged_allreduce(..., optim_spec=, "
                "world_size=))")
        self._check_complete(what)
        step = spans.armed_step()
        host_done = step is not None and not self._observed(step)
        try:
            g_shards = {}
            for f in self._inflight:
                with collective_scope(group_scope_name(f.gi)):
                    f.works[0].wait()
                    if host_done:
                        step.done[f.gi] = step.mark()
                    shard = f.out
                    if shard.dtype != self.layout.dtypes[f.gi]:
                        shard = shard.to(self.layout.dtypes[f.gi])
                    if self.mean:
                        shard = shard / self.world
                    g_shards[f.gi] = shard
        finally:
            self._inflight = []
            self._active = False
        return [g_shards[gi] for gi in sorted(g_shards)]

    def _clip_scale(self, g_shards: list[torch.Tensor]):
        """(global norm, threshold) when the optimizer clips: the shards'
        squares summed in float32 (float64 shards in float64), all-reduced
        once."""
        if self.optim.spec.norm_clip is None:
            return None
        acc = torch.promote_types(g_shards[0].dtype, torch.float32)
        with collective_scope(CLIP_NORM_SCOPE):
            local = torch.zeros((), dtype=acc, device=g_shards[0].device)
            for s in g_shards:
                local = local + torch.sum(s.to(acc) ** 2)
            if self.world > 1:
                dist.all_reduce(local, group=self.group)
                self.launches += 1
            return (torch.sqrt(local),
                    torch.tensor(self.optim.spec.norm_clip, dtype=acc,
                                 device=local.device))

    def _update_shards(self, g_shards: list[torch.Tensor], p_shard,
                       lr, after, ok: Optional[torch.Tensor] = None) -> None:
        """Run the optimizer on every group's shard: ``p_shard(gi)`` gives
        the parameter shard, ``after(gi, new shard)`` takes the result; the
        state's count advances by one. With ``ok`` (a 0-dim bool device
        tensor, the step's guard) each group's new shard and state are
        ``torch.where(ok, new, old)`` and the count advances by ``ok``: a
        bad step keeps them exactly, with no host branch."""
        optim, state = self.optim, self.opt_state
        clip_scale = self._clip_scale(g_shards)
        count = state.count_t
        if lr is None:  # a direct call: the count read on the host
            lr = optim.spec.learning_rate(int(count))
        for gi in range(self.num_groups):
            with collective_scope(group_scope_name(gi)):
                p = p_shard(gi)
                old = [state.slots[s][gi] for s in range(optim.num_slots)]
                new_p, slots_out = optim.update_shard(
                    gi, g_shards[gi], p, old, count, clip_scale, self.rank,
                    lr=lr,
                )
                g_shards[gi] = None
                if ok is not None:
                    new_p = torch.where(ok, new_p, p)
                    slots_out = [torch.where(ok, n, o)
                                 for n, o in zip(slots_out, old)]
                # the state is updated in its own storage (SCH006)
                for s in range(optim.num_slots):
                    state.slots[s][gi].copy_(slots_out[s])
                after(gi, new_p)
        count.add_(1 if ok is None else ok)

    def _own_shard(self, gi: int) -> torch.Tensor:
        """This rank's slice of group gi's padded parameter bucket."""
        n = self.optim.shard_size(gi)
        return buckets_lib.pack_shard(
            self._arr, self.layout, gi, self.rank * n, (self.rank + 1) * n)

    def _launch_gather(self, gi: int, shard: torch.Tensor
                       ) -> tuple[Any, torch.Tensor]:
        full = shard.new_empty(self.optim.padded_size(gi))
        work = all_gather_single(full, shard.contiguous(), group=self.group,
                                 async_op=True)
        self.launches += 1
        return work, full

    def _unpack_params(self, gi: int, work, full: torch.Tensor) -> None:
        """Wait for group gi's all-gather and copy it into the parameters'
        storage."""
        with collective_scope(group_scope_name(gi)):
            work.wait()
            views = buckets_lib.unpack_group(
                full, self.layout, gi, self._shapes)
            with torch.no_grad():
                torch._foreach_copy_(
                    [self._arr[k] for k in views],
                    [views[k] for k in views])

    @torch.no_grad()
    def reduce_and_update(self, lr=None,
                          ok: Optional[torch.Tensor] = None) -> None:
        """The rs_opt_ag step: wait for the reduce-scatters, take the mean
        (each shard cast back to its group's dtype first), clip by the
        global norm when the optimizer does (one all-reduce), update this
        rank's shard of every group's parameters and optimizer state,
        all-gather the updated parameters and unpack them into the
        parameters' data. ``lr`` (a float or a 0-dim device tensor)
        overrides ``spec.learning_rate(count)``; the state's count advances
        by one, or by ``ok`` (``_update_shards``). The all-gathers run
        whatever ``ok`` says: a bad step gathers the unchanged shards."""
        if self.comm_op != "rs_opt_ag":
            raise RuntimeError(
                "reduce_and_update() requires comm_op='rs_opt_ag' (built "
                "by make_merged_allreduce(..., optim_spec=, world_size=))")
        g_shards = self._reduced_shards("reduce_and_update")
        gathers = []
        self._update_shards(
            g_shards, self._own_shard, lr,
            lambda gi, new_p: gathers.append(
                (gi, *self._launch_gather(gi, new_p))), ok)
        for gi, work, full in gathers:
            self._unpack_params(gi, work, full)

    # -- the cross-step pipeline (rs_fwd_ag) ------------------------------
    @torch.no_grad()
    def reduce_and_defer(self, lr=None,
                         ok: Optional[torch.Tensor] = None) -> None:
        """The rs_fwd_ag step's backward half (the JAX package's
        ``merged_rs_defer``): wait for the reduce-scatters, take the mean,
        clip, update the carried parameter shards and optimizer state as
        ``reduce_and_update`` does, and gather nothing. The module's
        parameters are one update stale until the next forward (or
        ``materialize``) gathers them. ``lr`` and ``ok`` as in
        ``reduce_and_update``."""
        if self.comm_op != "rs_fwd_ag":
            raise RuntimeError(
                "reduce_and_defer() requires comm_op='rs_fwd_ag' (built by "
                "make_merged_allreduce(..., optim_spec=, world_size=))")
        g_shards = self._reduced_shards("reduce_and_defer")
        shards = self.param_shards

        def keep(gi, new_p):
            shards[gi].copy_(new_p)  # in the carry's storage (SCH006)

        self._update_shards(g_shards, lambda gi: shards[gi], lr, keep, ok)
        self._stale = True

    @torch.no_grad()
    def scatter_params(self) -> None:
        """The carry from the module's current parameters: this rank's
        shard of every group's padded bucket (after a restore or any other
        write to the parameters)."""
        self._gathers = {}
        self._stale = False
        self.param_shards = [self._own_shard(gi).clone()
                             for gi in range(self.num_groups)]

    def gather_params(self) -> None:
        """The rs_fwd_ag step's forward half (the JAX package's
        ``merged_fwd_allgather``): launch every group's all-gather of its
        carried shard, in the gather sequence (the forward's measured
        first-use order once adopted, reverse group order before). The
        forward pre-hooks wait for them; nothing is launched when the
        parameters are current."""
        if not self._stale:
            return
        self._adopt()
        for gi in self._gather_seq:
            with collective_scope(group_scope_name(gi)):
                self._gathers[gi] = self._launch_gather(
                    gi, self.param_shards[gi])
        self._stale = False

    def finish_gather(self) -> None:
        """Wait for every gather still in flight and unpack it."""
        for gi in sorted(self._gathers, reverse=True):
            self._unpack_params(gi, *self._gathers.pop(gi))

    def materialize(self) -> None:
        """Bring the module's parameters up to the carried shards (a
        collective when they are stale): every reader of the parameters
        between rs_fwd_ag steps calls this first."""
        if self.comm_op != "rs_fwd_ag":
            return
        self.gather_params()
        self.finish_gather()

    def _need(self, gs: tuple) -> None:
        """A module's forward pre-hook: wait for its parameters' groups
        (and, until the sequences are measured, note their first use)."""
        if self._order_state == "measure":
            self._first_use.update(dict.fromkeys(gs))
        if not self._gathers:
            if self._stale:
                raise RuntimeError(
                    "rs_fwd_ag: a forward read parameters that are one "
                    "update stale; call gather_params() (the train step) "
                    "or materialize() (any other reader) first")
            return
        for gi in gs:
            if gi in self._gathers:
                self._unpack_params(gi, *self._gathers.pop(gi))


def plan_merged_allreduce(
    module: nn.Module,
    *,
    policy: str = "mgwfbp",
    tb: Optional[Sequence[float]] = None,
    tf: Optional[Sequence[float]] = None,
    cost_model: Any = None,
    threshold: int = 0,
    comm_op: str = "all_reduce",
    comm_dtype: Optional[torch.dtype] = None,
    groups: Optional[Sequence[Sequence[int]]] = None,
    dcn_groups: Optional[Sequence[Sequence[int]]] = None,
    policy_detail: Optional[str] = None,
) -> tuple[MergeSchedule, BucketLayout, list[int], list[torch.Tensor]]:
    """(schedule, bucket layout, arrival permutation, parameters in leaf
    order) of ``module``'s merged collectives, solved as
    ``make_merged_allreduce`` solves them, with no process group: the
    layout the sharded optimizer is built on at any world size.

    ``tb`` is the per-arrival backward seconds (``profiling.
    benchmark_backward``); absent, 'mgwfbp'/'auto' fall back to the
    volume prior (``size_prior_tb``). ``tf`` is the per-arrival forward
    seconds that rs_fwd_ag prices its deferred all-gathers against
    (``solver.forward_prior_tf(tb)`` when absent). ``groups`` (and, for
    hier, ``dcn_groups``) are an explicit grouping that bypasses the
    policy (``policy_detail`` labels its provenance). On hier the outer
    partition is carried across any dtype split
    of the groups and, without a wire dtype, split at dtype boundaries
    (``remap_dcn_groups``, ``align_dcn_groups``)."""
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
    if comm_op == "rs_fwd_ag" and tb is not None and tf is None:
        tf = forward_prior_tf(tb)
    schedule = build_schedule(
        specs, tb, tf=tf, policy=policy, cost_model=cost_model,
        threshold=threshold, comm_op=comm_op, groups=groups,
        dcn_groups=dcn_groups, policy_detail=policy_detail,
    )
    layout = build_layout(arr, schedule.groups)
    dcn_part = None
    if comm_op == "hier":
        # the outer partition must describe the groups actually issued
        dcn_part = [list(d) for d in schedule.dcn_groups] or (
            singleton_dcn_groups(len(schedule.groups)))
        if layout.groups != schedule.groups:
            dcn_part = remap_dcn_groups(schedule.groups, layout.groups,
                                        dcn_part)
        if comm_dtype is None:
            # a wire cast unifies the shards' dtype; without one each
            # cross-slice buffer must hold one dtype
            dcn_part = align_dcn_groups(dcn_part, layout.dtypes)
    dcn_changed = comm_op == "hier" and tuple(
        tuple(d) for d in dcn_part) != schedule.dcn_groups
    if layout.groups != schedule.groups or dcn_changed:
        # a dtype split adds real collectives: predict what is issued
        schedule = dataclasses.replace(
            schedule, groups=layout.groups,
            dcn_groups=(tuple(tuple(int(i) for i in d) for d in dcn_part)
                        if dcn_part is not None else schedule.dcn_groups))
        if tb is not None and cost_model is not None:
            cost_fn = effective_cost_fn(cost_model, comm_op)
            sizes_b = [s.nbytes for s in specs]
            if comm_op == "rs_fwd_ag":
                rs_cost, ag_cost = cross_step_phase_costs(cost_model)
                total, nonoverlap, comm = simulate_cross_step(
                    layout.groups, sizes_b, tb, tf, rs_cost, ag_cost,
                    float(getattr(cost_model, "gamma", 0.0)),
                    float(getattr(cost_model, "overlap", 1.0)),
                    float(getattr(cost_model, "pack_beta", 0.0)),
                )
            elif comm_op == "hier" and is_two_level(cost_model):
                rs_c, dcn_c, ag_c = two_level_leg_costs(cost_model)
                total, nonoverlap, comm = simulate_groups_two_level(
                    layout.groups, dcn_part, sizes_b, tb, rs_c, dcn_c, ag_c,
                    gamma=float(getattr(cost_model.ici, "gamma", 0.0)),
                    dcn_gamma=float(getattr(cost_model.dcn, "gamma", 0.0)),
                    overlap=float(getattr(cost_model, "overlap", 1.0)),
                    pack_beta=float(getattr(cost_model, "pack_beta", 0.0)),
                )
            else:
                total, nonoverlap, comm = simulate_groups(
                    layout.groups, sizes_b, tb, cost_fn,
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
                    layout.groups, sizes_b, cost_fn
                ),
            )
    return schedule, layout, p, params


def sharded_optim_step(spec: OptimSpec, layout: BucketLayout,
                       perm: Sequence[int], params: Sequence[torch.Tensor],
                       world: int) -> ShardedOptimStep:
    """The ``ShardedOptimStep`` of a planned layout at ``world`` ranks."""
    return ShardedOptimStep(
        spec=spec, layout=layout,
        shapes=tuple(tuple(int(d) for d in params[j].shape) for j in perm),
        perm=tuple(perm), world=int(world),
    )


def make_merged_allreduce(
    module: nn.Module,
    *,
    policy: str = "mgwfbp",
    tb: Optional[Sequence[float]] = None,
    tf: Optional[Sequence[float]] = None,
    cost_model: Any = None,
    threshold: int = 0,
    mean: bool = True,
    comm_dtype: Optional[torch.dtype] = None,
    comm_op: str = "all_reduce",
    compressor: Any = None,
    optim_spec: Optional[OptimSpec] = None,
    world_size: Optional[int] = None,
    levels: Any = None,
    groups: Optional[Sequence[Sequence[int]]] = None,
    dcn_groups: Optional[Sequence[Sequence[int]]] = None,
    policy_detail: Optional[str] = None,
    group: Optional[dist.ProcessGroup] = None,
) -> MergedAllreduce:
    """Solve the merge schedule for ``module``'s parameters
    (``plan_merged_allreduce``) and return the reducer with its hooks
    attached. ``comm_op`` 'rs_opt_ag' and 'rs_fwd_ag' also need
    ``optim_spec`` (the optimizer run on the shards, ``optim.OptimSpec``)
    and ``world_size`` (the shard layout's world, which must be the
    process group's) and take no compressor; 'rs_fwd_ag' prices its
    schedule on ``tf`` too; 'hier' needs ``levels`` (``parallel.mesh.
    two_level_groups``). ``groups`` (arrival-order index groups covering
    every leaf once) and, for hier, ``dcn_groups`` bypass the policy, as in
    ``solver.build_schedule``; ``policy_detail`` labels the schedule.
    Collectives run over ``group`` (the default process group when None;
    the measuring tools time the first n ranks of a world)."""
    if comm_op in SHARDED_OPS and (optim_spec is None or world_size is None):
        raise ValueError(
            f"comm_op={comm_op!r} requires optim_spec and world_size")
    schedule, layout, p, params = plan_merged_allreduce(
        module, policy=policy, tb=tb, tf=tf, cost_model=cost_model,
        threshold=threshold, comm_op=comm_op, comm_dtype=comm_dtype,
        groups=groups, dcn_groups=dcn_groups, policy_detail=policy_detail,
    )
    optim = None
    if comm_op in SHARDED_OPS:
        optim = sharded_optim_step(optim_spec, layout, p, params, world_size)
    return MergedAllreduce(
        schedule, layout, p, params, mean=mean, comm_dtype=comm_dtype,
        comm_op=comm_op, compressor=compressor, optim=optim, levels=levels,
        module=module, group=group,
    ).attach()
