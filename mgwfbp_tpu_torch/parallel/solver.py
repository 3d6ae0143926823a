"""MG-WFBP merge-group solver (a copy of the flat part of
``mgwfbp_tpu/parallel/solver.py``).

Decides which per-layer gradients to fuse into one all-reduce so that
communication overlaps the backward pass while amortizing the startup
latency alpha. Pure functions on plain data; the copy is kept verbatim so
that both packages solve identical schedules (tests hold them equal).

Conventions: every sequence is in gradient-arrival order (index 0 is the
first gradient the backward produces, the last forward layer); ``tb[i]`` is
the backward time attributed to layer i, so gradient i is ready at
``tb[0] + ... + tb[i]``; groups are tuples of arrival-order indices.

The merge rule: scanning arrivals with an open group whose collective would
start at ``start`` and occupy the link for ``comm``, the next gradient
(ready at ``r``) joins the group when (a) ``start > r`` (merging adds no
wait) or (b) ``r - start < alpha`` (the wait is cheaper than another
startup). The single-level lowerings all solve here (``all_reduce``,
``rs_ag``, ``rs_opt_ag``, whose shard update ``effective_cost_fn``
prices); the two-level and cross-step schedules of the JAX package
(``hier``, ``rs_fwd_ag``) are not ported (ROADMAP.md Queue 1 item 7b).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

CostFn = Callable[[float], float]  # bytes -> seconds


SINGLE_LEVEL_OPS = ("all_reduce", "rs_ag", "rs_opt_ag")


def check_comm_op(comm_op: str) -> None:
    """Raise for a lowering the port does not have: the cross-step and
    two-level ones (``rs_fwd_ag``, ``hier``) are ROADMAP.md Queue 1 item
    7b."""
    if comm_op not in SINGLE_LEVEL_OPS:
        raise ValueError(
            f"comm_op {comm_op!r} is not ported: the port lowers "
            f"{', '.join(SINGLE_LEVEL_OPS)} (rs_fwd_ag and hier are "
            "ROADMAP.md Queue 1 item 7b)"
        )


def effective_cost_fn(cost_model, comm_op: str = "all_reduce") -> CostFn:
    """Per-bucket link-occupancy predictor for a lowering:
    ``cost_model.predict`` for ``all_reduce`` and ``rs_ag``. ``rs_opt_ag``
    runs the shard update between the reduce-scatter and the all-gather,
    and the gather cannot start before it ends, so the update's
    ``update_beta * bucket_bytes`` rides the same serial timeline and is
    added here. The cross-step and two-level lowerings (``rs_fwd_ag``,
    ``hier``) are not ported (ROADMAP.md Queue 1 item 7b)."""
    check_comm_op(comm_op)
    ub = float(getattr(cost_model, "update_beta", 0.0))
    if comm_op != "rs_opt_ag" or ub == 0.0:
        return cost_model.predict
    base = cost_model.predict
    return lambda nbytes: base(nbytes) + ub * nbytes


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One gradient tensor, in arrival order."""

    name: str
    size: int  # number of elements
    itemsize: int = 4  # bytes per element (4 fp32, 2 bf16)

    @property
    def nbytes(self) -> int:
        return self.size * self.itemsize


@dataclasses.dataclass(frozen=True)
class MergeSchedule:
    """Solver output: groups of arrival-order indices plus predictions."""

    groups: tuple[tuple[int, ...], ...]
    layer_names: tuple[str, ...]
    predicted_total_time: float  # ready-to-step wall clock, seconds
    predicted_nonoverlap_time: float  # comm time not hidden by backward
    predicted_comm_time: float  # sum of per-group collective durations
    # per-group (payload_bytes, predicted_seconds), arrival order — the
    # reference logs this prediction and measures each merged tensor's
    # allreduce in-loop (distributed_optimizer.py:256-259, 374-391);
    # tools/overlap_report.py compares these against trace timings
    predicted_group_times: tuple[tuple[int, float], ...] = ()
    # which candidate won when policy='auto' ('mgwfbp', 'wfbp', 'single',
    # or 'threshold:<elems>'); empty for direct policies
    policy_detail: str = ""

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    def named_groups(self) -> list[list[str]]:
        return [[self.layer_names[i] for i in g] for g in self.groups]



def predict_group_times(
    groups: Sequence[Sequence[int]],
    sizes_bytes: Sequence[int],
    cost: CostFn,
) -> tuple[tuple[int, float], ...]:
    """Per-group (payload_bytes, predicted_seconds), arrival order."""
    out = []
    for g in groups:
        b = int(sum(sizes_bytes[i] for i in g))
        out.append((b, float(cost(b))))
    return tuple(out)


def simulate_groups(
    groups: Sequence[Sequence[int]],
    sizes_bytes: Sequence[int],
    tb: Sequence[float],
    cost: CostFn,
    gamma: float = 0.0,
    overlap: float = 1.0,
    pack_beta: float = 0.0,
) -> tuple[float, float, float]:
    """Simulate the backward/comm overlap timeline for a fixed grouping.

    Returns (total_time, nonoverlap_time, comm_time). A group's collective can
    start when its last member's gradient is ready and the link is free
    (reference's taoc recurrence, distributed_optimizer.py:187-192, expressed
    over groups instead of layers). `gamma` is the per-collective fixed
    overhead that lives OUTSIDE the link timeline (pack/unpack/dispatch,
    costmodel.AlphaBeta.gamma): it lands on the step's critical path once per
    group, un-hideable by overlap, so it is added to both the total and the
    nonoverlap prediction.

    `overlap` is the platform's calibrated capability to hide collectives
    behind concurrent compute (costmodel.AlphaBeta.overlap): 1.0 gives the
    reference's fully-async timeline, 0.0 a fully serialized one
    (bwd + all comm back-to-back — the virtual CPU mesh regime, where
    compute and collective thunks share the cores); intermediate values
    blend the two linearly.

    `pack_beta` charges the bucketization copy (flatten-concat + unpack)
    per byte of every MULTI-member group — singleton groups reduce their
    tensor in place, so isolating a huge layer in its own group avoids its
    pack copy entirely (costmodel.AlphaBeta.pack_beta; grouping-dependent,
    hence part of the argmin objective).
    """
    ready = np.cumsum(np.asarray(tb, dtype=np.float64))
    bwd_end = float(ready[-1]) if len(ready) else 0.0
    link_free = 0.0
    comm_sum = 0.0
    pack_bytes = 0.0
    n_groups = 0
    for g in groups:
        gbytes = float(sum(sizes_bytes[i] for i in g))
        t = cost(gbytes)
        start = max(link_free, float(ready[max(g)]))
        link_free = start + t
        comm_sum += t
        n_groups += 1
        if len(g) > 1:
            pack_bytes += gbytes
    overhead = gamma * n_groups + pack_beta * pack_bytes
    total_hidden = max(bwd_end, link_free)
    total_serial = bwd_end + comm_sum
    ov = min(max(overlap, 0.0), 1.0)
    total = ov * total_hidden + (1.0 - ov) * total_serial + overhead
    return total, total - bwd_end, comm_sum


def mgwfbp_groups(
    sizes: Sequence[int],
    tb: Sequence[float],
    alpha: float,
    cost: CostFn,
    itemsize: int | Sequence[int] = 4,
    gamma: float = 0.0,
) -> list[list[int]]:
    """The MG-WFBP adaptive merge scan (reference semantics, arrival order).

    sizes: element counts per gradient, arrival order.
    tb: backward-compute seconds per gradient, arrival order.
    alpha: startup latency a merge saves (rule (b)).
    cost: bytes -> seconds predictor for one all-reduce.
    itemsize: bytes per element, scalar or per-layer.
    gamma: per-collective fixed overhead a merge ALSO saves — closing a
        group costs alpha (link startup) + gamma (pack/dispatch) for the
        next one, so rule (b) tolerates waits up to alpha + gamma.
    """
    L = len(sizes)
    if L == 0:
        return []
    if L != len(tb):
        raise ValueError(f"sizes ({L}) and tb ({len(tb)}) length mismatch")
    itemsizes = [itemsize] * L if isinstance(itemsize, int) else list(itemsize)
    if len(itemsizes) != L:
        raise ValueError(f"itemsize ({len(itemsizes)}) and sizes ({L}) length mismatch")
    nbytes = [int(s) * it for s, it in zip(sizes, itemsizes)]
    ready = np.cumsum(np.asarray(tb, dtype=np.float64)).tolist()

    # Mutable per-position state: mass[i] holds the byte payload accumulated at
    # scan position i (the open group's total rides along the scan, mirroring
    # the reference's p[l-1] += p[l] at :194-201).
    mass = list(nbytes)
    tc = [cost(b) for b in mass]

    def comm_start(i: int) -> float:
        # Link-busy recurrence over positions 0..i: start[j] =
        # max(start[j-1] + tc[j-1], ready[j]). Positions whose mass was merged
        # away have tc == 0 and do not occupy the link.
        start = ready[0]
        for j in range(1, i + 1):
            start = max(start + tc[j - 1], ready[j])
        return start

    groups: list[list[int]] = []
    group: list[int] = [0]
    for i in range(L - 1):
        # The open group's payload currently sits at position i.
        r_next = ready[i + 1]
        start_i = comm_start(i)
        merged = False
        if r_next < start_i + tc[i]:
            # Comm for the open group is still in flight (or hasn't begun)
            # when the next gradient arrives.
            if start_i > r_next:
                merged = True  # rule (a): no extra wait introduced
            elif r_next - start_i < alpha + gamma:
                merged = True  # rule (b): wait cheaper than another startup
        elif gamma > 0.0 and tc[i] - alpha < gamma:
            # rule (c), gamma-only: the link went idle before the next
            # arrival — the reference never merges here (an extra collective
            # costs it nothing but alpha on an idle link) — but each group
            # also costs gamma of pack/dispatch on the critical path.
            # Merging defers the open group's transmit into the next
            # collective: the combined comm runs tc[i] - alpha longer than
            # the next group's alone would, while one gamma is saved — so
            # merge exactly when that deferred transmit is cheaper than the
            # dispatch overhead. (Comparing gamma against the IDLE GAP
            # instead would cascade well-pipelined large groups into one
            # giant late collective to save slivers of gamma.)
            merged = True
        if merged:
            mass[i + 1] += mass[i]
            mass[i] = 0
            tc[i] = 0.0
            tc[i + 1] = cost(mass[i + 1])
            group.append(i + 1)
        else:
            groups.append(group)
            group = [i + 1]
    groups.append(group)
    return groups


def threshold_groups(sizes: Sequence[int], threshold: int) -> list[list[int]]:
    """Static merge policy: pack arrivals until cumulative elements reach
    ``threshold`` (reference distributed_optimizer.py:140-162).

    threshold <= 0 means no merging (pure WFBP: one group per layer);
    a huge threshold yields a single group (SyncEASGD-style).
    """
    L = len(sizes)
    if threshold <= 0:
        return [[i] for i in range(L)]
    groups: list[list[int]] = []
    group: list[int] = []
    acc = 0
    for i in range(L):
        group.append(i)
        acc += int(sizes[i])
        if acc >= threshold:
            groups.append(group)
            group = []
            acc = 0
    if group:
        groups.append(group)
    return groups


def single_group(sizes: Sequence[int]) -> list[list[int]]:
    """All gradients in one collective (threshold=inf limit)."""
    return [list(range(len(sizes)))] if len(sizes) else []


def isolate_bigs_groups(
    nbytes: Sequence[int], big_bytes: int
) -> list[list[int]]:
    """Singleton groups for layers over `big_bytes`; each contiguous run of
    smaller layers fuses into one group. Rationale: a huge tensor pays
    pack_beta * bytes to ride a fused bucket but ~nothing alone, while the
    small layers between two bigs amortize alpha+gamma best as one bucket.
    Neither the scan nor a cumulative threshold can produce this shape
    (threshold packs a big layer together with its predecessors)."""
    groups: list[list[int]] = []
    run: list[int] = []
    for i, b in enumerate(nbytes):
        if b > big_bytes:
            if run:
                groups.append(run)
                run = []
            groups.append([i])
        else:
            run.append(i)
    if run:
        groups.append(run)
    return groups


def auto_groups(
    sizes: Sequence[int],
    tb: Sequence[float],
    alpha: float,
    cost: CostFn,
    itemsize: int | Sequence[int] = 4,
    gamma: float = 0.0,
    overlap: float = 1.0,
    pack_beta: float = 0.0,
) -> tuple[list[list[int]], str]:
    """Simulate-and-argmin policy: evaluate every candidate schedule under
    the calibrated cost model (including gamma) and return the cheapest.

    The mgwfbp scan is locally greedy — it cannot reach, e.g., the
    single-group schedule when gradient gaps exceed alpha + gamma even
    though fusing everything wins globally on links where comm is cheap
    relative to compute (VERDICT r3 Weak #1: single beat mgwfbp on 2 of 3
    measured grids). `auto` closes that gap by construction: its candidate
    set contains wfbp, single, the mgwfbp scan itself, and a geometric
    threshold sweep, so its predicted time is <= every one of them.

    Returns (groups, detail) with detail naming the winning candidate.
    """
    L = len(sizes)
    if L == 0:
        return [], "empty"
    itemsizes = [itemsize] * L if isinstance(itemsize, int) else list(itemsize)
    nbytes = [int(s) * it for s, it in zip(sizes, itemsizes)]
    candidates = candidate_groupings(
        sizes, tb, alpha, cost, itemsizes, gamma=gamma, pack_beta=pack_beta
    )
    best = None
    for detail, groups in candidates:
        total, _, _ = simulate_groups(
            groups, nbytes, tb, cost, gamma, overlap, pack_beta
        )
        if best is None or total < best[0]:
            best = (total, groups, detail)
    return best[1], best[2]



def candidate_groupings(
    sizes: Sequence[int],
    tb: Sequence[float],
    alpha: float,
    cost: CostFn,
    itemsize: int | Sequence[int] = 4,
    gamma: float = 0.0,
    pack_beta: float = 0.0,
) -> list[tuple[str, list[list[int]]]]:
    """Enumerate the solver's candidate schedules, deduped by group shape.

    The shared candidate set behind `auto_groups` (simulate-and-argmin) and
    `schedule_frontier` (the autotuner's race roster): the per-policy picks
    (wfbp / single / the mgwfbp scan), a geometric merge-threshold sweep,
    and — when bucketization has a per-byte price — the isolate-the-bigs
    shapes. Dedup is by group SHAPE, not count: two thresholds can produce
    the same number of groups with different boundaries (e.g. sizes
    [5,5,5,5] at th=6 vs th=11), and those are distinct schedules a
    consumer must see.
    """
    L = len(sizes)
    if L == 0:
        return []
    itemsizes = [itemsize] * L if isinstance(itemsize, int) else list(itemsize)
    nbytes = [int(s) * it for s, it in zip(sizes, itemsizes)]
    candidates: list[tuple[str, list[list[int]]]] = [
        ("wfbp", threshold_groups(sizes, 0)),
        ("single", single_group(sizes)),
        ("mgwfbp", mgwfbp_groups(sizes, tb, alpha, cost, itemsizes, gamma)),
    ]
    total_elems = int(sum(sizes))
    th = 1 << 14
    seen_shapes = {tuple(map(tuple, g)) for _, g in candidates}
    while th < total_elems:
        groups = threshold_groups(sizes, th)
        key = tuple(map(tuple, groups))
        if key not in seen_shapes:
            seen_shapes.add(key)
            candidates.append((f"threshold:{th}", groups))
        th <<= 1
    if pack_beta > 0.0:
        # isolate-the-bigs shapes only pay off when bucketization has a
        # per-byte price; sweep the "big" boundary geometrically
        bb = 1 << 10
        max_b = max(nbytes)
        while bb < max_b:
            groups = isolate_bigs_groups(nbytes, bb)
            key = tuple(map(tuple, groups))
            if key not in seen_shapes:
                seen_shapes.add(key)
                candidates.append((f"isolate-bigs:{bb}", groups))
            bb <<= 1
    return candidates



def size_prior_tb(
    layers: Sequence["LayerSpec"], cost_model=None
) -> list[float]:
    """Fallback tb when no measured backward profile exists: SHAPE from
    parameter volume, SCALE from the cost model — total backward time taken
    as the predicted time to all-reduce the whole model once (the regime
    where merging decisions matter; if compute is far cheaper than comm the
    solver converges to one group, if far more expensive to per-layer
    groups — both safe). Shared by `make_merged_allreduce` and the
    autotuner so the two can never disagree on the prior."""
    total_size = float(sum(l.size for l in layers)) or 1.0
    total_bytes = float(sum(l.nbytes for l in layers))
    if cost_model is not None:
        tb_total = float(cost_model.predict(total_bytes))
    else:
        tb_total = 1e-3  # last-resort scale, no information available
    return [tb_total * l.size / total_size for l in layers]



def build_schedule(
    layers: Sequence[LayerSpec],
    tb: Optional[Sequence[float]] = None,
    *,
    policy: str = "mgwfbp",
    cost_model=None,
    threshold: int = 0,
    comm_op: str = "all_reduce",
    groups: Optional[Sequence[Sequence[int]]] = None,
    policy_detail: Optional[str] = None,
) -> MergeSchedule:
    """A MergeSchedule for gradient tensors in arrival order.

    policy: 'mgwfbp' (the adaptive scan; needs tb and cost_model), 'auto'
    (simulate-and-argmin over every candidate schedule; needs tb and
    cost_model), 'threshold', 'single', or 'wfbp' (no merging). ``comm_op``
    is the lowering the schedule is issued as: every per-bucket cost goes
    through ``effective_cost_fn``. ``groups`` is an explicit grouping that
    bypasses the policy (labelled by ``policy_detail``); predictions are
    simulated either way."""
    sizes = [l.size for l in layers]
    names = tuple(l.name for l in layers)
    nbytes = [l.nbytes for l in layers]
    cost_fn = effective_cost_fn(cost_model, comm_op) if cost_model else None
    gamma = float(getattr(cost_model, "gamma", 0.0)) if cost_model else 0.0
    overlap = (
        float(getattr(cost_model, "overlap", 1.0)) if cost_model else 1.0
    )
    pack_beta = (
        float(getattr(cost_model, "pack_beta", 0.0)) if cost_model else 0.0
    )
    detail = ""
    if groups is not None:
        fixed = [list(int(i) for i in g) for g in groups]
        if sorted(i for g in fixed for i in g) != list(range(len(layers))):
            raise ValueError(
                "explicit groups must cover every layer index exactly once "
                f"(got {len(layers)} layers, groups {fixed})"
            )
        groups = fixed
        detail = policy_detail or "fixed"
    elif policy == "mgwfbp":
        if tb is None or cost_model is None:
            raise ValueError("policy 'mgwfbp' requires tb and cost_model")
        groups = mgwfbp_groups(
            sizes, tb, alpha=cost_model.alpha, cost=cost_fn,
            itemsize=[l.itemsize for l in layers], gamma=gamma,
        )
    elif policy == "auto":
        if tb is None or cost_model is None:
            raise ValueError("policy 'auto' requires tb and cost_model")
        groups, detail = auto_groups(
            sizes, tb, alpha=cost_model.alpha, cost=cost_fn,
            itemsize=[l.itemsize for l in layers], gamma=gamma,
            overlap=overlap, pack_beta=pack_beta,
        )
    elif policy == "threshold":
        groups = threshold_groups(sizes, threshold)
    elif policy == "single":
        groups = single_group(sizes)
    elif policy == "wfbp":
        groups = threshold_groups(sizes, 0)
    else:
        raise ValueError(f"unknown policy {policy!r}")
    if tb is not None and cost_model is not None and len(layers):
        total, nonoverlap, comm = simulate_groups(
            groups, nbytes, tb, cost_fn, gamma, overlap, pack_beta
        )
        group_times = predict_group_times(groups, nbytes, cost_fn)
    else:
        total = nonoverlap = comm = float("nan")
        group_times = ()
    return MergeSchedule(
        groups=tuple(tuple(g) for g in groups),
        layer_names=names,
        predicted_total_time=total,
        predicted_nonoverlap_time=nonoverlap,
        predicted_comm_time=comm,
        predicted_group_times=group_times,
        policy_detail=detail,
    )


def check_unique(names: Sequence[str]) -> None:
    """Raise on duplicate layer names (reference utils.py:160-167, called from
    distributed_optimizer.py:204)."""
    seen: set[str] = set()
    for n in names:
        if n in seen:
            raise ValueError(f"duplicate layer name: {n!r}")
        seen.add(n)
