"""MG-WFBP merge-group solver (a copy of ``mgwfbp_tpu/parallel/solver.py``).

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
startup). Every lowering solves here: the single-level ones
(``all_reduce``, ``rs_ag``, ``rs_opt_ag``, whose shard update
``effective_cost_fn`` prices), the cross-step ``rs_fwd_ag`` (its deferred
all-gathers priced against the next step's forward,
``simulate_cross_step``) and the two-level ``hier`` (a nested pair of
partitions, inner groups and the cross-slice groups of them, priced on two
links, ``simulate_groups_two_level``). ``schedule_frontier`` is the
autotuner's race roster (``parallel.autotune``): the solved schedule's
neighbourhood, ranked by predicted step time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

CostFn = Callable[[float], float]  # bytes -> seconds


COMM_OPS = ("all_reduce", "rs_ag", "hier", "rs_opt_ag", "rs_fwd_ag")


def check_comm_op(comm_op: str) -> None:
    """Raise for a lowering neither package has."""
    if comm_op not in COMM_OPS:
        raise ValueError(
            f"unknown comm_op {comm_op!r}; expected one of "
            f"{', '.join(COMM_OPS)}"
        )


def effective_cost_fn(cost_model, comm_op: str = "all_reduce") -> CostFn:
    """Per-bucket link-occupancy predictor for a lowering.

    For the plain collectives this is `cost_model.predict`. The rs_opt_ag
    lowering inserts the fused shard optimizer update BETWEEN the
    reduce-scatter and the param all-gather — the gather cannot start
    before the update finishes, so the update's duration
    (`update_beta * bucket_bytes`, see costmodel.AlphaBeta.update_beta)
    rides the same serial timeline the merge rule and the simulator reason
    about. Keeping the term inside the cost function means every consumer
    (the mgwfbp scan, auto's argmin, predicted_group_times) prices the
    update-in-the-middle consistently without growing their signatures.
    The cross-step rs_fwd_ag lowering pays the same update between its RS
    and the (next-step) AG, so its per-group TOTAL is priced identically;
    the per-phase split lives in `cross_step_phase_costs`.
    """
    ub = float(getattr(cost_model, "update_beta", 0.0))
    if comm_op not in ("rs_opt_ag", "rs_fwd_ag") or ub == 0.0:
        return cost_model.predict
    base = cost_model.predict
    return lambda nbytes: base(nbytes) + ub * nbytes


# A ring all-reduce is reduce-scatter + all-gather, each moving (P-1)/P of
# the payload: absent a measurement, the calibrated full-collective
# predictor splits evenly between the two phases for the cross-step
# timeline. This is only the DEFAULT prior — a `calibrate --allgather`
# sweep measures the link's real split and persists it as the profile's
# `ag_fraction` (costmodel, schema v3), which `cross_step_phase_costs`
# prefers; the split is clamped to [MIN_AG_FRACTION, 1-MIN_AG_FRACTION]
# so a degenerate calibration can never zero out a whole phase.
CROSS_STEP_RS_FRACTION = 0.5
MIN_AG_FRACTION = 0.05


def cross_step_phase_costs(cost_model) -> tuple[CostFn, CostFn]:
    """(rs_cost, ag_cost) per bucket for the rs_fwd_ag lowering.

    The reduce-scatter leg rides the BACKWARD-side link timeline and also
    carries the shard optimizer update (update_beta — the carried shard is
    not ready to gather until the update lands); the deferred all-gather
    leg rides the NEXT step's forward-side timeline. The two sum to
    `effective_cost_fn(cost_model, 'rs_fwd_ag')` by construction, so
    per-group totals (predict_group_times, overlap accounting) and the
    two-phase simulate can never disagree on a bucket's wire time.

    The RS/AG split comes from the cost model's measured ``ag_fraction``
    when a `calibrate --allgather` sweep fit one; models without it (v1/v2
    profiles, built-in tables) keep the historical halved split
    (`CROSS_STEP_RS_FRACTION`)."""
    base = cost_model.predict
    ub = float(getattr(cost_model, "update_beta", 0.0))
    ag_frac = float(getattr(
        cost_model, "ag_fraction", 1.0 - CROSS_STEP_RS_FRACTION
    ))
    ag_frac = min(max(ag_frac, MIN_AG_FRACTION), 1.0 - MIN_AG_FRACTION)
    rs_frac = 1.0 - ag_frac

    def rs_cost(nbytes: float) -> float:
        return rs_frac * base(nbytes) + ub * nbytes

    def ag_cost(nbytes: float) -> float:
        return ag_frac * base(nbytes)

    return rs_cost, ag_cost


def forward_prior_tf(tb: Sequence[float]) -> list[float]:
    """Fallback per-layer FORWARD durations when no measured forward
    profile exists: backward is ~2x forward FLOPs for conv/dense layers
    (grad-of-input + grad-of-weights vs one matmul), so tf = tb/2 keeps
    the measured backward profile's shape at a defensible scale. A
    measured profile (`profiling.benchmark_trainer_forward`) always takes
    precedence."""
    return [0.5 * float(t) for t in tb]


def simulate_cross_step(
    groups: Sequence[Sequence[int]],
    sizes_bytes: Sequence[int],
    tb: Sequence[float],
    tf: Sequence[float],
    rs_cost: CostFn,
    ag_cost: CostFn,
    gamma: float = 0.0,
    overlap: float = 1.0,
    pack_beta: float = 0.0,
) -> tuple[float, float, float]:
    """Steady-state step timeline of the cross-step (rs_fwd_ag) pipeline.

    Returns (total, nonoverlap, comm_time) where `total` is COMPARABLE to
    `simulate_groups`' total for the in-step lowerings: both measure the
    step's critical path from the moment the backward could begin on an
    idle link — i.e. the cross-step total EXCLUDES the forward-compute
    floor sum(tf) that every lowering pays identically, and counts only
    the forward STALL the deferred gathers add on top of it. Concretely::

        total = (fwd_end - sum(tf))          # forward stall from late AGs
              + overlap-blended backward/RS timeline
              + per-group overheads (gamma, pack_beta)

    Two phases share one serial link:

      * forward: groups gather in REVERSE arrival order (group G-1 holds
        the first forward layers). Group g's AG must land before the
        forward reaches its first consuming layer — arrival index max(g),
        whose forward block starts after all later-arrival groups' blocks
        — or the forward stalls for the difference. This is the
        AG-before-first-use deadline.
      * backward: the solver's taoc recurrence (`simulate_groups`) over
        the RS legs, with grad-ready times offset by the forward stall and
        the link initially busy until the last AG finished.

    `nonoverlap` = total - sum(tb): comm time (and stall) not hidden
    behind compute, the same convention as `simulate_groups`.
    """
    groups = list(groups)
    n_layers = len(sizes_bytes)
    if len(tb) != n_layers or len(tf) != n_layers:
        raise ValueError(
            f"tb ({len(tb)}) / tf ({len(tf)}) / sizes ({n_layers}) "
            "length mismatch"
        )
    tf_total = float(np.sum(np.asarray(tf, np.float64))) if n_layers else 0.0
    tb_total = float(np.sum(np.asarray(tb, np.float64))) if n_layers else 0.0

    # ---- forward phase: AG deadlines vs forward compute ----
    link = 0.0  # serial comm link, busy-until
    fwd = 0.0  # forward compute, busy-until
    comm_sum = 0.0
    pack_bytes = 0.0
    for g in reversed(groups):  # forward-consumption order
        gbytes = float(sum(sizes_bytes[i] for i in g))
        t_ag = ag_cost(gbytes)
        link += t_ag  # shards are ready at step start; AGs queue serially
        comm_sum += t_ag
        if len(g) > 1:
            pack_bytes += gbytes
        # the group's layers cannot start their forward before its gather
        fwd = max(fwd, link) + float(sum(tf[i] for i in g))
    fwd_end = fwd
    fwd_stall = max(fwd_end - tf_total, 0.0)

    # ---- backward phase: the taoc recurrence over the RS legs ----
    # Anchor at the backward start (like simulate_groups): grads become
    # ready along the backward, delayed by any forward stall already on
    # the critical path; the link is free once the last AG drained (the
    # forward ran at least as long, so only a comm-bound tail carries over)
    ready = fwd_stall + np.cumsum(np.asarray(tb, dtype=np.float64))
    bwd_end = fwd_stall + tb_total
    link_free = max(link - tf_total, 0.0)
    n_groups = 0
    for g in groups:
        gbytes = float(sum(sizes_bytes[i] for i in g))
        t_rs = rs_cost(gbytes)
        start = max(link_free, float(ready[max(g)]))
        link_free = start + t_rs
        comm_sum += t_rs
        n_groups += 1
    overhead = gamma * n_groups + pack_beta * pack_bytes
    total_hidden = max(bwd_end, link_free)
    total_serial = tb_total + comm_sum  # fully serialized regime
    ov = min(max(overlap, 0.0), 1.0)
    total = ov * total_hidden + (1.0 - ov) * total_serial + overhead
    return total, total - tb_total, comm_sum


# ---------------------------------------------------------------------------
# Two-link (ICI + DCN) scheduling: the hierarchical lowering's timeline.
#
# A multi-slice pod has TWO interconnects at once — fast ICI inside a slice,
# slow DCN across slices — and the paper's own result (the 10GbE and IB
# clusters of arXiv:1912.09268 solve to different groupings) says the merge
# schedule is a function of the link. So a hier schedule is a PAIR of nested
# partitions: the inner (ICI) grouping of layers, plus an outer (DCN)
# grouping of those inner groups — small buckets may merge on the
# high-latency DCN link while staying split on ICI (amortizing the DCN
# alpha without giving up ICI-side overlap granularity).
# ---------------------------------------------------------------------------


def is_two_level(cost_model) -> bool:
    """Duck-typed: does this model price two link classes separately?"""
    return (
        cost_model is not None
        and hasattr(cost_model, "ici")
        and hasattr(cost_model, "dcn")
        and int(getattr(cost_model, "dcn_size", 1)) > 1
    )


def two_level_leg_costs(cost_model) -> tuple[CostFn, CostFn, CostFn]:
    """(rs_cost, dcn_cost, ag_cost) per bucket for the hier lowering.

    All three take the FULL bucket payload in bytes. The ICI side splits
    into its RS and AG legs by the INNER link's measured ag_fraction
    (calibrate --allgather; 0.5 prior); the DCN leg is the outer-link
    all-reduce of the 1/ici_size shard (`TwoLevelAlphaBeta.
    dcn_shard_predict` owns the shard division). The three sum to
    `cost_model.predict` by construction, so per-group totals and the
    two-link simulate can never disagree on a bucket's wire time."""
    ici = cost_model.ici
    af = float(getattr(ici, "ag_fraction", 0.5))
    af = min(max(af, MIN_AG_FRACTION), 1.0 - MIN_AG_FRACTION)

    def rs_cost(nbytes: float) -> float:
        return (1.0 - af) * float(ici.predict(nbytes))

    def ag_cost(nbytes: float) -> float:
        return af * float(ici.predict(nbytes))

    return rs_cost, cost_model.dcn_shard_predict, ag_cost


def singleton_dcn_groups(num_groups: int) -> list[list[int]]:
    """One DCN collective per inner group — the pre-nesting hier shape
    (and the default for explicit/non-auto schedules)."""
    return [[gi] for gi in range(num_groups)]


def check_dcn_partition(
    dcn_groups: Sequence[Sequence[int]], num_groups: int
) -> None:
    """A DCN partition must cover every inner-group index exactly once
    (a gap means a bucket whose cross-slice reduction never happens —
    silently wrong gradients)."""
    flat = sorted(i for d in dcn_groups for i in d)
    if flat != list(range(num_groups)):
        raise ValueError(
            f"dcn_groups must cover every inner-group index exactly once "
            f"(got {num_groups} groups, partition {list(dcn_groups)})"
        )


def simulate_groups_two_level(
    groups: Sequence[Sequence[int]],
    dcn_groups: Sequence[Sequence[int]],
    sizes_bytes: Sequence[int],
    tb: Sequence[float],
    rs_cost: CostFn,
    dcn_cost: CostFn,
    ag_cost: CostFn,
    gamma: float = 0.0,
    dcn_gamma: float = 0.0,
    overlap: float = 1.0,
    pack_beta: float = 0.0,
) -> tuple[float, float, float]:
    """Two-link timeline of the hierarchical lowering for a nested
    schedule. Returns (total, nonoverlap, comm_time), comparable with
    `simulate_groups` (both are backward-anchored).

    Two serial links race the backward pass:

      * ICI link: each inner group's reduce-scatter starts when its last
        gradient is ready and the link is free (the taoc recurrence);
        after the RS phase the same link carries the all-gathers, each
        gated on its DCN group's cross-slice reduction landing — the
        phase order the lowering's token chain realizes.
      * DCN link: one all-reduce per DCN group over the concatenated
        member shards (payload = the members' 1/ici_size shards), issued
        when the group's LAST member's reduce-scatter completes.

    `gamma` is the per-inner-group fixed overhead (pack/dispatch on the
    ICI side), `dcn_gamma` the per-DCN-collective one — nesting exists
    exactly to trade the latter against DCN-link wait. `pack_beta`
    charges the bucketization copy per byte of multi-member inner groups
    plus the shard concat of multi-member DCN groups."""
    groups = list(groups)
    dcn_groups = [list(d) for d in dcn_groups]
    check_dcn_partition(dcn_groups, len(groups))
    ready = np.cumsum(np.asarray(tb, dtype=np.float64))
    bwd_end = float(ready[-1]) if len(ready) else 0.0
    gbytes = [float(sum(sizes_bytes[i] for i in g)) for g in groups]

    # ---- ICI link, RS phase ----
    ici_free = 0.0
    comm_sum = 0.0
    pack_bytes = 0.0
    rs_done = [0.0] * len(groups)
    for gi, g in enumerate(groups):
        t = rs_cost(gbytes[gi])
        start = max(ici_free, float(ready[max(g)]) if len(g) else 0.0)
        ici_free = start + t
        rs_done[gi] = ici_free
        comm_sum += t
        if len(g) > 1:
            pack_bytes += gbytes[gi]

    # ---- DCN link: one cross-slice all-reduce per DCN group ----
    dcn_free = 0.0
    dcn_done = [0.0] * len(groups)
    for d in dcn_groups:
        dbytes = float(sum(gbytes[gi] for gi in d))
        t = dcn_cost(dbytes)
        start = max(dcn_free, max(rs_done[gi] for gi in d))
        dcn_free = start + t
        for gi in d:
            dcn_done[gi] = dcn_free
        comm_sum += t
        # multi-member DCN groups concat/split their members' SHARD
        # buffers (1/ici_size of the bucket each) — a copy so small next
        # to the inner-side bucket pack that charging it would only add
        # an ici_size knob to every caller; left unpriced by design

    # ---- ICI link, AG phase (after the RS queue; gated per DCN group) ----
    for gi in range(len(groups)):
        t = ag_cost(gbytes[gi])
        start = max(ici_free, dcn_done[gi])
        ici_free = start + t
        comm_sum += t

    overhead = (
        gamma * len(groups) + dcn_gamma * len(dcn_groups)
        + pack_beta * pack_bytes
    )
    total_hidden = max(bwd_end, ici_free, dcn_free)
    total_serial = bwd_end + comm_sum
    ov = min(max(overlap, 0.0), 1.0)
    total = ov * total_hidden + (1.0 - ov) * total_serial + overhead
    return total, total - bwd_end, comm_sum


def dcn_partition_candidates(
    groups: Sequence[Sequence[int]],
    sizes_bytes: Sequence[int],
    tb: Sequence[float],
    rs_cost: CostFn,
    dcn_cost: CostFn,
    dcn_alpha: float,
    dcn_gamma: float = 0.0,
) -> list[tuple[str, list[list[int]]]]:
    """Candidate DCN partitions for a FIXED inner grouping, deduped.

    The outer link sees each inner group as one "layer": its payload is
    the group's (full-bucket) bytes and its arrival time the completion
    of its reduce-scatter on the ICI link. Candidates: one collective per
    group (the pre-nesting shape), everything in one, and the mgwfbp scan
    re-run ON THE DCN LINK — the per-link merge decision this module
    exists for (small groups merge on DCN but stay split on ICI when the
    DCN alpha dominates their shard payloads)."""
    ready = np.cumsum(np.asarray(tb, dtype=np.float64))
    gbytes = [int(sum(sizes_bytes[i] for i in g)) for g in groups]
    ici_free = 0.0
    rs_done = []
    for gi, g in enumerate(groups):
        start = max(ici_free, float(ready[max(g)]) if len(g) else 0.0)
        ici_free = start + rs_cost(float(gbytes[gi]))
        rs_done.append(ici_free)
    # per-"layer" time deltas whose cumsum reproduces the arrival times
    tb_dcn = [rs_done[0]] + [
        rs_done[i] - rs_done[i - 1] for i in range(1, len(rs_done))
    ]
    n = len(groups)
    out: list[tuple[str, list[list[int]]]] = [
        ("per-group", singleton_dcn_groups(n)),
        ("single", [list(range(n))] if n else []),
    ]
    if n:
        out.append((
            "scan",
            mgwfbp_groups(
                gbytes, tb_dcn, alpha=dcn_alpha, cost=dcn_cost,
                itemsize=1, gamma=dcn_gamma,
            ),
        ))
    seen: set = set()
    deduped = []
    for detail, part in out:
        key = tuple(map(tuple, part))
        if key in seen:
            continue
        seen.add(key)
        deduped.append((detail, part))
    return deduped


def two_level_frontier(
    sizes: Sequence[int],
    tb: Sequence[float],
    cost_model,
    itemsize: int | Sequence[int] = 4,
    max_candidates: int = 6,
) -> list[tuple[str, list[list[int]], list[list[int]], float]]:
    """Ranked nested schedules for the hier lowering: (detail, groups,
    dcn_groups, predicted_total_s), cheapest first.

    Inner candidates come from `candidate_groupings` priced on the ICI
    link (its RS+AG legs are what occupy that link; the DCN hop rides a
    different wire and must not distort the inner merge rule); each inner
    candidate is then nested under every `dcn_partition_candidates` pick
    and the pair scored by the two-link simulate. This IS the per-link
    merge decision: the argmin is free to keep buckets split on ICI while
    merging their cross-slice reductions on DCN."""
    L = len(sizes)
    if L == 0:
        return []
    if not is_two_level(cost_model):
        raise ValueError(
            "two_level_frontier needs a TwoLevelAlphaBeta-shaped cost "
            f"model (got {type(cost_model).__name__})"
        )
    itemsizes = [itemsize] * L if isinstance(itemsize, int) else list(itemsize)
    nbytes = [int(s) * it for s, it in zip(sizes, itemsizes)]
    rs_cost, dcn_cost, ag_cost = two_level_leg_costs(cost_model)
    ici = cost_model.ici
    dcn = cost_model.dcn
    gamma = float(getattr(ici, "gamma", 0.0))
    dcn_gamma = float(getattr(dcn, "gamma", 0.0))
    overlap = float(getattr(cost_model, "overlap", 1.0))
    pack_beta = float(getattr(cost_model, "pack_beta", 0.0))
    ici_cost = ici.predict
    scored: list[tuple[str, list[list[int]], list[list[int]], float]] = []
    seen: set = set()
    for inner_detail, groups in candidate_groupings(
        sizes, tb, float(getattr(ici, "alpha", 0.0)), ici_cost, itemsizes,
        gamma=gamma, pack_beta=pack_beta,
    ):
        for dcn_detail, part in dcn_partition_candidates(
            groups, nbytes, tb, rs_cost, dcn_cost,
            dcn_alpha=float(getattr(dcn, "alpha", 0.0)),
            dcn_gamma=dcn_gamma,
        ):
            key = (tuple(map(tuple, groups)), tuple(map(tuple, part)))
            if key in seen:
                continue
            seen.add(key)
            total, _, _ = simulate_groups_two_level(
                groups, part, nbytes, tb, rs_cost, dcn_cost, ag_cost,
                gamma=gamma, dcn_gamma=dcn_gamma, overlap=overlap,
                pack_beta=pack_beta,
            )
            scored.append((
                f"{inner_detail}/dcn-{dcn_detail}", groups, part,
                float(total),
            ))
    scored.sort(key=lambda c: c[3])
    return scored[: max(max_candidates, 1)]


def remap_dcn_groups(
    old_groups: Sequence[Sequence[int]],
    new_groups: Sequence[Sequence[int]],
    dcn_groups: Sequence[Sequence[int]],
) -> list[list[int]]:
    """Carry a DCN partition across a refinement of the inner grouping
    (`buckets.build_layout` splits dtype-mixed groups): every new group
    descends from exactly one old group, and inherits its DCN membership.
    Order within each DCN group follows the new (arrival) indices."""
    member_to_old: dict[int, int] = {}
    for oi, g in enumerate(old_groups):
        for i in g:
            member_to_old[i] = oi
    new_owner = [member_to_old[g[0]] for g in new_groups]
    out: list[list[int]] = []
    for d in dcn_groups:
        want = set(int(i) for i in d)
        members = [ni for ni, oi in enumerate(new_owner) if oi in want]
        if members:
            out.append(members)
    return out


def align_dcn_groups(
    dcn_groups: Sequence[Sequence[int]], dtypes: Sequence
) -> list[list[int]]:
    """Split DCN groups at bucket-dtype boundaries: one DCN collective
    concatenates its members' shards into ONE buffer, which only exists
    for a homogeneous dtype. Each split adds a real cross-slice
    collective (and its DCN alpha), so callers re-simulate predictions
    on the partition actually issued."""
    out: list[list[int]] = []
    for d in dcn_groups:
        run: list[int] = []
        for gi in d:
            if run and dtypes[gi] != dtypes[run[-1]]:
                out.append(run)
                run = []
            run.append(int(gi))
        if run:
            out.append(run)
    return out


def auto_groups_two_level(
    sizes: Sequence[int],
    tb: Sequence[float],
    cost_model,
    itemsize: int | Sequence[int] = 4,
) -> tuple[list[list[int]], list[list[int]], str]:
    """`auto_groups` for the hierarchical lowering: argmin over the
    two-level frontier. Returns (groups, dcn_groups, detail) — a PAIR of
    nested partitions, the schedule shape a two-interconnect topology
    actually calls for."""
    if len(sizes) == 0:
        return [], [], "empty"
    best = two_level_frontier(
        sizes, tb, cost_model, itemsize, max_candidates=1
    )[0]
    return best[1], best[2], best[0]


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
    # hier (two-level) only: the OUTER (DCN) partition — groups of
    # inner-group indices, arrival order; each DCN group issues ONE
    # cross-slice collective over its members' concatenated shards. Empty
    # for flat lowerings (and treated as one-DCN-collective-per-group by
    # the hier lowering when a two-level solve never ran).
    dcn_groups: tuple[tuple[int, ...], ...] = ()

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    @property
    def num_dcn_groups(self) -> int:
        return len(self.dcn_groups) if self.dcn_groups else len(self.groups)

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



def auto_groups_cross_step(
    sizes: Sequence[int],
    tb: Sequence[float],
    tf: Sequence[float],
    cost_model,
    itemsize: int | Sequence[int] = 4,
) -> tuple[list[list[int]], str]:
    """`auto_groups` for the cross-step (rs_fwd_ag) lowering: the same
    candidate set, scored by the TWO-phase simulate — the deferred
    all-gather against the forward timeline, the reduce-scatter against
    the backward — instead of the in-step backward-only recurrence. The
    candidate scan itself runs on the RS leg's cost (the link the merge
    rule reasons about at backward time)."""
    L = len(sizes)
    if L == 0:
        return [], "empty"
    itemsizes = [itemsize] * L if isinstance(itemsize, int) else list(itemsize)
    nbytes = [int(s) * it for s, it in zip(sizes, itemsizes)]
    gamma = float(getattr(cost_model, "gamma", 0.0))
    overlap = float(getattr(cost_model, "overlap", 1.0))
    pack_beta = float(getattr(cost_model, "pack_beta", 0.0))
    rs_cost, ag_cost = cross_step_phase_costs(cost_model)
    candidates = candidate_groupings(
        sizes, tb, cost_model.alpha, rs_cost, itemsizes, gamma=gamma,
        pack_beta=pack_beta,
    )
    best = None
    for detail, groups in candidates:
        total, _, _ = simulate_cross_step(
            groups, nbytes, tb, tf, rs_cost, ag_cost, gamma, overlap,
            pack_beta,
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



def schedule_frontier(
    sizes: Sequence[int],
    tb: Sequence[float],
    alpha: float,
    cost: CostFn,
    itemsize: int | Sequence[int] = 4,
    *,
    gamma: float = 0.0,
    overlap: float = 1.0,
    pack_beta: float = 0.0,
    max_candidates: int = 6,
    cross_step: Optional[tuple[Sequence[float], CostFn, CostFn]] = None,
) -> list[tuple[str, list[list[int]], float]]:
    """The argmin's neighbourhood: candidate schedules ranked by predicted
    total step time, for the in-situ autotuner to RACE on the live job
    (`parallel.autotune`).

    Returns up to `max_candidates` (detail, groups, predicted_total_s)
    tuples, cheapest predicted first. The single-group schedule is always
    kept in the roster even when its prediction ranks it out: under a
    mis-calibrated cost model the prediction order is exactly what cannot
    be trusted, and `single` is the structural extreme the prediction most
    often mis-ranks (VERDICT r3 Weak #1: single beat mgwfbp on 2 of 3
    measured grids while the model said otherwise).

    cross_step: (tf, rs_cost, ag_cost) prices the frontier for the
    rs_fwd_ag lowering instead — candidates score under
    `simulate_cross_step`, whose totals are backward-anchored and thus
    DIRECTLY comparable with the in-step lowerings' (both exclude the
    sum(tf) compute floor every lowering pays); `cost` should then be the
    RS leg (the scan's link cost at backward time).
    """
    L = len(sizes)
    if L == 0:
        return []
    itemsizes = [itemsize] * L if isinstance(itemsize, int) else list(itemsize)
    nbytes = [int(s) * it for s, it in zip(sizes, itemsizes)]
    scored: list[tuple[str, list[list[int]], float]] = []
    for detail, groups in candidate_groupings(
        sizes, tb, alpha, cost, itemsizes, gamma=gamma, pack_beta=pack_beta
    ):
        if cross_step is not None:
            tf, rs_cost, ag_cost = cross_step
            total, _, _ = simulate_cross_step(
                groups, nbytes, tb, tf, rs_cost, ag_cost, gamma, overlap,
                pack_beta,
            )
        else:
            total, _, _ = simulate_groups(
                groups, nbytes, tb, cost, gamma, overlap, pack_beta
            )
        scored.append((detail, groups, float(total)))
    scored.sort(key=lambda c: c[2])
    out = scored[: max(max_candidates, 1)]
    if not any(len(g) == 1 and len(g[0]) == L for _, g, _ in out):
        fallback = next(
            (c for c in scored if len(c[1]) == 1 and len(c[1][0]) == L), None
        )
        if fallback is not None:
            out = out[:-1] + [fallback] if len(out) >= max_candidates else (
                out + [fallback]
            )
    return out


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
    tf: Optional[Sequence[float]] = None,
    policy: str = "mgwfbp",
    cost_model=None,
    threshold: int = 0,
    comm_op: str = "all_reduce",
    groups: Optional[Sequence[Sequence[int]]] = None,
    dcn_groups: Optional[Sequence[Sequence[int]]] = None,
    policy_detail: Optional[str] = None,
) -> MergeSchedule:
    """Build a MergeSchedule for gradient tensors in arrival order.

    policy: 'mgwfbp' (adaptive; needs tb and cost_model), 'auto'
    (simulate-and-argmin over all candidate schedules; needs tb and
    cost_model), 'threshold', 'single', or 'wfbp' (no merging). Mirrors the
    reference's policy dispatch (distributed_optimizer.py:263-270: adaptive
    iff ADAPTIVE_MERGE and layerwise_times available, else threshold).

    comm_op: the lowering the schedule will be issued as; 'rs_opt_ag' adds
    the update-in-the-middle term to every per-bucket cost prediction
    (`effective_cost_fn`) so the schedule still describes the wire.
    'rs_fwd_ag' (cross-step) additionally needs `tf`, the arrival-ordered
    per-layer FORWARD profile (defaults to `forward_prior_tf(tb)`): its
    predictions come from `simulate_cross_step`, which prices each group's
    deferred all-gather against its first-consuming-layer deadline in the
    next step's forward. The mgwfbp scan then runs on the reduce-scatter
    leg's cost only (the backward-side link the merge rule reasons about).

    groups: an EXPLICIT grouping (arrival-order index groups) that bypasses
    the policy solve — the autotuner's raced candidates and cache hits
    enter here. Must cover every layer index exactly once; predictions are
    still simulated under the cost model so the schedule stays comparable
    to solved ones. `policy_detail` labels its provenance.

    comm_op='hier' with a two-level cost model schedules BOTH links: the
    'auto' policy argmins over the nested frontier
    (`auto_groups_two_level`), an explicit `dcn_groups` partition rides
    through (cache hits / raced candidates), and every other policy keeps
    one DCN collective per inner group; predictions come from the
    two-link simulator either way.
    """
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
    cross_step = comm_op == "rs_fwd_ag"
    if cross_step and tb is not None and tf is None:
        tf = forward_prior_tf(tb)
    two_level = comm_op == "hier" and is_two_level(cost_model)
    scan_cost = cost_fn
    if cross_step and cost_model is not None:
        # the merge rule scans BACKWARD arrivals against the link — on the
        # cross-step lowering only the reduce-scatter leg occupies it there
        scan_cost, _ = cross_step_phase_costs(cost_model)

    detail = ""
    dcn_part: Optional[list[list[int]]] = (
        [list(int(i) for i in d) for d in dcn_groups]
        if dcn_groups is not None
        else None
    )
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
            sizes,
            tb,
            alpha=cost_model.alpha,
            cost=scan_cost,
            itemsize=[l.itemsize for l in layers],
            gamma=gamma,
        )
    elif policy == "auto":
        if tb is None or cost_model is None:
            raise ValueError("policy 'auto' requires tb and cost_model")
        if two_level:
            groups, dcn_part, detail = auto_groups_two_level(
                sizes, tb, cost_model,
                itemsize=[l.itemsize for l in layers],
            )
        elif cross_step:
            groups, detail = auto_groups_cross_step(
                sizes,
                tb,
                tf,
                cost_model,
                itemsize=[l.itemsize for l in layers],
            )
        else:
            groups, detail = auto_groups(
                sizes,
                tb,
                alpha=cost_model.alpha,
                cost=cost_fn,
                itemsize=[l.itemsize for l in layers],
                gamma=gamma,
                overlap=overlap,
                pack_beta=pack_beta,
            )
    elif policy == "threshold":
        groups = threshold_groups(sizes, threshold)
    elif policy == "single":
        groups = single_group(sizes)
    elif policy == "wfbp":
        groups = threshold_groups(sizes, 0)
    else:
        raise ValueError(f"unknown policy {policy!r}")

    if comm_op == "hier":
        if dcn_part is None:
            dcn_part = singleton_dcn_groups(len(groups))
        check_dcn_partition(dcn_part, len(groups))
    else:
        dcn_part = None

    if tb is not None and cost_model is not None and len(layers):
        if two_level:
            rs_c, dcn_c, ag_c = two_level_leg_costs(cost_model)
            total, nonoverlap, comm = simulate_groups_two_level(
                groups, dcn_part, nbytes, tb, rs_c, dcn_c, ag_c,
                gamma=float(getattr(cost_model.ici, "gamma", 0.0)),
                dcn_gamma=float(getattr(cost_model.dcn, "gamma", 0.0)),
                overlap=overlap, pack_beta=pack_beta,
            )
        elif cross_step:
            rs_c, ag_c = cross_step_phase_costs(cost_model)
            total, nonoverlap, comm = simulate_cross_step(
                groups, nbytes, tb, tf, rs_c, ag_c, gamma, overlap,
                pack_beta,
            )
        else:
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
        dcn_groups=(
            tuple(tuple(int(i) for i in d) for d in dcn_part)
            if dcn_part is not None
            else ()
        ),
    )

def check_unique(names: Sequence[str]) -> None:
    """Raise on duplicate layer names (reference utils.py:160-167, called from
    distributed_optimizer.py:204)."""
    seen: set[str] = set()
    for n in names:
        if n in seen:
            raise ValueError(f"duplicate layer name: {n!r}")
        seen.add(n)
