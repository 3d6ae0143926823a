"""Overlap accounting: exposed against hidden communication (a copy of
``mgwfbp_tpu/telemetry/overlap.py``).

MG-WFBP's headline quantity: how much all-reduce time hides behind the
backward pass. ``attribute_overlap`` replays the timeline the solver
reasons about (gradient-ready times from the per-layer backward profile
tb, one serial link occupied by the merge groups in group order) and
splits every group's communication into **hidden** (while the backward
still runs) and **exposed** (on the step's critical path). Efficiency is
hidden / total communication.

Per-group durations come from a trace (``profiling.trace_group_times``:
``attribution`` "trace") or, where the trace attributes nothing, from the
cost model (``solver.effective_cost_fn``: "cost-model"). Starts are
replayed from tb along a launch ``order``: by default group-index order
with each group ready at the cumulative tb of its last arrival position
(the JAX package's replay); given the reducer's ``launch_sequence`` (the
order the hooks measured the groups completing in, which the reducer
launches them in), the backward is replayed in that sequence, each group
ready once it and every group before it have their tb, and the link
serves the groups in that order. Under index order ResNet-20's stem sits
among the first arrivals although its hooks fire last, so that replay
overstates the hidden share; the trainer's telemetry passes the
sequence. rs_fwd_ag's all-gathers are replayed in its
``gather_sequence`` when given (reverse group order by default). The
reducer's ``comm_op`` prices each group
(``all_reduce`` and ``rs_ag`` by the collective, ``rs_opt_ag`` with its
shard update's ``update_beta`` term). ``rs_fwd_ag`` replays two phases
(``attribute_overlap_cross_step``): each group's deferred all-gather
against the next step's forward (``tf``), its reduce-scatter against the
backward; ``hier`` replays two links (``attribute_overlap_two_level``),
and each row and the summary split the time into ``ici_s`` and ``dcn_s``
and name the ``bottleneck_link``. Everything here is host arithmetic on
host data: no device synchronisation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class GroupOverlap:
    """One merge group's share of the replayed step timeline."""

    group: int  # arrival-order group index
    nbytes: int  # bucket payload on the wire
    start_s: float  # link-timeline start (ready[max member], link free)
    comm_s: float  # collective duration (measured or predicted)
    hidden_s: float  # portion overlapping compute (backward; + forward
    # for the cross-step deferred-AG leg)
    exposed_s: float  # portion on the critical path
    # cross-step (rs_fwd_ag) only: the deferred all-gather leg, which
    # executes during the NEXT step's forward. ag_start_s is anchored at
    # that step's start; comm_s above is the rs+ag TOTAL and start_s the
    # reduce-scatter leg's (step-anchored) start. Zero on in-step rows.
    ag_start_s: float = 0.0
    ag_s: float = 0.0
    # hierarchical (hier) only: the group's comm split by LINK — ici_s is
    # the inner reduce-scatter + all-gather legs, dcn_s this group's share
    # of its DCN group's cross-slice collective. comm_s = ici_s + dcn_s;
    # the split is what tells an operator WHICH interconnect is the
    # bottleneck. Zero on flat rows.
    ici_s: float = 0.0
    dcn_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class OverlapSummary:
    """Per-step overlap accounting for one schedule regime."""

    step_s: float  # measured seconds per optimizer step
    tb_total_s: float  # backward compute total (sum of tb)
    groups: tuple[GroupOverlap, ...]
    attribution: str  # 'trace' | 'cost-model'
    # forward compute total — nonzero only for the cross-step (rs_fwd_ag)
    # regime, whose replayed timeline starts at the FORWARD (deferred AGs
    # hide behind it); in-step regimes replay backward-anchored as before
    tf_total_s: float = 0.0
    # where the replayed forward REGION ends (tf_total_s + AG-deadline
    # stalls) = where the backward begins; renderers anchor on this so a
    # stalled forward never desynchronizes the backward vs the RS spans
    fwd_end_s: float = 0.0

    @property
    def comm_s(self) -> float:
        return sum(g.comm_s for g in self.groups)

    @property
    def hidden_s(self) -> float:
        return sum(g.hidden_s for g in self.groups)

    @property
    def exposed_s(self) -> float:
        return sum(g.exposed_s for g in self.groups)

    @property
    def efficiency(self) -> float:
        """hidden / total comm; a comm-free step is perfectly hidden."""
        total = self.comm_s
        if total <= 0.0:
            return 1.0
        return self.hidden_s / total

    @property
    def timeline_end_s(self) -> float:
        """End of the replayed compute+comm timeline (export's render
        span). Cross-step rows count only their RS leg here (comm_s -
        ag_s): the AG leg lives at the timeline's start."""
        last_comm = max(
            (g.start_s + (g.comm_s - g.ag_s) for g in self.groups),
            default=0.0,
        )
        fwd = max(self.fwd_end_s, self.tf_total_s)
        return max(fwd + self.tb_total_s, last_comm)

    @property
    def ici_s(self) -> float:
        return sum(g.ici_s for g in self.groups)

    @property
    def dcn_s(self) -> float:
        return sum(g.dcn_s for g in self.groups)

    @property
    def bottleneck_link(self) -> Optional[str]:
        """'ici' or 'dcn' — the link carrying the larger comm share of a
        hierarchical regime (None on flat regimes, where only one link
        exists). The drift detector and the fleet console read this to
        name WHICH wire to blame before anyone re-autotunes."""
        if self.dcn_s <= 0.0:
            return None
        return "dcn" if self.dcn_s >= self.ici_s else "ici"

    def to_event_fields(self) -> dict:
        """The aggregate `overlap` telemetry record's payload."""
        out = {
            "step_s": float(self.step_s),
            "tb_total_s": float(self.tb_total_s),
            "tf_total_s": float(self.tf_total_s),
            "fwd_end_s": float(self.fwd_end_s),
            "comm_s": float(self.comm_s),
            "hidden_s": float(self.hidden_s),
            "exposed_s": float(self.exposed_s),
            "efficiency": float(self.efficiency),
            "attribution": self.attribution,
            "timeline_end_s": float(self.timeline_end_s),
            "num_groups": len(self.groups),
        }
        if self.dcn_s > 0.0:
            out["ici_s"] = float(self.ici_s)
            out["dcn_s"] = float(self.dcn_s)
            out["bottleneck_link"] = self.bottleneck_link
        return out

    def group_event_fields(self, step: int) -> list[dict]:
        """One `comm_group` telemetry record payload per merge group
        (cross-step rows add the deferred-AG leg's span fields)."""
        out = []
        for g in self.groups:
            fields = {
                "step": int(step),
                "group": g.group,
                "nbytes": int(g.nbytes),
                "comm_s": float(g.comm_s),
                "start_s": float(g.start_s),
                "hidden_s": float(g.hidden_s),
                "exposed_s": float(g.exposed_s),
                "attribution": self.attribution,
            }
            if g.ag_s > 0.0:
                fields["ag_start_s"] = float(g.ag_start_s)
                fields["ag_s"] = float(g.ag_s)
            if g.dcn_s > 0.0:
                fields["ici_s"] = float(g.ici_s)
                fields["dcn_s"] = float(g.dcn_s)
            out.append(fields)
        return out


def _ready_times(groups: Sequence[Sequence[int]], tb: Sequence[float],
                 order: Optional[Sequence[int]]
                 ) -> tuple[list[float], list[int], float]:
    """(each group's ready time, the launch order, the backward's end):
    index order with the cumulative tb of each group's last arrival
    position when ``order`` is None, else the backward replayed along
    ``order`` (a permutation of the groups)."""
    ready = np.cumsum(np.asarray(tb, dtype=np.float64))
    bwd_end = float(ready[-1]) if len(ready) else 0.0
    n = len(groups)
    if order is None:
        return ([float(ready[max(g)]) if len(g) and len(ready) else 0.0
                 for g in groups], list(range(n)), bwd_end)
    order = [int(gi) for gi in order]
    if sorted(order) != list(range(n)):
        raise ValueError(f"launch order {order[:8]}... is not a "
                         f"permutation of the {n} groups")
    at, t = [0.0] * n, 0.0
    if not len(ready):
        return at, order, bwd_end
    for gi in order:
        t += float(sum(float(tb[k]) for k in groups[gi]))
        at[gi] = t
    return at, order, bwd_end


def attribute_overlap(
    groups: Sequence[Sequence[int]],
    tb: Sequence[float],
    comm_s: Sequence[float],
    nbytes: Sequence[int],
    order: Optional[Sequence[int]] = None,
) -> list[GroupOverlap]:
    """Replay the backward/comm timeline and split each group's comm time.

    The recurrence is the solver's (`solver.simulate_groups`, itself the
    reference's taoc recurrence, distributed_optimizer.py:187-192): group
    g's collective starts at max(link free, ready[max(g)]) where ready is
    the cumulative backward profile; the part of [start, start + comm)
    before the backward end is hidden, the rest exposed. Durations may be
    measured (trace) or predicted (cost model); starts are always
    model-replayed — a trace yields per-scope totals, not start offsets.
    ``order`` is the launch sequence the link serves the groups in
    (``_ready_times``); the rows stay in group order.
    """
    if len(groups) != len(comm_s) or len(groups) != len(nbytes):
        raise ValueError(
            f"groups/comm_s/nbytes disagree: {len(groups)}/"
            f"{len(comm_s)}/{len(nbytes)}"
        )
    ready, order, bwd_end = _ready_times(groups, tb, order)
    link_free = 0.0
    out: list[Optional[GroupOverlap]] = [None] * len(groups)
    for gi in order:
        t = float(comm_s[gi])
        start = max(link_free, ready[gi])
        hidden = min(max(bwd_end - start, 0.0), t)
        out[gi] = GroupOverlap(
            group=gi,
            nbytes=int(nbytes[gi]),
            start_s=start,
            comm_s=t,
            hidden_s=hidden,
            exposed_s=t - hidden,
        )
        link_free = start + t
    return out


def attribute_overlap_cross_step(
    groups: Sequence[Sequence[int]],
    tb: Sequence[float],
    tf: Sequence[float],
    rs_s: Sequence[float],
    ag_s: Sequence[float],
    nbytes: Sequence[int],
    order: Optional[Sequence[int]] = None,
    gather_order: Optional[Sequence[int]] = None,
) -> tuple[list[GroupOverlap], float]:
    """The cross-step (rs_fwd_ag) replay: each group's comm splits into a
    deferred all-gather leg racing the FORWARD timeline (issued in
    forward-consumption order — reverse arrival — each gated by its first
    consuming layer's AG deadline) and a reduce-scatter leg racing the
    BACKWARD (the solver's taoc recurrence, offset to the forward's end).
    hidden = AG time inside the forward window + RS time inside the
    backward window; everything else is exposed — the overlap-efficiency
    headline stays honest about which side hid what. All times are
    step-anchored (0 = forward begin), unlike the in-step replay's
    backward anchor; `OverlapSummary.tf_total_s` marks the regime.

    Returns (rows, fwd_end_s): fwd_end_s is where the forward REGION
    actually ends — sum(tf) plus any AG-deadline stall — i.e. where the
    backward the RS starts were computed against begins; renderers must
    anchor the backward there, not at sum(tf).

    ``order`` is the reduce-scatters' launch sequence (``_ready_times``)
    and ``gather_order`` the all-gathers' (reverse group order when
    None); the rows stay in group order."""
    n = len(groups)
    if any(len(x) != n for x in (rs_s, ag_s, nbytes)):
        raise ValueError(
            f"groups/rs_s/ag_s/nbytes disagree: {n}/{len(rs_s)}/"
            f"{len(ag_s)}/{len(nbytes)}"
        )
    if gather_order is None:
        gather_order = list(reversed(range(n)))
    elif sorted(int(gi) for gi in gather_order) != list(range(n)):
        raise ValueError(f"gather order {list(gather_order)[:8]}... is not "
                         f"a permutation of the {n} groups")
    tf_total = float(np.sum(np.asarray(tf, np.float64))) if len(tf) else 0.0
    # forward phase replay (simulate_cross_step's recurrence)
    link = 0.0
    fwd = 0.0
    ag_starts = [0.0] * n
    for gi in gather_order:
        ag_starts[gi] = link
        link += float(ag_s[gi])
        fwd = max(fwd, link) + float(
            sum(tf[i] for i in groups[gi]) if len(tf) else 0.0
        )
    fwd_end = max(fwd, tf_total)
    # backward phase replay, offset to the forward's end; the RS link
    # opens once the AG queue drained (a comm-bound tail can outlive the
    # forward compute)
    ready, order, bwd = _ready_times(groups, tb, order)
    bwd_end = fwd_end + bwd if len(tb) else fwd_end
    link_free = max(link, fwd_end)
    out: list[Optional[GroupOverlap]] = [None] * n
    for gi in order:
        t_ag = float(ag_s[gi])
        t_rs = float(rs_s[gi])
        hidden_ag = min(max(fwd_end - ag_starts[gi], 0.0), t_ag)
        ready_at = (fwd_end + ready[gi] if len(groups[gi]) and len(tb)
                    else fwd_end)
        rs_start = max(link_free, ready_at)
        hidden_rs = min(max(bwd_end - rs_start, 0.0), t_rs)
        out[gi] = GroupOverlap(
            group=gi,
            nbytes=int(nbytes[gi]),
            start_s=rs_start,
            comm_s=t_rs + t_ag,
            hidden_s=hidden_rs + hidden_ag,
            exposed_s=(t_rs - hidden_rs) + (t_ag - hidden_ag),
            ag_start_s=ag_starts[gi],
            ag_s=t_ag,
        )
        link_free = rs_start + t_rs
    return out, fwd_end


def attribute_overlap_two_level(
    groups: Sequence[Sequence[int]],
    dcn_groups: Sequence[Sequence[int]],
    tb: Sequence[float],
    rs_s: Sequence[float],
    dcn_s: Sequence[float],
    ag_s: Sequence[float],
    nbytes: Sequence[int],
    order: Optional[Sequence[int]] = None,
) -> list[GroupOverlap]:
    """The hierarchical (hier) replay: two serial links race the backward
    (`solver.simulate_groups_two_level`'s recurrence). Per inner group the
    ICI link carries its reduce-scatter (taoc recurrence) and — after the
    RS queue drains and its DCN group's cross-slice collective lands —
    its all-gather; the DCN link carries one collective per DCN group
    (`dcn_s`, one entry per DCN group), whose time and hidden share are
    apportioned to member groups by payload. hidden = time inside the
    backward window on EITHER link; the per-row ici_s/dcn_s split is what
    names the bottleneck link. ``order`` is the launch sequence
    (``_ready_times``): the reduce-scatters and the all-gathers follow it,
    and the DCN collectives go in the order it completes their DCN
    groups (DCN-group order when None); the rows stay in group order."""
    n = len(groups)
    if any(len(x) != n for x in (rs_s, ag_s, nbytes)):
        raise ValueError(
            f"groups/rs_s/ag_s/nbytes disagree: {n}/{len(rs_s)}/"
            f"{len(ag_s)}/{len(nbytes)}"
        )
    if len(dcn_s) != len(dcn_groups):
        raise ValueError(
            f"dcn_groups/dcn_s disagree: {len(dcn_groups)}/{len(dcn_s)}"
        )
    dcn_order = list(range(len(dcn_groups)))
    if order is not None:
        at = {int(gi): i for i, gi in enumerate(order)}
        dcn_order.sort(key=lambda di: max(at[gi] for gi in dcn_groups[di]))
    ready, order, bwd_end = _ready_times(groups, tb, order)

    def hidden_in_bwd(start: float, dur: float) -> float:
        return min(max(bwd_end - start, 0.0), dur)

    # ICI link, RS phase
    ici_free = 0.0
    rs_start = [0.0] * n
    rs_done = [0.0] * n
    for gi in order:
        start = max(ici_free, ready[gi])
        rs_start[gi] = start
        ici_free = start + float(rs_s[gi])
        rs_done[gi] = ici_free
    # DCN link: apportion each DCN collective to its members by payload
    dcn_free = 0.0
    dcn_done = [0.0] * n
    g_dcn = [0.0] * n
    g_dcn_hidden = [0.0] * n
    for di in dcn_order:
        d = dcn_groups[di]
        t = float(dcn_s[di])
        start = max(dcn_free, max(rs_done[gi] for gi in d))
        dcn_free = start + t
        hidden = hidden_in_bwd(start, t)
        total_b = float(sum(nbytes[gi] for gi in d)) or 1.0
        for gi in d:
            share = float(nbytes[gi]) / total_b
            dcn_done[gi] = dcn_free
            g_dcn[gi] = t * share
            g_dcn_hidden[gi] = hidden * share
    # ICI link, AG phase
    out: list[Optional[GroupOverlap]] = [None] * n
    for gi in order:
        start = max(ici_free, dcn_done[gi])
        t_ag = float(ag_s[gi])
        ici_free = start + t_ag
        hidden = (
            hidden_in_bwd(rs_start[gi], float(rs_s[gi]))
            + g_dcn_hidden[gi]
            + hidden_in_bwd(start, t_ag)
        )
        comm = float(rs_s[gi]) + g_dcn[gi] + t_ag
        out[gi] = GroupOverlap(
            group=gi,
            nbytes=int(nbytes[gi]),
            start_s=rs_start[gi],
            comm_s=comm,
            hidden_s=hidden,
            exposed_s=comm - hidden,
            ici_s=float(rs_s[gi]) + t_ag,
            dcn_s=g_dcn[gi],
        )
    return out


def group_comm_times(
    reducer,
    cost_model,
    measured: Optional[Sequence[float]] = None,
) -> tuple[list[float], list[int], str]:
    """(seconds per group, bytes per group, attribution) for a reducer:
    ``measured`` (trace-attributed, group order) when it covers every
    group, else the cost model's prediction of each bucket."""
    from mgwfbp_tpu_torch.parallel.solver import effective_cost_fn

    layout = reducer.layout
    nbytes = [
        int(layout.group_sizes[gi]) * int(layout.dtypes[gi].itemsize)
        for gi in range(layout.num_groups)
    ]
    if measured is not None and len(measured) == layout.num_groups:
        return [float(t) for t in measured], nbytes, "trace"
    cost = effective_cost_fn(
        cost_model, getattr(reducer, "comm_op", "all_reduce")
    )
    return [float(cost(b)) for b in nbytes], nbytes, "cost-model"


def summarize(
    reducer,
    cost_model,
    tb: Sequence[float],
    step_s: float,
    measured: Optional[Sequence[float]] = None,
    tf: Optional[Sequence[float]] = None,
    order: Optional[Sequence[int]] = None,
    gather_order: Optional[Sequence[int]] = None,
) -> OverlapSummary:
    """Full overlap accounting for one live schedule regime.

    tb is the arrival-ordered per-layer backward profile (measured, or the
    size prior the solver fell back to); step_s the measured seconds per
    optimizer step the snapshot describes. For a cross-step (rs_fwd_ag)
    reducer, `tf` is the forward profile its deferred-AG legs race
    (defaults to `solver.forward_prior_tf(tb)`); per-group comm — trace
    totals cover BOTH legs of a group's scope — splits between the legs in
    the cost model's phase proportions (`solver.cross_step_phase_costs`).
    ``order`` (the reducer's ``launch_sequence``) and, for rs_fwd_ag,
    ``gather_order`` (its ``gather_sequence``) are the orders the replay
    issues the collectives in; index order (and reverse group order for
    the gathers) when None.
    """
    comm, nbytes, attribution = group_comm_times(
        reducer, cost_model, measured
    )
    comm_op = getattr(reducer, "comm_op", "all_reduce")
    if comm_op == "hier":
        from mgwfbp_tpu_torch.parallel.solver import (
            is_two_level,
            singleton_dcn_groups,
            two_level_leg_costs,
        )

        dcn_part = [
            list(d) for d in getattr(reducer.schedule, "dcn_groups", ())
        ] or singleton_dcn_groups(len(nbytes))
        if is_two_level(cost_model):
            rs_c, dcn_c, ag_c = two_level_leg_costs(cost_model)
        else:
            # a flat model cannot split the links; put everything on the
            # ICI side so the replay still runs (dcn_s = 0 marks the
            # split as unavailable rather than inventing one)
            rs_c = lambda b: 0.5 * float(cost_model.predict(b))  # noqa: E731
            ag_c = lambda b: 0.5 * float(cost_model.predict(b))  # noqa: E731
            dcn_c = lambda b: 0.0  # noqa: E731
        # Per-link pricing. The DCN link runs ONE collective per DCN
        # group over the members' concatenated shards — its cost is
        # dcn_c(sum of member bytes), exactly once (summing per-member
        # predictions would charge the DCN alpha per member, the very
        # overhead merging on DCN exists to avoid — and precisely in the
        # merged regime this accounting describes). ICI legs: TRACE
        # totals sum the mgwfbp_groupNNNN scopes only — the ICI legs
        # (the DCN collectives live under their own mgwfbp_dcngroupNNNN
        # scopes, which per-group attribution does not yet collect) — so
        # a measured t splits across the ICI legs and the DCN leg stays
        # model-priced; without a trace the leg costs price directly.
        dcn_s = [
            float(dcn_c(float(sum(nbytes[gi] for gi in d))))
            for d in dcn_part
        ]
        rs_s, ag_s = [], []
        for t, b in zip(comm, nbytes):
            r, a = rs_c(b), ag_c(b)
            if attribution == "trace":
                tot = max(r + a, 1e-30)
                rs_s.append(t * r / tot)
                ag_s.append(t * a / tot)
            else:
                rs_s.append(float(r))
                ag_s.append(float(a))
        rows = attribute_overlap_two_level(
            reducer.layout.groups, dcn_part, tb, rs_s, dcn_s, ag_s, nbytes,
            order=order,
        )
        return OverlapSummary(
            step_s=float(step_s),
            tb_total_s=float(sum(float(t) for t in tb)),
            groups=tuple(rows),
            attribution=attribution,
        )
    if comm_op == "rs_fwd_ag":
        from mgwfbp_tpu_torch.parallel.solver import (
            cross_step_phase_costs,
            forward_prior_tf,
        )

        if tf is None:
            tf = forward_prior_tf(tb)
        rs_c, ag_c = cross_step_phase_costs(cost_model)
        rs_s, ag_s = [], []
        for t, b in zip(comm, nbytes):
            r, a = rs_c(b), ag_c(b)
            frac = r / max(r + a, 1e-30)
            rs_s.append(t * frac)
            ag_s.append(t * (1.0 - frac))
        rows, fwd_end = attribute_overlap_cross_step(
            reducer.layout.groups, tb, tf, rs_s, ag_s, nbytes,
            order=order, gather_order=gather_order,
        )
        return OverlapSummary(
            step_s=float(step_s),
            tb_total_s=float(sum(float(t) for t in tb)),
            tf_total_s=float(sum(float(t) for t in tf)),
            fwd_end_s=float(fwd_end),
            groups=tuple(rows),
            attribution=attribution,
        )
    rows = attribute_overlap(reducer.layout.groups, tb, comm, nbytes,
                             order=order)
    return OverlapSummary(
        step_s=float(step_s),
        tb_total_s=float(sum(float(t) for t in tb)),
        groups=tuple(rows),
        attribution=attribution,
    )
