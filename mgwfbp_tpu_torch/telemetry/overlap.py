"""Overlap accounting: exposed against hidden communication (a copy of the
single-level part of ``mgwfbp_tpu/telemetry/overlap.py``).

MG-WFBP's headline quantity: how much all-reduce time hides behind the
backward pass. ``attribute_overlap`` replays the timeline the solver
reasons about (gradient-ready times from the per-layer backward profile
tb, one serial link occupied by the merge groups in group order) and
splits every group's communication into **hidden** (while the backward
still runs) and **exposed** (on the step's critical path). Efficiency is
hidden / total communication.

Per-group durations come from a trace (``profiling.trace_group_times``:
``attribution`` "trace") or, where the trace attributes nothing, from the
cost model (``solver.effective_cost_fn``: "cost-model"). Starts are always
replayed from tb in the arrival permutation's order, which for ResNet-20
places the stem among the first arrivals although its hooks fire last
(ROADMAP.md Queue 3): the replayed hidden share can overstate what the
strict launch order allows. The reducer's ``comm_op`` prices each group
(``all_reduce`` and ``rs_ag`` by the collective, ``rs_opt_ag`` with its
shard update's ``update_beta`` term). The cross-step and two-level replays
are ROADMAP.md Queue 1 item 7b. Everything here is host arithmetic on
host data: no device synchronisation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class GroupOverlap:
    """One merge group's share of the replayed step timeline."""

    group: int  # group index (launch order)
    nbytes: int  # bucket payload
    start_s: float  # replayed start: max(link free, ready[last member])
    comm_s: float  # collective duration (traced or predicted)
    hidden_s: float  # the part that overlaps the backward
    exposed_s: float  # the part on the critical path


@dataclasses.dataclass(frozen=True)
class OverlapSummary:
    """Per-step overlap accounting for one schedule."""

    step_s: float  # measured seconds per optimizer step
    tb_total_s: float  # backward compute (sum of tb)
    groups: tuple[GroupOverlap, ...]
    attribution: str  # 'trace' | 'cost-model'
    # the cross-step regime's forward fields; 0 in the flat regime, kept
    # so the records carry the JAX package's keys
    tf_total_s: float = 0.0
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
        """hidden / total comm; a step without communication is fully
        hidden."""
        total = self.comm_s
        if total <= 0.0:
            return 1.0
        return self.hidden_s / total

    @property
    def timeline_end_s(self) -> float:
        """End of the replayed compute + comm timeline."""
        last_comm = max((g.start_s + g.comm_s for g in self.groups),
                        default=0.0)
        fwd = max(self.fwd_end_s, self.tf_total_s)
        return max(fwd + self.tb_total_s, last_comm)

    def to_event_fields(self) -> dict:
        """The ``overlap`` telemetry record's payload."""
        return {
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

    def group_event_fields(self, step: int) -> list[dict]:
        """One ``comm_group`` record payload per merge group."""
        return [{
            "step": int(step),
            "group": g.group,
            "nbytes": int(g.nbytes),
            "comm_s": float(g.comm_s),
            "start_s": float(g.start_s),
            "hidden_s": float(g.hidden_s),
            "exposed_s": float(g.exposed_s),
            "attribution": self.attribution,
        } for g in self.groups]


def attribute_overlap(
    groups: Sequence[Sequence[int]],
    tb: Sequence[float],
    comm_s: Sequence[float],
    nbytes: Sequence[int],
) -> list[GroupOverlap]:
    """Replay the backward/comm timeline (the solver's recurrence, as in
    ``solver.simulate_groups``): group g starts at max(link free,
    ready[max(g)]); the part of [start, start + comm) before the backward
    ends is hidden, the rest exposed."""
    if len(groups) != len(comm_s) or len(groups) != len(nbytes):
        raise ValueError(
            f"groups/comm_s/nbytes disagree: {len(groups)}/"
            f"{len(comm_s)}/{len(nbytes)}"
        )
    ready = np.cumsum(np.asarray(tb, dtype=np.float64))
    bwd_end = float(ready[-1]) if len(ready) else 0.0
    link_free = 0.0
    out: list[GroupOverlap] = []
    for gi, g in enumerate(groups):
        t = float(comm_s[gi])
        ready_at = float(ready[max(g)]) if len(g) and len(ready) else 0.0
        start = max(link_free, ready_at)
        hidden = min(max(bwd_end - start, 0.0), t)
        out.append(GroupOverlap(
            group=gi, nbytes=int(nbytes[gi]), start_s=start, comm_s=t,
            hidden_s=hidden, exposed_s=t - hidden,
        ))
        link_free = start + t
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
) -> OverlapSummary:
    """Overlap accounting for a live reducer: tb is the arrival-ordered
    backward profile the schedule was solved on, ``step_s`` the measured
    seconds per optimizer step."""
    comm, nbytes, attribution = group_comm_times(reducer, cost_model, measured)
    rows = attribute_overlap(reducer.layout.groups, tb, comm, nbytes)
    return OverlapSummary(
        step_s=float(step_s),
        tb_total_s=float(sum(float(t) for t in tb)),
        groups=tuple(rows),
        attribution=attribution,
    )
