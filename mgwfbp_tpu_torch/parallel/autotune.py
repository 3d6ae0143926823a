"""Closed-loop schedule autotuner (counterpart of
``mgwfbp_tpu/parallel/autotune.py``): race candidate schedules on the live
job.

MG-WFBP's schedule is only as good as its inputs, the per-layer backward
times tb and the alpha-beta cost model, and the solver optimises a model of
the step, never the step itself. This module holds the schedule-shaped and
cache-shaped half of the loop that corrects it during the first real
training steps; ``Trainer.autotune`` owns the live half (steps, state,
data, the hot swap):

  1. frontier: ``solver.schedule_frontier`` enumerates the solved
     schedule's neighbourhood (the merge-threshold sweep, one group, the
     per-policy picks) under every lowering the live state permits
     (``allowed_comm_ops``), ``build_candidates`` ranks and caps it and
     keeps the incumbent;
  2. verify: every candidate's first step is observed at the process-group
     level and checked against its reducer
     (``analysis.schedule_check.verify_step_against_reducer``) before it may
     race; a rejected candidate's step is undone;
  3. race: each verified candidate takes warmup + k real training steps,
     the state carried through (``profiling.time_carried_steps``);
  4. refit: the measurements refit alpha/beta/update_beta
     (``costmodel.refit_from_observations``; step-time deltas across the
     raced group counts, ``step_delta_observations``, or per-group trace
     times on one process), and the re-solved schedule joins the race;
  5. commit: the measured argmin is hot-swapped in and persisted in a
     schedule cache keyed by ``cache_key`` (its docstring is the one
     statement of the keyed fields), so later runs skip the search.

The functions here are the JAX package's, letter for letter, and a cache
entry is the same JSON in both packages: each reads the other's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Optional, Sequence

from mgwfbp_tpu_torch.parallel.costmodel import check_schema_version
from mgwfbp_tpu_torch.parallel.solver import (
    LayerSpec,
    effective_cost_fn,
    schedule_frontier,
)

# Version stamp of cache entries (same convention as the calibration
# profiles' schema_version, costmodel.PROFILE_SCHEMA_VERSION — the cache
# reuses that format family and will evolve it independently).
CACHE_SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One schedule the tuner may race: an explicit grouping + lowering.
    hier candidates additionally carry the nested DCN partition."""

    label: str
    groups: tuple[tuple[int, ...], ...]
    comm_op: str
    predicted_total_s: float = float("nan")
    dcn_groups: tuple[tuple[int, ...], ...] = ()


@dataclasses.dataclass
class RaceEntry:
    """Outcome of one candidate's verification + timed steps."""

    label: str
    comm_op: str
    num_groups: int
    verified: bool = False
    measured_step_s: Optional[float] = None
    predicted_total_s: Optional[float] = None
    groups: tuple[tuple[int, ...], ...] = ()
    dcn_groups: tuple[tuple[int, ...], ...] = ()

    def to_json(self) -> dict:
        return {
            "label": self.label,
            "comm_op": self.comm_op,
            "num_groups": self.num_groups,
            "verified": self.verified,
            "measured_step_s": self.measured_step_s,
            "predicted_total_s": self.predicted_total_s,
            "groups": [list(g) for g in self.groups],
            "dcn_groups": [list(d) for d in self.dcn_groups],
        }


def allowed_comm_ops(base: str, multi_slice: bool = False) -> tuple[str, ...]:
    """Lowerings a candidate may race under, given the configured one.

    all_reduce and rs_ag are freely interchangeable (same replicated state,
    numerically identical reduction), so candidates race under both.
    rs_opt_ag owns the device-sharded optimizer state (a different state
    layout per schedule is already handled by the hot-swap seam, but a
    different *optimizer contract* mid-run is not a tuning knob) — it
    races schedule shapes only.

    A run CONFIGURED for the cross-step rs_fwd_ag lowering races against
    the in-step interchangeable pair too: the user already opted into the
    sharded-optimizer contract, the hot-swap seam moves freely between the
    carries (gather to the replicated interchange form, re-scatter), and
    the whole point of the cross-step race is measuring whether deferring
    the gathers actually beats hiding everything behind backward on this
    link. The reverse direction stays off (an all_reduce run never swaps
    INTO the sharded contract uninvited).

    hier needs a multi-slice world (``--dcn-slices`` > 1):
    `multi_slice=True` says the live world has one, and then hier and the
    flat pair race each OTHER in
    both directions — the grads-only lowerings all share the replicated
    state, and whether the explicit hierarchy beats the flat lowering
    on THIS topology is exactly the measured question (the reference's
    10GbE-vs-IB result, asked per deployment). On a single-slice world hier
    candidates cannot even build, so the flat pair stands alone.
    """
    if base in ("all_reduce", "rs_ag"):
        return (
            ("all_reduce", "rs_ag", "hier")
            if multi_slice
            else ("all_reduce", "rs_ag")
        )
    if base == "hier":
        return ("hier", "all_reduce", "rs_ag") if multi_slice else ("hier",)
    if base == "rs_fwd_ag":
        return ("rs_fwd_ag", "all_reduce", "rs_ag")
    return (base,)


def build_candidates(
    specs: Sequence[LayerSpec],
    tb: Sequence[float],
    cost_model,
    comm_ops: Sequence[str],
    *,
    tf: Optional[Sequence[float]] = None,
    max_candidates: int = 6,
    incumbent: Optional[tuple] = None,
) -> list[Candidate]:
    """The candidate frontier: solver picks under each permitted lowering.

    Candidates are ranked by predicted total step time and capped at
    `max_candidates`; the incumbent (the live solved schedule, a
    ``(groups, comm_op)`` or ``(groups, comm_op, dcn_groups)`` tuple) is
    always included — the race must be able to conclude "keep what we
    have".

    tf: arrival-ordered per-layer forward profile for pricing cross-step
    (rs_fwd_ag) candidates — their `simulate_cross_step` totals are
    backward-anchored, so the ranking here compares them directly with the
    in-step lowerings' `simulate_groups` totals (both exclude the sum(tf)
    compute floor every lowering pays identically). Defaults to
    `solver.forward_prior_tf(tb)` when a cross-step op is racing without
    a measured forward profile.
    """
    gamma = float(getattr(cost_model, "gamma", 0.0))
    overlap = float(getattr(cost_model, "overlap", 1.0))
    pack_beta = float(getattr(cost_model, "pack_beta", 0.0))
    sizes = [s.size for s in specs]
    itemsizes = [s.itemsize for s in specs]
    out: list[Candidate] = []
    seen: set[tuple] = set()
    for op in comm_ops:
        if op == "hier":
            # hier candidates come from the TWO-LEVEL frontier: nested
            # (inner, dcn) partition pairs, priced by the two-link
            # simulate — totals backward-anchored and directly comparable
            # with the flat lowerings' simulate_groups totals
            from mgwfbp_tpu_torch.parallel.solver import (
                is_two_level,
                two_level_frontier,
            )

            if not is_two_level(cost_model):
                continue  # no two-link pricing -> nothing solvable to race
            for detail, groups, dcn_part, pred in two_level_frontier(
                sizes, tb, cost_model, itemsizes,
                max_candidates=max(max_candidates, 2),
            ):
                key = (
                    op, tuple(map(tuple, groups)),
                    tuple(map(tuple, dcn_part)),
                )
                if key in seen:
                    continue
                seen.add(key)
                out.append(Candidate(
                    label=f"{op}:{detail}",
                    groups=tuple(tuple(int(i) for i in g) for g in groups),
                    comm_op=op,
                    predicted_total_s=float(pred),
                    dcn_groups=tuple(
                        tuple(int(i) for i in d) for d in dcn_part
                    ),
                ))
            continue
        cost = effective_cost_fn(cost_model, op)
        cross = None
        if op == "rs_fwd_ag":
            from mgwfbp_tpu_torch.parallel.solver import (
                cross_step_phase_costs,
                forward_prior_tf,
            )

            rs_cost, ag_cost = cross_step_phase_costs(cost_model)
            cross = (
                list(tf) if tf is not None else forward_prior_tf(tb),
                rs_cost,
                ag_cost,
            )
            cost = rs_cost  # the scan's link cost at backward time
        for detail, groups, pred in schedule_frontier(
            sizes, tb, cost_model.alpha, cost, itemsizes, gamma=gamma,
            overlap=overlap, pack_beta=pack_beta,
            max_candidates=max(max_candidates, 2),
            cross_step=cross,
        ):
            key = (op, tuple(map(tuple, groups)), ())
            if key in seen:
                continue
            seen.add(key)
            out.append(Candidate(
                label=f"{op}:{detail}",
                groups=tuple(tuple(int(i) for i in g) for g in groups),
                comm_op=op,
                predicted_total_s=float(pred),
            ))
    out.sort(key=lambda c: c.predicted_total_s)
    kept = out[:max_candidates]
    # The race can only refit from step-time deltas when the roster spans
    # MORE THAN ONE group count (autotune.step_delta_observations needs >=2
    # distinct payload sizes), and a mis-calibrated model loves to rank the
    # whole frontier onto one shape — keep the best differently-shaped
    # candidate in the roster even when its prediction ranks it out.
    if len(kept) >= 2 and len({len(c.groups) for c in kept}) < 2:
        alt = next(
            (c for c in out if len(c.groups) != len(kept[0].groups)), None
        )
        if alt is not None:
            kept = kept[:-1] + [alt]
    out = kept
    if incumbent is not None:
        inc_groups = tuple(tuple(int(i) for i in g) for g in incumbent[0])
        inc_dcn = tuple(
            tuple(int(i) for i in d)
            for d in (incumbent[2] if len(incumbent) > 2 else ())
        )
        key = (incumbent[1], inc_groups, inc_dcn)
        if key not in {(c.comm_op, c.groups, c.dcn_groups) for c in out}:
            inc = Candidate(
                label=f"{incumbent[1]}:incumbent",
                groups=inc_groups,
                comm_op=incumbent[1],
                dcn_groups=inc_dcn,
            )
            if len(out) >= max_candidates and len(out) > 1:
                # make room WITHOUT collapsing group-count diversity: drop
                # the worst-predicted entry whose group count another
                # remaining candidate (or the incumbent) still covers —
                # never the sole representative of a shape
                counts = [len(c.groups) for c in out] + [len(inc.groups)]
                drop = len(out) - 1
                for i in range(len(out) - 1, -1, -1):
                    if counts.count(counts[i]) > 1:
                        drop = i
                        break
                out = out[:drop] + out[drop + 1:]
            out = [inc] + out
    return out


def step_delta_observations(
    entries: Sequence[RaceEntry], total_bytes: float, tb_total_s: float
) -> list[tuple[float, float]]:
    """Pseudo per-collective (bytes, seconds) observations from whole-step
    timings — the refit's fallback when the profiler trace attributes
    nothing (no collective kernel in a group's range, e.g. the CPU), or
    where it is not used (several processes: the agreed entry times are
    identical on every process, per-process traces are not).

    For a raced schedule of n groups over the model's constant total_bytes,
    the comm + per-group-overhead share of its measured step is
    ~(measured - tb_total); split evenly over its n collectives that yields
    one sample at payload total_bytes/n. Schedules with different group
    counts then populate the payload axis, and `fit_alpha_beta` recovers a
    per-collective fixed cost (alpha + gamma) and a per-byte rate. Coarse
    by construction — it assumes the serialized timeline (overlap ~ 0,
    the CPU regime); on platforms that hide comm well the trace path
    should win.
    """
    obs: list[tuple[float, float]] = []
    for e in entries:
        if e.measured_step_s is None or e.num_groups <= 0:
            continue
        comm = e.measured_step_s - tb_total_s
        if comm <= 0.0:
            continue
        obs.append((total_bytes / e.num_groups, comm / e.num_groups))
    if len({round(b) for b, _ in obs}) < 2:
        return []  # fit needs >= 2 distinct payload sizes
    return obs


def model_summary(model) -> dict:
    """The scalar cost-model fields a refit can move (cache provenance).
    Two-level models additionally record each link's constants — a
    per-link refit is invisible in the aggregate scalars (TwoLevelAlphaBeta
    has no flat beta at all)."""
    out = {
        "alpha": float(getattr(model, "alpha", 0.0)),
        "beta": float(getattr(model, "beta", 0.0)),
        "gamma": float(getattr(model, "gamma", 0.0)),
        "overlap": float(getattr(model, "overlap", 1.0)),
        "pack_beta": float(getattr(model, "pack_beta", 0.0)),
        "update_beta": float(getattr(model, "update_beta", 0.0)),
    }
    if hasattr(model, "ici") and hasattr(model, "dcn"):
        for link in ("ici", "dcn"):
            m = getattr(model, link)
            out[link] = {
                "alpha": float(getattr(m, "alpha", 0.0)),
                "beta": float(getattr(m, "beta", 0.0)),
                "gamma": float(getattr(m, "gamma", 0.0)),
            }
    return out


# ---------------------------------------------------------------------------
# Schedule cache: committed winners, keyed by `cache_key` (its docstring
# is the single authoritative statement of the keyed fields).
# ---------------------------------------------------------------------------


def _safe(token) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "-", str(token))


def cache_key(
    model: str,
    world: int,
    comm_op: str,
    dtype,
    comm_dtype=None,
    compressor: Optional[str] = None,
    density: Optional[float] = None,
    batch_size: Optional[int] = None,
    nsteps_update: Optional[int] = None,
    dcn_slices: Optional[int] = None,
) -> str:
    """Filename-safe cache key — THE single authoritative statement of
    what a committed schedule is keyed by (README/ROADMAP refer here
    instead of restating it).

    The key is, in filename order:

      * ``model`` — the architecture (its layer set also rides inside the
        entry and is re-validated on load);
      * ``world`` — the data-parallel world size (changes the alpha-beta
        cost constants);
      * ``comm_op`` — the bucket lowering (changes the collective
        contract);
      * ``dtype`` — the compute/param dtype;
      * ``batch_size`` (``_b<N>``) and, when > 1, ``nsteps_update``
        (``_acc<N>``) — the per-device batch and accumulation depth scale
        tb, which moves the compute/comm balance the grouping was tuned
        for;
      * when set: ``comm_dtype`` (``_wire-<dtype>``) and
        ``compressor``/``density`` — they change the wire bytes the race
        optimized for (a winner tuned at bf16 wire or 1% density must not
        be served to an f32 dense run);
      * ``dcn_slices`` (``_dcn<N>``, when > 1) — the multi-slice world
        shape: the same world split (4,2) vs (2,4) prices both links
        differently and a hier winner's nested partition describes one
        topology only.

    These are exactly the fields a schedule is NOT portable across;
    everything else (seed, logdir, epochs, ...) is deliberately excluded.
    """
    key = f"{_safe(model)}_w{int(world)}_{_safe(comm_op)}_{_safe(dtype)}"
    if dcn_slices is not None and int(dcn_slices) > 1:
        key += f"_dcn{int(dcn_slices)}"
    if batch_size is not None:
        key += f"_b{int(batch_size)}"
    if nsteps_update is not None and int(nsteps_update) > 1:
        key += f"_acc{int(nsteps_update)}"
    if comm_dtype is not None:
        key += f"_wire-{_safe(comm_dtype)}"
    if compressor not in (None, "", "none"):
        key += f"_{_safe(compressor)}-{_safe(density)}"
    return key


def entry_path(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, key + ".json")


def load_cache_entry(path: str) -> Optional[dict]:
    """Committed cache entry at `path`, or None when absent. Rejects
    unknown schema versions with a clear error instead of silently racing
    a stale format into the live job."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        d = json.load(f)
    check_schema_version(
        d, path=path, supported=(CACHE_SCHEMA_VERSION,),
        what="schedule-cache entry",
    )
    return d


def save_cache_entry(path: str, entry: dict) -> None:
    """Persist a committed schedule (atomic replace: a crashed run must not
    leave a truncated entry a later run would fail to parse)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    doc = dict(entry)
    doc["schema_version"] = CACHE_SCHEMA_VERSION
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)
