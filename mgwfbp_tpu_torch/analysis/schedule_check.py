"""Does a live step realize its merge schedule? (the port's counterpart of
``mgwfbp_tpu/analysis/jaxpr_check.py``, ``verify_jaxpr_against_reducer``).

The JAX verifier traces the jitted step on abstract inputs and reads its
collectives from the program. A torch step has no program to read, so
this module observes one real step instead, at the process-group level:
``CollectiveObserver`` wraps the collective methods of
``torch.distributed.ProcessGroup`` (all_reduce, reduce-scatter,
all-gather, broadcast, ...) for as long as it is armed, so it sees every
collective of the step, on whatever thread issued it (on the card the
gradient hooks run on autograd's device thread), whoever issued it. Each
record holds the collective's kind, its input payload (elements and
dtype), the ranks of its process group and the ranges open on the issuing
thread (``parallel.allreduce.collective_scope``: the reducer's
``mgwfbp_groupNNNN`` and ``mgwfbp_dcngroupNNNN`` ranges, the rs_opt_ag
clip's ``sharded_clip_norm``, the train step's ``metrics_reduce``,
``bstats_reduce`` and ``flat_grad_reduce``), which play the part of the
JAX program's name scopes. The reducer's own counters are not read: a
collective it did not issue is seen all the same.

``check_collectives`` then holds the records against the reducer that
built the step, under the JAX rule ids (``analysis.rules``):

  SCH003  the bucket layout covers every gradient leaf exactly once, with
          dtype-homogeneous groups and consistent offsets, and has as many
          groups as the schedule;
  SCH001  every group's range holds the lowering's collectives, and
          exactly as many groups issue them as the layout has:
          all_reduce one all-reduce per group; rs_ag one reduce-scatter
          and one all-gather; rs_opt_ag one reduce-scatter and one
          all-gather (the updated shard); rs_fwd_ag one reduce-scatter in
          the step and its all-gather in the next forward (the observed
          window runs ``reducer.materialize()`` after the step); hier one
          inner reduce-scatter and one inner all-gather per group; top-k
          its two all-gathers (values and indices), or one all-reduce where
          the group keeps every entry;
  SCH007  each collective carries the group's element count (padded to
          the world, or to the slice, on the reduce-scatter lowerings; the
          1/world shard on a parameter all-gather);
  SCH002  ... at the wire dtype (``comm_dtype``, else the bucket's); a
          parameter all-gather at the bucket dtype;
  SCH004  no collective outside the declared ranges, none other than the
          lowering's inside a group's, the clip range only on rs_opt_ag
          and rs_fwd_ag with exactly one all-reduce when the optimizer
          clips, and on rs_fwd_ag no all-gather after the group's
          reduce-scatter inside the step (the deferral degenerated into
          the in-step rs_opt_ag shape);
  SCH009  the hier contract: the group legs ride the slice's group (no
          cross-slice collective in a group's range), each DCN group one
          all-reduce over the cross-slice group moving its members'
          concatenated shards at the wire dtype, and no DCN range on
          another lowering.

The rules the JAX verifier reads off a traced program's host callbacks,
donated buffers and guard are held on the same observed step by
``HostObserver``, armed for the same window: a ``TorchDispatchMode`` (which
autograd's thread-local state carries onto the thread that runs the
gradient hooks on the card) records every ``aten._local_scalar_dense`` and
every synchronous device-to-host ``_to_copy`` / ``copy_`` (``.item()``,
``float(t)``, ``if t:``, ``.cpu()`` of a card tensor), and
``Tensor.tolist`` / ``Tensor.numpy`` (which dispatch nothing on a CPU
tensor) and ``isfinite`` (composite: below the Python dispatch key it is
abs/ne/eq) are wrapped for the window, each record with the ranges open on
its thread:

  SCH005  no host synchronisation inside the observed step: the step
          decides its guard on the device and returns its metrics there
          (``train.step``), and the trainer reads them late, outside it;
  SCH006  the storages (``untyped_storage().data_ptr()``) of every
          parameter and module buffer, every optimizer state tensor,
          ``TrainStep.buffers`` and the sharded lowerings' optimizer slots
          and carried parameter shards are the same before and after the
          step (the counterpart of donation: state updated in place);
  SCH008  a ``grad_guard=True`` step calls ``isfinite`` inside its
          ``finite_check`` range, a ``grad_guard=False`` step does not;
  SCH010  (``compare_footprints``) the same step with the health
          statistics on issues the same collectives by kind and the same
          number of host synchronisations as with them off.

``verify_step_against_reducer(run_step, reducer, leaves)`` observes
``run_step()`` and checks the collectives; ``verify_observed_step`` adds
the host-side rules of its ``TrainStep``. Observing runs the step for
real; the autotuner (``Trainer._verify_live_step``) undoes the step of a
candidate the collective check rejects.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from mgwfbp_tpu_torch.analysis.rules import Finding
from mgwfbp_tpu_torch.parallel import buckets as buckets_lib
from mgwfbp_tpu_torch.train.step import FINITE_CHECK_SCOPE
from mgwfbp_tpu_torch.parallel.allreduce import (
    CLIP_NORM_SCOPE,
    DCN_GROUP_SCOPE_PREFIX,
    GROUP_SCOPE_PREFIX,
    SHARDED_OPS,
    open_scopes,
    watch_scopes,
)

# ranges the train step declares for its own collectives (the JAX
# verifier's DEFAULT_ALLOWED_SCOPES); anything else collective-shaped must
# sit in a merge group's range
DEFAULT_ALLOWED_SCOPES = (
    "metrics_reduce", "bstats_reduce", "flat_grad_reduce",
    CLIP_NORM_SCOPE, "runtime_coord",
)

# ProcessGroup method -> (kind, position of its input argument; None: no
# payload). Methods a torch release lacks are skipped.
_METHODS = {
    "allreduce": ("all_reduce", 0),
    "allreduce_coalesced": ("all_reduce", 0),
    "reduce": ("reduce", 0),
    "broadcast": ("broadcast", 0),
    "allgather": ("all_gather", 1),
    "_allgather_base": ("all_gather", 1),
    "all_gather_single": ("all_gather", 1),
    "allgather_coalesced": ("all_gather", 1),
    "allgather_into_tensor_coalesced": ("all_gather", 1),
    "all_gather_single_coalesced": ("all_gather", 1),
    "reduce_scatter": ("reduce_scatter", 1),
    "_reduce_scatter_base": ("reduce_scatter", 1),
    "reduce_scatter_single": ("reduce_scatter", 1),
    "reduce_scatter_tensor_coalesced": ("reduce_scatter", 1),
    "reduce_scatter_single_coalesced": ("reduce_scatter", 1),
    "alltoall": ("all_to_all", 1),
    "alltoall_base": ("all_to_all", 1),
    "all_to_all_single": ("all_to_all", 1),
    "gather": ("gather", 1),
    "scatter": ("scatter", 1),
    "send": ("send", 0),
    "recv": ("recv", 0),
    "recv_anysource": ("recv", 0),
    "barrier": ("barrier", None),
    "monitored_barrier": ("barrier", None),
}


@dataclasses.dataclass(frozen=True)
class Collective:
    """One observed collective: its kind (``all_reduce``,
    ``reduce_scatter``, ``all_gather``, ...), its input payload (elements,
    dtype of the first input tensor; 0 and None without one), the ranks of
    its process group, the ranges open on the issuing thread (outermost
    first), the window's phase (``step``, or ``next`` for what runs after
    the step) and the issuing thread's name."""

    kind: str
    numel: int
    dtype: Optional[torch.dtype]
    ranks: tuple[int, ...]
    scopes: tuple[str, ...]
    phase: str = "step"
    thread: str = ""


def _tensors(arg) -> list[torch.Tensor]:
    if isinstance(arg, torch.Tensor):
        return [arg]
    if isinstance(arg, (list, tuple)):
        return [t for a in arg for t in _tensors(a)]
    return []


def _ranks(pg) -> tuple[int, ...]:
    try:
        return tuple(int(r) for r in dist.get_process_group_ranks(pg))
    except Exception:  # noqa: BLE001 — a group torch.distributed does not
        # track (a backend's private one) has no rank list to report
        return ()


_ACTIVE_LOCK = threading.Lock()
_active: list = []


class CollectiveObserver:
    """Record every collective issued through a ``ProcessGroup`` while
    armed (a context manager; one at a time per process). ``phase`` names
    the part of the window the following records belong to."""

    def __init__(self):
        self.records: list[Collective] = []
        self.phase = "step"
        self._saved: dict[str, Any] = {}
        self._watch = None

    def _wrap(self, name: str, orig, kind: str, pos: Optional[int]):
        observer = self

        def observed(pg, *args, **kwargs):
            ins = (_tensors(args[pos]) if pos is not None and len(args) > pos
                   else [])
            observer.records.append(Collective(
                kind=kind,
                numel=sum(int(t.numel()) for t in ins),
                dtype=ins[0].dtype if ins else None,
                ranks=_ranks(pg),
                scopes=open_scopes(),
                phase=observer.phase,
                thread=threading.current_thread().name,
            ))
            return orig(pg, *args, **kwargs)

        observed.__name__ = name
        return observed

    def __enter__(self) -> "CollectiveObserver":
        with _ACTIVE_LOCK:
            if any(isinstance(a, CollectiveObserver) for a in _active):
                raise RuntimeError("a CollectiveObserver is already armed "
                                   "in this process")
            _active.append(self)
        pg_cls = dist.ProcessGroup
        for name, (kind, pos) in _METHODS.items():
            orig = pg_cls.__dict__.get(name)
            if orig is None:
                continue
            self._saved[name] = orig
            setattr(pg_cls, name, self._wrap(name, orig, kind, pos))
        self._watch = watch_scopes()
        self._watch.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._watch.__exit__(*exc)
        for name, orig in self._saved.items():
            setattr(dist.ProcessGroup, name, orig)
        self._saved = {}
        with _ACTIVE_LOCK:
            _active.remove(self)
        return False


# -- the checks ---------------------------------------------------------------


def layout_problems(layout, leaves: Sequence[Any]) -> list[str]:
    """Structural invariants of a bucket layout against ``leaves`` (arrival
    order; anything with ``shape`` and ``dtype``), the JAX package's
    ``BucketLayout.validate``: every leaf in exactly one group, each group
    of one dtype, offsets and sizes matching the members' element
    counts (the JAX messages)."""
    problems: list[str] = []
    seen: dict[int, int] = {}
    for gi, members in enumerate(layout.groups):
        if len(layout.offsets[gi]) != len(members):
            problems.append(f"group {gi} has {len(members)} members but "
                            f"{len(layout.offsets[gi])} offsets")
            continue
        acc = 0
        for slot, idx in enumerate(members):
            if idx in seen:
                problems.append(f"leaf {idx} in groups {seen[idx]} and {gi}")
            seen[idx] = gi
            if not 0 <= idx < len(leaves):
                problems.append(f"group {gi} references leaf {idx} outside "
                                f"[0, {len(leaves)})")
                continue
            if leaves[idx].dtype != layout.dtypes[gi]:
                problems.append(
                    f"group {gi} dtype {_name(layout.dtypes[gi])} != member "
                    f"leaf {idx} dtype {_name(leaves[idx].dtype)}")
            if layout.offsets[gi][slot] != acc:
                problems.append(f"group {gi} member {idx}: offset "
                                f"{layout.offsets[gi][slot]} != expected "
                                f"{acc}")
            acc += buckets_lib._numel(leaves[idx].shape)
        if acc != layout.group_sizes[gi]:
            problems.append(f"group {gi} size {layout.group_sizes[gi]} != "
                            f"member element total {acc}")
    missing = sorted(set(range(len(leaves))) - set(seen))
    if missing:
        problems.append(f"leaves {missing} belong to no group")
    return problems


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _scope_index(scopes: tuple[str, ...], prefix: str) -> Optional[int]:
    """The index of the innermost range named ``<prefix>NNNN``, if any."""
    for s in reversed(scopes):
        if s.startswith(prefix) and s[len(prefix):].isdigit():
            return int(s[len(prefix):])
    return None


def classify(records: Sequence[Collective]) -> dict[str, Any]:
    """{"groups": {gi: [records]}, "dcn_groups": {di: [records]},
    "allowed": [...], "stray": [...]} by the ranges each record was issued
    in (a DCN group's range before a group's, as the JAX verifier)."""
    groups: dict[int, list] = {}
    dcn: dict[int, list] = {}
    allowed: list = []
    stray: list = []
    for r in records:
        di = _scope_index(r.scopes, DCN_GROUP_SCOPE_PREFIX)
        gi = _scope_index(r.scopes, GROUP_SCOPE_PREFIX)
        if di is not None:
            dcn.setdefault(di, []).append(r)
        elif gi is not None:
            groups.setdefault(gi, []).append(r)
        elif any(s in DEFAULT_ALLOWED_SCOPES for s in r.scopes):
            allowed.append(r)
        else:
            stray.append(r)
    return {"groups": groups, "dcn_groups": dcn, "allowed": allowed,
            "stray": stray}


def _wire(reducer, gi: int):
    comm = getattr(reducer, "comm_dtype", None)
    return comm if comm is not None else reducer.layout.dtypes[gi]


def _split(recs: list, kinds: Sequence[str]):
    """(records of each kind in ``kinds``, the rest)."""
    by = [[r for r in recs if r.kind == k] for k in kinds]
    rest = [r for r in recs if r.kind not in kinds]
    return by, rest


def _check_payload(add, what: str, rec: Collective, numel: int, dtype,
                   leg: str) -> None:
    if rec.numel != numel:
        add("SCH007", f"{what}: {leg} moves {rec.numel} elements, the "
                      f"layout says {numel}")
    if rec.dtype != dtype:
        add("SCH002", f"{what}: {leg} runs at dtype {_name(rec.dtype)}, "
                      f"the wire dtype is {_name(dtype)}")


def _check_dense_group(reducer, gi: int, recs: list, add) -> None:
    """all_reduce: one all-reduce of the group's bucket at the wire dtype;
    with a sparsifying compressor, the two all-gathers of its top-k values
    and indices (or one all-reduce where k reaches the bucket)."""
    n = reducer.layout.group_sizes[gi]
    wire = _wire(reducer, gi)
    if getattr(reducer, "sparse", False):
        (ars, ags), rest = _split(recs, ("all_reduce", "all_gather"))
        if len(ars) == 1 and not ags:
            _check_payload(add, f"group {gi}", ars[0], n, wire, "all-reduce")
        elif len(ags) == 2 and not ars:
            vals, idx = ags
            if vals.dtype != wire:
                add("SCH002", f"group {gi}: top-k values gather at dtype "
                              f"{_name(vals.dtype)}, wire dtype is "
                              f"{_name(wire)}")
            if idx.dtype is None or idx.dtype.is_floating_point:
                add("SCH002", f"group {gi}: top-k index gather at dtype "
                              f"{_name(idx.dtype)}, not an integer dtype")
            if vals.numel != idx.numel or vals.numel > n:
                add("SCH007", f"group {gi}: top-k gathers move "
                              f"{vals.numel} values and {idx.numel} indices "
                              f"of a {n}-element bucket")
        else:
            add("SCH001", f"top-k group {gi}: expected 2 all-gathers (or 1 "
                          f"all-reduce) under its range, found "
                          f"{[r.kind for r in recs]}")
            return
        for r in rest:
            add("SCH004", f"group {gi}: unexpected '{r.kind}' in the group "
                          "range")
        return
    (ars,), rest = _split(recs, ("all_reduce",))
    if len(ars) != 1:
        add("SCH001", f"group {gi}: expected 1 all-reduce under its range, "
                      f"found {len(ars)}")
    for r in rest:
        add("SCH004", f"group {gi}: unexpected '{r.kind}' in the group range")
    if ars:
        _check_payload(add, f"group {gi}", ars[0], n, wire, "all-reduce")


def _check_rs_group(reducer, gi: int, recs: list, add) -> None:
    """rs_ag: one reduce-scatter of the padded bucket and one all-gather of
    the summed shard back, both at the wire dtype, in that order;
    rs_opt_ag: the all-gather moves the updated parameter shard at the
    bucket dtype."""
    op = reducer.comm_op
    world = reducer.world
    padded = buckets_lib.padded_group_size(reducer.layout, gi, world)
    wire = _wire(reducer, gi)
    (rss, ags), rest = _split(recs, ("reduce_scatter", "all_gather"))
    if len(rss) != 1 or len(ags) != 1:
        add("SCH001", f"{op} group {gi}: expected exactly 1 reduce-scatter "
                      f"+ 1 all-gather under its range, found {len(rss)} "
                      f"reduction(s) + {len(ags)} gather(s)")
        return
    for r in rest:
        add("SCH004", f"{op} group {gi}: unexpected '{r.kind}' in the group "
                      "range")
    rs, ag = rss[0], ags[0]
    if recs.index(ag) < recs.index(rs):
        add("SCH004", f"{op} group {gi}: the all-gather precedes the "
                      "reduce-scatter")
    _check_payload(add, f"{op} group {gi}", rs, padded, wire,
                   "reduce-scatter")
    ag_dtype = reducer.layout.dtypes[gi] if op == "rs_opt_ag" else wire
    _check_payload(add, f"{op} group {gi}", ag, padded // world, ag_dtype,
                   "all-gather")


def _check_rs_fwd_ag_group(reducer, gi: int, recs: list, add) -> None:
    """rs_fwd_ag, per step: one reduce-scatter of the padded bucket at the
    wire dtype in the step and, in the next forward, one all-gather of the
    carried shard at the bucket dtype. An all-gather inside the step may
    only precede the reduce-scatter (the previous update's gather landing
    in this forward); one after it means the gather was not deferred."""
    world = reducer.world
    padded = buckets_lib.padded_group_size(reducer.layout, gi, world)
    step = [r for r in recs if r.phase == "step"]
    nxt = [r for r in recs if r.phase != "step"]
    (rss, step_ags), rest = _split(step, ("reduce_scatter", "all_gather"))
    (next_ags,), next_rest = _split(nxt, ("all_gather",))
    if len(rss) != 1 or len(next_ags) != 1:
        add("SCH001", f"rs_fwd_ag group {gi}: expected 1 reduce-scatter in "
                      f"the step + 1 all-gather in the next forward, found "
                      f"{len(rss)} reduction(s) + {len(next_ags)} "
                      "gather(s)")
        return
    for r in rest + next_rest:
        add("SCH004", f"rs_fwd_ag group {gi}: unexpected '{r.kind}' in the "
                      "group range")
    rs = rss[0]
    late = [a for a in step_ags if step.index(a) > step.index(rs)]
    if late or len(step_ags) > 1:
        add("SCH004", f"rs_fwd_ag group {gi}: an all-gather follows the "
                      "reduce-scatter inside the step: the gather was NOT "
                      "deferred across the step boundary (this is the "
                      "in-step rs_opt_ag shape)")
    _check_payload(add, f"rs_fwd_ag group {gi}", rs, padded,
                   _wire(reducer, gi), "reduce-scatter")
    for ag in step_ags[:1] + next_ags:
        _check_payload(add, f"rs_fwd_ag group {gi}", ag, padded // world,
                       reducer.layout.dtypes[gi], "all-gather")


def _hier_ranks(reducer) -> tuple[tuple[int, ...], tuple[int, ...]]:
    levels = reducer.levels
    return _ranks(levels.inner), _ranks(levels.outer)


def _check_hier_group(reducer, gi: int, recs: list, add) -> Optional[int]:
    """hier, per group: one reduce-scatter of the bucket padded to the
    slice, then one all-gather of the slice shard, both over the slice's
    group at the wire dtype. Returns the shard's element count (the DCN
    contract's unit), None when the shape is too broken to measure."""
    inner, _ = _hier_ranks(reducer)
    for r in recs:
        if r.ranks != inner:
            add("SCH009", f"hier group {gi}: '{r.kind}' over ranks "
                          f"{list(r.ranks)} inside a group range, the inner "
                          f"legs ride the slice {list(inner)} only: "
                          "cross-slice traffic belongs under "
                          "mgwfbp_dcngroupNNNN")
    (rss, ags), rest = _split(recs, ("reduce_scatter", "all_gather"))
    if len(rss) != 1 or len(ags) != 1:
        add("SCH001", f"hier group {gi}: expected exactly 1 reduce-scatter "
                      f"+ 1 all-gather under its range, found {len(rss)} "
                      f"reduction(s) + {len(ags)} gather(s)")
        return None
    for r in rest:
        add("SCH004", f"hier group {gi}: unexpected '{r.kind}' in the group "
                      "range")
    rs, ag = rss[0], ags[0]
    if recs.index(ag) < recs.index(rs):
        add("SCH009", f"hier group {gi}: the all-gather precedes the "
                      "reduce-scatter: the inner RS -> outer AR -> inner AG "
                      "leg order degenerated")
    ici = reducer.levels.ici
    n = reducer.layout.group_sizes[gi]
    padded = n + (-n) % ici
    wire = _wire(reducer, gi)
    _check_payload(add, f"hier group {gi}", rs, padded, wire,
                   "reduce-scatter")
    _check_payload(add, f"hier group {gi}", ag, padded // ici, wire,
                   "all-gather")
    return padded // ici


def _check_hier_dcn(reducer, dcn_recs: dict, shard_elems: dict, add) -> None:
    """hier's cross-slice contract: the outer partition covers every group
    once, and each DCN group issues exactly one all-reduce over the
    cross-slice group moving its members' concatenated shards at the wire
    dtype."""
    from mgwfbp_tpu_torch.parallel.solver import check_dcn_partition

    layout = reducer.layout
    inner, outer = _hier_ranks(reducer)
    part = [list(d) for d in reducer.dcn_groups] or [
        [gi] for gi in range(layout.num_groups)]
    try:
        check_dcn_partition(part, layout.num_groups)
    except ValueError as e:
        add("SCH009", f"hier: {e}")
        return
    if sorted(dcn_recs) != list(range(len(part))):
        add("SCH009", f"hier: the step issues DCN collectives for ranges "
                      f"{sorted(dcn_recs)}, the nested schedule promises "
                      f"{len(part)} DCN group(s)")
        return
    for di, members in enumerate(part):
        recs = dcn_recs[di]
        if len(recs) != 1 or recs[0].kind != "all_reduce":
            add("SCH009", f"hier dcn group {di}: expected exactly 1 "
                          "cross-slice all-reduce under its range, found "
                          f"{[r.kind for r in recs]}")
            continue
        r = recs[0]
        if r.ranks != outer:
            add("SCH009", f"hier dcn group {di}: all-reduce runs over ranks "
                          f"{list(r.ranks)}, the cross-slice leg must ride "
                          f"{list(outer)} only")
        if all(shard_elems.get(gi) for gi in members):
            want = sum(shard_elems[gi] for gi in members)
            if r.numel != want:
                add("SCH009", f"hier dcn group {di}: cross-slice all-reduce "
                              f"moves {r.numel} elements, members {members} "
                              f"shard to {want}")
        dtypes = {_wire(reducer, gi) for gi in members}
        if len(dtypes) == 1 and r.dtype != next(iter(dtypes)):
            add("SCH009", f"hier dcn group {di}: cross-slice all-reduce runs "
                          f"at dtype {_name(r.dtype)}, wire dtype is "
                          f"{_name(next(iter(dtypes)))}")


def check_collectives(
    records: Sequence[Collective],
    reducer,
    grad_leaves: Sequence[Any],
    *,
    file: str = "<observed step>",
) -> list[Finding]:
    """The findings of one observed step's collectives against the reducer
    that issued it (module docstring). ``grad_leaves``: the gradient
    leaves (or the parameters) in arrival order, ``[leaves[j] for j in
    reducer.perm]``."""
    layout = reducer.layout
    out: list[Finding] = []

    def add(rule_id: str, msg: str) -> None:
        out.append(Finding(file, 0, rule_id, msg))

    for problem in layout_problems(layout, grad_leaves):
        add("SCH003", problem)
    if layout.num_groups != reducer.schedule.num_groups:
        add("SCH003", f"layout has {layout.num_groups} groups but the "
                      f"schedule promises {reducer.schedule.num_groups}")

    info = classify(records)
    groups = info["groups"]
    op = reducer.comm_op
    if len(groups) != layout.num_groups:
        add("SCH001", f"observed step issues {len(groups)} merged "
                      f"collective group(s), schedule promises "
                      f"{layout.num_groups}")
    shards: dict[int, Optional[int]] = {}
    for gi in sorted(groups):
        if gi >= layout.num_groups:
            add("SCH001", f"collective in the range of group {gi} but the "
                          f"layout has only {layout.num_groups} groups")
            continue
        recs = groups[gi]
        if op == "hier":
            shards[gi] = _check_hier_group(reducer, gi, recs, add)
        elif op == "rs_fwd_ag":
            _check_rs_fwd_ag_group(reducer, gi, recs, add)
        elif op in ("rs_ag", "rs_opt_ag"):
            _check_rs_group(reducer, gi, recs, add)
        else:
            _check_dense_group(reducer, gi, recs, add)

    if op == "hier":
        _check_hier_dcn(reducer, info["dcn_groups"], shards, add)
    else:
        for di in sorted(info["dcn_groups"]):
            for r in info["dcn_groups"][di]:
                add("SCH009", f"'{r.kind}' under range "
                              f"{DCN_GROUP_SCOPE_PREFIX}{di:04d} but "
                              f"comm_op is {op!r} (range reserved for the "
                              "hierarchical lowering)")
    for r in info["stray"]:
        add("SCH004", f"unexpected '{r.kind}' outside declared ranges "
                      f"(ranges: {list(r.scopes) or '<none>'}, thread "
                      f"{r.thread})")
    clip = [r for r in info["allowed"] if CLIP_NORM_SCOPE in r.scopes]
    if op not in SHARDED_OPS:
        for r in clip:
            add("SCH004", f"'{r.kind}' under range {CLIP_NORM_SCOPE} but "
                          f"comm_op is {op!r} (range reserved for the "
                          "sharded-update lowerings)")
    else:
        for r in clip:
            if r.kind != "all_reduce":
                add("SCH004", f"'{r.kind}' under range {CLIP_NORM_SCOPE} "
                              "(only the clip norm's all-reduce belongs "
                              "there)")
        clips = getattr(reducer.optim.spec, "norm_clip", None) is not None
        want = 1 if clips and reducer.world > 1 else 0
        got = sum(r.kind == "all_reduce" for r in clip)
        if got != want:
            add("SCH004", f"{CLIP_NORM_SCOPE} range carries {got} "
                          f"all-reduce(s); the spec (norm_clip="
                          f"{getattr(reducer.optim.spec, 'norm_clip', None)!r}"
                          f") calls for exactly {want}")
    return out


def verify_step_against_reducer(
    run_step: Callable[[], Any],
    reducer,
    grad_leaves: Sequence[Any],
    *,
    file: str = "<observed step>",
) -> tuple[list[Finding], list[Collective]]:
    """Observe ``run_step()`` (one real step through ``reducer``) and, on
    rs_fwd_ag, the next forward's gathers (``reducer.materialize()``, phase
    ``next``), then ``check_collectives``. Returns (findings, records).
    Every rank of the group must call it at the same point: observing runs
    the step's collectives."""
    with CollectiveObserver() as obs:
        run_step()
        if reducer.comm_op == "rs_fwd_ag":
            obs.phase = "next"
            reducer.materialize()
    records = list(obs.records)
    return check_collectives(records, reducer, grad_leaves, file=file), records


# -- the host-side rules (SCH005, SCH006, SCH008, SCH010) ----------------------



@dataclasses.dataclass(frozen=True)
class HostSync:
    """One observed host synchronisation: the op (``aten.<name>``, or
    ``Tensor.tolist`` / ``Tensor.numpy``), the ranges open on the issuing
    thread, the window's phase and the thread's name."""

    op: str
    scopes: tuple[str, ...]
    phase: str = "step"
    thread: str = ""


_READS = threading.local()  # .depth: inside a recorded Tensor read-back


def _on_host(device) -> bool:
    return device is None or torch.device(device).type == "cpu"


def _sync_op(func, args, kwargs) -> Optional[str]:
    """The name of a dispatched op that blocks the host on the device,
    None for any other."""
    packet = func.overloadpacket
    if packet is torch.ops.aten._local_scalar_dense:
        return "aten._local_scalar_dense"
    if packet is torch.ops.aten._to_copy and args:
        src = args[0]
        if (isinstance(src, torch.Tensor) and not _on_host(src.device)
                and _on_host(kwargs.get("device", src.device))
                and not kwargs.get("non_blocking", False)):
            return "aten._to_copy"
    if packet is torch.ops.aten.copy_ and len(args) >= 2:
        dst, src = args[0], args[1]
        non_blocking = (args[2] if len(args) > 2
                        else kwargs.get("non_blocking", False))
        if (isinstance(src, torch.Tensor) and not _on_host(src.device)
                and _on_host(dst.device) and not non_blocking):
            return "aten.copy_"
    return None


class _SyncDispatch(TorchDispatchMode):
    def __init__(self, observer: "HostObserver"):
        super().__init__()
        self.observer = observer

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not getattr(_READS, "depth", 0):
            op = _sync_op(func, args, kwargs)
            if op is not None:
                self.observer._note(op)
        return func(*args, **kwargs)


class HostObserver:
    """Record the host synchronisations (``syncs``) and the ``isfinite``
    calls (``guard_calls``: the ranges open at each) of the code run while
    armed (a context manager, entered on the thread that runs the step;
    one at a time per process). The dispatch mode is thread-local state,
    which autograd carries onto the thread that runs the gradient hooks;
    ``Tensor.tolist``, ``Tensor.numpy`` and ``isfinite`` are wrapped for
    the window on the class and the module, for every thread: a torch
    function mode would not see them, since it is popped while it handles
    the ``backward`` call that runs the hooks. ``phase`` names the part of
    the window the following records belong to."""

    _READ_METHODS = (("tolist", "Tensor.tolist"), ("numpy", "Tensor.numpy"))

    def __init__(self):
        self.syncs: list[HostSync] = []
        self.guard_calls: list[tuple[str, ...]] = []
        self.phase = "step"
        self._lock = threading.Lock()
        self._mode = None
        self._watch = None
        self._saved: list = []

    def _note(self, op: str) -> None:
        rec = HostSync(op, open_scopes(), self.phase,
                       threading.current_thread().name)
        with self._lock:
            self.syncs.append(rec)

    def _read(self, orig, label: str):
        observer = self

        def read(t, *args, **kwargs):
            observer._note(label)
            # the copy a card tensor's read dispatches is this read, not
            # another synchronisation
            _READS.depth = getattr(_READS, "depth", 0) + 1
            try:
                return orig(t, *args, **kwargs)
            finally:
                _READS.depth -= 1

        return read

    def _guard(self, orig):
        observer = self

        def isfinite(*args, **kwargs):
            observer.guard_calls.append(open_scopes())
            return orig(*args, **kwargs)

        return isfinite

    def _patch(self, owner, name: str, wrapper) -> None:
        self._saved.append((owner, name, owner.__dict__.get(name)))
        setattr(owner, name, wrapper)

    def __enter__(self) -> "HostObserver":
        with _ACTIVE_LOCK:
            if any(isinstance(a, HostObserver) for a in _active):
                raise RuntimeError("a HostObserver is already armed in "
                                   "this process")
            _active.append(self)
        self._watch = watch_scopes()
        self._watch.__enter__()
        for name, label in self._READ_METHODS:
            self._patch(torch.Tensor, name,
                        self._read(getattr(torch.Tensor, name), label))
        self._patch(torch.Tensor, "isfinite",
                    self._guard(torch.Tensor.isfinite))
        self._patch(torch, "isfinite", self._guard(torch.isfinite))
        self._mode = _SyncDispatch(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._mode.__exit__(*exc)
        self._mode = None
        for owner, name, orig in reversed(self._saved):
            if orig is None:
                delattr(owner, name)
            else:
                setattr(owner, name, orig)
        self._saved = []
        self._watch.__exit__(*exc)
        with _ACTIVE_LOCK:
            _active.remove(self)
        return False


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def state_storages(train_step) -> dict[str, int]:
    """{what: storage address} of the state a step must update in place:
    the module's parameters and buffers, the optimizer's state tensors,
    ``TrainStep.buffers`` and, on the sharded lowerings, the reducer's
    optimizer slots and carried parameter shards."""
    out: dict[str, int] = {}
    model = train_step.model
    names = {}
    for name, p in model.named_parameters():
        out[f"parameter {name}"] = _storage(p)
        names[p] = name
    for name, b in model.named_buffers():
        out[f"buffer {name}"] = _storage(b)
    if train_step.buffers is not None:
        out["TrainStep.buffers"] = _storage(train_step.buffers)
    opt = train_step.optimizer
    if opt is not None:
        for p, st in opt.state.items():
            for k, v in st.items():
                if isinstance(v, torch.Tensor):
                    out[f"optimizer state {names.get(p, '?')}.{k}"] = (
                        _storage(v))
    reducer = train_step.reducer
    if reducer is not None:
        state = getattr(reducer, "opt_state", None)
        if state is not None:
            for si, slot in enumerate(state.slots):
                for gi, t in enumerate(slot):
                    out[f"sharded optimizer slot {si} group {gi}"] = (
                        _storage(t))
        shards = getattr(reducer, "param_shards", None)
        for gi, t in enumerate(shards or ()):
            out[f"carried parameter shard group {gi}"] = _storage(t)
    return out


def check_host_syncs(syncs: Sequence[HostSync], *,
                     file: str = "<observed step>") -> list[Finding]:
    """SCH005: no host synchronisation inside the step."""
    return [Finding(file, 0, "SCH005", (
        f"host synchronisation '{s.op}' inside the step (ranges: "
        f"{list(s.scopes) or '<none>'}, thread {s.thread}, phase "
        f"{s.phase}): the step must not wait for the device"))
        for s in syncs]


def check_state_in_place(before: dict[str, int], after: dict[str, int], *,
                         file: str = "<observed step>") -> list[Finding]:
    """SCH006: every state tensor present before the step keeps its
    storage."""
    out: list[Finding] = []
    for what, ptr in before.items():
        now = after.get(what)
        if now is None:
            out.append(Finding(file, 0, "SCH006",
                               f"{what} is gone after the step"))
        elif now != ptr:
            out.append(Finding(file, 0, "SCH006", (
                f"{what} was rebound to a fresh storage by the step: state "
                "not updated in place")))
    return out


def check_guard(guard_calls: Sequence[tuple[str, ...]], grad_guard: bool, *,
                file: str = "<observed step>") -> list[Finding]:
    """SCH008 in both directions."""
    inside = sum(FINITE_CHECK_SCOPE in scopes for scopes in guard_calls)
    if grad_guard and not inside:
        return [Finding(file, 0, "SCH008", (
            "grad_guard=True but the step calls no isfinite inside its "
            f"{FINITE_CHECK_SCOPE} range: the non-finite guard is missing "
            f"({len(guard_calls)} isfinite call(s) outside it)"))]
    if not grad_guard and inside:
        return [Finding(file, 0, "SCH008", (
            f"grad_guard=False but the step still calls isfinite {inside} "
            f"time(s) inside its {FINITE_CHECK_SCOPE} range: the disabled "
            "guard was not removed"))]
    return []


@dataclasses.dataclass
class StepObservation:
    """One observed step: its collectives, host synchronisations,
    ``isfinite`` calls' ranges and findings."""

    records: list
    syncs: list
    guard_calls: list
    findings: list


def verify_observed_step(
    run_step: Callable[[], Any],
    train_step,
    grad_leaves: Optional[Sequence[Any]] = None,
    *,
    file: str = "<observed step>",
) -> StepObservation:
    """Observe ``run_step()`` (one real ``train_step`` call, every rank at
    the same point) with the collective and the host observers armed and
    apply SCH005, SCH006 and SCH008 and, when the step has a reducer,
    ``check_collectives`` (``grad_leaves`` in arrival order; the
    reducer's ``arrival_params`` by default). On rs_fwd_ag the window takes in the next
    forward's gathers, as ``verify_step_against_reducer``."""
    reducer = train_step.reducer
    before = state_storages(train_step)
    with CollectiveObserver() as obs, HostObserver() as host:
        run_step()
        if reducer is not None and reducer.comm_op == "rs_fwd_ag":
            obs.phase = host.phase = "next"
            reducer.materialize()
    after = state_storages(train_step)
    records = list(obs.records)
    findings: list[Finding] = []
    if reducer is not None:
        if grad_leaves is None:
            grad_leaves = list(reducer.arrival_params)
        findings += check_collectives(records, reducer, grad_leaves,
                                      file=file)
    findings += check_host_syncs(host.syncs, file=file)
    findings += check_state_in_place(before, after, file=file)
    findings += check_guard(host.guard_calls, train_step.grad_guard,
                            file=file)
    return StepObservation(records, list(host.syncs),
                           list(host.guard_calls), findings)


def compare_footprints(base: StepObservation, stats: StepObservation, *,
                       file: str = "<health-stats step>") -> list[Finding]:
    """SCH010: the stats-on step issues the collectives of the stats-off
    step, kind for kind, and as many host synchronisations."""
    out: list[Finding] = []
    fp_base = collections.Counter(r.kind for r in base.records)
    fp_stats = collections.Counter(r.kind for r in stats.records)
    for kind in sorted(set(fp_base) | set(fp_stats)):
        b, s = fp_base.get(kind, 0), fp_stats.get(kind, 0)
        if s > b:
            out.append(Finding(file, 0, "SCH010", (
                f"health statistics added {s - b} '{kind}' collective(s) "
                f"({b} -> {s}) — the stats must ride the EXISTING metrics "
                "all-reduce, not new collectives")))
        elif s < b:
            out.append(Finding(file, 0, "SCH010", (
                f"health statistics REMOVED {b - s} '{kind}' collective(s) "
                f"({b} -> {s}) — the stats build no longer realizes the "
                "same schedule as the plain step")))
    if len(stats.syncs) != len(base.syncs):
        out.append(Finding(file, 0, "SCH010", (
            f"health statistics changed the step's host synchronisations "
            f"({len(base.syncs)} -> {len(stats.syncs)}) — the stats must "
            "add no read-back")))
    return out
