"""Cost measurement (counterpart of ``mgwfbp_tpu/profiling.py``): the
layer-wise backward and forward benchmarks, the communication sweeps that
``calibrate`` fits the cost model from, and per-group trace attribution.

Layer profiles. The merge solver's input ``tb``: seconds of backward
compute attributed to each gradient, in arrival order. The original
reference timestamps each gradient from an autograd hook; so does this
module: a post-accumulate-grad hook on every parameter marks when its
gradient lands (a CUDA event on the card, the host clock on the CPU), and
each leaf is charged the time since the previous mark (the first since the
backward began). ``tf``, the forward, is timed the same way from forward
hooks on the modules that own parameters. The JAX package attributes a
profiler trace instead, which XLA's fused program needs.

Communication sweeps. Each runs over a ``torch.distributed`` group (NCCL
on the card, gloo on the CPU; ``profile_two_level`` over the inner and the
outer groups of a two-level world) with the JAX package's protocols: warm-up
calls, then timed calls, each window closed by a synchronisation (a
``torch.cuda.synchronize`` on the card); every rank's window time is
agreed to the group's maximum, so all ranks fit the same constants. gamma
and pack_beta time the production path: ``MergedAllreduce`` launching
from gradient hooks during a real backward, less the same backward with
the hooks disarmed. update_beta times two single-group reducers of the
same collectives, rs_ag against rs_opt_ag (``profile_update_beta``).

The public measurement functions take ``device`` as the port's entry
points do: None means the card (and raises without one), the CPU only
when asked for (``utils/device.py``).

Trace attribution. ``trace_group_times`` runs steps under
``torch.profiler`` and charges each merge group the device time of the
kernels and copies launched inside its ``mgwfbp_groupNNNN`` range;
``trace_two_level_group_times`` adds hier's ``mgwfbp_dcngroupNNNN`` ranges
(the outer link), whose payloads ``dcn_shard_nbytes`` gives.
``time_carried_steps`` times live steps for the autotuner's race.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from mgwfbp_tpu_torch.parallel.costmodel import (
    AlphaBeta,
    check_schema_version,
    fit_alpha_beta,
)
from mgwfbp_tpu_torch.utils.device import resolve_device

# the JAX package's sweep: 8K .. 16M float32 elements
DEFAULT_SIZES = tuple(int(2**k) for k in range(13, 25))


class TbProfile(list):
    """Arrival-ordered per-leaf backward seconds plus ``source``: 'hooks'
    (measured per leaf) or 'volume-prior' (a measured total split by
    parameter volume, used only when the hooks measure nothing)."""

    def __init__(self, values, source: str = "volume-prior"):
        super().__init__(float(v) for v in values)
        self.source = source


def _clock(cuda: bool):
    """(mark, seconds): a timestamp (a recorded CUDA event on the card,
    the host clock on the CPU) and the seconds between two of them."""

    def mark():
        if not cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def seconds(a, b) -> float:
        return a.elapsed_time(b) * 1e-3 if cuda else b - a

    return mark, seconds


def backward_cost_weights(
    params: Sequence[torch.Tensor], perm: Sequence[int]
) -> np.ndarray:
    """Per-leaf parameter volume in arrival order, normalized to sum 1."""
    w = np.asarray([float(max(params[j].numel(), 1)) for j in perm])
    return w / max(w.sum(), 1e-12)


def benchmark_backward(
    module: nn.Module,
    loss_of: Callable[[], torch.Tensor],
    params: Sequence[torch.Tensor],
    perm: Sequence[int],
    warmup: int = 2,
    iters: int = 10,
) -> TbProfile:
    """``tb`` in arrival order (``perm[k]`` is the leaf at position k),
    averaged over ``iters`` backward passes after ``warmup``. ``loss_of()``
    runs one forward and returns the scalar loss. The module's buffers
    (batch-norm running statistics) and gradients are left as they were."""
    cuda = params[0].device.type == "cuda"
    saved = [b.detach().clone() for b in module.buffers()]
    stamps: list = []
    mark, seconds = _clock(cuda)
    handles = [
        p.register_post_accumulate_grad_hook(
            lambda _p, j=j: stamps.append((j, mark()))
        )
        for j, p in enumerate(params)
    ]
    per_leaf = np.zeros(len(params))
    totals = []
    try:
        for it in range(warmup + iters):
            for p in params:
                p.grad = None
            loss = loss_of()
            stamps.clear()
            t0 = time.perf_counter()
            start = mark()
            loss.backward()
            if cuda:
                torch.cuda.synchronize()
            totals.append(time.perf_counter() - t0)
            if it < warmup:
                continue
            prev = start
            for j, m in stamps:
                per_leaf[j] += seconds(prev, m)
                prev = m
    finally:
        for h in handles:
            h.remove()
        for p in params:
            p.grad = None
        with torch.no_grad():
            for b, s in zip(module.buffers(), saved):
                b.copy_(s)
    per_leaf /= max(iters, 1)
    if per_leaf.sum() > 0:
        return TbProfile((per_leaf[j] for j in perm), source="hooks")
    total = float(np.mean(totals[warmup:] or totals))
    weights = backward_cost_weights(params, perm)
    return TbProfile((total * w for w in weights), source="volume-prior")


def benchmark_forward(
    module: nn.Module,
    loss_of: Callable[[], torch.Tensor],
    params: Sequence[torch.Tensor],
    perm: Sequence[int],
    warmup: int = 2,
    iters: int = 10,
) -> TbProfile:
    """``tf`` in arrival order: the forward's seconds per leaf, from a
    forward hook on every module that owns parameters. Each such module is
    charged the time since the previous mark (the first since the forward
    began), split among its own parameters by volume; averaged over
    ``iters`` forwards (``loss_of()``, as trained) after ``warmup``. The
    module's buffers are left as they were."""
    cuda = params[0].device.type == "cuda"
    saved = [b.detach().clone() for b in module.buffers()]
    leaf_of = {id(p): j for j, p in enumerate(params)}
    owners = []
    for m in module.modules():
        own = [leaf_of[id(p)] for p in m.parameters(recurse=False)
               if id(p) in leaf_of]
        if own:
            owners.append((m, own))
    stamps: list = []
    mark, seconds = _clock(cuda)
    handles = [
        m.register_forward_hook(lambda *_, i=i: stamps.append((i, mark())))
        for i, (m, _) in enumerate(owners)
    ]
    per_leaf = np.zeros(len(params))
    totals = []
    try:
        for it in range(warmup + iters):
            stamps.clear()
            t0 = time.perf_counter()
            start = mark()
            loss_of()
            if cuda:
                torch.cuda.synchronize()
            totals.append(time.perf_counter() - t0)
            if it < warmup:
                continue
            prev = start
            for i, m in stamps:
                own = owners[i][1]
                vol = np.asarray([float(max(params[j].numel(), 1)) for j in own])
                per_leaf[own] += seconds(prev, m) * vol / vol.sum()
                prev = m
    finally:
        for h in handles:
            h.remove()
        with torch.no_grad():
            for b, s in zip(module.buffers(), saved):
                b.copy_(s)
    per_leaf /= max(iters, 1)
    if per_leaf.sum() > 0:
        return TbProfile((per_leaf[j] for j in perm), source="hooks")
    total = float(np.mean(totals[warmup:] or totals))
    weights = backward_cost_weights(params, perm)
    return TbProfile((total * w for w in weights), source="volume-prior")


# Layer-profile persistence (tb_profile.json and calibrate --forward): the
# JAX package's schema. 1 = unstamped, backward only; 2 = stamped, with the
# optional forward timeline (tf_s, tf_total_s, tf_source).
LAYER_PROFILE_SCHEMA_VERSION = 2


def layer_profile_doc(
    tb: Sequence[float],
    arrival_names: Sequence[str],
    tf: Optional[Sequence[float]] = None,
    meta: Optional[dict] = None,
) -> dict:
    """A layer profile in the JAX package's tb_profile.json layout."""
    doc = {
        "schema_version": LAYER_PROFILE_SCHEMA_VERSION,
        "tb_s": list(tb),
        "arrival_names": list(arrival_names),
        "total_s": sum(tb),
        "source": getattr(tb, "source", "volume-prior"),
    }
    if tf is not None:
        doc["tf_s"] = list(tf)
        doc["tf_total_s"] = sum(tf)
        doc["tf_source"] = getattr(tf, "source", "volume-prior")
    if meta:
        doc["meta"] = meta
    return doc


def save_layer_profile(path: str, doc: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)


def load_layer_profile(path: str) -> dict:
    """Read a layer profile written by either package; a file without
    forward times gets ``tf_s`` zeros (with a warning), as the JAX
    package's reader gives it."""
    with open(path) as f:
        d = json.load(f)
    check_schema_version(
        d, path=path, supported=(1, LAYER_PROFILE_SCHEMA_VERSION),
        what="layer profile",
    )
    if not d.get("tf_s"):
        logging.getLogger("mgwfbp.profiling").warning(
            "%s: forward times defaulted to 0 (re-profile with `python -m "
            "mgwfbp_tpu_torch.calibrate --forward --model <dnn>`)", path,
        )
        d["tf_s"] = [0.0] * len(d.get("tb_s", []))
        d.setdefault("tf_source", "absent")
    return d


# ---------------------------------------------------------------------------
# Communication sweeps
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CommProfile:
    sizes_bytes: list[float]
    times_s: list[float]
    model: AlphaBeta


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _agree_max(values: Sequence[float], group, device) -> list[float]:
    """The group's elementwise maximum of per-rank timings, so every rank
    fits the same constants (the slowest rank bounds a collective)."""
    if dist.get_world_size(group) == 1:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t.tolist()


def _window_s(fn: Callable[[], None], iters: int, device) -> float:
    """Seconds per call of ``fn`` over one window of ``iters`` calls,
    closed by a synchronisation."""
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / max(iters, 1)


def profile_allreduce(
    group=None,
    device: Optional[Union[str, torch.device]] = None,
    sizes: Sequence[int] = DEFAULT_SIZES,
    warmup: int = 5,
    iters: int = 20,
    dtype: torch.dtype = torch.float32,
) -> CommProfile:
    """One all-reduce per payload size over ``group``, synchronised after
    every call (the reference's protocol); fit t = alpha + beta * bytes.
    A one-rank group moves no bytes: its curve is the dispatch floor."""
    device = resolve_device(device)
    times, nbytes = [], []
    itemsize = torch.empty((), dtype=dtype).element_size()
    for n in sizes:
        x = torch.ones(n, dtype=dtype, device=device)

        def call():
            dist.all_reduce(x, group=group)
            _sync(device)

        for _ in range(warmup):
            call()
        times.append(_window_s(call, iters, device))
        nbytes.append(n * itemsize)
    times = _agree_max(times, group, device)
    return CommProfile(
        sizes_bytes=nbytes, times_s=times, model=fit_alpha_beta(nbytes, times)
    )


def profile_allgather(
    group=None,
    device: Optional[Union[str, torch.device]] = None,
    sizes: Sequence[int] = DEFAULT_SIZES,
    warmup: int = 5,
    iters: int = 20,
    dtype: torch.dtype = torch.float32,
) -> CommProfile:
    """One all-gather per FULL payload size (each rank holds n / P
    elements and the gather reassembles n: the all-gather leg of an
    n-element ring all-reduce), for ``fit_ag_fraction``."""
    device = resolve_device(device)
    times, nbytes = [], []
    itemsize = torch.empty((), dtype=dtype).element_size()
    world = dist.get_world_size(group)
    for n in sizes:
        shard = max(n // world, 1)
        x = torch.ones(shard, dtype=dtype, device=device)
        out = torch.empty(shard * world, dtype=dtype, device=device)

        def call():
            dist.all_gather_into_tensor(out, x, group=group)
            _sync(device)

        for _ in range(warmup):
            call()
        times.append(_window_s(call, iters, device))
        nbytes.append(shard * world * itemsize)
    times = _agree_max(times, group, device)
    return CommProfile(
        sizes_bytes=nbytes, times_s=times, model=fit_alpha_beta(nbytes, times)
    )


def fit_ag_fraction(
    full: CommProfile, ag: CommProfile, lo: float = 0.05, hi: float = 0.95,
) -> float:
    """The median per-size ratio of all-gather to all-reduce time, clamped
    to [lo, hi]; sweeps that do not pair keep the 0.5 prior, with a
    warning."""
    ratios = [
        ag_t / full_t
        for full_t, ag_t in zip(full.times_s, ag.times_s)
        if full_t > 0.0
    ]
    if len(full.times_s) != len(ag.times_s) or not ratios:
        logging.getLogger("mgwfbp.profiling").warning(
            "fit_ag_fraction: sweeps do not pair (%d full vs %d ag "
            "samples); keeping the unmeasured 0.5 phase-split prior",
            len(full.times_s), len(ag.times_s),
        )
        return 0.5
    return float(min(max(float(np.median(ratios)), lo), hi))


def profile_two_level(
    levels,
    device: Optional[Union[str, torch.device]] = None,
    sizes: Sequence[int] = DEFAULT_SIZES,
    warmup: int = 5,
    iters: int = 20,
    allgather: bool = False,
    dtype: torch.dtype = torch.float32,
):
    """Per-link calibration of an (ici x dcn) world split by
    ``parallel.mesh.two_level_groups`` (the JAX package's
    ``profile_two_level``, the ``calibrate --two-level`` engine): an
    all-reduce over only the inner groups (every slice at once) and over
    only the outer groups at every payload size, each rank's times agreed
    to the world's maximum, each link fit on its own; with ``allgather``
    an inner all-gather sweep fits the inner link's ``ag_fraction``.

    Returns (model, raw): a ``TwoLevelAlphaBeta`` whose links are the
    measured curves (``SampledCost``), and the payload sizes, the inner
    link's ag_fraction and each link's fit. Where both levels share one
    fabric (the cards of one host, or gloo through host memory), the two
    links differ only by group size and contention: the calibration
    checks the composition, not a slower link."""
    from mgwfbp_tpu_torch.parallel.costmodel import (
        SampledCost,
        TwoLevelAlphaBeta,
    )

    if levels.dcn <= 1:
        raise ValueError(f"--two-level needs dcn > 1 (got {levels.dcn})")
    device = resolve_device(device)
    ici = profile_allreduce(levels.inner, device, sizes=sizes, warmup=warmup,
                            iters=iters, dtype=dtype)
    dcn = profile_allreduce(levels.outer, device, sizes=sizes, warmup=warmup,
                            iters=iters, dtype=dtype)
    n = len(ici.times_s)
    agreed = _agree_max(list(ici.times_s) + list(dcn.times_s), None, device)
    t_ici, t_dcn = agreed[:n], agreed[n:]
    nbytes = list(ici.sizes_bytes)
    ab_ici = fit_alpha_beta(nbytes, t_ici)
    ab_dcn = fit_alpha_beta(nbytes, t_dcn)
    ag_fraction = 0.5
    if allgather:
        ag = profile_allgather(levels.inner, device, sizes=sizes,
                               warmup=warmup, iters=iters, dtype=dtype)
        ag_t = _agree_max(ag.times_s, None, device)
        ag_fraction = fit_ag_fraction(
            CommProfile(nbytes, t_ici, ab_ici),
            CommProfile(ag.sizes_bytes, ag_t, ag.model))
    model = TwoLevelAlphaBeta(
        ici=SampledCost(sizes_bytes=tuple(nbytes), times_s=tuple(t_ici),
                        ab=ab_ici, ag_fraction=ag_fraction),
        dcn=SampledCost(sizes_bytes=tuple(nbytes), times_s=tuple(t_dcn),
                        ab=ab_dcn),
        ici_size=int(levels.ici), dcn_size=int(levels.dcn),
    )
    raw = {
        "sizes_bytes": nbytes,
        "ag_fraction": ag_fraction,
        "fit": {
            "ici": {"alpha": ab_ici.alpha, "beta": ab_ici.beta},
            "dcn": {"alpha": ab_dcn.alpha, "beta": ab_dcn.beta},
        },
    }
    return model, raw


class _HookBench:
    """The production bucket path on flat parameters of the given sizes:
    ``MergedAllreduce`` under ``policy`` and ``comm_op`` over ``group``,
    launched by its gradient hooks during a backward of ``sum(p.sum())``.
    ``step(armed)`` runs one backward with the reducer armed (and
    synchronised, or, on rs_opt_ag, updated: SGD with momentum 0.9) or
    disarmed (the same backward and hook calls, no collective)."""

    def __init__(self, sizes: Sequence[int], policy: str, group, device,
                 dtype: torch.dtype = torch.float32,
                 comm_op: str = "all_reduce"):
        from mgwfbp_tpu_torch.optim import OptimSpec
        from mgwfbp_tpu_torch.parallel.allreduce import (
            MergedAllreduce,
            ShardedOptimStep,
            arrival_order,
        )
        from mgwfbp_tpu_torch.parallel.buckets import build_layout
        from mgwfbp_tpu_torch.parallel.solver import LayerSpec, build_schedule

        self.params = [
            torch.ones(n, dtype=dtype, device=device, requires_grad=True)
            for n in sizes
        ]
        # sum() runs the last term's backward first: arrival is reversed
        perm = arrival_order(len(self.params))
        arr = [self.params[j] for j in perm]
        specs = [LayerSpec(f"g{k:04d}", t.numel(), t.element_size())
                 for k, t in enumerate(arr)]
        schedule = build_schedule(specs, policy=policy)
        layout = build_layout(arr, schedule.groups)
        optim = None
        if comm_op == "rs_opt_ag":
            optim = ShardedOptimStep(
                OptimSpec(lr=1e-3, kind="sgd", momentum=0.9), layout,
                tuple(tuple(t.shape) for t in arr), tuple(perm),
                dist.get_world_size(group))
        self.reducer = MergedAllreduce(
            schedule, layout, perm, self.params, group=group,
            comm_op=comm_op, optim=optim,
        ).attach()

    def step(self, armed: bool) -> None:
        for p in self.params:
            p.grad = None
        self.reducer.begin(active=armed)
        sum(p.sum() for p in self.params).backward()
        if armed and self.reducer.comm_op == "rs_opt_ag":
            self.reducer.reduce_and_update()
        elif armed:
            self.reducer.synchronize()

    def close(self) -> None:
        self.reducer.detach()


def _step_s(fn: Callable[[], None], device) -> float:
    """Seconds of one call of ``fn`` run to completion."""
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return time.perf_counter() - t0


def _reducer_s(benches: Sequence[_HookBench], warmup: int, iters: int,
               device, group, rounds: int = 5) -> list[float]:
    """Seconds per step that each bench's armed reducer adds to its
    backward, agreed across the group. Every step runs to completion and
    is timed alone; the armed and bare steps of all benches alternate, and
    each configuration keeps the median of its ``rounds * iters`` steps. A
    drift of host or clock speed then falls on every configuration alike,
    and load spikes, which lengthen single steps, move no median (window
    means of a shared host varied by more than the reducer's cost)."""
    for _ in range(warmup):
        for b in benches:
            b.step(True)
            b.step(False)
    samples: list[list[float]] = [[] for _ in range(2 * len(benches))]
    for _ in range(rounds * iters):
        for i, b in enumerate(benches):
            for j, armed in enumerate((True, False)):
                samples[2 * i + j].append(
                    _step_s(lambda: b.step(armed), device))
    med = _agree_max([float(np.median(s)) for s in samples], group, device)
    return [med[2 * i] - med[2 * i + 1] for i in range(len(benches))]


def profile_group_overhead(
    group=None,
    device: Optional[Union[str, torch.device]] = None,
    alpha: float = 0.0,
    total_elems: int = 1 << 22,
    group_counts: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
    warmup: int = 3,
    iters: int = 10,
) -> tuple[float, list[tuple[int, float]]]:
    """gamma: the fixed cost of one more collective beyond alpha. A FIXED
    payload split into k equal parameters, policy ``wfbp`` (k groups, so k
    collectives), for each k: the pack bytes stay constant, so the slope
    of the reducer's time against k is the marginal cost of a collective
    (link startup alpha plus pack, dispatch and hook work). Returns
    (max(slope - alpha, 0), [(k, seconds), ...])."""
    device = resolve_device(device)
    times: list[tuple[int, float]] = []
    for k in group_counts:
        per = max(total_elems // k, 1)
        bench = _HookBench([per] * k, "wfbp", group, device)
        try:
            times.append((k, _reducer_s([bench], warmup, iters, device,
                                        group)[0]))
        finally:
            bench.close()
    ks = np.asarray([k for k, _ in times], np.float64)
    ts = np.asarray([t for _, t in times], np.float64)
    slope = float(((ks - ks.mean()) * (ts - ts.mean())).sum()
                  / max(((ks - ks.mean()) ** 2).sum(), 1e-30))
    return max(slope - alpha, 0.0), times


def profile_pack_overhead(
    group=None,
    device: Optional[Union[str, torch.device]] = None,
    total_elems: int = 1 << 22,
    members: int = 32,
    warmup: int = 3,
    iters: int = 10,
) -> float:
    """pack_beta: the per-byte cost of a MULTI-member group. Policy
    ``single`` over one parameter against ``members`` parameters of the
    identical total payload (per * members elements in both): one
    collective each, so the difference over the payload bytes prices what
    a multi-member bucket adds."""
    device = resolve_device(device)
    per = max(total_elems // members, 1)
    benches = [_HookBench(sizes, "single", group, device)
               for sizes in ([per * members], [per] * members)]
    try:
        # interleaved: timed one after the other, a clock or load drift
        # between the two benches pushed the difference below zero
        t_mono, t_packed = _reducer_s(benches, warmup, iters, device, group)
    finally:
        for bench in benches:
            bench.close()
    nbytes = float(per * members * torch.float32.itemsize)
    return max((t_packed - t_mono) / nbytes, 0.0)


def profile_update_beta(
    group=None,
    device: Optional[Union[str, torch.device]] = None,
    total_elems: int = 1 << 22,
    warmup: int = 3,
    iters: int = 10,
    dtype: torch.dtype = torch.float32,
) -> float:
    """update_beta: the per-BUCKET-byte cost of the shard optimizer update
    the rs_opt_ag lowering runs between the reduce-scatter and the
    all-gather (``costmodel.AlphaBeta.update_beta``). Two single-group
    reducers of ``total_elems`` elements with the same collectives, rs_ag
    and rs_opt_ag with SGD momentum, each the minimum over 3 windows of
    ``iters`` steps (their windows alternate, each closed by a
    synchronisation); the difference over the bucket bytes is update_beta,
    with the 1/world factor folded in as the solver charges it (the update
    touches the shard, the divisor is the bucket)."""
    device = resolve_device(device)
    benches = [_HookBench([total_elems], "single", group, device, dtype,
                          comm_op=op) for op in ("rs_ag", "rs_opt_ag")]
    try:
        for _ in range(warmup):
            for b in benches:
                b.step(True)
        best = [float("inf")] * len(benches)
        for _ in range(3):
            for i, b in enumerate(benches):
                _sync(device)
                best[i] = min(best[i],
                              _window_s(lambda: b.step(True), iters, device))
        t_rs, t_opt = _agree_max(best, group, device)
    finally:
        for b in benches:
            b.close()
    nbytes = float(total_elems * torch.empty((), dtype=dtype).element_size())
    return max((t_opt - t_rs) / nbytes, 0.0)


def profile_overlap_capability(
    group=None,
    device: Optional[Union[str, torch.device]] = None,
    payload_elems: int = 1 << 22,
    warmup: int = 3,
    iters: int = 10,
) -> float:
    """How much collective time the platform hides behind compute: C (a
    chain of tanh(y @ w) on the current stream), R (one all-reduce of
    ``payload_elems``) and T (the all-reduce launched asynchronously, then
    the chain, then the wait). Returns clip((C + R - T) / min(C, R), 0, 1);
    the chain is sized so that C is about 4 R."""
    device = resolve_device(device)
    w = torch.full((512, 512), 1e-3, device=device)
    x = torch.ones((512, 512), device=device)
    payload = torch.ones(payload_elems, device=device)

    def chain(k: int):
        y = x
        for _ in range(k):
            y = torch.tanh(y @ w)
        return y

    def comm():
        dist.all_reduce(payload, group=group)

    def timed(fn) -> float:
        for _ in range(warmup):
            fn()
        _sync(device)
        return _agree_max([_window_s(fn, iters, device)], group, device)[0]

    r = timed(comm)
    c4 = timed(lambda: chain(4))
    k = min(max(int(round(4 * r / max(c4, 1e-9))), 1), 512)
    # every rank must run the same chain length: the agreed timings give it
    c = timed(lambda: chain(k))

    def both():
        work = dist.all_reduce(payload, group=group, async_op=True)
        chain(k)
        work.wait()

    t = timed(both)
    denom = min(c, r)
    if denom <= 0:
        return 1.0
    return float(min(max((c + r - t) / denom, 0.0), 1.0))


def time_carried_steps(
    step_once: Callable, state, iters: int, warmup: int = 1,
    device: Optional[Union[str, torch.device]] = None,
) -> tuple:
    """``measure_step_time`` for live training (the JAX package's
    function): real steps timed while the state is carried through, so
    every timed call is a genuine optimizer step on a fresh batch and
    nothing is replayed (the autotuner's race protocol). ``step_once(state)
    -> new state`` takes its own batch (the state may be None where the
    step keeps it in place, as the port's ``TrainStep`` does); ``warmup``
    steps run untimed, then one window of ``iters`` closed by a
    synchronisation of ``device`` (``torch.cuda.synchronize`` on the card,
    nothing on the CPU, the default): the port's step reads nothing back,
    so that synchronisation is the window's only wait, and ``step_once``
    keeps what it must read on the device until after the window. Returns
    (final state, seconds per step)."""
    device = torch.device(device if device is not None else "cpu")
    for _ in range(max(warmup, 0)):
        state = step_once(state)
    _sync(device)
    t0 = time.perf_counter()
    n = max(iters, 1)
    for _ in range(n):
        state = step_once(state)
    _sync(device)
    return state, (time.perf_counter() - t0) / n


def measure_step_time(
    fn: Callable, *args, warmup: int = 5, iters: int = 50,
    device: Optional[Union[str, torch.device]] = None,
) -> float:
    """Seconds per call of ``fn(*args)``: ``warmup`` calls, then one
    window of ``iters`` closed by a synchronisation (the reference's 5 +
    50 protocol)."""
    device = resolve_device(device)
    for _ in range(warmup):
        fn(*args)
    _sync(device)
    return _window_s(lambda: fn(*args), iters, device)


# ---------------------------------------------------------------------------
# Trace attribution
# ---------------------------------------------------------------------------


def group_times_from_rows(
    rows: Sequence[tuple[str, float]], num_groups: int, iters: int,
    scope_name: Optional[Callable[[int], str]] = None,
) -> Optional[list[float]]:
    """Seconds per step of each merge group from (identifier, duration in
    µs) rows: the sum of the durations whose identifier carries the
    group's scope (``scope_name``, default ``group_scope_name``), averaged
    over ``iters`` traced steps. None when any group attributes nothing:
    partial attribution is worse than none."""
    from mgwfbp_tpu_torch.parallel.allreduce import group_scope_name

    scope_name = scope_name or group_scope_name
    out: list[float] = []
    for gi in range(num_groups):
        tag = scope_name(gi)
        dur_us = sum(dur for ident, dur in rows if tag in ident)
        if dur_us <= 0.0:
            return None
        out.append(dur_us * 1e-6 / max(iters, 1))
    return out


def is_collective_kernel(name: str) -> bool:
    """A device kernel of a collective: NCCL names every one of them
    ``nccl...`` (``ncclDevKernel_AllReduce_Sum_f32_RING_LL`` and the
    like). Pack and unpack copies are not."""
    return "nccl" in name.lower()


def collective_group_times(
    rows: Sequence[tuple[str, float]], num_groups: int, iters: int,
    scope_name: Optional[Callable[[int], str]] = None,
) -> Optional[list[float]]:
    """``group_times_from_rows`` over ``trace_group_rows``' rows, charged
    only when every group's range holds a collective kernel. A range of
    copies alone (NCCL's in-place sum over one rank launches no kernel)
    measured the pack, not the all-reduce: None, as for a missing group.
    ``scope_name``: as in ``group_times_from_rows``."""
    from mgwfbp_tpu_torch.parallel.allreduce import group_scope_name

    scope_name = scope_name or group_scope_name
    for gi in range(num_groups):
        tag = scope_name(gi) + " "
        if not any(ident.startswith(tag)
                   and is_collective_kernel(ident[len(tag):])
                   for ident, _ in rows):
            return None
    return group_times_from_rows(rows, num_groups, iters, scope_name)


def _device_activity(event):
    """The device kernels and copies launched under a profiler event: its
    own and its children's, joined to their launches by the profiler's
    correlation ids."""
    yield from event.kernels
    for child in event.cpu_children:
        yield from _device_activity(child)


# torch.profiler refuses a second active profiler in one process; every
# window of this package takes this lock, so two never overlap (a second
# one fails at once instead)
_PROFILER_LOCK = threading.Lock()


def trace_group_rows(
    run_steps: Callable[[], None], logdir: Optional[str] = None,
    trace_name: str = "trace.json",
) -> list[tuple[str, float]]:
    """Run ``run_steps()`` under torch.profiler (CPU and, on a card, CUDA
    activities) and return one ("<scope> <kernel>", device µs) row for
    every kernel or copy whose launch lies inside a merge group's range
    (``mgwfbp_groupNNNN``, and hier's ``mgwfbp_dcngroupNNNN``).
    A host operator's own time (gloo's ``all_reduce``, whose duration is
    its enqueue) is never counted, so a CPU run returns no rows. With
    ``logdir`` the window's Chrome trace goes to ``<logdir>/<trace_name>``.
    A window while another of this package's is active raises
    RuntimeError."""
    from torch.profiler import ProfilerActivity, profile

    from mgwfbp_tpu_torch.parallel.allreduce import (
        DCN_GROUP_SCOPE_PREFIX,
        GROUP_SCOPE_PREFIX,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    if not _PROFILER_LOCK.acquire(blocking=False):
        raise RuntimeError("another torch.profiler window is active in "
                           "this process")
    try:
        with profile(activities=activities) as prof:
            run_steps()
        if logdir is not None:
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(logdir, trace_name))
    finally:
        _PROFILER_LOCK.release()
    rows = []
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith((GROUP_SCOPE_PREFIX,
                                       DCN_GROUP_SCOPE_PREFIX))):
            rows.extend((f"{e.name} {k.name}", float(k.duration))
                        for k in _device_activity(e))
    return rows


def trace_group_times(
    run_steps: Callable[[], None], num_groups: int, iters: int = 1,
    logdir: Optional[str] = None, trace_name: str = "trace.json",
) -> Optional[list[float]]:
    """Measured per-merge-group device seconds per step, from a profiler
    trace of ``run_steps()`` (which runs ``iters`` steps and synchronises):
    each group is charged its range's collective kernel and copies
    (``trace_group_rows``, ``collective_group_times``). Returns None when
    some group's range holds no collective kernel: on the CPU, and where
    the collective launches none (NCCL's in-place sum over one rank). The
    JAX package's second path, a join with the compiled HLO's op metadata,
    has no counterpart: there is no HLO here. ``logdir``, ``trace_name``:
    as in ``trace_group_rows``."""
    return collective_group_times(
        trace_group_rows(run_steps, logdir, trace_name), num_groups, iters)


def trace_two_level_group_times(
    run_steps: Callable[[], None], num_groups: int, num_dcn_groups: int,
    iters: int = 1, logdir: Optional[str] = None,
    trace_name: str = "trace.json",
) -> tuple[Optional[list[float]], Optional[list[float]]]:
    """Per-link trace attribution of a hier schedule (the JAX package's
    function): one trace of ``run_steps()``, split two ways. The
    ``mgwfbp_groupNNNN`` ranges time each bucket's inner legs (the
    reduce-scatter and the all-gather), the ``mgwfbp_dcngroupNNNN`` ranges
    its cross-slice all-reduce. Returns ``(inner_times, dcn_times)`` in
    group and DCN-group order (seconds per step), either None when its
    ranges hold no collective kernel (``collective_group_times``): the
    autotuner then refits from step deltas. The DCN samples let
    ``costmodel.refit_two_level_from_observations`` refit the outer link
    from its own observations."""
    from mgwfbp_tpu_torch.parallel.allreduce import dcn_group_scope_name

    rows = trace_group_rows(run_steps, logdir, trace_name)
    return (collective_group_times(rows, num_groups, iters),
            collective_group_times(rows, num_dcn_groups, iters,
                                   dcn_group_scope_name))


def _itemsize(dtype) -> int:
    """Bytes per element of a torch or numpy dtype."""
    size = getattr(dtype, "itemsize", None)
    return int(size) if isinstance(size, int) else np.dtype(dtype).itemsize


def dcn_shard_nbytes(layout, dcn_groups: Sequence[Sequence[int]],
                     ici_size: int, comm_dtype=None) -> list[int]:
    """Each DCN group's outer-wire payload in bytes (the JAX package's
    function): the sum of its members' 1/ici_size shards of their buckets
    padded to a multiple of ``ici_size``, at the wire dtype (else each
    bucket's). That is what hier's one cross-slice all-reduce moves, and
    the byte convention of ``refit_two_level_from_observations``'
    ``dcn_observations``."""
    ici = max(int(ici_size), 1)
    out: list[int] = []
    for members in dcn_groups:
        total = 0
        for gi in members:
            n = int(layout.group_sizes[gi])
            padded = n + ((-n) % ici)
            total += (padded // ici) * _itemsize(
                comm_dtype if comm_dtype is not None else layout.dtypes[gi])
        out.append(total)
    return out
