"""Comm/compute overlap of the port's train step, from a torch.profiler
trace (the counterpart of the JAX package's ``tools/overlap_report.py``).

    python -m mgwfbp_tpu_torch.tools.overlap_report [--model resnet20]
        [--batch 16] [--policy mgwfbp] [--nsteps 1] [--steps 5]
        [--mode trace|hlo] [--comm-profile p.json] [--device cuda]
        [--out overlap.json]

Runs ``--steps`` train steps (``TrainStep`` with the merged all-reduce of
``--policy`` on tb measured by the gradient hooks) under torch.profiler
(``profiling.trace_group_rows``, which also exports the window's Chrome
trace), then reports, per collective kernel, how much device compute ran
concurrently with it: the JAX tool's rows and summary, read from the
card's lanes (the kernels, copies and memsets of the CUDA streams). NCCL
kernels are the collectives (``profiling.is_collective_kernel``, beside the
JAX tool's name markers); copies and the JAX tool's non-compute markers
are not compute. ``predicted_vs_actual`` pairs each merge group's
predicted collective time with the mean device time of the NCCL kernels
launched inside that group's ``mgwfbp_groupNNNN`` range;
``launch_sequence`` is the order the reducer issued the groups in, and
``held_groups`` the groups that order held back on the last traced step's
hooks, beside those group-index order would have held.

``--mode hlo``: there is no HLO in torch. Its counterpart reads the same
facts from the trace's launch order (the kernels in the order they were
launched, by the profiler's correlation ids; on a host without a card,
the CPU operators in their order): the collectives launched, and the
compute kernels launched between consecutive collectives, under the JAX
report's field names.

Several processes (one per card) come from the launch environment
(``MGWFBP_COORDINATOR``/``MGWFBP_NUM_PROCESSES``/``MGWFBP_PROCESS_ID``);
every rank runs and traces the same steps, rank 0 writes. One process
forms a one-rank group, over which NCCL launches no kernel: the
collective rows then come only from two or more cards.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import sys
import tempfile
import time

_COLLECTIVE_MARKERS = (
    "all-reduce", "all_reduce", "allreduce",
    "reduce-scatter", "all-gather", "collective-permute",
)
_NON_COMPUTE_MARKERS = _COLLECTIVE_MARKERS + (
    "copy", "infeed", "outfeed", "send", "recv", "tuple", "bitcast",
)
# torch.profiler's categories of the card's own activity: kernels, copies
# and memsets run on the CUDA streams; ``gpu_user_annotation`` spans (the
# record_function ranges drawn on a stream) are not work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
NON_COMPUTE_CATEGORIES = ("gpu_memcpy", "gpu_memset")
_COMPUTE_OP = ("conv", "addmm", "mm", "bmm", "matmul", "linear", "gemm")


def _is_collective(name: str) -> bool:
    from mgwfbp_tpu_torch.profiling import is_collective_kernel

    low = name.lower()
    return is_collective_kernel(name) or any(
        m in low for m in _COLLECTIVE_MARKERS)


def _load_trace_events(path: str) -> list[dict]:
    """The events of a Chrome trace file (``.json`` or ``.json.gz``), or of
    every one under a directory (torch.profiler's ``trace.json`` and the
    JAX profiler's ``plugins/profile/*/*.trace.json.gz`` alike)."""
    if os.path.isdir(path):
        paths = sorted(
            glob.glob(os.path.join(path, "*.json"))
            + glob.glob(os.path.join(path, "*.json.gz"))
            + glob.glob(os.path.join(path, "plugins", "profile", "*",
                                     "*.trace.json.gz")))
    else:
        paths = [path]
    events: list[dict] = []
    for p in paths:
        opener = gzip.open if p.endswith(".gz") else open
        with opener(p, "rt") as f:
            data = json.load(f)
        events.extend(data.get("traceEvents", []) if isinstance(data, dict)
                      else data)
    return events


def _device_events(events: list[dict]) -> list[dict]:
    """The complete events of the card's lanes (``DEVICE_CATEGORIES``)."""
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES
            and "dur" in e and "ts" in e]


def summarize_overlap(path: str) -> dict:
    """A profiler trace (file or directory) -> the JAX tool's overlap
    summary: per collective its duration and the compute that ran
    concurrently, largest first."""
    complete = _device_events(_load_trace_events(path))
    colls = [e for e in complete if _is_collective(e.get("name", ""))]
    computes = [
        e for e in complete
        if e.get("cat") not in NON_COMPUTE_CATEGORIES
        and not _is_collective(e.get("name", ""))
        and not any(m in e.get("name", "").lower()
                    for m in _NON_COMPUTE_MARKERS)
    ]
    rows = []
    for c in colls:
        c0, c1 = c["ts"], c["ts"] + c["dur"]
        concurrent = 0.0
        for k in computes:
            lo, hi = max(c0, k["ts"]), min(c1, k["ts"] + k["dur"])
            if hi > lo:
                concurrent += hi - lo
        rows.append({
            "name": c["name"][:120],
            "dur_us": c["dur"],
            "concurrent_compute_us": round(concurrent, 3),
            "overlap_fraction": round(concurrent / max(c["dur"], 1e-9), 4),
        })
    rows.sort(key=lambda r: -r["dur_us"])
    total = sum(r["dur_us"] for r in rows)
    overlapped = sum(r["concurrent_compute_us"] for r in rows)
    return {
        "n_collective_events": len(rows),
        "total_collective_us": round(total, 3),
        "overlapped_us": round(min(overlapped, total), 3),
        "overlap_fraction": round(overlapped / total, 4) if total else None,
        "collectives": rows[:40],
        # beside the JAX summary: what the parse counted as compute
        "n_compute_events": len(computes),
        "compute_us": round(sum(k["dur"] for k in computes), 3),
    }


def launch_order_report(path: str) -> dict:
    """The JAX tool's HLO schedule facts from a trace's launch order: for
    each collective, the compute kernels launched since the previous one.
    The card's kernels in launch order (the profiler's correlation ids);
    without any, the CPU operators in their start order (collectives by
    name, compute: convolutions and matmuls)."""
    events = _load_trace_events(path)
    dev = _device_events(events)
    if dev:
        seq = sorted(dev, key=lambda e: (e.get("args", {}).get(
            "correlation", 0), e["ts"]))

        def is_compute(e):
            return (e.get("cat") == "kernel"
                    and not any(m in e["name"].lower()
                                for m in _NON_COMPUTE_MARKERS))
        source = "the card's kernels in launch order (correlation ids)"
    else:
        seq = sorted((e for e in events if e.get("ph") == "X"
                      and e.get("cat") == "cpu_op"), key=lambda e: e["ts"])

        def is_compute(e):
            name = e["name"].lower().rsplit("::", 1)[-1]
            return any(name.startswith(m) for m in _COMPUTE_OP)
        source = "the CPU operators in start order (no card in the trace)"
    rows, since_prev, after_first, seen = [], 0, 0, False
    for e in seq:
        if _is_collective(e["name"]):
            rows.append({"collective": e["name"][:60],
                         "compute_ops_since_prev": since_prev})
            since_prev, seen = 0, True
        elif is_compute(e):
            since_prev += 1
            if seen:
                after_first += 1
    return {
        "n_collectives_in_schedule": len(rows),
        "collectives_with_compute_interleaved_before": sum(
            1 for r in rows[1:] if r["compute_ops_since_prev"] > 0),
        "compute_ops_scheduled_after_first_collective": after_first,
        "collectives": rows[:40],
        "source": source,
    }


def measure_tb(model, meta, batch: int, device, compute_dtype=None):
    """One arrival-order backward profile of ``model`` at ``batch`` (zero
    images and labels, 1 warm-up and 3 timed passes, the JAX tool's
    protocol), through the bench's ``measure_tb``; shared by
    ``_build_setup``, ``gamma_sensitivity`` and ``policy_grid``, which
    measure once and solve every schedule from the same numbers."""
    import torch

    from mgwfbp_tpu_torch.bench import measure_tb as bench_tb

    x = torch.zeros((batch, *meta.input_shape), device=device)
    y = torch.zeros((batch,), dtype=torch.int64, device=device)
    return bench_tb(model, x.movedim(-1, -3).contiguous(), y, compute_dtype,
                    warmup=1, iters=3, task=meta.task)


def arrival_layers(model, itemsize=None) -> list:
    """``model``'s leaves as the solver's LayerSpecs in arrival order (the
    reducer's), each of ``itemsize`` bytes an element (the compute
    dtype's; None: the leaf's own)."""
    from mgwfbp_tpu_torch.convert import flax_leaves, keystr
    from mgwfbp_tpu_torch.parallel.allreduce import arrival_order
    from mgwfbp_tpu_torch.parallel.solver import LayerSpec

    leaves = flax_leaves(model)
    names = [keystr(p) for p, _ in leaves]
    perm = arrival_order(len(names), names=names)
    return [LayerSpec(names[j], int(leaves[j][1].numel()),
                      itemsize or int(leaves[j][1].element_size()))
            for j in perm]


def cost_model_for(comm_profile, world: int):
    """The cost model at ``world`` workers (at least 2): the profile's,
    resolved there, else the ``ici`` prior."""
    from mgwfbp_tpu_torch.parallel.costmodel import (
        load_profile,
        lookup_alpha_beta,
        resolve_profile,
    )

    if comm_profile:
        return resolve_profile(load_profile(comm_profile), max(world, 2))
    return lookup_alpha_beta("ici", max(world, 2))


def _build_setup(model_name, batch, policy, nsteps, comm_profile=None,
                 tb=None, device="cuda", group=None, compute_dtype=None):
    """Shared setup: (model, meta, step, reducer, world) with the reducer
    solved on measured tb. ``tb``: a precomputed profile, so that every
    policy of an A/B grid is solved from the same measurement; by default
    it is measured here for the policies that need it (mgwfbp, auto).
    ``group``: the process group the step spans (default: the world).
    The step is the bench's (``bench._Grid.build_step``)."""
    import torch.distributed as dist

    from mgwfbp_tpu_torch.bench import _Grid
    from mgwfbp_tpu_torch.parallel.mesh import world_size

    world = world_size() if group is None else dist.get_world_size(group)
    grid = _Grid(model_name, batch, 1, device, compute_dtype,
                 cost_model_for(comm_profile, world))
    if tb is None and policy in ("mgwfbp", "auto"):
        tb = measure_tb(grid.model, grid.meta, batch, device, compute_dtype)
    step, reducer = grid.build_step(policy, tb, group=group, nsteps=nsteps)
    return grid.model, grid.meta, step, reducer, world


def _trace(model_name, batch, policy, nsteps, steps, comm_profile, device):
    """(setup, trace path, group rows): ``steps`` steps traced after one of
    warm-up; the trace lands in a new temporary directory."""
    from mgwfbp_tpu_torch.bench import random_batch
    from mgwfbp_tpu_torch.profiling import _sync as sync
    from mgwfbp_tpu_torch.profiling import trace_group_rows

    model, meta, step, reducer, world = _build_setup(
        model_name, batch, policy, nsteps, comm_profile, device=device)
    x, y = random_batch(meta, nsteps, batch, device)
    step(x, y)  # warm-up: cuDNN's choice, the reducer's buffers
    sync(device)

    def run_steps():
        for _ in range(steps):
            step(x, y)
        sync(device)

    logdir = tempfile.mkdtemp(prefix="mgwfbp_trace_")
    rows = trace_group_rows(run_steps, logdir=logdir)
    if reducer is not None:
        reducer.detach()
    return (meta, reducer, world), logdir, rows


def _header(model_name, policy, nsteps, world, device, reducer) -> dict:
    from mgwfbp_tpu_torch.utils.device import device_kind

    return {
        "model": model_name,
        "policy": policy,
        "nsteps_update": nsteps,
        "n_devices": world,
        "device_kind": device_kind(device),
        "merge_groups": reducer.num_groups if reducer else 0,
    }


def predicted_vs_actual(schedule, rows, steps: int) -> list[dict]:
    """Each merge group's predicted (bytes, seconds) beside the mean device
    seconds per step of the NCCL kernels launched in its range; a group
    whose range holds none (one rank, the CPU) has no measured field."""
    from mgwfbp_tpu_torch.parallel.allreduce import group_scope_name
    from mgwfbp_tpu_torch.profiling import is_collective_kernel

    out = []
    for gi, (nbytes, pred) in enumerate(schedule.predicted_group_times):
        tag = group_scope_name(gi) + " "
        durs = [d for ident, d in rows if ident.startswith(tag)
                and is_collective_kernel(ident[len(tag):])]
        row = {"group": gi, "bytes": nbytes, "predicted_s": pred}
        if durs:
            meas = sum(durs) * 1e-6 / max(steps, 1)
            row["measured_s"] = round(meas, 9)
            row["measured_over_predicted"] = (
                round(meas / pred, 3) if pred > 0 else None)
        out.append(row)
    return out


def capture_and_report(model_name, batch, policy, nsteps, steps=5,
                       comm_profile=None, device="cuda") -> dict:
    (meta, reducer, world), logdir, rows = _trace(
        model_name, batch, policy, nsteps, steps, comm_profile, device)
    out = summarize_overlap(logdir)
    out.update(_header(model_name, policy, nsteps, world, device, reducer))
    out["trace_dir"] = logdir
    if reducer is not None:
        # the order the traced steps issued the groups' collectives in, and
        # the groups that order held back on the last step's hooks beside
        # those group order would have held
        from mgwfbp_tpu_torch.parallel.allreduce import held_groups

        groups = [list(g) for g in reducer.layout.groups]
        out["launch_sequence"] = reducer.launch_sequence
        out["held_groups"] = {
            "group_order": held_groups(groups, reducer.arrivals),
            "launch_sequence": held_groups(groups, reducer.arrivals,
                                           reducer.launch_sequence)}
    if reducer is not None and reducer.schedule.predicted_group_times:
        # the reference logs the prediction and times each merged tensor's
        # all-reduce in its loop (distributed_optimizer.py:256-259,
        # 374-391); here each group's range names its kernels
        out["predicted_vs_actual"] = predicted_vs_actual(
            reducer.schedule, rows, steps)
        out["alignment"] = (
            "by group: each row's measured_s is the NCCL kernels launched "
            "inside that group's mgwfbp_groupNNNN range (no measured_s: "
            "the range launched no collective kernel)")
    return out


def launch_order_schedule_report(model_name, batch, policy, nsteps,
                                 comm_profile=None, device="cuda") -> dict:
    """``--mode hlo``: one traced step's launch order (module docstring)."""
    (meta, reducer, world), logdir, _ = _trace(
        model_name, batch, policy, nsteps, 1, comm_profile, device)
    return {"mode": "launch_order",
            **_header(model_name, policy, nsteps, world, device, reducer),
            **launch_order_report(logdir), "trace_dir": logdir}


def write_report(report: dict, out) -> None:
    """Print ``report`` (indented JSON) and write it to ``out`` if given."""
    text = json.dumps(report, indent=2)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            f.write(text)
    print(text, flush=True)


def run_tool(main_fn, args):
    """Start the launch environment's group (one rank: a group of this
    process alone) on ``args.device`` (``cuda`` fails without a card) over
    ``args.backend``, run ``main_fn(device, rank)`` and end the group it
    started."""
    import torch.distributed as dist

    from mgwfbp_tpu_torch.parallel.mesh import rank, start_group
    from mgwfbp_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)  # a missing card fails here, never the CPU
    rdv = tempfile.TemporaryDirectory(prefix="mgwfbp_tool_")
    device, started = start_group(args.device, rdv.name, args.backend)
    try:
        return main_fn(device, rank())
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
        rdv.cleanup()


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    """``--device`` (the card unless asked for the CPU) and ``--backend``."""
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="the process group's backend (default: nccl on "
                         "the card, gloo on the CPU; gloo lets several "
                         "ranks share one card)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mgwfbp_tpu_torch.tools.overlap_report",
        description="comm/compute overlap of the train step from a "
                    "torch.profiler trace")
    ap.add_argument("--model", default="resnet20")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--policy", default="mgwfbp")
    ap.add_argument("--nsteps", type=int, default=1)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--mode", choices=["trace", "hlo"], default="trace",
                    help="trace: concurrency on the card's lanes; hlo: the "
                         "trace's launch order (torch has no HLO)")
    ap.add_argument("--comm-profile", dest="comm_profile", default=None,
                    help="calibrated profile (calibrate --out)")
    ap.add_argument("--out", default=None)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    from mgwfbp_tpu_torch.utils.device import set_matmul_precision

    set_matmul_precision(None)
    t0 = time.perf_counter()

    def body(device, rank):
        if args.mode == "hlo":
            report = launch_order_schedule_report(
                args.model, args.batch, args.policy, args.nsteps,
                args.comm_profile, device)
        else:
            report = capture_and_report(
                args.model, args.batch, args.policy, args.nsteps, args.steps,
                args.comm_profile, device)
        report["seconds"] = time.perf_counter() - t0
        if rank == 0:
            write_report(report, args.out)

    run_tool(body, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
