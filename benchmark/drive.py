"""One rank of a benchmark run.

Set-up builds the program's ``Trainer`` as a user of a data-parallel
trainer would (``make_config`` of the configuration's model, the traffic's
per-card batch, policy and lowering, bfloat16, a constant learning rate,
no augmentation, checkpoints or telemetry), hands it the seeded weights,
and drives ``Trainer.step_batch`` through the correctness check's first
steps and a warm-up on a pool of seeded device batches. The window then
runs a fixed number of steps with no host synchronisation inside it; the
traced run adds the exposed-communication probe and a profiled stretch.
Once the window has closed and the peak memory is read, the program is
freed and the plain reference repeats the check's steps.
"""

from __future__ import annotations

import contextlib
import gc
import os
import statistics
import sys
import time
import types

import torch
import torch.distributed as dist

from benchmark import check, faults, spec, trace as trace_lib, weights

FORBIDDEN = ("jax", "jaxlib", "flax", "mgwfbp_tpu")
CHECK_STEPS = 3
WARM_STEPS = 3
TIMED_WARM_STEPS = 8
PROBE_STEPS = 20
PROFILED_STEPS = 5


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the benchmark must never
    load, compared whole (the program's name begins with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Clock:
    """Step boundaries: CUDA events on the card, the host clock on the
    CPU (where every operation is synchronous)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def gaps(self, marks: list) -> list[float]:
        """Seconds between consecutive marks (after a sync)."""
        self.sync()
        if self.cuda:
            return [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
        return [b - a for a, b in zip(marks, marks[1:])]


def build_trainer(cell: spec.Cell, seed: int, device: torch.device,
                  logdir: str):
    from mgwfbp_tpu_torch.config import make_config
    from mgwfbp_tpu_torch.train.trainer import Trainer

    c, t, opt = cell.config, cell.traffic, cell.config["optimizer"]
    cfg = make_config(
        c["program_model"], dataset=c["program_dataset"],
        batch_size=int(t["batch_per_card"]), dtype=c["dtype"],
        policy=t["policy"], comm_op=t["comm_op"], lr=float(opt["lr"]),
        lr_schedule=opt["schedule"], momentum=float(opt["momentum"]),
        weight_decay=float(opt["weight_decay"]), augment=False,
        logdir=logdir, checkpoint_dir=None, telemetry=False,
        seed=int(seed) % (2 ** 31),
    )
    return Trainer(cfg, device=device, synthetic_data=True)


@torch.no_grad()
def prime(model: torch.nn.Module, optimizer, w: dict) -> None:
    """The seeded weights into ``model``, its batch-norm statistics and the
    optimizer's state reset."""
    named = dict(model.named_parameters())
    if set(named) != set(w):
        raise ValueError(f"the model's leaves differ from the "
                         f"configuration's: {sorted(set(named) ^ set(w))[:6]}")
    for name, p in named.items():
        p.copy_(w[name])
    for m in model.modules():
        if isinstance(getattr(m, "running_mean", None), torch.Tensor):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    optimizer.state.clear()


def leaf_norms(tensors: list[torch.Tensor]) -> list[float]:
    """Each tensor's L2 norm, accumulated in float64."""
    return torch.stack([t.double().norm() for t in tensors]).tolist()


def program_check(trainer, feed, names: list[str]) -> dict:
    """The check's readings of the program: its first ``CHECK_STEPS``
    steps through ``step_batch`` on pool batches 0, 1, 2."""
    params = dict(trainer.model.named_parameters())
    p0 = [params[k].detach().clone() for k in names]
    losses = []
    for i in range(CHECK_STEPS):
        losses.append(trainer.step_batch(*feed(i))["loss"])
        if i == 0:
            state = trainer.optimizer.state
            grad = leaf_norms([
                state[params[k]].get("momentum_buffer",
                                     torch.zeros_like(params[k]))
                if params[k] in state else torch.zeros_like(params[k])
                for k in names])
    change = leaf_norms([params[k].detach() - a for k, a in zip(names, p0)])
    return {"losses": [float(v) for v in losses], "grad": grad,
            "change": change}


def reference_check(cell: spec.Cell, seed: int, feed, device: torch.device,
                    world: int, quant=None) -> dict:
    """The same readings of the plain reference in float32 (TF32 off) on
    the same seeded weights and batches; at several ranks each rank's
    gradient is averaged over the ranks, as data-parallel SGD does."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = cell.config
    ref = spec.family_module("reference", c["family"])
    leaves = spec.family_module("work", c["family"]).params(c)
    names = [n for n, _, _ in leaves]
    p = {k: v.clone() for k, v in
         weights.make_weights(leaves, seed, device).items()}
    p0 = {k: v.clone() for k, v in p.items()}
    bufs: dict = {}
    losses = []
    for i in range(CHECK_STEPS):
        x, y = feed(i)
        loss, g = ref.loss_and_grads(c, p, x[0], y[0], quant)
        if world > 1:
            flat = torch.cat([loss.reshape(1)]
                             + [g[k].reshape(-1) for k in names])
            dist.all_reduce(flat)
            flat.div_(world)
            loss = flat[0]
            g = {k: v.view_as(g[k]) for k, v in
                 zip(names, flat[1:].split([g[k].numel() for k in names]))}
        ref.sgd_step(p, bufs, g, c["optimizer"])
        losses.append(float(loss))
        if i == 0:
            grad = leaf_norms([bufs[k] for k in names])
        del g
    change = leaf_norms([p[k] - p0[k] for k in names])
    return {"losses": losses, "grad": grad, "change": change}


def gather(value, world: int, device: torch.device) -> list:
    """Every rank's float list (or float) at every rank."""
    if world == 1:
        return [value]
    t = torch.tensor(value, dtype=torch.float64, device=device)
    out = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(out, t)
    return [o.tolist() for o in out]


def broadcast_int(value: int, device: torch.device, world: int) -> int:
    if world == 1:
        return value
    t = torch.tensor([value], dtype=torch.int64, device=device)
    dist.broadcast(t, 0)
    return int(t.item())


def local_step_s(trainer, w: dict, feed, clock: Clock, start: int,
                 rank: int, world: int) -> float:
    """Median event-timed step of a second copy of the model through a
    ``TrainStep`` with no reducer over a one-rank group: the same step on
    the same card with no collective."""
    from mgwfbp_tpu_torch import models as zoo
    from mgwfbp_tpu_torch.optim import make_optimizer
    from mgwfbp_tpu_torch.train.step import TrainStep

    cfg = trainer.config
    groups = [dist.new_group([r], backend="gloo") for r in range(world)]
    model, meta = zoo.create_model(cfg.dnn, dataset=cfg.dataset)
    model = zoo.for_training(model).to(trainer.device)
    optimizer, lr_fn, _ = make_optimizer(
        model.parameters(), cfg.lr, momentum=cfg.momentum,
        weight_decay=cfg.weight_decay, lr_schedule=cfg.lr_schedule,
        dataset=cfg.dataset)
    prime(model, optimizer, w)
    step = TrainStep(model, optimizer, lr_fn, grad_guard=cfg.grad_guard,
                     task=meta.task, compute_dtype=trainer.compute_dtype,
                     group=groups[rank])
    for i in range(WARM_STEPS):
        step(*feed(start + i))
    marks = [clock.mark()]
    for i in range(PROBE_STEPS):
        step(*feed(start + i))
        marks.append(clock.mark())
    out = statistics.median(clock.gaps(marks))
    del step, model, optimizer
    return out


def profile_steps(trainer, feed, clock: Clock, start: int, path: str,
                  device: torch.device) -> float:
    """``PROFILED_STEPS`` steps under torch.profiler, each in a
    ``trace.STEP`` range, after one profiled step that the reading leaves
    out; the trace goes to ``path``. Returns the wall seconds a profiled
    step took."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        trainer.step_batch(*feed(start))
        clock.sync()
        t0 = time.perf_counter()
        for i in range(PROFILED_STEPS):
            with torch.profiler.record_function(trace_lib.STEP):
                trainer.step_batch(*feed(start + 1 + i))
        clock.sync()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    return wall / PROFILED_STEPS


def run_rank(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, rank: int, world: int, t_start: float,
             workdir: str, fault: str = None) -> dict:
    """Everything one rank does; rank 0 returns the run's result (the
    others a stub). ``t_start`` is the wall time the run began at."""
    c, t = cell.config, cell.traffic
    work = spec.family_module("work", c["family"])
    names = [n for n, _, _ in work.params(c)]
    clock = Clock(device)
    phases = {"start": time.time()}
    trainer = build_trainer(cell, seed, device,
                            os.path.join(workdir, f"logs{rank}"))
    phases["trainer"] = time.time()
    sched = trainer.reducer.schedule if trainer.reducer is not None else None
    schedule = None if sched is None else {"groups": sched.num_groups,
                                           "policy": sched.policy_detail}
    w = weights.make_weights(work.params(c), seed, device)
    prime(trainer.model, trainer.optimizer, w)
    trainer.train_step.step = 0
    pool_x, pool_y = weights.make_batches(
        int(t["pool_batches"]), int(t["batch_per_card"]),
        int(c["in_channels"]), int(c["image_size"]), int(c["num_classes"]),
        seed, rank, device)

    def feed(i: int):
        j = i % pool_x.shape[0]
        return pool_x[j], pool_y[j]

    clock.sync()
    phases["weights_batches"] = time.time()
    planted = faults.plant(fault, trainer) if fault else contextlib.nullcontext()
    with planted:
        prog = program_check(trainer, feed, names)
        phases["check_steps"] = time.time()
        pos = CHECK_STEPS
        for _ in range(WARM_STEPS):
            trainer.step_batch(*feed(pos))
            pos += 1
        clock.sync()
        t0 = time.perf_counter()
        for _ in range(TIMED_WARM_STEPS):
            trainer.step_batch(*feed(pos))
            pos += 1
        clock.sync()
        warm_s = (time.perf_counter() - t0) / TIMED_WARM_STEPS
        n = broadcast_int(max(int(round(seconds / warm_s)), 1), device, world)
        if world > 1:
            dist.barrier()
        # the window: no host synchronisation between its first launch and
        # the synchronisation after its last step
        clock.sync()
        phases["warm_up"] = time.time()
        setup_s = phases["warm_up"] - t_start
        t0 = time.perf_counter()
        marks, out = [clock.mark()], []
        for _ in range(n):
            out.append(trainer.step_batch(*feed(pos)))
            marks.append(clock.mark())
            pos += 1
        clock.sync()
        window_s = time.perf_counter() - t0
        gaps = clock.gaps(marks)
        failed = int((torch.stack([m["grads_nonfinite"] for m in out]) > 0)
                     .sum())
        del out
        step_s = [max(col) for col in zip(*gather(gaps, world, device))]
        stray = forbidden_modules()
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        peak = max(gather(float(peak), world, device))
        ctx = types.SimpleNamespace(
            config=c, traffic=t, work=work, chips=cell.chips, world=world,
            batch=int(t["batch_per_card"]), peak=None, trace=None,
            probe=None, window=dict(steps=n, seconds=window_s,
                                    images=n * int(t["batch_per_card"]) * world,
                                    step_s=step_s, setup_s=setup_s),
            family=spec.kernel_family)
        if device.type == "cuda":
            ctx.peak = spec.peaks().get(torch.cuda.get_device_name(device))
        extra = {}
        if trace:
            if world > 1:
                local = max(gather(local_step_s(trainer, w, feed, clock, pos,
                                                rank, world), world, device))
                ctx.probe = dict(trainer_s=statistics.median(step_s),
                                 local_s=local)
                dist.barrier()
            path = os.path.join(workdir, f"trace{rank}.json")
            profiled_s = profile_steps(trainer, feed, clock, pos, path, device)
            view = trace_lib.TraceView.from_file(path)
            families = spec.kernel_families()
            os.remove(path)
            busy = gather([view.busy_s, view.window_s], world, device)
            if rank == 0:
                ctx.trace = view
                extra = dict(
                    busy_s=statistics.fmean(b for b, _ in busy),
                    window_s=statistics.fmean(wd for _, wd in busy),
                    breakdown={"device_ops": view.top_ops(),
                               "idle_gaps": view.idle_gaps()},
                    profiler_overhead={
                        "profiled_step_s": profiled_s,
                        "unprofiled_step_s": statistics.median(step_s)},
                    kernel_families={
                        "steps": view.steps,
                        "device_s": view.busy_s,
                        **{k: view.family_s(f) for k, f in families.items()},
                        "unclassified": view.unclassified(families)})
    metrics_of = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    if rank == 0:
        for m in metrics_of:
            v = spec.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    # the check runs once the program is freed: a process's peak never
    # falls again, so the reference must not set it
    del trainer, w, planted
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_check(cell, seed, feed, device, world)
    values = check.numbers(prog, ref)
    worst = [max(col) for col in zip(*gather(
        [values[k] for k in sorted(values)], world, device))]
    values = dict(zip(sorted(values), worst))
    stray = sorted(set(stray) | set(forbidden_modules()))
    stray_any = max(gather(float(bool(stray)), world, device))
    if rank != 0:
        return {"stray": stray}
    ok, rows = check.judge(values, cell.limits)
    result = {
        "correct": ok, "attempted": n, "failed": failed, "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": world, "memory_peak_bytes": int(peak),
        },
    }
    if trace:
        result["device"]["busy_s"] = extra.get("busy_s", 0.0)
        result["device"]["window_s"] = extra.get("window_s", 0.0)
        result["breakdown"] = extra.get("breakdown")
        result["profiler_overhead"] = extra.get("profiler_overhead")
        result["kernel_families"] = extra.get("kernel_families")
    if schedule is not None:
        result["schedule"] = schedule
    marks = [t_start] + list(phases.values())
    result["setup_phases_s"] = dict(zip(
        ["imports_cuda"] + list(phases)[1:],
        [b - a for a, b in zip(marks, marks[1:])]))
    result["step_ms"] = {"min": 1e3 * min(step_s),
                         "p50": 1e3 * statistics.median(step_s),
                         "max": 1e3 * max(step_s),
                         "over_1.2x_p50": sum(
                             s > 1.2 * statistics.median(step_s)
                             for s in step_s)}
    result["losses"] = {"program": prog["losses"], "reference": ref["losses"]}
    result["checks"] = rows
    result["stray"] = stray if stray else (["another rank"] if stray_any
                                           else [])
    return result
