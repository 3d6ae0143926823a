"""Calibration and overlap accounting across several cards of one host.

    python3 chip_multicard.py                       # every card of the host
    python3 chip_multicard.py --device cpu --processes 4 --min-log2 8 \\
        --max-log2 10 --iters 2 --warmup 1 --gamma-total-log2 12 \\
        --batches 2                                 # a gloo rehearsal

Two steps, each N processes (one per card, ``LOCAL_RANK`` = process id)
started together on a localhost rendezvous:

  1. ``python -m mgwfbp_tpu_torch.calibrate --world-sizes 1,2,..,N``: a
     family profile measured over the first n ranks for each n;
  2. ``python -m mgwfbp_tpu_torch.train_cli --dnn resnet20 --synthetic
     --policy mgwfbp --comm-profile <family> --telemetry`` with
     ``MGWFBP_TELEMETRY_TRACE=1``: ResNet-20 at the per-worker batch 32 on
     the family resolved at N, two traced steps, then the epochs.

Prints the calibrated constants per world size, each rank's resolved cost
model, schedule, traced per-group device times (or why none) and last
overlap record, and one JSON line ``{"multicard": ...}``. Every process is
joined with a timeout and killed if it outlives it. Writes under
``--out-dir`` (default ``build/multicard``).

With ``--telemetry`` it runs another step instead: a supervised ResNet-20
group of N processes (``--fleet-port 0``, the live plane on every process,
``MGWFBP_AGREE_INTERVAL=1``) held at step 10, where ``/fleet/profile?steps=3``
arms every process; the group agrees on the window, and each process's
result carries every process's per-group device time
(``per_process_device_s``); the last process then sleeps 0.5 s before each
of steps 25-30, and every stream carries the same ``straggler`` records
naming it. Prints one JSON line ``{"multicard_telemetry": ...}``.

With ``--heal`` the script runs another step instead of those two: a
supervised ResNet-20
group of N processes (``python -m mgwfbp_tpu_torch.runtime.supervise``)
whose last process SIGKILLs itself after step 8
(``kill@step=8,proc=N-1``). The survivors are blocked in the step's
all-reduce, which the dead peer never joins (``MGWFBP_AGREE_INTERVAL=1000``
keeps the gloo drain vote out of the way, so the NCCL path is the one
measured); the collective timeout ``MGWFBP_COORD_TIMEOUT_S`` (30 s) ends
them. The healer shrinks the group to N-1, which resumes from the last
committed step under the n-N tag and trains to the end. Prints one JSON
line ``{"multicard_heal": ...}``: the exit codes of each incarnation, the
seconds from the kill to the survivors' exit, the heal, the resize and the
final step, and a survivor's timeline: its exit trace
(``MGWFBP_STACK_SAMPLE_S``: the main thread's frames and the teardown's
steps) and torch's C++ log at INFO (the NCCL watchdog's timeout, its
dump, the abort), each line in seconds after the kill (``heal: survivor``
lines).

With ``--lowerings`` it runs another step instead: N processes (one per
card, NCCL) train ResNet-50 (``--model``) at bfloat16 (``--dtype``) at
``--batch-size`` 128 per card on synthetic ImageNet-shaped batches drawn on
the card, LOWERINGS_STEPS steps each of the merged collectives lowered as
``all_reduce``, ``rs_ag``, ``rs_opt_ag`` (the sharded optimizer),
``all_reduce`` with the top-k compressor at density 0.01, ``rs_fwd_ag``
(the sharded optimizer with each all-gather deferred into the next step's
forward; at bfloat16 the forward waits for every gather before its cast)
and ``hier`` (``LOWERINGS_DCN`` slices of N / LOWERINGS_DCN cards, both
levels NVLink on one host: it checks the mechanism, not a slower link),
every run from the same initialisation on the same batches (policy mgwfbp
on the 10GbE constants at N, SGD momentum 0.9), each lowering in
processes of its own. Then ``calibrate --two-level --dcn LOWERINGS_DCN
--allgather`` over the N cards, and ``train_cli --dnn resnet20
--synthetic`` for LOWERINGS_CLI_STEPS steps with ``--comm-op rs_fwd_ag``
and with ``--comm-op hier --dcn-slices LOWERINGS_DCN``.
Prints one JSON line ``{"multicard_lowerings": ...}``: per lowering the
median step time, the peak memory, the optimizer-state bytes per card,
whether every rank holds the same parameters after the last step, the
parameters' relative distance to the all_reduce run's (a reading: each
run's own forward amplifies a rounding difference), and each process's
device timeline of one more, profiled step (``step_breakdown``). ``--device cpu --processes 4
--lowerings --model resnet20 --dtype float32 --batch-size 4`` rehearses it
over gloo.

With ``--autotune`` it runs another step instead: N processes (one per
card, NCCL) of ``train_cli --autotune --autotune-steps 3 --no-augment``
on ResNet-50 (``--model``) at bfloat16 (``--dtype``), ``--batch-size`` 128
per card, the 10GbE constants at N: configured for all_reduce (racing all_reduce
and rs_ag), then for rs_fwd_ag (racing all three), then the all_reduce
command again, which must load the committed winner from the schedule
cache without racing. Prints each candidate's measured and predicted step
and each winner against the configured lowering's solved schedule, and
one JSON line ``{"multicard_autotune": ...}``. ``--device cpu --processes
2 --autotune --model resnet20 --dtype float32 --batch-size 4`` rehearses it
over gloo.

With ``--seq-parallel S`` it runs another step instead: N processes (one
per card, NCCL) in rings of S (data N / S x seq S) run the checks of
``chip_smoke.py``'s phase (p2), through ``chip_smoke.seq_rank``: the ring
against ``local_attention`` on each card (p1), one step of ``train_cli
--seq-parallel S``'s Trainer (dropout off, a constant rate) against a dense
step on the world's global batch, and SEQ_STEPS steps of the user's command
(the full-width transformer preset, policy auto over the world): the
median step, the ring's point-to-point operations per step, the merge
groups and those the group order held back. Prints one JSON line
``{"multicard_seq": ...}``. ``--device cpu --processes 4 --seq-parallel 2``
rehearses it over gloo.

With ``--tools`` it runs another step instead: the measuring tools at N
processes (one per card, NCCL; ResNet-20 at ``--batch-size`` per card): a
family calibrated over the first 1, 2, 4 .. ranks (``calibrate
--world-sizes``), then ``tools.overlap_report`` (its collective rows must
be NCCL kernels, each with the compute that ran beside it, and each merge
group's predicted time beside its kernels' measured one),
``tools.policy_grid`` at N, ``tools.scaling_efficiency`` at every extent
with predictions on the family, and ``tools.two_level_validation`` at
(N / 2) x 2. Prints one JSON line ``{"multicard_tools": ...}``.
``--device cpu --processes 4 --tools --batch-size 4 --min-log2 8
--max-log2 10 --iters 2 --warmup 1 --gamma-total-log2 12`` rehearses it
over gloo.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_group(n: int, argv: list[str], out_dir: str, name: str,
               timeout_s: float, extra_env: dict) -> list[str]:
    """Start ``python -m <argv>`` in n processes of one world; return each
    one's standard output. Fails (exit 1) on a non-zero exit or a hang."""
    port = _free_port()
    procs, logs = [], []
    for r in range(n):
        env = dict(os.environ, PYTHONPATH=ROOT,
                   MGWFBP_COORDINATOR=f"127.0.0.1:{port}",
                   MGWFBP_NUM_PROCESSES=str(n), MGWFBP_PROCESS_ID=str(r),
                   LOCAL_RANK=str(r), **extra_env)
        log = open(os.path.join(out_dir, f"{name}.rank{r}.err"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", *argv], stdout=subprocess.PIPE,
            stderr=log, text=True, cwd=out_dir, env=env,
        ))
    outs, codes = [], []
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                out = ""
            outs.append(out)
            codes.append(p.poll())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
        for log in logs:
            log.close()
    if codes != [0] * n:
        print(f"chip_multicard: {name} ranks exited {codes} (logs in "
              f"{out_dir})", file=sys.stderr, flush=True)
        raise SystemExit(1)
    return outs


LOWERINGS_STEPS = 10
LOWERINGS = (("all_reduce", "all_reduce", None),
             ("rs_ag", "rs_ag", None),
             ("rs_opt_ag", "rs_opt_ag", None),
             ("topk", "all_reduce", 0.01),
             ("rs_fwd_ag", "rs_fwd_ag", None),
             ("hier", "hier", None))
LOWERINGS_DCN = 2  # hier's slices (and calibrate --two-level's)
LOWERINGS_CLI_STEPS = 10  # each train_cli run of the --lowerings step


def _union(intervals) -> list:
    """Sorted, merged (start, end) intervals."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def _uncovered(intervals, cover) -> float:
    """The length of ``intervals`` (merged) that ``cover`` (merged) does
    not overlap."""
    covered = 0.0
    for a, b in intervals:
        for c, d in cover:
            covered += max(0.0, min(b, d) - max(a, c))
    return _length(intervals) - covered


def step_breakdown(prof) -> dict:
    """The device timeline of one profiled step, in ms: its span (first
    device activity to last), the time anything ran, the compute (every
    kernel and copy but NCCL's) and the collectives (NCCL's kernels), the
    collectives' time that no compute overlaps, each collective kind's
    count and time, and the same after the metrics' device-to-host copy
    (the optimizer update and what it launches)."""
    from torch.autograd import DeviceType

    sys.path.insert(0, ROOT)
    from mgwfbp_tpu_torch.parallel.allreduce import (
        CLIP_NORM_SCOPE,
        GROUP_SCOPE_PREFIX,
    )

    # kernels, copies and sets only: the device-side ranges of
    # record_function annotations (NCCL's "nccl:*", the group scopes)
    # repeat or span them
    ev = [(e.time_range.start, e.time_range.end, e.name)
          for e in prof.events() if e.device_type == DeviceType.CUDA
          and not getattr(e, "is_user_annotation", False)
          and not e.name.startswith(("nccl:", GROUP_SCOPE_PREFIX,
                                     CLIP_NORM_SCOPE))]
    if not ev:
        return {"reason": "no device activity in the trace"}

    def part(events) -> dict:
        comm = _union((a, b) for a, b, n in events if "nccl" in n.lower())
        comp = _union((a, b) for a, b, n in events if "nccl" not in n.lower())
        span = (max(b for _, b, _ in events) - min(a for a, _, _ in events)
                if events else 0.0)
        busy = _length(_union((a, b) for a, b, _ in events))
        return {"span_ms": span / 1e3, "busy_ms": busy / 1e3,
                "idle_share": 1.0 - busy / span if span > 0 else None,
                "compute_ms": _length(comp) / 1e3,
                "collective_ms": _length(comm) / 1e3,
                "collective_exposed_ms": _uncovered(comm, comp) / 1e3}

    out = part(ev)
    kinds: dict = {}
    for a, b, n in ev:
        if "nccl" not in n.lower():
            continue
        kind = next((k for k in ("ReduceScatter", "AllGather", "AllReduce",
                                 "Broadcast") if k in n), "other")
        d = kinds.setdefault(kind, {"count": 0, "ms": 0.0})
        d["count"] += 1
        d["ms"] += (b - a) / 1e3
    out["collectives"] = kinds
    d2h = [b for _, b, n in ev if "DtoH" in n]
    if d2h:
        t = min(d2h)
        out["after_metrics_read"] = part([e for e in ev if e[0] >= t])
    return out


def lowerings_rank(label: str, model_name: str, dtype: str, batch_size: int,
                   device: str) -> dict:
    """One rank of one lowering of the --lowerings step (its world from the
    launch environment): LOWERINGS_STEPS timed steps from one
    initialisation on the same batches, then one profiled step (on the
    card). Process 0 writes the parameters after them to
    ``lowerings_final_<label>.npy`` in the working directory."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from mgwfbp_tpu_torch.models import create_model
    from mgwfbp_tpu_torch.models.common import init_weights
    from mgwfbp_tpu_torch.optim import make_optimizer
    from mgwfbp_tpu_torch.parallel.allreduce import make_merged_allreduce
    from mgwfbp_tpu_torch.parallel.compression import TopKCompressor
    from mgwfbp_tpu_torch.parallel.costmodel import lookup_alpha_beta
    from mgwfbp_tpu_torch.parallel.mesh import init_distributed, two_level_groups
    from mgwfbp_tpu_torch.train import TrainStep
    from mgwfbp_tpu_torch.utils.device import set_matmul_precision

    op, density = {lab: (o, d) for lab, o, d in LOWERINGS}[label]
    compute = None if dtype == "float32" else getattr(torch, dtype)
    set_matmul_precision(compute)
    dev = init_distributed(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    cuda = dev.type == "cuda"
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out: dict = {"world": world, "model": model_name, "dtype": dtype,
                 "batch_per_card": batch_size}
    try:
        model, meta = create_model(model_name)
        init_weights(model, torch.Generator().manual_seed(5)).to(dev)
        opt, lr_fn, _, spec = make_optimizer(
            model.parameters(), 0.1, num_batches_per_epoch=100,
            world_size=world, return_spec=True)
        reducer = make_merged_allreduce(
            model, policy="mgwfbp",
            cost_model=lookup_alpha_beta("10GbE", world), comm_op=op,
            compressor=TopKCompressor(density) if density else None,
            optim_spec=spec if op in ("rs_opt_ag", "rs_fwd_ag") else None,
            world_size=world,
            levels=two_level_groups(LOWERINGS_DCN) if op == "hier" else None)
        step = TrainStep(model, opt, lr_fn, reducer=reducer,
                         compute_dtype=compute)
        hw = meta.input_shape[:2]
        gen = torch.Generator(device=dev)

        def batch(k):
            gen.manual_seed(1000 * k + rank)
            x = torch.randn((1, batch_size, 3, *hw), generator=gen,
                            device=dev)
            y = torch.randint(0, meta.num_classes, (1, batch_size),
                              generator=gen, device=dev)
            return x, y

        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        times, losses = [], []
        for k in range(LOWERINGS_STEPS):
            x, y = batch(k)
            t0 = time.perf_counter()
            m = step(x, y)
            loss = float(m["loss"])  # waits for the step: nothing in it does
            times.append(time.perf_counter() - t0)
            losses.append(loss)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else None
        launches = reducer.launches
        breakdown = None
        if cuda:
            # before the parameters are read: rs_fwd_ag's profiled step
            # then gathers the last timed update in its forward
            from torch.profiler import ProfilerActivity, profile

            x, y = batch(LOWERINGS_STEPS)
            torch.cuda.synchronize(dev)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step(x, y)
                torch.cuda.synchronize(dev)
                traced_ms = (time.perf_counter() - t0) * 1e3
            breakdown = {"host_step_ms": traced_ms, **step_breakdown(prof)}
        reducer.materialize()  # rs_fwd_ag: the last update's gathers
        flat = torch.cat([p.detach().reshape(-1).float()
                          for p in model.parameters()])
        gathered = [torch.empty_like(flat) for _ in range(world)]
        dist.all_gather(gathered, flat)
        same = all(torch.equal(t, gathered[0]) for t in gathered)
        if rank == 0:
            np.save(f"lowerings_final_{label}.npy", flat.cpu().numpy())
        del gathered, flat
        if op in ("rs_opt_ag", "rs_fwd_ag"):
            opt_bytes = reducer.optim.state_bytes_per_device()
        else:
            opt_bytes = sum(
                s["momentum_buffer"].numel()
                * s["momentum_buffer"].element_size()
                for s in opt.state.values() if "momentum_buffer" in s)
        out.update({
            "comm_op": reducer.comm_op, "density": density,
            "num_groups": reducer.num_groups,
            "dcn_groups": len(reducer.dcn_groups),
            "collectives_per_step": launches / LOWERINGS_STEPS,
            "step_ms_median": float(np.median(times[2:])) * 1e3,
            "step_ms": [t * 1e3 for t in times],
            "peak_memory_bytes": peak if cuda else "not measured (CPU)",
            "opt_state_bytes_per_card": int(opt_bytes),
            "params_equal_across_ranks": bool(same),
            "first_loss": losses[0], "last_loss": losses[-1],
            "traced_step": breakdown if cuda else "not measured (CPU)",
            "device_kind": (torch.cuda.get_device_name(dev) if cuda
                            else "cpu"),
        })
        reducer.detach()
    finally:
        dist.destroy_process_group()
    return out


def _two_level_calibration(n: int, device: str, out_dir: str, sweep: list,
                           env: dict) -> dict:
    """``calibrate --two-level --dcn LOWERINGS_DCN --allgather`` over the N
    processes: each link's alpha, beta and the inner link's ag_fraction
    (both links NVLink on one host)."""
    out = os.path.join(out_dir, "two_level.json")
    t0 = time.perf_counter()
    outs = _run_group(
        n, ["mgwfbp_tpu_torch.calibrate", "--out", out, "--two-level",
            "--dcn", str(LOWERINGS_DCN), "--allgather", "--device", device,
            *sweep], out_dir, "calibrate_two_level", 900, env)
    report = json.loads(outs[0].strip().splitlines()[-1])
    report["seconds"] = time.perf_counter() - t0
    print(f"calibrate --two-level: ici alpha {report['ici']['alpha_s']:.4g} s"
          f", beta {report['ici']['beta_s_per_byte']:.4g} s/B, ag_fraction "
          f"{report['ici']['ag_fraction']:.4g}; dcn alpha "
          f"{report['dcn']['alpha_s']:.4g} s, beta "
          f"{report['dcn']['beta_s_per_byte']:.4g} s/B ({report['mesh']})",
          flush=True)
    return report


def _cli_run(n: int, device: str, out_dir: str, label: str, flags: list,
             env: dict) -> dict:
    """``train_cli --dnn resnet20 --synthetic`` at N processes for
    LOWERINGS_CLI_STEPS steps with ``flags``: the processes' result lines
    (which must agree) and the seconds."""
    t0 = time.perf_counter()
    outs = _run_group(
        n, ["mgwfbp_tpu_torch.train_cli", "--dnn", "resnet20", "--synthetic",
            "--device", device, "--epochs", "1", "--num-batches-per-epoch",
            str(LOWERINGS_CLI_STEPS), "--policy", "mgwfbp", "--logdir",
            os.path.join(out_dir, f"cli_{label}"), *flags],
        out_dir, f"cli_{label}", 900, env)
    docs = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    if not all(d == docs[0] for d in docs):
        print(f"chip_multicard: train_cli {label}: the processes' results "
              "differ", file=sys.stderr, flush=True)
        raise SystemExit(1)
    secs = time.perf_counter() - t0
    print(f"train_cli {' '.join(flags)}: {n} processes, "
          f"{LOWERINGS_CLI_STEPS} steps, train {docs[0]['train']}, eval "
          f"{docs[0].get('eval')} ({secs:.1f} s)", flush=True)
    return {"result": docs[0], "seconds": secs}


def lowerings_phase(n: int, device: str, out_dir: str, batch_size: int,
                    model: str, dtype: str, env: dict,
                    sweep: list = ()) -> dict:
    """The --lowerings step: each lowering in its own N processes (so that
    each peak memory is its own); fails when the ranks' parameters differ
    after a run."""
    import numpy as np

    t0 = time.perf_counter()
    res: dict = {"runs": {}}
    finals = {}
    for label, _, _ in LOWERINGS:
        outs = _run_group(
            n, ["chip_multicard", "--lowerings-rank", label, "--model", model,
                "--dtype", dtype, "--batch-size", str(batch_size),
                "--device", device], out_dir, f"lowerings_{label}", 900, env)
        docs = [json.loads(o.strip().splitlines()[-1]) for o in outs]
        if not all(d["params_equal_across_ranks"] for d in docs):
            print(f"chip_multicard: lowerings {label}: the ranks' "
                  "parameters differ", file=sys.stderr, flush=True)
            raise SystemExit(1)
        r = docs[0]
        for key in ("world", "model", "dtype", "batch_per_card",
                    "device_kind"):
            res[key] = r.pop(key)
        # each process's own profiled step: a collective's kernel on the
        # process that reaches it first also waits for the others
        r["traced_step_by_rank"] = [d.pop("traced_step") for d in docs]
        res["runs"][label] = r
        path = os.path.join(out_dir, f"lowerings_final_{label}.npy")
        finals[label] = np.load(path).astype(np.float64)
        os.remove(path)
    base = finals["all_reduce"]
    for label, r in res["runs"].items():
        r["rel_l2_to_all_reduce"] = float(
            np.linalg.norm(finals[label] - base) / np.linalg.norm(base))
        tr = r["traced_step_by_rank"][0]
        traced = (f"; traced step {tr['host_step_ms']:.3f} ms host, device "
                  f"span {tr['span_ms']:.3f} ms, collectives "
                  f"{tr['collective_ms']:.3f} ms ({tr['collective_exposed_ms']:.3f}"
                  " exposed)" if isinstance(tr, dict) and "span_ms" in tr
                  else "")
        print(f"lowerings {label}: {r['num_groups']} groups"
              + (f" ({r['dcn_groups']} DCN groups)" if r["dcn_groups"]
                 else "") + ", "
              f"{r['collectives_per_step']:g} collectives per step, step "
              f"{r['step_ms_median']:.3f} ms (median of steps 3-"
              f"{LOWERINGS_STEPS}), peak memory {r['peak_memory_bytes']}, "
              f"opt-state {r['opt_state_bytes_per_card']} B per card, "
              f"parameters equal across {n} ranks, "
              f"{r['rel_l2_to_all_reduce']:.3g} from all_reduce{traced}",
              flush=True)
    res["calibrate_two_level"] = _two_level_calibration(n, device, out_dir,
                                                        sweep, env)
    res["cli"] = {
        label: _cli_run(n, device, out_dir, label, flags, env)
        for label, flags in (
            ("rs_fwd_ag", ["--comm-op", "rs_fwd_ag"]),
            ("hier", ["--comm-op", "hier", "--dcn-slices",
                      str(LOWERINGS_DCN)]))}
    res["seconds"] = time.perf_counter() - t0
    if device != "cpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        res["cards"] = smi.stdout.strip().splitlines()
        print("\n".join(res["cards"]), flush=True)
    return res


AUTOTUNE_EPOCH_STEPS = 10  # each --autotune run's epoch after its race
AUTOTUNE_BASES = ("all_reduce", "rs_fwd_ag")  # the configured lowerings


def _race_table(entry: dict) -> list:
    return [{"label": e["label"], "comm_op": e["comm_op"],
             "num_groups": e["num_groups"], "verified": e["verified"],
             "measured_ms": None if e["measured_step_s"] is None
             else e["measured_step_s"] * 1e3,
             "predicted_ms": None if e["predicted_total_s"] is None
             else e["predicted_total_s"] * 1e3}
            for e in entry["race"]]


def autotune_phase(n: int, device: str, out_dir: str, batch_size: int,
                   model: str, dtype: str, env: dict) -> dict:
    """The --autotune step: ``train_cli --autotune --autotune-steps 3`` at
    N processes (one per card, NCCL) on ``--model`` at ``--dtype`` and
    ``--batch-size`` per card without augmentation (the host's augment of
    224 x 224 batches, 1.5 s a batch of 128, would set every step), the
    10GbE constants at N, configured for
    each of AUTOTUNE_BASES (all_reduce races all_reduce and rs_ag;
    rs_fwd_ag races all three), then the all_reduce command again (a cache
    hit). Fails when a run's processes disagree, an entry was not
    verified, or the second run raced; prints each candidate's step and
    the winner against all_reduce's solved schedule (the incumbent)."""
    t0 = time.perf_counter()
    cache = os.path.join(out_dir, "schedule_cache")
    shutil.rmtree(cache, ignore_errors=True)
    res: dict = {"model": model, "dtype": dtype, "batch_per_card": batch_size,
                 "world": n, "runs": {}}
    for label, base in [(b, b) for b in AUTOTUNE_BASES] + [
            ("cache_hit", "all_reduce")]:
        t1 = time.perf_counter()
        outs = _run_group(
            n, ["mgwfbp_tpu_torch.train_cli", "--dnn", model, "--synthetic",
                "--no-augment", "--device", device, "--dtype", dtype,
                "--batch-size", str(batch_size), "--connection", "10GbE",
                "--comm-op", base,
                "--autotune", "--autotune-steps", "3", "--schedule-cache",
                cache, "--epochs", "1", "--num-batches-per-epoch",
                str(AUTOTUNE_EPOCH_STEPS), "--logdir",
                os.path.join(out_dir, f"autotune_{label}")],
            out_dir, f"autotune_{label}", 900, env)
        docs = [json.loads(o.strip().splitlines()[-1]) for o in outs]
        if not all(d == docs[0] for d in docs):
            print(f"chip_multicard: autotune {label}: the processes' "
                  "results differ", file=sys.stderr, flush=True)
            raise SystemExit(1)
        with open(os.path.join(out_dir, f"autotune_{label}.rank0.err")) as f:
            log = f.read()
        (path,) = [os.path.join(cache, name) for name in os.listdir(cache)
                   if f"_{base}_" in name]
        with open(path) as f:
            entry = json.load(f)
        run = {"result": docs[0], "seconds": time.perf_counter() - t1,
               "winner": entry["winner"], "comm_op": entry["comm_op"],
               "num_groups": len(entry["groups"]),
               "winner_ms": entry["measured_step_s"] * 1e3}
        if label == "cache_hit":
            if "race skipped" not in log:
                print("chip_multicard: autotune: the second run raced",
                      file=sys.stderr, flush=True)
                raise SystemExit(1)
            run["cache_hit"] = True
            print(f"autotune cache hit: {entry['winner']} loaded, race "
                  f"skipped ({run['seconds']:.1f} s)", flush=True)
        else:
            table = _race_table(entry)
            if not all(r["verified"] for r in table):
                print(f"chip_multicard: autotune {label}: an entry was not "
                      "verified", file=sys.stderr, flush=True)
                raise SystemExit(1)
            run["race"] = table
            run["refit"] = entry.get("refit")
            fixed = next((r for r in table if r["comm_op"] == base), None)
            run["incumbent_ms"] = fixed["measured_ms"] if fixed else None
            for r in table:
                print(f"autotune {label}: {r['label']}: {r['num_groups']} "
                      f"groups, {r['measured_ms']:.3f} ms/step (predicted "
                      f"{(r['predicted_ms'] or float('nan')):.3f} ms)",
                      flush=True)
            print(f"autotune {label}: committed {entry['winner']} "
                  f"({run['num_groups']} groups, {entry['comm_op']}) at "
                  f"{run['winner_ms']:.3f} ms/step against {base}'s solved "
                  f"schedule's {run['incumbent_ms']} ms "
                  f"({run['seconds']:.1f} s)", flush=True)
        res["runs"][label] = run
    res["seconds"] = time.perf_counter() - t0
    if device != "cpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        res["cards"] = smi.stdout.strip().splitlines()
        print("\n".join(res["cards"]), flush=True)
    return res


HEAL_COORD_TIMEOUT_S = 30
HEAL_SAMPLE_S = 5  # the survivors' stack samples (the exit trace)


def _stamp(line: str) -> float:
    """Wall time of a log line (``YYYY-mm-dd HH:MM:SS,mmm ...``)."""
    day, ms = line[:23].split(",")
    return time.mktime(time.strptime(day, "%Y-%m-%d %H:%M:%S")) + int(ms) / 1e3


_GLOG = re.compile(r"\[[IWEF](\d\d)(\d\d) (\d\d):(\d\d):(\d\d)\.(\d+)")
_TRACE_WALL = re.compile(r"mgwfbp exit trace: .* wall (\d+\.\d+)")


def _line_wall(line: str, year: int):
    """Wall time of a survivor's log line: the exit trace's ``wall``,
    torch's C++ log prefix (``[E1018 18:47:35.826073503``, this year), or
    the Python logger's; None for any other line."""
    m = _TRACE_WALL.search(line)
    if m:
        return float(m.group(1))
    m = _GLOG.search(line)
    if m:
        mo, d, hh, mm, ss, frac = m.groups()
        return time.mktime((year, int(mo), int(d), int(hh), int(mm),
                            int(ss), 0, 0, -1)) + float("0." + frac)
    if re.match(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3}", line):
        return _stamp(line)
    return None


def survivor_timeline(log_path: str, kill_wall: float, exit_wall: float,
                      limit: int = 80) -> list:
    """(seconds after the kill, line) for every timestamped line of a
    survivor's log from the kill to its exit: torch's NCCL watchdog and
    c10d lines, the exit trace's marks and stack samples
    (``MGWFBP_STACK_SAMPLE_S``), the trainer's log."""
    year = time.localtime(kill_wall).tm_year
    out = []
    with open(log_path, errors="replace") as f:
        for line in f.read().splitlines():
            t = _line_wall(line, year)
            if t is not None and kill_wall - 1.0 <= t <= exit_wall + 1.0:
                out.append([round(t - kill_wall, 3), line[:240]])
    return out[:limit]


def heal_phase(n: int, device: str, out_dir: str, batch_size: int,
               env: dict) -> dict:
    """The supervised group, a SIGKILL of its last process, the survivors'
    exit through the collective timeout, the shrink to n-1 and its
    cross-world resume."""
    sys.path.insert(0, ROOT)
    from mgwfbp_tpu_torch.telemetry import events_of, read_events, stream_filename

    root = os.path.join(out_dir, "heal")
    shutil.rmtree(root, ignore_errors=True)
    log_dir = os.path.join(root, "sup")
    os.makedirs(log_dir)
    kill_step = 8
    cmd = [sys.executable, "-m", "mgwfbp_tpu_torch.runtime.supervise",
           "--processes", str(n), "--log-dir", log_dir, "--",
           "--dnn", "resnet20", "--synthetic", "--device", device,
           "--max-epochs", "2", "--num-batches-per-epoch", "12",
           "--batch-size", str(batch_size), "--ckpt-every-steps", "5",
           "--no-ckpt-async", "--telemetry",
           "--checkpoint-dir", os.path.join(root, "ckpt"),
           "--logdir", os.path.join(root, "logs")]
    full_env = dict(os.environ, PYTHONPATH=ROOT, **env,
                    MGWFBP_FAULT_PLAN=f"kill@step={kill_step},proc={n - 1}",
                    MGWFBP_COORD_TIMEOUT_S=str(HEAL_COORD_TIMEOUT_S),
                    MGWFBP_AGREE_INTERVAL="1000", MGWFBP_METRICS_PORT="0",
                    MGWFBP_STACK_SAMPLE_S=str(HEAL_SAMPLE_S),
                    TORCH_CPP_LOG_LEVEL="INFO")
    t0 = time.perf_counter()
    with open(os.path.join(root, "supervise.err"), "w") as err:
        p = subprocess.Popen(cmd, stdout=err, stderr=subprocess.STDOUT,
                             env=full_env, cwd=out_dir)
        try:
            rc = p.wait(timeout=900)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rc = None
    wall = time.perf_counter() - t0
    with open(os.path.join(root, "supervise.err")) as f:
        lines = f.read().splitlines()
    if rc != 0:
        print("chip_multicard: heal phase rc", rc, "\n" + "\n".join(lines[-20:]),
              file=sys.stderr, flush=True)
        raise SystemExit(1)
    codes = [ln.split("exit codes ", 1)[1] for ln in lines
             if "exit codes" in ln]
    first_exit = [ln for ln in lines if "exited HARD" in ln][0]
    all_exit = [ln for ln in lines if "incarnation 0: exit codes" in ln][0]
    sup = read_events(os.path.join(log_dir, "telemetry.supervisor.jsonl"))
    heal = [e for e in sup if e["event"] == "heal"]
    if not heal or heal[0]["action"] != "shrink" or heal[0]["world"] != n - 1:
        print(f"chip_multicard: heal events {heal}", file=sys.stderr)
        raise SystemExit(1)
    tags = os.listdir(os.path.join(root, "logs"))
    (tag,) = [t for t in tags if f"-n{n - 1}-" in t]
    recs = read_events(os.path.join(root, "logs", tag,
                                    stream_filename(0, n - 1)))
    resize = events_of(recs, "resize")
    steps = events_of(recs, "step")
    with open(os.path.join(log_dir, "p0.i0.log")) as f:
        survivor = [ln for ln in f.read().splitlines()
                    if "Watchdog" in ln or "timeout" in ln.lower()
                    or "coordination" in ln][-6:]
    timeline = survivor_timeline(os.path.join(log_dir, "p0.i0.log"),
                                 _stamp(first_exit), _stamp(all_exit))
    out = {
        "processes": n, "device": device, "kill_step": kill_step,
        "coord_timeout_s": HEAL_COORD_TIMEOUT_S, "exit_codes": codes,
        "kill_to_survivors_exit_s": _stamp(all_exit) - _stamp(first_exit),
        "survivor_timeline": timeline,
        "heal": heal[0], "resize": resize[0] if resize else None,
        "final_step": steps[-1]["step"] if steps else None,
        "survivor_log": survivor, "wall_s": wall,
    }
    print(f"heal: exit codes {codes}; the survivors left "
          f"{out['kill_to_survivors_exit_s']:.2f} s after the kill "
          f"(timeout {HEAL_COORD_TIMEOUT_S} s); {heal[0]['action']} "
          f"{heal[0]['old_world']} -> {heal[0]['world']}; resize "
          f"{resize[0]['old_world'] if resize else None} -> "
          f"{resize[0]['new_world'] if resize else None} at iteration "
          f"{resize[0]['iteration'] if resize else None}; final step "
          f"{out['final_step']}", flush=True)
    for t, line in timeline:
        print(f"heal: survivor p0 +{t:.3f} s: {line}", flush=True)
    return out


TEL_HOLD_STEP, TEL_HOLD_S = 10, 8.0  # every process holds: the arm
TEL_PROFILE_STEPS = 3
TEL_SLOW_STEPS, TEL_SLOW_S = range(25, 31), 0.5  # the last process lags


def _http(port: int, path: str, timeout_s: float = 30.0) -> dict:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout_s) as r:
        return json.loads(r.read().decode())


def _poll(what: str, probe, timeout_s: float = 300.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        try:
            got = probe()
        except (OSError, ValueError, KeyError):
            got = None
        if got:
            return got
        time.sleep(0.1)
    print(f"chip_multicard: telemetry: no {what} within {timeout_s:.0f}s",
          file=sys.stderr, flush=True)
    raise SystemExit(1)


def telemetry_phase(n: int, device: str, out_dir: str, batch_size: int,
                    env: dict) -> dict:
    """A supervised ResNet-20 group of n processes with the live plane and
    the fleet fan-in: /fleet/profile?steps=3 armed on every process while
    they hold, the lockstep window's per-group device time from each
    process (``per_process_device_s``), and a ``straggler`` alarm naming
    the last process, which sleeps before steps 25-30."""
    sys.path.insert(0, ROOT)
    from mgwfbp_tpu_torch.telemetry import (
        events_of,
        read_event_set,
        stream_filename,
    )

    root = os.path.join(out_dir, "telemetry")
    shutil.rmtree(root, ignore_errors=True)
    log_dir = os.path.join(root, "sup")
    os.makedirs(log_dir)
    plan = ";".join([f"stall@secs={TEL_HOLD_S},step={TEL_HOLD_STEP}"] + [
        f"stall@secs={TEL_SLOW_S},step={s},proc={n - 1}"
        for s in TEL_SLOW_STEPS])
    cmd = [sys.executable, "-m", "mgwfbp_tpu_torch.runtime.supervise",
           "--processes", str(n), "--log-dir", log_dir, "--fleet-port", "0",
           "--", "--dnn", "resnet20", "--synthetic", "--device", device,
           "--epochs", "1", "--num-batches-per-epoch", "40",
           "--batch-size", str(batch_size), "--policy", "mgwfbp",
           "--connection", "56GbIB", "--metrics-port", "0",
           "--logdir", os.path.join(root, "logs")]
    full_env = dict(os.environ, PYTHONPATH=ROOT, **env,
                    MGWFBP_FAULT_PLAN=plan, MGWFBP_METRICS_PORT="0",
                    MGWFBP_AGREE_INTERVAL="1")
    t0 = time.perf_counter()
    err_path = os.path.join(root, "supervise.err")
    err = open(err_path, "w")
    p = subprocess.Popen(cmd, stdout=err, stderr=subprocess.STDOUT,
                         env=full_env, cwd=out_dir)
    try:
        def fleet_port():
            with open(err_path) as f:
                for line in f:
                    if "fleet fan-in: http://" in line:
                        return int(line.split("fleet fan-in: http://")[1]
                                   .split()[0].rsplit(":", 1)[1])

        fport = _poll("fleet fan-in", fleet_port)

        def held():
            st = _http(fport, "/fleet/status")
            steps = [st["processes"][str(i)]["step"] or 0 for i in range(n)]
            return st if st["reachable"] == n and min(steps) >= (
                TEL_HOLD_STEP - 1) else None

        status = _poll("group at the hold", held)
        armed = _http(fport, f"/fleet/profile?steps={TEL_PROFILE_STEPS}")
        if armed.get("armed") != n:
            print(f"chip_multicard: /fleet/profile armed {armed}",
                  file=sys.stderr, flush=True)
            raise SystemExit(1)
        ports = {}
        for i in range(n):
            with open(os.path.join(log_dir, f"metrics_port.p{i}.json")) as f:
                ports[i] = json.load(f)["port"]

        def done():
            docs = [_http(ports[i], "/profile") for i in range(n)]
            return docs if all(d["state"] in ("done", "failed")
                               for d in docs) else None

        results = _poll("the profile windows", done)
        rc = p.wait(timeout=600)
    finally:
        if p.poll() is None:
            # SIGTERM: the supervisor tears its children down
            p.send_signal(signal.SIGTERM)
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        err.close()
    wall = time.perf_counter() - t0
    if rc != 0 or any(d["state"] != "done" for d in results):
        with open(err_path) as f:
            tail = f.read().splitlines()[-20:]
        print(f"chip_multicard: telemetry rc {rc}, windows "
              f"{[d['state'] for d in results]}\n" + "\n".join(tail),
              file=sys.stderr, flush=True)
        raise SystemExit(1)
    res = [d["result"] for d in results]
    per_proc = res[0].get("per_process_device_s") or {}
    groups = len(res[0]["groups"])
    if (sorted(per_proc) != [str(i) for i in range(n)]
            or any(len(v) != groups for v in per_proc.values())
            or any(r.get("per_process_device_s") != per_proc for r in res)):
        print(f"chip_multicard: per_process_device_s {per_proc} "
              f"({groups} groups)", file=sys.stderr, flush=True)
        raise SystemExit(1)
    (tag,) = os.listdir(os.path.join(root, "logs"))
    streams = [read_event_set(os.path.join(root, "logs", tag,
                                           stream_filename(i, n)))
               for i in range(n)]
    strag = [[{k: v for k, v in r.items() if k != "wall"}
              for r in events_of(s, "straggler")] for s in streams]
    if not strag[0] or any(s != strag[0] for s in strag) or (
            strag[0][0]["slow_process"] != n - 1):
        print(f"chip_multicard: straggler records {strag}", file=sys.stderr,
              flush=True)
        raise SystemExit(1)
    out = {
        "processes": n, "device": device, "groups": groups,
        "attribution": [r["attribution"] for r in res],
        "window_wall_s": [r["wall_s"] for r in res],
        "per_process_device_s": per_proc,
        "predicted_s": [g.get("predicted_s") for g in res[0]["groups"]],
        "nbytes": [g["nbytes"] for g in res[0]["groups"]],
        "straggler": strag[0],
        "fleet_reachable_at_hold": status["reachable"],
        "health_records": [len(events_of(s, "health")) for s in streams],
        "wall_s": wall,
    }
    print(f"telemetry: {n} processes, {groups} groups, attribution "
          f"{out['attribution']}, window {out['window_wall_s']} s; "
          f"straggler {[(r['active'], r['slow_process'], r['step']) for r in strag[0]]}",
          flush=True)
    return out


def seq_rank(seq: int, device: str, out_dir: str) -> dict:
    """One rank of the --seq-parallel step (its world from the launch
    environment): ``chip_smoke.seq_rank`` without (p3)."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from mgwfbp_tpu_torch.parallel.mesh import init_distributed

    import torch.distributed as dist

    from mgwfbp_tpu_torch.runtime import coordination

    dev = init_distributed(device)
    work = os.path.join(out_dir, f"seq_work.p{os.environ['MGWFBP_PROCESS_ID']}")
    os.makedirs(work, exist_ok=True)
    try:
        return chip_smoke.seq_rank(dev, work, seq, long=False)
    finally:
        coordination.release()
        dist.destroy_process_group()


def seq_phase(n: int, device: str, out_dir: str, seq: int, env: dict) -> dict:
    """The --seq-parallel step: fails when a rank reports a problem."""
    t0 = time.perf_counter()
    outs = _run_group(
        n, ["chip_multicard", "--seq-rank", "--seq-parallel", str(seq),
            "--device", device, "--out-dir", out_dir],
        out_dir, "seq", 300, env)
    ranks = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    for r in ranks:
        if r["problems"]:
            print(f"chip_multicard: seq rank {r['rank']}: "
                  f"{'; '.join(r['problems'])}", file=sys.stderr, flush=True)
            raise SystemExit(1)
    secs = time.perf_counter() - t0
    for r in ranks:
        p1, par, tim = r["p1"], r["p2_parity"], r["p2"]
        print(f"seq rank {r['rank']}: (p1) {p1['backend']} max abs err "
              f"{p1['max_abs_err']}; (p2) step 1 "
              f"{par['rel_l2_to_dense_step']:.3g} from the dense step over "
              f"{par['global_rows']} rows (moved {par['step_rel_l2']:.3g}); "
              f"median {tim['step_ms_median']:.2f} ms, "
              f"{tim['p2p_per_step'][0]} p2p per step, {tim['num_groups']} "
              f"groups, {tim['held_groups']} held", flush=True)
    return {"processes": n, "seq": seq, "data": n // seq, "device": device,
            "seconds": secs, "ranks": ranks}


TOOLS_MODEL = "resnet20"  # --tools: every tool's model, batch 32 per card
TOOLS_DCN = 2  # --tools: two_level_validation's slices


def _tool_report(n: int, device: str, out_dir: str, name: str, args: list,
                 env: dict) -> dict:
    """``python -m mgwfbp_tpu_torch.tools.<name> args`` at N processes,
    rank 0's artifact (``--out``) and the seconds."""
    path = os.path.join(out_dir, f"{name}.json")
    t0 = time.perf_counter()
    _run_group(n, [f"mgwfbp_tpu_torch.tools.{name}", *args, "--device",
                   device, "--out", path], out_dir, name, 900, env)
    with open(path) as f:
        doc = json.load(f)
    doc = doc.get("meta", doc)  # two_level_validation writes a profile
    doc["seconds"] = time.perf_counter() - t0
    return doc


def tools_phase(n: int, device: str, out_dir: str, batch_size: int,
                env: dict, sweep: list, family: str, extents: str) -> dict:
    """``--tools``: the measuring tools at N processes (one per card,
    NCCL): a family calibrated over the first 1, 2, 4 .. ranks, then
    overlap_report (its collective rows are NCCL kernels, each with the
    compute that ran beside it), policy_grid at N, scaling_efficiency at
    every extent (predictions on the family) and two_level_validation at
    (N / TOOLS_DCN) x TOOLS_DCN."""
    from mgwfbp_tpu_torch.profiling import is_collective_kernel

    t0 = time.perf_counter()
    _run_group(n, ["mgwfbp_tpu_torch.calibrate", "--out", family,
                   "--world-sizes", extents, "--device", device, *sweep],
               out_dir, "calibrate", 900, env)
    calibrate_s = time.perf_counter() - t0
    r20 = ["--model", TOOLS_MODEL, "--batch", str(batch_size)]
    ov = _tool_report(n, device, out_dir, "overlap_report",
                      [*r20, "--comm-profile", family], env)
    colls = ov["collectives"]
    if device == "cuda" and not (colls and all(
            is_collective_kernel(c["name"]) for c in colls)):
        print(f"chip_multicard: overlap_report's collectives {colls[:3]}",
              file=sys.stderr, flush=True)
        raise SystemExit(1)
    grid = _tool_report(n, device, out_dir, "policy_grid",
                        [*r20, "--comm-profile", family], env)
    scaling = _tool_report(n, device, out_dir, "scaling_efficiency",
                           [*r20, "--comm-profile", family], env)
    pairs = [sweep[i:i + 2] for i in range(0, len(sweep), 2)
             if sweep[i] != "--gamma-total-log2"]
    two = _tool_report(n, device, out_dir, "two_level_validation",
                       ["--ici", str(n // TOOLS_DCN), "--dcn", str(TOOLS_DCN),
                        *(x for pair in pairs for x in pair)], env)
    print(f"overlap_report: {ov['n_collective_events']} collective kernels, "
          f"{ov['total_collective_us']:.1f} us, {ov['overlapped_us']:.1f} us "
          f"beside compute (fraction {ov['overlap_fraction']}), "
          f"{ov['merge_groups']} groups; predicted vs measured per group: "
          + ", ".join(f"{r['predicted_s'] * 1e6:.1f}/"
                      f"{r.get('measured_s', float('nan')) * 1e6:.1f} us"
                      for r in ov.get("predicted_vs_actual", [])[:8]),
          flush=True)
    print("policy_grid: " + ", ".join(
        f"{p} {r['sec_per_iter'] * 1e3:.2f} ms ({r['merge_groups']} groups)"
        for p, r in grid["policies"].items())
        + f"; noise bound {grid['noise_pair']['bound_s'] * 1e3:.3f} ms; "
        f"fastest {grid['conclusion']['fastest_by_median']}", flush=True)
    print("scaling_efficiency: " + ", ".join(
        f"{k}: {v['sec_per_iter'] * 1e3:.2f} ms eff {v['efficiency']}"
        for k, v in scaling["measured_weak_scaling"].items()), flush=True)
    print(f"two_level_validation {two['mesh']}: median gap "
          f"{two['median_abs_gap_sampled_frac']} (corrected "
          f"{two['median_abs_gap_corrected_frac']}), hier/flat "
          f"{two['median_hier_vs_flat']}; solved hier/flat measured "
          f"{two['solved_schedule']['solved_hier_vs_flat_measured']}, "
          f"predicted "
          f"{two['solved_schedule']['solved_hier_vs_flat_predicted']}",
          flush=True)
    return {"processes": n, "device": device, "calibrate_s": calibrate_s,
            "overlap_report": {k: ov[k] for k in (
                "n_collective_events", "total_collective_us",
                "overlapped_us", "overlap_fraction", "collectives",
                "n_compute_events", "merge_groups", "predicted_vs_actual",
                "device_kind", "seconds") if k in ov},
            "policy_grid": grid, "scaling_efficiency": scaling,
            "two_level_validation": two}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="chip_multicard")
    p.add_argument("--processes", type=int, default=None,
                   help="world size (default: the host's card count)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out-dir", default=os.path.join(ROOT, "build",
                                                     "multicard"))
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batches", type=int, default=20,
                   help="optimizer steps per epoch")
    p.add_argument("--batch-size", type=int, default=None,
                   help="per-card batch (default 32; 128 with --lowerings)")
    for flag in ("--min-log2", "--max-log2", "--iters", "--warmup",
                 "--gamma-total-log2"):
        p.add_argument(flag, default=None)
    p.add_argument("--heal", action="store_true",
                   help="run the supervised heal step instead")
    p.add_argument("--telemetry", action="store_true",
                   help="run the supervised telemetry step instead")
    p.add_argument("--lowerings", action="store_true",
                   help="run the lowerings step instead (--batch-size "
                        "defaults to 128 there)")
    p.add_argument("--autotune", action="store_true",
                   help="run the autotune step instead (--batch-size "
                        "defaults to 128 there)")
    p.add_argument("--seq-parallel", dest="seq_parallel", type=int,
                   default=None,
                   help="run the sequence-parallel step instead, rings of "
                        "this many ranks")
    p.add_argument("--tools", action="store_true",
                   help="run the measuring tools' step instead")
    p.add_argument("--lowerings-rank", default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--seq-rank", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--model", default="resnet50")
    p.add_argument("--dtype", default="bfloat16")
    args = p.parse_args(argv)
    if args.seq_rank:
        print(json.dumps(seq_rank(args.seq_parallel, args.device,
                                  args.out_dir)), flush=True)
        return 0
    if args.lowerings_rank:
        print(json.dumps(lowerings_rank(args.lowerings_rank, args.model,
                                        args.dtype, args.batch_size,
                                        args.device)),
              flush=True)
        return 0
    # the children run in it: a relative path would name another place
    args.out_dir = os.path.abspath(args.out_dir)
    if args.batch_size is None:
        args.batch_size = 128 if args.lowerings or args.autotune else 32
    n = args.processes
    if n is None:
        import torch

        n = torch.cuda.device_count()
    if n < 2:
        print(f"chip_multicard: needs 2 or more processes, got {n}",
              file=sys.stderr)
        return 1
    os.makedirs(args.out_dir, exist_ok=True)
    sweep = [x for flag in ("min_log2", "max_log2", "iters", "warmup",
                            "gamma_total_log2")
             if getattr(args, flag) is not None
             for x in ("--" + flag.replace("_", "-"), getattr(args, flag))]
    family = os.path.join(args.out_dir, "family.json")
    # CPU ranks share the host's cores: one intra-op thread each
    env = {"OMP_NUM_THREADS": "1"} if args.device == "cpu" else {}
    extents = ",".join(str(1 << k) for k in range(n.bit_length())
                       if (1 << k) <= n)
    if str(n) not in extents.split(","):
        extents += f",{n}"

    if args.heal:
        print(json.dumps({"multicard_heal": heal_phase(
            n, args.device, args.out_dir, args.batch_size, env)}), flush=True)
        return 0
    if args.telemetry:
        print(json.dumps({"multicard_telemetry": telemetry_phase(
            n, args.device, args.out_dir, args.batch_size, env)}), flush=True)
        return 0
    if args.autotune:
        print(json.dumps({"multicard_autotune": autotune_phase(
            n, args.device, args.out_dir, args.batch_size, args.model,
            args.dtype, env)}), flush=True)
        return 0
    if args.seq_parallel:
        print(json.dumps({"multicard_seq": seq_phase(
            n, args.device, args.out_dir, args.seq_parallel, env)}),
            flush=True)
        return 0
    if args.tools:
        print(json.dumps({"multicard_tools": tools_phase(
            n, args.device, args.out_dir, args.batch_size, env, sweep,
            family, extents)}), flush=True)
        return 0
    if args.lowerings:
        print(json.dumps({"multicard_lowerings": lowerings_phase(
            n, args.device, args.out_dir, args.batch_size, args.model,
            args.dtype, env, sweep)}), flush=True)
        return 0

    t0 = time.perf_counter()
    outs = _run_group(
        n, ["mgwfbp_tpu_torch.calibrate", "--out", family, "--world-sizes",
            extents, "--device", args.device, *sweep],
        args.out_dir, "calibrate", 900, env,
    )
    calibrate_s = time.perf_counter() - t0
    report = json.loads(outs[0].strip().splitlines()[-1])
    for w, f in sorted(report["family"].items(), key=lambda kv: int(kv[0])):
        print(f"calibrate world {w}: alpha {f['alpha_s']:.4g} s, beta "
              f"{f['beta_s_per_byte']:.4g} s/B, gamma {f['gamma_s']:.4g} s, "
              f"pack_beta {f['pack_beta_s_per_byte']:.4g} s/B, overlap "
              f"{f['overlap']:.4g}", flush=True)
    with open(family) as fh:
        meta = json.load(fh)["meta"]

    logdir = os.path.join(args.out_dir, "logs")
    shutil.rmtree(logdir, ignore_errors=True)
    t0 = time.perf_counter()
    outs = _run_group(
        n, ["mgwfbp_tpu_torch.train_cli", "--dnn", "resnet20", "--synthetic",
            "--device", args.device, "--epochs", str(args.epochs),
            "--num-batches-per-epoch", str(args.batches), "--batch-size",
            str(args.batch_size), "--policy", "mgwfbp", "--comm-profile",
            family, "--telemetry", "--logdir", logdir],
        args.out_dir, "train", 900, {**env, "MGWFBP_TELEMETRY_TRACE": "1"},
    )
    train_s = time.perf_counter() - t0
    metrics = json.loads(outs[0].strip().splitlines()[-1])

    sys.path.insert(0, ROOT)
    from mgwfbp_tpu_torch.telemetry import events_of, find_stream_paths, read_events

    (tag,) = os.listdir(logdir)
    ranks = []
    for r, path in enumerate(find_stream_paths(os.path.join(logdir, tag))):
        recs = read_events(path)
        with open(os.path.join(args.out_dir, f"train.rank{r}.err")) as fh:
            log = fh.read().splitlines()
        pick = [ln.split("mgwfbp.trainer: ", 1)[-1] for ln in log
                if "cost model:" in ln or "merge schedule:" in ln
                or "telemetry trace:" in ln or "backward benchmark" in ln]
        overlap = events_of(recs, "overlap")[-1]
        groups = [g for g in events_of(recs, "comm_group")
                  if g["step"] == overlap["step"]]
        spans = [s["dur_s"] for s in events_of(recs, "step")]
        ranks.append({
            "rank": r, "log": pick, "overlap": overlap,
            "group_comm_s": [g["comm_s"] for g in groups],
            "group_nbytes": [g["nbytes"] for g in groups],
            "step_span_median_s": sorted(spans)[len(spans) // 2],
            "steps": len(spans),
        })
        print(f"train rank {r}: " + " | ".join(pick), flush=True)
        print(f"train rank {r}: overlap ({overlap['attribution']}) "
              f"efficiency {overlap['efficiency']:.4f}: "
              f"{overlap['comm_s'] * 1e3:.4f} ms comm per step = "
              f"{overlap['hidden_s'] * 1e3:.4f} hidden + "
              f"{overlap['exposed_s'] * 1e3:.4f} exposed, step "
              f"{overlap['step_s'] * 1e3:.3f} ms, {overlap['num_groups']} "
              "groups", flush=True)
    print(json.dumps({"multicard": {
        "processes": n, "device": args.device,
        "device_kind": meta.get("device_kind"), "backend": meta.get("backend"),
        "calibrate_s": calibrate_s, "train_s": train_s,
        "family": report["family"], "gamma_samples_s": meta.get(
            "gamma_samples_s"),
        "train": metrics, "ranks": ranks,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
