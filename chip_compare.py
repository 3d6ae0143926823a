"""Compare the serving path, with ``--train`` the training step, or with
``--order`` the merged collectives' launch order, of two checkouts of the
port on one CUDA card (``--order-nccl``: on four).

    python3 chip_compare.py PARENT_DIR CHANGE_DIR
    python3 chip_compare.py --train PARENT_DIR CHANGE_DIR
    python3 chip_compare.py --order PARENT_DIR CHANGE_DIR
    python3 chip_compare.py --order-nccl PARENT_DIR CHANGE_DIR

Each directory is the root of a checkout (for example the parent commit
unpacked with `git archive` into a directory that .gitignore lists). The
checkouts run in turns, parent, change, change, parent, one child process
each, so that each imports its own `mgwfbp_tpu_torch` and builds its own
kernels, on the same card. Each turn measures, for the registered
transformer at full width with random weights from seed 0:

  * the flash wrapper at the serving shape (8, 35, 4, 64) float32, causal,
    on strided views of a fused qkv tensor, as the transformer passes them:
    back-to-back calls by CUDA events (`flash_events_ms`), the host's time
    per call with no synchronisation inside the run of calls
    (`flash_host_us`), and the kernel's device time per launch from
    torch.profiler (`flash_device_us`);
  * `ServingModel.run_padded` of one example (the slot of 8): the median
    host time of 20 calls (`run_padded_ms`), and one call's device time in
    all (`forward_device_ms`) and in the flash kernel (`flash_in_forward_ms`)
    from torch.profiler.

With ``--train`` each turn measures instead, through each checkout's own
``Trainer`` at one worker (synthetic data, seeded random weights): for
full-width ResNet-20 at batch 32 and the preset transformer (window 64,
batch 16), the trainer loop's ms per step over one timed epoch (30 and 10
steps, after one of warm-up; `loop_ms_per_step`), and on one fixed device
batch the median step with a synchronisation after each (CUDA events,
`step_ms_synced`), the mean of 20 back-to-back steps closed by one
synchronisation (`step_ms_back_to_back`) and torch.profiler's busy share
over 10 back-to-back steps (`busy_share`); then the bench's ResNet-50 row
`none` (batch 128, bfloat16, 5 + 20 steps; `bench_resnet50_none_ms`).

With ``--order`` each turn runs two ranks over gloo sharing card 0 (with
``--order-nccl`` four ranks over NCCL, one a card), each a child process
of that checkout, and measures at rank 0, for full-width ResNet-20 at
batch 32 (float32) and ResNet-50 at batch 128 (bfloat16), each under the
merged policies mgwfbp (on the reference's 56Gb IB constants at 16
workers, tb measured by rank 0's hooks in the first turn, which every turn
solves on) and wfbp: the median step of 20 after 3 (CUDA events, a
synchronisation after each; `step_ms`), the groups held back on the last
step's hooks under group order and along the groups' launch order that
step (`held_by_group_order`, `held_as_launched`), then, over 3 traced
steps at rank 0, the NCCL kernels' time and the part of it that compute
kernels overlapped (`tools.overlap_report.summarize_overlap`; none over
gloo), the streams they ran on and how often another kernel started
between two of them, and the overlap replay's hidden and exposed seconds
(`telemetry.summarize`, along the reducer's launch sequence where the
checkout has one). ``--order``
then runs smoke phase (m1) of the checkout alone (`chip_smoke.
xstep_one_rank`): rs_fwd_ag's forward stall against rs_opt_ag at one rank.

Prints one JSON line per turn and, last, the card's name and power limit.
Exits non-zero without a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r'''
import json, sys, tempfile, time
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from mgwfbp_tpu_torch import models
from mgwfbp_tpu_torch.checkpoint import save_replicated_step
from mgwfbp_tpu_torch.convert import params_to_flax
from mgwfbp_tpu_torch.models.transformer import init_weights
from mgwfbp_tpu_torch.ops import flash_attention
from mgwfbp_tpu_torch.serving.model import ServingModel


def profiled(fn, calls):
    """Device time per call by kernel name (µs), from torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {
        e.key: e.self_device_time_total / calls
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    }


out = {}
gen = torch.Generator().manual_seed(0)
b, t, h, d = 8, 35, 4, 64
qkv = torch.randn((b, t, 3 * h * d), generator=gen).to("cuda")
q, k, v = (x.reshape(b, t, h, d) for x in qkv.split(h * d, dim=-1))


def call():
    return flash_attention(q, k, v, causal=True)


call()
torch.cuda.synchronize()
start = torch.cuda.Event(enable_timing=True)
end = torch.cuda.Event(enable_timing=True)
start.record()
for _ in range(200):
    call()
end.record()
torch.cuda.synchronize()
out["flash_events_ms"] = start.elapsed_time(end) / 200
t0 = time.perf_counter()
for _ in range(200):
    call()
out["flash_host_us"] = (time.perf_counter() - t0) / 200 * 1e6
torch.cuda.synchronize()
per = profiled(call, 50)
out["flash_device_us"] = sum(us for k, us in per.items() if "flash" in k)

module, meta = models.create_model("transformer")
with tempfile.TemporaryDirectory() as ckpt:
    save_replicated_step(ckpt, 1, params_to_flax(init_weights(module, gen)))
    model = ServingModel(module, meta, device="cuda")
    model.load_step(ckpt, 1)
x = np.random.RandomState(0).randint(0, meta.num_classes, (1, 35)).astype(np.int32)
times = []
for _ in range(20):
    t0 = time.perf_counter()
    model.run_padded(x)
    times.append((time.perf_counter() - t0) * 1e3)
out["run_padded_ms"] = sorted(times)[10]
per = profiled(lambda: model.run_padded(x), 5)
out["forward_device_ms"] = sum(per.values()) / 1e3
out["flash_in_forward_ms"] = sum(us for k, us in per.items() if "flash" in k) / 1e3
print(json.dumps(out))
'''


CHILD_TRAIN = r'''
import json, tempfile, time
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from mgwfbp_tpu_torch import bench
from mgwfbp_tpu_torch.config import make_config
from mgwfbp_tpu_torch.train import Trainer
from mgwfbp_tpu_torch.utils.device import set_matmul_precision

set_matmul_precision(None)
CUDA = torch.autograd.DeviceType.CUDA


def timing(step, x, y, n=20):
    for _ in range(5):
        step(x, y)
    torch.cuda.synchronize()
    synced = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(x, y)
        end.record()
        torch.cuda.synchronize()
        synced.append(start.elapsed_time(end))
    t0 = time.perf_counter()
    for _ in range(n):
        step(x, y)
    torch.cuda.synchronize()
    back = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            step(x, y)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == CUDA)
    return {"step_ms_synced": float(np.median(synced)),
            "step_ms_back_to_back": back, "busy_share": busy / wall_us}


out = {}
work = tempfile.mkdtemp(prefix="mgwfbp_compare_")
for name, steps, kw in (("resnet20", 30, {"batch_size": 32}),
                        ("transformer", 10, {})):
    cfg = make_config(name, num_batches_per_epoch=steps,
                      logdir=f"{work}/{name}", checkpoint_dir=None, **kw)
    tr = Trainer(cfg, device="cuda", synthetic_data=True,
                 profile_backward=False)
    tr.train_epoch(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.train_epoch(1)
    loop = (time.perf_counter() - t0) * 1e3 / steps
    xb, yb = tr.bundle.train.load_batch(0, 0)
    x, y = tr._to_device(xb[None], yb[None])
    out[name] = {"loop_ms_per_step": loop, **timing(tr.step_batch, x, y)}
    tr.close()
set_matmul_precision(torch.bfloat16)
grid = bench._Grid("resnet50", 128, 20, torch.device("cuda"),
                   torch.bfloat16, None)
try:
    dt, _ = grid.time_policy("none", None)
finally:
    grid.close()
out["bench_resnet50_none_ms"] = dt * 1e3
print(json.dumps(out))
'''


CHILD_ORDER = r'''
import json, os, sys, tempfile
import numpy as np
import torch
import torch.distributed as dist

rank, world, backend, rdv, tb_path = (int(sys.argv[1]), int(sys.argv[2]),
                                      sys.argv[3], sys.argv[4], sys.argv[5])
dev = torch.device("cuda", rank if backend == "nccl" else 0)
torch.cuda.set_device(dev)
dist.init_process_group(backend, init_method=f"file://{rdv}",
                        world_size=world, rank=rank)
from mgwfbp_tpu_torch import bench
from mgwfbp_tpu_torch.parallel.costmodel import lookup_alpha_beta
from mgwfbp_tpu_torch.profiling import trace_group_rows
from mgwfbp_tpu_torch.telemetry import summarize
from mgwfbp_tpu_torch.tools import overlap_report
from mgwfbp_tpu_torch.utils.device import set_matmul_precision


def lanes(logdir):
    """The traced kernels' streams (NCCL's, the others'), and the share of
    NCCL kernels after which, in start order, another kernel starts before
    the next NCCL kernel (1: each collective ran between compute kernels;
    low: the collectives ran in one burst)."""
    ev = overlap_report._device_events(overlap_report._load_trace_events(logdir))
    kern = sorted((e for e in ev if e.get("cat") == "kernel"),
                  key=lambda e: e["ts"])
    is_nccl = [overlap_report._is_collective(e["name"]) for e in kern]
    follows = [b for a, b in zip(is_nccl, is_nccl[1:]) if a]
    streams = lambda want: sorted({e.get("args", {}).get("stream")  # noqa: E731
                                   for e, c in zip(kern, is_nccl) if c == want})
    return {"nccl_streams": streams(True), "other_streams": streams(False),
            "nccl_followed_by_other": (follows.count(False) / len(follows)
                                       if follows else None)}


def held(groups, arrivals, sequence):
    # allreduce.held_groups, which the parent checkout lacks
    pos = {k: i for i, k in enumerate(arrivals)}
    n, launched_at = 0, -1
    for gi in sequence:
        complete_at = max(pos[k] for k in groups[gi])
        launched_at = max(launched_at, complete_at)
        n += launched_at > complete_at
    return n


cost = lookup_alpha_beta("56GbIB", 16)
# the first turn's tb (rank 0's hooks), so that every turn solves the same
# mgwfbp schedule
tbs = json.load(open(tb_path)) if os.path.exists(tb_path) else {}
out = {}
for name, batch, dtype in (("resnet20", 32, None),
                           ("resnet50", 128, torch.bfloat16)):
    set_matmul_precision(dtype)
    grid = bench._Grid(name, batch, 1, dev, dtype, cost)
    if name not in tbs:
        tb = torch.tensor(list(grid.tb()), dtype=torch.float64,
                          device=dev if backend == "nccl" else "cpu")
        dist.broadcast(tb, 0)
        tbs[name] = tb.cpu().tolist()
    tb = tbs[name]
    x, y = grid.x[None], grid.y[None]
    for policy in ("mgwfbp", "wfbp"):
        step, reducer = grid.build_step(policy, tb)
        for _ in range(3):
            step(x, y)
        torch.cuda.synchronize()
        times = []
        for _ in range(20):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step(x, y)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        groups = [list(g) for g in reducer.layout.groups]
        arrivals, log = list(reducer.arrivals), list(reducer.launch_log)
        sequence = getattr(reducer, "launch_sequence", None)
        logdir = tempfile.mkdtemp(prefix="mgwfbp_order_")

        def run():
            for _ in range(3):
                step(x, y)
            torch.cuda.synchronize()

        if rank == 0:  # the other ranks take the same steps untraced
            trace_group_rows(run, logdir=logdir)
        else:
            run()
        traced = overlap_report.summarize_overlap(logdir) if rank == 0 else {}
        step_ms = float(np.median(times))
        kw = {} if sequence is None else {"order": sequence}
        replay = summarize(reducer, cost, tb, step_ms / 1e3, **kw)
        out[f"{name}/{policy}"] = {} if rank else {
            "groups": len(groups), "step_ms": step_ms,
            "step_ms_range": [float(min(times)), float(max(times))],
            "held_by_group_order": held(groups, arrivals, range(len(groups))),
            "held_as_launched": held(groups, arrivals, log),
            "launched_in_group_order": log == list(range(len(groups))),
            "nccl_kernels_per_step": traced["n_collective_events"] / 3,
            "nccl_us_per_step": traced["total_collective_us"] / 3,
            "nccl_overlapped_us_per_step": traced["overlapped_us"] / 3,
            "nccl_overlap_fraction": traced["overlap_fraction"],
            "replay_hidden_ms": replay.hidden_s * 1e3,
            "replay_exposed_ms": replay.exposed_s * 1e3,
            "replay_efficiency": replay.efficiency,
            **lanes(logdir),
        }
        reducer.detach()
    grid.close()
    del grid
    torch.cuda.empty_cache()
dist.destroy_process_group()
if rank == 0:
    if not os.path.exists(tb_path):
        with open(tb_path, "w") as f:
            json.dump(tbs, f)
    print(json.dumps(out))
'''


CHILD_STALL = r'''
import json
import chip_smoke as cs
from mgwfbp_tpu_torch.utils.device import set_matmul_precision

set_matmul_precision(None)
r = cs.xstep_one_rank()
print(json.dumps({
    "forward_stall_host_ms": r["forward_stall_host_ms"],
    "in_forward_order": r["runs"]["rs_fwd_ag"]["traced_step"][
        "in_forward_order"],
    "forward_host_ms_median": {
        op: r["runs"][op]["forward_host_ms_median"]
        for op in ("rs_opt_ag", "rs_fwd_ag")},
}))
'''


def run_ranks(root: str, label: str, world: int, backend: str,
              tb_path: str) -> dict:
    """One turn of CHILD_ORDER: ``world`` ranks of the checkout at ``root``,
    rank 0's line; ``tb_path`` holds the first turn's tb (written by it)."""
    import tempfile

    root = os.path.abspath(root)
    env = dict(os.environ, PYTHONPATH=root)
    with tempfile.TemporaryDirectory(prefix="mgwfbp_order_rdv_") as d:
        procs = [subprocess.Popen(
            [sys.executable, "-c", CHILD_ORDER, str(r), str(world), backend,
             os.path.join(d, "rdv"), tb_path], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=root, env=env)
            for r in range(world)]
        try:
            outs = [p.communicate(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    if any(p.returncode for p in procs):
        raise SystemExit(f"{label} ({root}) failed:\n" + "\n".join(
            f"rank {r}: rc {p.returncode}\n{o[1][-3000:]}"
            for r, (p, o) in enumerate(zip(procs, outs))))
    doc = json.loads(outs[0][0].strip().splitlines()[-1])
    return {"turn": label, "root": root, "world": world, "backend": backend,
            **doc}


def run_turn(root: str, label: str, child: str = CHILD) -> dict:
    root = os.path.abspath(root)
    res = subprocess.run(
        [sys.executable, "-c", child], capture_output=True, text=True,
        timeout=600, cwd=root, env=dict(os.environ, PYTHONPATH=root),
    )
    if res.returncode != 0:
        raise SystemExit(f"{label} ({root}) failed:\n{res.stdout}\n{res.stderr}")
    doc = json.loads(res.stdout.strip().splitlines()[-1])
    return {"turn": label, "root": root, **doc}


def main() -> int:
    args = sys.argv[1:]
    child, order = CHILD, None
    if args[:1] == ["--train"]:
        args, child = args[1:], CHILD_TRAIN
    elif args[:1] == ["--order"]:
        args, order = args[1:], (2, "gloo")
    elif args[:1] == ["--order-nccl"]:
        args, order = args[1:], (4, "nccl")
    if len(args) != 2:
        raise SystemExit(__doc__)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_compare: needs a CUDA card")
    parent, change = args
    turns = (("parent", parent), ("change", change), ("change", change),
             ("parent", parent))
    import tempfile

    tb_dir = tempfile.TemporaryDirectory(prefix="mgwfbp_order_tb_")
    for label, root in turns:
        if order is None:
            print(json.dumps(run_turn(root, label, child)), flush=True)
        else:
            print(json.dumps(run_ranks(
                root, label, *order, os.path.join(tb_dir.name, "tb.json"))),
                flush=True)
    tb_dir.cleanup()
    if order == (2, "gloo"):
        for label, root in turns:
            print(json.dumps({"stall": run_turn(root, label, CHILD_STALL)}),
                  flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print((smi.stdout.strip().splitlines() or ["nvidia-smi unavailable"])[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
