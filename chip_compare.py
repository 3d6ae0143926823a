"""Compare the serving path, or with ``--train`` the training step, of two
checkouts of the port on one CUDA card.

    python3 chip_compare.py PARENT_DIR CHANGE_DIR
    python3 chip_compare.py --train PARENT_DIR CHANGE_DIR

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
    child = CHILD
    if args[:1] == ["--train"]:
        args, child = args[1:], CHILD_TRAIN
    if len(args) != 2:
        raise SystemExit(__doc__)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_compare: needs a CUDA card")
    parent, change = args
    for label, root in (("parent", parent), ("change", change),
                        ("change", change), ("parent", parent)):
        print(json.dumps(run_turn(root, label, child)), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print((smi.stdout.strip().splitlines() or ["nvidia-smi unavailable"])[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
