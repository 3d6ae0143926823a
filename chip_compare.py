"""Compare the serving path of two checkouts of the port on one CUDA card.

    python3 chip_compare.py PARENT_DIR CHANGE_DIR

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


def run_turn(root: str, label: str) -> dict:
    root = os.path.abspath(root)
    res = subprocess.run(
        [sys.executable, "-c", CHILD], capture_output=True, text=True,
        timeout=600, cwd=root, env=dict(os.environ, PYTHONPATH=root),
    )
    if res.returncode != 0:
        raise SystemExit(f"{label} ({root}) failed:\n{res.stdout}\n{res.stderr}")
    doc = json.loads(res.stdout.strip().splitlines()[-1])
    return {"turn": label, "root": root, **doc}


def main() -> int:
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_compare: needs a CUDA card")
    parent, change = sys.argv[1:]
    for label, root in (("parent", parent), ("change", change),
                        ("change", change), ("parent", parent)):
        print(json.dumps(run_turn(root, label)), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print((smi.stdout.strip().splitlines() or ["nvidia-smi unavailable"])[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
