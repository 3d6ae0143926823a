"""The port's bench (counterpart of ``bench.py``): the policy grid on the
card, one JSON line.

    python -m mgwfbp_tpu_torch.bench                 # on the card
    python -m mgwfbp_tpu_torch.bench --device cpu    # a CPU rehearsal

Times ResNet-50 (``MGWFBP_BENCH_MODEL``) on synthetic inputs at the
preset per-worker batch (128; ``MGWFBP_BENCH_BATCH``), bfloat16 compute
(``MGWFBP_BENCH_DTYPE``; float32 keeps TF32 off) and at least 50 timed
steps (``MGWFBP_BENCH_ITERS``), for each merge policy of the grid
{mgwfbp, auto, wfbp, single, none}, through the port's ``TrainStep``. A
CUDA out-of-memory error reruns the WHOLE grid at batch 64, and the payload
says so; any other failure prints an ``error`` payload (value null, no
traceback) and exits 1.

The card's outage record: CUDA's initialisation and a first kernel run
under ``utils.platform.preflight_backend``'s deadline
(``MGWFBP_INIT_TIMEOUT_S``), retried with backoff; when every attempt times
out (or ``MGWFBP_FAULT_PLAN=chip_unavailable`` says so) the bench prints a
``skipped: "chip unavailable"`` payload, appends a ``bench_skip`` event to
``$MGWFBP_TELEMETRY_DIR/telemetry.jsonl`` when that is set, and exits 0, as
``bench.py`` does: no card this time is not a regression. It never measures
on the CPU instead; no card at all (``torch.cuda.is_available()`` false) is
an ``error`` payload, rc 1.

Several processes (one per card) come from the launch environment
(``MGWFBP_COORDINATOR``/``MGWFBP_NUM_PROCESSES``/``MGWFBP_PROCESS_ID``);
each prints its line, the value is the global images/s and MFU is per
card. At one worker the ``Trainer`` builds no reducer; the bench builds the
``MergedAllreduce`` anyway, over a one-rank group (NCCL on the card), so
the grid measures each policy's per-group host cost. The headline row is
the production configuration, as in ``bench.py``: ``none`` at one worker
(what the trainer runs there), ``auto`` on several. The mgwfbp and auto
schedules are solved on tb measured by the hooks at the timed batch.

Timing: CUDA events around the timed loop and one synchronisation after
it. No step reads anything back (the non-finite guard decides on the
card); the timed steps' losses are read once, after the window, and a
non-finite one turns the row into an error. FLOPs per step come from
``torch.utils.flop_counter.FlopCounterMode`` over one forward and backward;
MFU is FLOPs over step time over the peak for the compute dtype
(``utils.platform.peak_flops``), and an MFU above 1.0 turns the payload
into an error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Optional

P100_RESNET50_IMG_S = 250.0  # bench.py's baseline
POLICIES = ("mgwfbp", "auto", "wfbp", "single", "none")
WARMUP = 5
FALLBACK_BATCH = 64


def _progress(msg: str) -> None:
    """Phase marker on stderr (stdout carries exactly one JSON line)."""
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


class ChipUnavailable(RuntimeError):
    """CUDA's initialisation timed out on every attempt: there is no card
    to measure this time (a structured skip, rc 0), as opposed to a
    failure (rc 1)."""


# seconds slept before the k-th retry of a timed-out initialisation
INIT_RETRY_DELAYS_S = (30.0, 60.0)


def _devices_with_retry(device: str, timeout_attempts: int = 3,
                        sleep=time.sleep) -> list:
    """``preflight_backend`` with bounded retries of a timed-out
    initialisation; ChipUnavailable once every attempt timed out. Any
    other error (no card at all) is raised at once."""
    from mgwfbp_tpu_torch.utils.faults import FaultPlan
    from mgwfbp_tpu_torch.utils.platform import (
        DeadlineExceeded,
        preflight_backend,
    )

    if FaultPlan.from_env().chip_unavailable():
        raise ChipUnavailable(
            f"CUDA initialisation timed out in each of {timeout_attempts} "
            "attempts (injected by MGWFBP_FAULT_PLAN=chip_unavailable)"
        )
    timeouts = 0
    while True:
        try:
            return preflight_backend(device=device)
        except DeadlineExceeded as e:
            timeouts += 1
            _progress(f"{e} (attempt {timeouts}/{timeout_attempts})")
            if timeouts >= timeout_attempts:
                raise ChipUnavailable(
                    f"CUDA initialisation timed out in each of {timeouts} "
                    f"attempts: {e}"
                ) from None
        sleep(INIT_RETRY_DELAYS_S[min(timeouts - 1,
                                      len(INIT_RETRY_DELAYS_S) - 1)])


def _record_bench_skip(detail: str) -> None:
    """Append a ``bench_skip`` event to ``$MGWFBP_TELEMETRY_DIR``'s stream
    (the event family live runs write), when that is set."""
    d = os.environ.get("MGWFBP_TELEMETRY_DIR")
    if not d:
        return
    try:
        from mgwfbp_tpu_torch.telemetry import EventWriter

        w = EventWriter(os.path.join(d, "telemetry.jsonl"),
                        run={"source": "bench"})
        w.emit("bench_skip", detail=detail)
        w.close()
    except Exception:  # noqa: BLE001 — a structured skip (rc 0) must not
        # become a crash
        pass


def _is_oom(e: BaseException) -> bool:
    import torch

    return isinstance(e, torch.cuda.OutOfMemoryError) or (
        "out of memory" in str(e).lower()
    )


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def flops_per_step(model, x, y, compute_dtype) -> int:
    """FLOPs of one forward and backward of the training loss, counted by
    torch's FlopCounterMode (convolutions and matmuls; 2 per
    multiply-add)."""
    from torch.utils.flop_counter import FlopCounterMode

    from mgwfbp_tpu_torch.train.step import forward_loss

    with FlopCounterMode(display=False) as counter:
        loss, _, _ = forward_loss(model, "classify", x, y, None, compute_dtype)
        loss.backward()
    for p in model.parameters():
        p.grad = None
    return int(counter.get_total_flops())


def make_model(model_name: str, device, seed: int = 0):
    """(module on ``device`` in training mode, meta) of an image
    classifier, its weights from a seeded generator."""
    import torch

    from mgwfbp_tpu_torch import models as zoo
    from mgwfbp_tpu_torch.models.common import init_weights

    model, meta = zoo.create_model(model_name)
    if meta.task != "classify":
        raise ValueError(f"only image classifiers are timed here; "
                         f"{model_name!r} is a {meta.task} model")
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).train(), meta


def random_batch(meta, nsteps: int, batch: int, device, seed: int = 0):
    """(x, y): ``nsteps`` micro-batches of ``batch`` random images (NCHW)
    and labels, drawn from a seeded numpy generator."""
    import numpy as np
    import torch

    rs = np.random.RandomState(seed)
    x = rs.randn(nsteps, batch, *meta.input_shape).astype(np.float32)
    y = rs.randint(0, meta.num_classes, (nsteps, batch))
    return (torch.from_numpy(x).to(device).movedim(-1, -3).contiguous(),
            torch.from_numpy(y.astype(np.int64)).to(device))


def time_steps(step, x, y, iters: int, device, what: str = "step") -> float:
    """Seconds per step of ``iters`` steps of ``step(x, y)`` after WARMUP:
    CUDA events around the timed steps on the card (the host clock on the
    CPU), one synchronisation after the last; the losses, read after the
    window, must be finite."""
    import torch

    for _ in range(WARMUP):
        step(x, y)
    _sync(device)
    cuda = device.type == "cuda"
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    losses = [step(x, y)["loss"] for _ in range(iters)]
    if cuda:
        end.record()
    _sync(device)
    dt = (start.elapsed_time(end) / 1e3 if cuda
          else time.perf_counter() - t0) / iters
    if not bool(torch.stack(losses).isfinite().all()):
        raise RuntimeError(f"{what}: non-finite loss in the timed loop")
    return dt


def measure_tb(model, x, y, compute_dtype=None, warmup: int = 2,
               iters: int = 5, task: str = "classify"):
    """``model``'s tb in arrival order, measured by the gradient hooks on
    the batch (x, y) (``profiling.benchmark_backward``); over several
    ranks, rank 0's, so that every rank solves the same schedule (as the
    trainer broadcasts it)."""
    import torch
    import torch.distributed as dist

    from mgwfbp_tpu_torch.convert import flax_leaves, keystr
    from mgwfbp_tpu_torch.parallel.allreduce import arrival_order
    from mgwfbp_tpu_torch.parallel.mesh import world_size
    from mgwfbp_tpu_torch.profiling import TbProfile, benchmark_backward
    from mgwfbp_tpu_torch.train.step import forward_loss

    leaves = flax_leaves(model)
    perm = arrival_order(len(leaves), names=[keystr(p) for p, _ in leaves])
    tb = benchmark_backward(
        model,
        lambda: forward_loss(model, task, x, y, None, compute_dtype)[0],
        [t for _, t in leaves], perm, warmup=warmup, iters=iters,
    )
    if world_size() > 1:
        vals = torch.tensor(list(tb), dtype=torch.float64, device=x.device)
        dist.broadcast(vals, 0)
        tb = TbProfile(vals.tolist(), source=tb.source)
    return tb


class _Grid:
    """One batch size's tb measurement and policy grid. Every policy
    starts from the same initial state (weights, batch statistics) and a
    fresh optimizer."""

    def __init__(self, model_name: str, batch: int, iters: int, device,
                 compute_dtype, cost_model):
        self.device, self.iters = device, iters
        self.compute_dtype, self.cost_model = compute_dtype, cost_model
        self.model, self.meta = make_model(model_name, device)
        self.init_state = {k: v.detach().clone()
                           for k, v in self.model.state_dict().items()}
        x, y = random_batch(self.meta, 1, batch, device)
        self.x, self.y = x[0], y[0]

    def tb(self):
        return measure_tb(self.model, self.x, self.y, self.compute_dtype)

    def build_step(self, policy: str, tb, group=None, nsteps: int = 1):
        """(TrainStep over ``nsteps`` micro-batches, reducer or None) of
        ``policy`` on this grid's model from its initial state, with a fresh
        optimizer; the reducer (over ``group``, the default process group
        when None) is attached until the caller detaches it."""
        from mgwfbp_tpu_torch.optim import make_optimizer
        from mgwfbp_tpu_torch.parallel.allreduce import make_merged_allreduce
        from mgwfbp_tpu_torch.train.step import TrainStep

        model = self.model
        model.load_state_dict(self.init_state)
        threshold = 0
        if policy.startswith("threshold:"):
            # "threshold:N" rows: the reference's static-threshold sweep
            policy, threshold = "threshold", int(policy.split(":", 1)[1])
        reducer = None
        if policy not in ("none", "xla"):
            # every policy is priced on the one tb (its groups need it only
            # for mgwfbp and auto)
            reducer = make_merged_allreduce(
                model, policy=policy, tb=tb, cost_model=self.cost_model,
                threshold=threshold, group=group,
            )
        opt, lr_fn, _ = make_optimizer(
            model.parameters(), 0.01, momentum=0.9, weight_decay=1e-4,
            lr_schedule="const", dataset="imagenet", num_batches_per_epoch=1,
        )
        return TrainStep(model, opt, lr_fn, reducer=reducer, group=group,
                         nsteps_update=nsteps,
                         compute_dtype=self.compute_dtype), reducer

    def time_policy(self, policy: str, tb) -> tuple[float, int]:
        """(seconds per step, merge groups) over ``iters`` steps after
        WARMUP, by CUDA events on the card (the host clock on the CPU)."""
        import torch

        step, reducer = self.build_step(policy, tb)
        try:
            dt = time_steps(step, self.x[None], self.y[None], self.iters,
                            self.device, what=f"policy {policy}")
        finally:
            if reducer is not None:
                reducer.detach()
        return dt, reducer.num_groups if reducer is not None else 0

    def run(self) -> tuple[list, dict, int]:
        """(tb, {policy: row}, FLOPs per step); the model's dataset is
        ``self.meta.dataset``."""
        _progress(f"tb from the hooks (batch {len(self.y)})")
        tb = self.tb()
        flops = flops_per_step(self.model, self.x, self.y, self.compute_dtype)
        rows = {}
        for policy in POLICIES:
            _progress(f"policy {policy}: {WARMUP} warm-up + {self.iters} "
                      "timed steps")
            dt, groups = self.time_policy(policy, tb)
            rows[policy] = {"sec_per_iter": dt,
                            "images_per_sec": len(self.y) / dt,
                            "merge_groups": groups}
        return tb, rows, flops

    def close(self) -> None:
        import torch

        del self.model, self.x, self.y, self.init_state
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run_bench(device_arg: str = "cuda") -> dict:
    import torch

    from mgwfbp_tpu_torch.config import PRESETS
    from mgwfbp_tpu_torch.parallel.costmodel import committed_profile_or_prior
    from mgwfbp_tpu_torch.parallel.mesh import start_group, world_size
    from mgwfbp_tpu_torch.utils.device import device_kind, set_matmul_precision
    from mgwfbp_tpu_torch.utils.platform import peak_flops

    model_name = os.environ.get("MGWFBP_BENCH_MODEL", "resnet50")
    batch = int(os.environ.get(
        "MGWFBP_BENCH_BATCH",
        str(PRESETS.get(model_name, {}).get("batch_size", 32)),
    ))
    iters = int(os.environ.get("MGWFBP_BENCH_ITERS", "50"))
    dtype_name = os.environ.get("MGWFBP_BENCH_DTYPE", "bfloat16")
    if dtype_name in ("float32", "f32"):
        dtype_name, compute_dtype = "float32", None
    elif dtype_name in ("bfloat16", "bf16"):
        dtype_name, compute_dtype = "bfloat16", torch.bfloat16
    else:
        raise ValueError(f"MGWFBP_BENCH_DTYPE={dtype_name!r}: float32 or "
                         "bfloat16")
    set_matmul_precision(compute_dtype)
    import torch.distributed as dist

    rdv = tempfile.TemporaryDirectory(prefix="mgwfbp_bench_")
    device, started = start_group(device_arg, rdv.name)
    try:
        n_dev = world_size()
        cost_model, cost_src = committed_profile_or_prior(
            os.environ.get("MGWFBP_BENCH_PROFILE"), "ici", max(n_dev, 2)
        )

        def grid_at(b: int):
            grid = _Grid(model_name, b, iters, device, compute_dtype,
                         cost_model)
            try:
                return (*grid.run(), grid.meta.dataset)
            finally:
                grid.close()

        batch_fallback = False
        try:
            tb, rows, flops, dataset = grid_at(batch)
        except Exception as e:  # noqa: BLE001 — only an OOM is retried
            if not (_is_oom(e) and batch > FALLBACK_BATCH):
                raise
            _progress(f"out of memory at batch {batch}: the whole grid again "
                      f"at {FALLBACK_BATCH}")
            batch_fallback, batch = True, FALLBACK_BATCH
            tb, rows, flops, dataset = grid_at(batch)
        kind = device_kind(device)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
        rdv.cleanup()

    headline = "none" if n_dev == 1 else "auto"
    main = rows[headline]
    dt, img_s = main["sec_per_iter"], main["images_per_sec"] * n_dev
    peak = peak_flops(kind, dtype_name)
    mfu = flops / dt / peak if flops and peak else None
    payload = {
        "metric": f"{model_name}_synthetic_{dataset}_train_throughput",
        "value": img_s,
        "unit": "images/s",
        "vs_baseline": img_s / P100_RESNET50_IMG_S,
        "policy": headline,
        "n_devices": n_dev,
        "device_kind": kind,
        "batch_per_device": batch,
        "batch_fallback": batch_fallback,
        "compute_dtype": dtype_name,
        "iters": iters,
        "sec_per_iter": dt,
        "merge_groups": main["merge_groups"],
        "policies": rows,
        "tb_total_s": float(sum(tb)),
        "tb_source": tb.source,
        "cost_profile": cost_src or "UNCALIBRATED ici prior",
        "mfu": mfu,
        "flops_per_step": flops,
        "peak_flops": peak,
    }
    if n_dev == 1:
        payload["note"] = (
            "one worker: the headline is the production configuration, the "
            "trainer's (no reducer, the 'none' row); the other rows run the "
            "merged all-reduce over a one-rank group, which moves no bytes, "
            "so they measure each policy's host cost per group")
    if mfu is not None and mfu > 1.0:
        payload.update({
            "value": None, "vs_baseline": None,
            "error": (f"computed MFU {mfu:.3f} > 1.0 — timing not credible "
                      f"(dt={dt}, flops={flops}, peak={peak})"),
        })
    return payload


def main(argv: Optional[list[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mgwfbp_tpu_torch.bench",
        description="time the merge-policy grid on the card; one JSON line",
    )
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)
    try:
        if args.device != "cpu":
            _devices_with_retry(args.device)
        payload = run_bench(args.device)
    except ChipUnavailable as e:
        detail = f"{type(e).__name__}: {e}"
        _record_bench_skip(detail)
        payload = {
            "metric": "resnet50_synthetic_imagenet_train_throughput",
            "value": None, "unit": "images/s", "vs_baseline": None,
            "skipped": "chip unavailable", "detail": detail,
        }
    except Exception as e:  # noqa: BLE001 — one JSON line, never a traceback
        payload = {
            "metric": "resnet50_synthetic_imagenet_train_throughput",
            "value": None, "unit": "images/s", "vs_baseline": None,
            "error": f"{type(e).__name__}: {e}",
        }
    print(json.dumps(payload), flush=True)
    return 1 if payload.get("error") else 0


if __name__ == "__main__":
    raise SystemExit(main())
