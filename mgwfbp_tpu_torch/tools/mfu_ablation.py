"""MFU counterfactual rows for ResNet-50 (the counterpart of the JAX
package's ``tools/mfu_ablation.py``): the rows its roofline argument only
reasoned about, MEASURED on the card.

  * batch 64 / 128 / 256: if the step is bound by memory traffic per
    sample, throughput stays flat across batches;
  * uint8 input and normalisation on the card (``Uint8Normalize``): the
    input read shrinks 4x (the lean host-to-device input path);
  * bfloat16 batch statistics (``MGWFBP_BN_DTYPE=bfloat16``, set for the
    row and restored after): the batch norm's reductions in bfloat16.

    python -m mgwfbp_tpu_torch.tools.mfu_ablation [--iters 30] [--out a.json]

Each row: the bench's protocol (``TrainStep`` at bfloat16 on synthetic
batches, ``bench.time_steps``: 5 warm-up steps, ``--iters`` timed steps
between two CUDA events and one synchronisation after the last), FLOPs
per step from torch's FlopCounterMode (``bench.flops_per_step``:
convolutions and matmuls, 2 per multiply-add; the uint8 wrapper's
elementwise normalisation counts none),
MFU against ``utils.platform.peak_flops`` at bfloat16. XLA's cost analysis
(``bytes accessed``) has no torch counterpart: those fields are null,
never estimated. Nothing is written without ``--out`` (``--no-save`` is
accepted for the JAX tool's command line).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

NORM_MEAN, NORM_STD = 0.45, 0.225  # the JAX wrapper's constants


def uint8_normalize(inner):
    """``inner`` behind a module that takes uint8 NCHW images and
    dequantises and normalises them on the card in bfloat16, as the JAX
    tool's ``Uint8Normalize``: (x / 255 - 0.45) / 0.225, each product
    rounded to bfloat16; the result is handed on in the inner model's
    parameter dtype (bfloat16 in a bfloat16 step)."""
    import torch
    from torch import nn

    class Uint8Normalize(nn.Module):
        def __init__(self, inner: nn.Module):
            super().__init__()
            self.inner = inner

        def forward(self, x):
            bf = torch.bfloat16
            x = x.to(bf) * torch.tensor(1.0 / 255.0, dtype=bf)
            x = (x - torch.tensor(NORM_MEAN, dtype=bf)) * torch.tensor(
                1.0 / NORM_STD, dtype=bf)
            return self.inner(x.to(next(self.inner.parameters()).dtype))

    return Uint8Normalize(inner)


def _build(model_name, batch, device, uint8_input=False):
    """(step, x, y, FLOPs per step) of one row."""
    import numpy as np
    import torch

    from mgwfbp_tpu_torch.bench import flops_per_step, make_model
    from mgwfbp_tpu_torch.optim import make_optimizer
    from mgwfbp_tpu_torch.train.step import TrainStep

    model, meta = make_model(model_name, device)
    if uint8_input:
        model = uint8_normalize(model)
    rs = np.random.RandomState(0)
    shape = (batch, *meta.input_shape)
    if uint8_input:
        x = torch.from_numpy(rs.randint(0, 256, shape).astype(np.uint8))
    else:
        x = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    x = x.to(device).movedim(-1, -3).contiguous()
    y = torch.from_numpy(rs.randint(0, meta.num_classes, (batch,))
                         .astype(np.int64)).to(device)
    flops = flops_per_step(model, x, y, torch.bfloat16)
    opt, lr_fn, _ = make_optimizer(
        model.parameters(), 0.01, momentum=0.9, weight_decay=1e-4,
        lr_schedule="const", dataset=meta.dataset, num_batches_per_epoch=1)
    step = TrainStep(model, opt, lr_fn, compute_dtype=torch.bfloat16)
    return step, x[None], y[None], flops


def row_names(batch: int) -> dict:
    """name -> (batch, uint8 input, bfloat16 statistics); the JAX tool's
    names at the default batch of 128."""
    return {
        f"baseline_b{batch}": (batch, False, False),
        f"batch_{batch // 2}": (batch // 2, False, False),
        f"batch_{batch * 2}": (batch * 2, False, False),
        f"uint8_input_b{batch}": (batch, True, False),
        f"bf16_batchstats_b{batch}": (batch, False, True),
    }


def run_rows(iters, model_name="resnet50", batch=128, device="cuda") -> dict:
    import torch

    from mgwfbp_tpu_torch.bench import WARMUP, time_steps
    from mgwfbp_tpu_torch.utils.device import device_kind
    from mgwfbp_tpu_torch.utils.platform import peak_flops

    kind = device_kind(device)
    peak = peak_flops(kind, "bfloat16")
    rows = {}
    for name, (b, uint8_input, bn_bf16) in row_names(batch).items():
        prior = os.environ.get("MGWFBP_BN_DTYPE")
        # a row labelled baseline must BE the baseline even where the
        # caller exported the switch
        if bn_bf16:
            os.environ["MGWFBP_BN_DTYPE"] = "bfloat16"
        else:
            os.environ.pop("MGWFBP_BN_DTYPE", None)
        try:
            step, x, y, flops = _build(model_name, b, device, uint8_input)
            dt = time_steps(step, x, y, iters, device, what=name)
        finally:
            if prior is None:
                os.environ.pop("MGWFBP_BN_DTYPE", None)
            else:
                os.environ["MGWFBP_BN_DTYPE"] = prior
        del step, x, y
        if device.type == "cuda":
            torch.cuda.empty_cache()
        rows[name] = {
            "batch": b,
            "sec_per_iter": dt,
            "images_per_sec": b / dt,
            "mfu": flops / dt / peak if peak else None,
            "flops_per_step": flops,
            "xla_bytes_accessed_GB": None,
            "achieved_GBps_on_xla_bytes": None,
        }
        print(name, json.dumps(rows[name]), file=sys.stderr, flush=True)
    base = rows[f"baseline_b{batch}"]
    for r in rows.values():
        r["throughput_vs_baseline"] = r["images_per_sec"] / base[
            "images_per_sec"]
    return {
        "protocol": (
            f"TrainStep at bfloat16, {WARMUP} warm-up + {iters} timed steps "
            "between CUDA events, one synchronisation after the last; FLOPs "
            "from torch's FlopCounterMode (bench.flops_per_step); "
            "xla_bytes_accessed_GB and achieved_GBps_on_xla_bytes are null: "
            "XLA's cost analysis has no torch counterpart, and no TPU "
            "figure stands in for it"
        ),
        "model": model_name,
        "device": kind,
        "peak_flops": peak,
        "rows": rows,
    }


def main(argv=None) -> int:
    from mgwfbp_tpu_torch.tools.overlap_report import write_report

    ap = argparse.ArgumentParser(
        prog="python -m mgwfbp_tpu_torch.tools.mfu_ablation",
        description="ResNet-50's MFU counterfactual rows, measured")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--batch", type=int, default=128,
                    help="the baseline batch (the others: half and double)")
    ap.add_argument("--no-save", action="store_true",
                    help="accepted for the JAX tool's command line; "
                         "nothing is written without --out")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    from mgwfbp_tpu_torch.utils.device import (
        resolve_device,
        set_matmul_precision,
    )

    device = resolve_device(args.device)
    set_matmul_precision("bfloat16")
    report = run_rows(args.iters, args.model, args.batch, device)
    base = report["rows"][f"baseline_b{args.batch}"]
    report["conclusion"] = [
        f"{name}: {r['images_per_sec'] / base['images_per_sec'] - 1.0:+.1%} "
        "img/s vs baseline"
        for name, r in report["rows"].items() if r is not base]
    write_report(report, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
