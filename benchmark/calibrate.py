"""The readings that the correctness check's limits are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 --fault-seeds 1,2,3 --out <file.jsonl>

In one process per rank (several ranks are started as ``run.py`` starts
them), one trainer is built for the cell and, for each seed, given that
seed's weights, its optimizer state and batch-norm statistics reset, and
driven through the check's steps at the cell's own sizes:

  * ``program``: the program against the float32 reference (the lower
    reading is the largest over the seeds);
  * ``control``: the reference computed in fp8 (``reference.<family>``'s
    ``quant="fp8"``) in the program's place;
  * ``witness:bf16``: the reference rounded to bfloat16 as the program
    rounds (``quant="bf16"``), what rounding alone moves;
  * ``fault:<name>``: the program with a fault of ``benchmark.faults``
    planted (``no_exchange`` only where the cell has several ranks).

Each reading is written as one JSON line (rank 0).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402  (sets the run's environment)


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def rank_main(args) -> int:
    import torch

    from benchmark import check, drive, faults, spec, weights

    cell = spec.load_cell(ROOT, args.workload)
    world, rank = cell.ranks, args.rank or 0
    device = run.rank_device(args.device, world)
    c, t = cell.config, cell.traffic
    work = spec.family_module("work", c["family"])
    names = [n for n, _, _ in work.params(c)]
    seeds = _seeds(args.seeds)
    trainer = drive.build_trainer(cell, seeds[0], device,
                                  os.path.join(args.workdir, f"logs{rank}"))
    kinds = ["unchanged", "half_batch"] + (["no_exchange"] if world > 1
                                           else [])
    out = open(args.out, "a") if rank == 0 else None

    def emit(seed, kind, prog, ref):
        vals = check.numbers(prog, ref)
        worst = [max(col) for col in zip(*drive.gather(
            [vals[k] for k in sorted(vals)], world, device))]
        if out is not None:
            row = {"cell": cell.name, "seed": seed, "kind": kind,
                   **dict(zip(sorted(vals), worst))}
            out.write(json.dumps(row) + "\n")
            out.flush()
            print(json.dumps(row), file=sys.stderr)

    def program(seed, fault=None):
        w = weights.make_weights(work.params(c), seed, device)
        drive.prime(trainer.model, trainer.optimizer, w)
        trainer.train_step.step = 0
        if fault is None:
            return drive.program_check(trainer, feed, names)
        with faults.plant(fault, trainer):
            return drive.program_check(trainer, feed, names)

    for seed in seeds:
        x, y = weights.make_batches(
            drive.CHECK_STEPS, int(t["batch_per_card"]),
            int(c["in_channels"]), int(c["image_size"]),
            int(c["num_classes"]), seed, rank, device)

        def feed(i, x=x, y=y):
            return x[i % x.shape[0]], y[i % y.shape[0]]

        prog = program(seed)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = drive.reference_check(cell, seed, feed, device, world)
        emit(seed, "program", prog, ref)
        if seed in _seeds(args.control_seeds):
            ctrl = drive.reference_check(cell, seed, feed, device, world,
                                         quant="fp8")
            emit(seed, "control", ctrl, ref)
            bf16 = drive.reference_check(cell, seed, feed, device, world,
                                         quant="bf16")
            emit(seed, "witness:bf16", bf16, ref)
        if seed in _seeds(args.fault_seeds):
            for kind in kinds:
                emit(seed, f"fault:{kind}", program(seed, kind), ref)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if out is not None:
        out.close()
    if world > 1:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--workdir", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    args.out = os.path.abspath(args.out)
    if args.rank is not None:
        return rank_main(args)
    from benchmark import spec

    cell = spec.load_cell(ROOT, args.workload)
    args.workdir = tempfile.mkdtemp(prefix="benchmark-calibrate-")
    try:
        if cell.ranks == 1:
            args.rank = 0
            return rank_main(args)
        argv = ["--workload", args.workload, "--seeds", args.seeds,
                "--control-seeds", args.control_seeds, "--fault-seeds",
                args.fault_seeds, "--out", args.out, "--device", args.device,
                "--workdir", args.workdir]
        return run.launch(os.path.abspath(__file__), argv, cell.ranks,
                          args.device, timeout_s=3000.0)
    finally:
        shutil.rmtree(args.workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
