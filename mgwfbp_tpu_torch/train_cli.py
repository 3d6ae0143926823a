"""Training CLI (counterpart of ``mgwfbp_tpu/train_cli.py``).

    python -m mgwfbp_tpu_torch.train_cli --dnn resnet20 --synthetic
    python -m mgwfbp_tpu_torch.train_cli --dnn resnet20 --synthetic \\
        --device cpu --epochs 1 --num-batches-per-epoch 8
    python -m mgwfbp_tpu_torch.train_cli --dnn lstm --synthetic \\
        --device cpu --batch-size 4 --num-batches-per-epoch 4 --epochs 1
    python -m mgwfbp_tpu_torch.train_cli --dnn resnet50 --dtype bfloat16 \\
        --synthetic

The flags are the JAX CLI's for the fields the port reads, plus
``--device`` (default ``cuda``; a missing card raises, ``cpu`` runs on the
CPU). Several processes, one per card, form a world from
``--coordinator host:port --num-processes N --process-id i`` or the
``MGWFBP_COORDINATOR``/``MGWFBP_NUM_PROCESSES``/``MGWFBP_PROCESS_ID``
environment; each takes the card of its local rank (``LOCAL_RANK``,
``SLURM_LOCALID``, ``OMPI_COMM_WORLD_LOCAL_RANK``, else the process id
modulo the host's cards) unless ``--device cuda:K`` names one. Prints one
JSON result line at the end (language models add ``perplexity`` to their
train and eval metrics). ``--comm-profile`` takes a profile written by
``python -m mgwfbp_tpu_torch.calibrate``; ``--telemetry`` writes the event
stream (``MGWFBP_TELEMETRY_TRACE=1`` adds a profiler trace of two steps
before the first epoch, whose per-group device times replace the cost
model's in the overlap records).

Resilience: with ``--checkpoint-dir`` a rerun of the same command resumes
from the newest committed step (``--ckpt-every-steps N`` adds mid-epoch
steps). SIGTERM or SIGINT drains at a step boundary: a checkpoint, one
``{"preempted": true, "signal", "epoch", "iteration"}`` line and exit code
75, so that a supervisor restarts the command. ``MGWFBP_FAULT_PLAN`` injects
faults (``utils/faults.py``), e.g. ``nan@step=4,count=3`` or
``preempt@step=12``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from mgwfbp_tpu_torch.config import PRESETS, TrainConfig, make_config
from mgwfbp_tpu_torch.models import model_names


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mgwfbp-train-torch",
        description="MG-WFBP data-parallel training on CUDA (PyTorch port)",
    )
    p.add_argument("--dnn", default="resnet20",
                   help=f"model: {model_names()} (presets: {sorted(PRESETS)})")
    p.add_argument("--dataset", default=None)
    p.add_argument("--data-dir", dest="data_dir", default=None)
    p.add_argument("--batch-size", dest="batch_size", type=int, default=None,
                   help="per-worker batch (weak scaling)")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--max-epochs", dest="max_epochs", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None,
                   help="run this many epochs (default: through --max-epochs)")
    p.add_argument("--num-batches-per-epoch", dest="num_batches_per_epoch",
                   type=int, default=None,
                   help="cap optimizer steps per epoch (smoke runs)")
    p.add_argument("--num-steps", dest="num_steps", type=int, default=None,
                   help="LM window length (default: the preset's, else 35)")
    p.add_argument("--nsteps-update", dest="nsteps_update", type=int,
                   default=None, help="gradient accumulation micro-steps")
    p.add_argument("--policy", default=None,
                   choices=["mgwfbp", "auto", "threshold", "single", "wfbp",
                            "none"],
                   help="merge policy ('none': one all-reduce per tensor)")
    p.add_argument("--threshold", type=int, default=None,
                   help="elements per group for --policy threshold")
    p.add_argument("--connection", default=None,
                   help="cost-model link class: ici|dcn|56GbIB|10GbE")
    p.add_argument("--comm-profile", dest="comm_profile", default=None,
                   help="path to a calibrated alpha-beta json "
                        "(python -m mgwfbp_tpu_torch.calibrate); a family "
                        "profile resolves at the world size")
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                   help="compute dtype: float32 | bfloat16 (mixed precision;"
                        " master weights stay float32). TF32 stays off "
                        "either way (utils.device.set_matmul_precision)")
    p.add_argument("--comm-dtype", dest="comm_dtype", default=None,
                   help="wire dtype for the all-reduce, e.g. bfloat16")
    p.add_argument("--norm-clip", dest="norm_clip", type=float, default=None,
                   help="clip gradients to this global norm")
    p.add_argument("--lr-schedule", dest="lr_schedule", default=None,
                   choices=["auto", "step", "cosine", "ptb", "anneal", "vgg",
                            "const"],
                   help="learning-rate schedule (default: the preset's)")
    p.add_argument("--synthetic", action="store_true",
                   help="force synthetic data (no dataset files needed)")
    p.add_argument("--no-augment", action="store_true",
                   help="disable training-time data augmentation")
    p.add_argument("--no-grad-guard", action="store_true",
                   help="apply updates even when gradients are non-finite")
    p.add_argument("--no-profile-backward", action="store_true",
                   help="skip the backward benchmark (volume prior)")
    p.add_argument("--checkpoint-dir", dest="checkpoint_dir", default=None)
    p.add_argument("--ckpt-every-steps", dest="ckpt_every_steps", type=int,
                   default=None,
                   help="mid-epoch step-indexed checkpoint every N optimizer "
                        "steps (a restart resumes from the exact step; 0 = "
                        "epoch boundaries only)")
    p.add_argument("--ckpt-format", dest="ckpt_format", default=None,
                   choices=["sharded", "replicated"],
                   help="checkpoint format (default sharded, the "
                        "shard-native format both packages read); "
                        "'replicated' (orbax) is refused by the port")
    p.add_argument("--no-ckpt-async", action="store_true",
                   help="make mid-epoch checkpoints block the step loop (by "
                        "default a writer thread writes the payload and the "
                        "commit lands at a later step)")
    p.add_argument("--bad-step-limit", dest="bad_step_limit", type=int,
                   default=None,
                   help="consecutive non-finite steps before rollback to "
                        "the newest checkpoint (0 disables rollback)")
    p.add_argument("--pretrain", default=None,
                   help="checkpoint directory to initialize weights from")
    p.add_argument("--deterministic", action="store_true",
                   help="torch.use_deterministic_algorithms(True, "
                        "warn_only=True) (set CUBLAS_WORKSPACE_CONFIG=:4096:8 "
                        "on the card)")
    p.add_argument("--telemetry", action="store_true",
                   help="write the event stream: step spans, and per epoch "
                        "an epoch record, the overlap accounting and one "
                        "comm_group record per merge group; render with "
                        "tools/telemetry_report.py")
    p.add_argument("--telemetry-dir", dest="telemetry_dir", default=None,
                   help="directory for the event stream (default "
                        "<logdir>/<tag>; implies --telemetry)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--logdir", default=None)
    p.add_argument("--coordinator", default=None,
                   help="rendezvous address host:port of rank 0")
    p.add_argument("--num-processes", dest="num_processes", type=int,
                   default=None)
    p.add_argument("--process-id", dest="process_id", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--print-config", action="store_true",
                   help="print the resolved config as JSON and exit")
    return p


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    overrides = {
        k: getattr(args, k)
        for k in (
            "dataset", "data_dir", "batch_size", "lr", "max_epochs",
            "nsteps_update", "policy", "threshold", "connection",
            "comm_profile", "dtype", "comm_dtype", "norm_clip", "lr_schedule",
            "logdir", "checkpoint_dir", "seed", "num_batches_per_epoch",
            "telemetry_dir", "num_steps", "ckpt_every_steps", "ckpt_format",
            "bad_step_limit", "pretrain",
        )
        if getattr(args, k, None) is not None
    }
    if args.no_augment:
        overrides["augment"] = False
    if args.no_grad_guard:
        overrides["grad_guard"] = False
    if args.no_ckpt_async:
        overrides["ckpt_async"] = False
    if args.deterministic:
        overrides["deterministic"] = True
    if args.telemetry or args.telemetry_dir:
        overrides["telemetry"] = True
    return make_config(args.dnn, **overrides)


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if args.print_config:
        print(json.dumps(cfg.__dict__, indent=2, default=str))
        return 0
    import torch.distributed as dist

    from mgwfbp_tpu_torch.parallel.mesh import init_distributed
    from mgwfbp_tpu_torch.runtime.coordination import CoordinationTimeout
    from mgwfbp_tpu_torch.train.trainer import Trainer
    from mgwfbp_tpu_torch.utils.faults import PREEMPT_RC, Preempted

    device = init_distributed(
        args.device, coordinator=args.coordinator,
        num_processes=args.num_processes, process_id=args.process_id,
    )
    trainer = None
    try:
        trainer = Trainer(
            cfg, device=device,
            profile_backward=not args.no_profile_backward,
            synthetic_data=True if args.synthetic else None,
        )
        metrics = trainer.fit(args.epochs)
    except Preempted as p:
        # the drain checkpointed and emitted its event; EX_TEMPFAIL tells
        # a supervisor "restart me to resume"
        print(json.dumps({
            "preempted": True, "signal": p.signal_name,
            "epoch": p.epoch, "iteration": p.iteration,
        }), flush=True)
        return PREEMPT_RC
    except CoordinationTimeout as ct:
        # a peer died mid-collective: no barrier can complete, so leave
        # without the process group's teardown (restart-friendly, drain-less)
        print(json.dumps({
            "coordination_timeout": True, "op": ct.op,
            "timeout_s": ct.timeout_s,
            "iteration": trainer.iteration if trainer else None,
        }), flush=True)
        if trainer is not None:
            trainer.close()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(PREEMPT_RC)
    finally:
        if trainer is not None:
            trainer.close()
        if dist.is_initialized():
            dist.destroy_process_group()
    print(json.dumps(metrics), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
