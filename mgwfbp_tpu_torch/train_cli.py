"""Training CLI (counterpart of ``mgwfbp_tpu/train_cli.py``).

    python -m mgwfbp_tpu_torch.train_cli --dnn resnet20 --synthetic
    python -m mgwfbp_tpu_torch.train_cli --dnn resnet20 --synthetic \\
        --device cpu --epochs 1 --num-batches-per-epoch 8

The flags are the JAX CLI's for the fields the port reads, plus
``--device`` (default ``cuda``; a missing card raises, ``cpu`` runs on the
CPU). Several processes, one per card, form a world from
``--coordinator host:port --num-processes N --process-id i`` or the
``MGWFBP_COORDINATOR``/``MGWFBP_NUM_PROCESSES``/``MGWFBP_PROCESS_ID``
environment; each takes the card of its local rank (``LOCAL_RANK``,
``SLURM_LOCALID``, ``OMPI_COMM_WORLD_LOCAL_RANK``, else the process id
modulo the host's cards) unless ``--device cuda:K`` names one. Prints one
JSON result line at the end.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

from mgwfbp_tpu_torch.config import PRESETS, TrainConfig, make_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mgwfbp-train-torch",
        description="MG-WFBP data-parallel training on CUDA (PyTorch port)",
    )
    p.add_argument("--dnn", default="resnet20", help=f"model: {sorted(PRESETS)}")
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
                   help="path to a calibrated alpha-beta json")
    p.add_argument("--comm-dtype", dest="comm_dtype", default=None,
                   help="wire dtype for the all-reduce, e.g. bfloat16")
    p.add_argument("--synthetic", action="store_true",
                   help="force synthetic data (no dataset files needed)")
    p.add_argument("--no-augment", action="store_true",
                   help="disable training-time data augmentation")
    p.add_argument("--no-grad-guard", action="store_true",
                   help="apply updates even when gradients are non-finite")
    p.add_argument("--no-profile-backward", action="store_true",
                   help="skip the backward benchmark (volume prior)")
    p.add_argument("--checkpoint-dir", dest="checkpoint_dir", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--logdir", default=None)
    p.add_argument("--coordinator", default=None,
                   help="rendezvous address host:port of rank 0")
    p.add_argument("--num-processes", dest="num_processes", type=int,
                   default=None)
    p.add_argument("--process-id", dest="process_id", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    overrides = {
        k: getattr(args, k)
        for k in (
            "dataset", "data_dir", "batch_size", "lr", "max_epochs",
            "nsteps_update", "policy", "threshold", "connection",
            "comm_profile", "comm_dtype", "logdir", "checkpoint_dir", "seed",
            "num_batches_per_epoch",
        )
        if getattr(args, k, None) is not None
    }
    if args.no_augment:
        overrides["augment"] = False
    if args.no_grad_guard:
        overrides["grad_guard"] = False
    return make_config(args.dnn, **overrides)


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    import torch.distributed as dist

    from mgwfbp_tpu_torch.parallel.mesh import init_distributed
    from mgwfbp_tpu_torch.train.trainer import Trainer

    device = init_distributed(
        args.device, coordinator=args.coordinator,
        num_processes=args.num_processes, process_id=args.process_id,
    )
    try:
        trainer = Trainer(
            cfg, device=device,
            profile_backward=not args.no_profile_backward,
            synthetic_data=True if args.synthetic else None,
        )
        try:
            metrics = trainer.fit(args.epochs)
        finally:
            trainer.close()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(json.dumps(metrics), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
