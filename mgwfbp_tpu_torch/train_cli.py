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
75, so that a supervisor restarts the command
(``python -m mgwfbp_tpu_torch.runtime.supervise``). ``MGWFBP_FAULT_PLAN``
injects faults (``utils/faults.py``), e.g. ``nan@step=4,count=3``,
``preempt@step=12``, ``stall@secs=60,step=5``, ``kill@step=12`` or
``wedge@step=18,secs=600``. ``MGWFBP_WATCHDOG_S`` arms the progress
watchdog (``MGWFBP_WATCHDOG_ABORT=1``: rc 86 after a stack dump);
``--metrics-port`` serves /metrics, /healthz, /status, /profile?steps=N
(a ``torch.profiler`` window over N live steps) and /postmortems (the flight
recorder's bundles); ``--no-health-stats`` turns off the in-step health
statistics, ``--tensorboard`` streams scalars, ``--serve-shadow`` serves
and shadow-scores the run's checkpoints in-process. ``--comm-op`` picks the
lowering of the merged collectives (``all_reduce``, ``rs_ag``,
``rs_opt_ag``: the sharded optimizer, ``rs_fwd_ag``: the sharded optimizer
with each all-gather deferred into the next step's forward, ``hier``: the
two-level lowering over ``--dcn-slices`` slices, which it needs to be more
than 1), ``--compressor topk --density D`` the top-k compressor
(``--density 0``: the cost model's choice). ``--autotune`` races verified
candidate schedules for ``--autotune-steps`` real steps each before the
first epoch and commits the fastest, cached under ``--schedule-cache``
(a second run with the same key loads it without racing); at one process
there is no reducer and nothing to tune. A single-process launch first
probes the card under ``MGWFBP_INIT_TIMEOUT_S``
(``utils.platform.preflight_backend``).

    python -m mgwfbp_tpu_torch.train_cli --dnn resnet20 --synthetic \\
        --comm-op rs_fwd_ag                # with 2 or more processes
    python -m mgwfbp_tpu_torch.train_cli --dnn resnet20 --synthetic \\
        --comm-op hier --dcn-slices 2      # with 4 processes: 2 x 2

``--seq-parallel S`` trains a windowed LM (the transformer) with each
window's time dimension sharded over rings of S processes
(``parallel.mesh.seq_groups``: ranks [d * S, (d + 1) * S) form ring d and
share their batch rows, rank r holding time slice r % S) through ring
attention; the world must be a multiple of S, the window too, and a model
with a BPTT carry, or ``--comm-op hier``, is refused:

    python -m mgwfbp_tpu_torch.train_cli --dnn transformer --synthetic \\
        --seq-parallel 2                   # with 2 processes: 1 x 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from mgwfbp_tpu_torch.config import (
    PRESETS,
    TrainConfig,
    check_hier,
    make_config,
)
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
                   help="LM window length (default: the preset's, else 35; "
                        "must divide by --seq-parallel)")
    p.add_argument("--seq-parallel", dest="seq_parallel", type=int,
                   default=None,
                   help="ranks per sequence-parallel ring: each ring shares "
                        "its batch rows and shards the LM window over ring "
                        "attention (windowed LMs, e.g. transformer)")
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
    p.add_argument("--compressor", default=None, choices=["none", "topk"],
                   help="gradient compressor (reference --compressor)")
    p.add_argument("--density", type=float, default=None,
                   help="kept fraction for sparsifying compressors; 0 = "
                        "auto (cost-model chooser, may fall back to dense)")
    p.add_argument("--comm-op", dest="comm_op", default=None,
                   choices=["all_reduce", "rs_ag", "hier", "rs_opt_ag",
                            "rs_fwd_ag"],
                   help="bucket collective: monolithic all-reduce, "
                        "reduce-scatter + all-gather (DeAR-style), the "
                        "hierarchical two-level lowering (requires "
                        "--dcn-slices > 1), reduce-scatter + SHARDED "
                        "optimizer update + param all-gather (ZeRO-1-style "
                        "1/world optimizer state; same wire bytes as "
                        "rs_ag), or rs_fwd_ag, the CROSS-STEP pipeline: "
                        "rs_opt_ag whose param all-gather is deferred into "
                        "the next step's forward (params carried as "
                        "1/world shards between steps)")
    p.add_argument("--dcn-slices", dest="dcn_slices", type=int, default=None,
                   help="slices of a multi-slice world: slice s is ranks "
                        "[s * n / D, (s + 1) * n / D); the outer "
                        "data-parallel level of the two-level cost model "
                        "and of --comm-op hier")
    p.add_argument("--autotune", action="store_true",
                   help="closed-loop schedule autotuning: race verified "
                        "candidate schedules for a few real training steps "
                        "each, refit the cost model from the measurements, "
                        "commit the measured argmin and cache it (see "
                        "README 'Autotuning')")
    p.add_argument("--autotune-steps", dest="autotune_steps", type=int,
                   default=None,
                   help="timed steps per raced candidate (plus one "
                        "warmup step each)")
    p.add_argument("--schedule-cache", dest="schedule_cache", default=None,
                   help="directory for committed autotune schedules "
                        "(default profiles/schedule_cache); a second run "
                        "with the same schedule-cache key (see "
                        "parallel/autotune.py cache_key) skips the race")
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
    p.add_argument("--no-health-stats", action="store_true",
                   help="disable the in-step training-health statistics "
                        "(global and per-group gradient norms, the "
                        "update/param ratio) and with them the health "
                        "detector's alarms")
    p.add_argument("--tensorboard", action="store_true",
                   help="stream train/eval scalars (scalar records in the "
                        "event stream, else <logdir>/<tag>/events.jsonl; "
                        "mirrored into TensorBoard files when a writer "
                        "package imports)")
    p.add_argument("--telemetry", action="store_true",
                   help="write the event stream: step spans, and per epoch "
                        "an epoch record, the overlap accounting and one "
                        "comm_group record per merge group; render with "
                        "python -m mgwfbp_tpu_torch.tools.telemetry_report")
    p.add_argument("--telemetry-dir", dest="telemetry_dir", default=None,
                   help="directory for the event stream (default "
                        "<logdir>/<tag>; implies --telemetry)")
    p.add_argument("--metrics-port", dest="metrics_port", type=int,
                   default=None,
                   help="live HTTP plane: /healthz (200, or 503 while the "
                        "watchdog sees a stall) and /status (step, epoch, "
                        "health, last checkpoint, run) on this port + the "
                        "process index; 0 = ephemeral (the bound port is "
                        "written to MGWFBP_METRICS_PORT_FILE); implies "
                        "--telemetry (MGWFBP_METRICS_PORT)")
    p.add_argument("--serve-shadow", action="store_true",
                   help="in-process serving plane: hot-reload every "
                        "committed checkpoint into a ServingModel, score the "
                        "held-out shadow stream on it (shadow_eval events, "
                        "served-vs-training loss gauge) and answer POST "
                        "/predict on the metrics port; one process only, "
                        "needs --checkpoint-dir and telemetry")
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
            "bad_step_limit", "pretrain", "metrics_port", "compressor",
            "density", "comm_op", "dcn_slices", "autotune_steps",
            "schedule_cache", "seq_parallel",
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
    if args.no_health_stats:
        overrides["health_stats"] = False
    if args.tensorboard:
        overrides["tensorboard"] = True
    if args.serve_shadow:
        # the plane's reload, shadow_eval and serve_stats events ride the
        # event stream, so serving implies it
        overrides["serve_shadow"] = True
        overrides["telemetry"] = True
    if args.telemetry or args.telemetry_dir or args.metrics_port is not None:
        overrides["telemetry"] = True
    if args.autotune:
        overrides["autotune"] = True
    return make_config(args.dnn, **overrides)


def main(argv: Optional[list[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    try:
        check_hier(cfg.comm_op, cfg.dcn_slices, cfg.seq_parallel)
    except ValueError as e:
        parser.error(str(e))
    if args.print_config:
        print(json.dumps(cfg.__dict__, indent=2, default=str))
        return 0
    import torch.distributed as dist

    from mgwfbp_tpu_torch.parallel.mesh import (
        init_distributed,
        resolve_launch_env,
    )
    from mgwfbp_tpu_torch.runtime.coordination import CoordinationTimeout
    from mgwfbp_tpu_torch.train.trainer import Trainer, check_lowering
    from mgwfbp_tpu_torch.utils.faults import PREEMPT_RC, Preempted
    from mgwfbp_tpu_torch.utils.platform import preflight_backend
    from mgwfbp_tpu_torch.utils.watchdog import exit_mark, start_stack_sampler

    env_coord, env_num, env_pid = resolve_launch_env()
    try:
        # before the rendezvous: a rank that failed inside it would leave
        # and take the group down while a peer still waited there, which
        # then died of the store's error instead of this message
        world = (args.num_processes if args.num_processes is not None
                 else env_num)
        check_lowering(cfg, int(world or 1))
    except ValueError as e:
        parser.error(str(e))
    multi_process = bool(
        (args.coordinator or env_coord) is not None
        or (args.process_id if args.process_id is not None
            else env_pid) is not None
        or ((args.num_processes or env_num) or 0) > 1
    )
    if not multi_process:
        # a wedged card blocks CUDA's initialisation with no error: probe
        # it under MGWFBP_INIT_TIMEOUT_S first (--device cpu touches no
        # CUDA). One process only: in a group the rendezvous is the first
        # contact, and its timeout surfaces a dead peer
        preflight_backend(device=args.device)
    device = init_distributed(
        args.device, coordinator=args.coordinator,
        num_processes=args.num_processes, process_id=args.process_id,
    )
    start_stack_sampler()
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
        exit_mark(f"coordination timeout in {ct.op}: closing the trainer")
        if trainer is not None:
            trainer.close()
        exit_mark("trainer closed: os._exit")
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(PREEMPT_RC)
    finally:
        exit_mark("leaving: closing the trainer")
        if trainer is not None:
            trainer.close()
        if dist.is_initialized():
            exit_mark("trainer closed: destroy_process_group")
            dist.destroy_process_group()
        exit_mark("process group destroyed")
    print(json.dumps(metrics), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
