"""Training configuration (counterpart of ``mgwfbp_tpu/config.py``).

One dataclass with per-model presets, ``MGWFBP_<FIELD>`` environment
overrides and keyword overrides, resolved by ``make_config`` exactly as the
JAX package resolves them. Only the fields the port's training path reads
are kept; the rest of the JAX config (lowerings other than ``all_reduce``,
autotune, the rest of the telemetry plane, the serving shadow) is listed in
ROADMAP.md.
``deterministic`` is the port's own (torch's deterministic algorithms;
the JAX package has no counterpart to switch).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class TrainConfig:
    # model/data
    dnn: str = "resnet20"
    dataset: str = "cifar10"
    data_dir: str = "./data"
    batch_size: int = 32  # per-worker batch (weak scaling)
    lr: float = 0.1
    max_epochs: int = 141
    nsteps_update: int = 1  # gradient accumulation micro-steps
    augment: bool = True  # train-split augmentation
    num_steps: Optional[int] = None  # LM window length override (default 35)

    # distributed: the number of data-parallel workers (one per card)
    nworkers: int = 1

    # MG-WFBP scheduler
    policy: str = "auto"  # auto | mgwfbp | threshold | single | wfbp | none
    threshold: int = 0  # elements, for policy='threshold'
    connection: str = "ici"  # cost-model link class
    comm_profile: Optional[str] = None  # path to a calibrated alpha-beta json

    # numerics
    # compute dtype: None/'float32', or 'bfloat16' (mixed precision: the
    # forward and backward on bfloat16 copies; master weights, batch
    # statistics and optimizer state stay float32)
    dtype: Optional[str] = None
    comm_dtype: Optional[str] = None  # wire dtype, e.g. 'bfloat16'
    weight_decay: float = 1e-4
    momentum: float = 0.9
    norm_clip: Optional[float] = None

    # schedule
    lr_schedule: str = "auto"  # auto | step | cosine | ptb | anneal | vgg | const
    warmup_epochs: int = 5

    # io / bookkeeping
    logdir: str = "./logs"
    checkpoint_dir: Optional[str] = None
    checkpoint_every_epochs: int = 1
    # 'sharded' (the shard-native format); 'replicated' (the JAX package's
    # orbax escape hatch) is refused: the port has no orbax
    ckpt_format: str = "sharded"
    # mid-epoch saves hand their payload (host copies made at the step
    # boundary) to a writer thread and commit at a later step; False makes
    # every save block the step loop. Boundary and drain saves block.
    ckpt_async: bool = True
    # a mid-epoch checkpoint every N optimizer steps of an epoch (0: epoch
    # boundaries only); a SIGTERM/SIGINT drain always writes one
    ckpt_every_steps: int = 0
    grad_guard: bool = True  # drop the update on non-finite gradients
    # consecutive non-finite steps before rolling back to the newest
    # checkpoint (0: never; skipping still applies)
    bad_step_limit: int = 3
    # a run's checkpoint directory to take weights, batch statistics and
    # counters from (the optimizer starts fresh)
    pretrain: Optional[str] = None
    # torch.use_deterministic_algorithms(True, warn_only=True):
    # bitwise-repeatable steps on the card (cuBLAS also needs
    # CUBLAS_WORKSPACE_CONFIG in the environment; an op without a
    # deterministic implementation warns); off by default, as it costs speed
    deterministic: bool = False
    # the event stream (telemetry/events.py): step spans, per-epoch overlap
    # accounting; written to telemetry_dir, default <logdir>/<tag>
    telemetry: bool = False
    telemetry_dir: Optional[str] = None
    # the live HTTP plane (telemetry/serve.py): /healthz (watchdog-wired
    # liveness) and /status (step, health, run) on base + process index;
    # None = off, 0 = an ephemeral port (written to
    # MGWFBP_METRICS_PORT_FILE when set). Implies the event stream, which
    # feeds it. Env: MGWFBP_METRICS_PORT
    metrics_port: Optional[int] = None
    seed: int = 0
    num_batches_per_epoch: Optional[int] = None
    eval_every_epochs: int = 1

    def tag(self) -> str:
        from mgwfbp_tpu_torch.utils.logging import run_tag

        return run_tag(dataclasses.asdict(self))


# Dataset-keyed SGD constants; make_config fills them for any model trained
# on that dataset unless the preset or caller overrides.
_DATASET_SGD: dict[str, dict] = {
    "imagenet": dict(momentum=0.875, weight_decay=2 * 3.0517578125e-05),
    "ptb": dict(momentum=0.0, weight_decay=0.0),
}
# The JAX package's presets.
PRESETS: dict[str, dict] = {
    "mnistnet": dict(dataset="mnist", batch_size=64, lr=0.01, max_epochs=10),
    "lenet": dict(dataset="mnist", batch_size=64, lr=0.01, max_epochs=10),
    "resnet20": dict(dataset="cifar10", batch_size=32, lr=0.1, max_epochs=141),
    "resnet56": dict(dataset="cifar10", batch_size=32, lr=0.1, max_epochs=141),
    "resnet110": dict(dataset="cifar10", batch_size=32, lr=0.1, max_epochs=141),
    "vgg16": dict(dataset="cifar10", batch_size=128, lr=0.1, max_epochs=141,
                  lr_schedule="vgg"),
    "resnet50": dict(dataset="imagenet", batch_size=128, lr=0.01, max_epochs=70),
    "resnet152": dict(dataset="imagenet", batch_size=32, lr=0.01, max_epochs=70),
    "densenet121": dict(dataset="imagenet", batch_size=64, lr=0.01, max_epochs=70),
    "densenet161": dict(dataset="imagenet", batch_size=32, lr=0.01, max_epochs=70),
    "densenet201": dict(dataset="imagenet", batch_size=64, lr=0.01, max_epochs=70),
    "googlenet": dict(dataset="imagenet", batch_size=64, lr=0.01, max_epochs=70),
    "inceptionv3": dict(dataset="imagenet", batch_size=64, lr=0.01, max_epochs=70),
    "inceptionv4": dict(dataset="imagenet", batch_size=64, lr=0.01, max_epochs=70),
    "alexnet": dict(dataset="imagenet", batch_size=128, lr=0.01, max_epochs=70),
    "lstm": dict(dataset="ptb", batch_size=20, lr=22.0, max_epochs=40,
                 lr_schedule="ptb", norm_clip=0.25),
    "transformer": dict(dataset="ptb", batch_size=16, lr=1.0, max_epochs=40,
                        lr_schedule="cosine", weight_decay=1e-5, momentum=0.9,
                        num_steps=64),
    "lstman4": dict(dataset="an4", batch_size=4, lr=2e-4, max_epochs=100,
                    lr_schedule="anneal", norm_clip=400.0),
    "fcn5net": dict(dataset="mnist", batch_size=64, lr=0.05, max_epochs=10),
    "lr": dict(dataset="mnist", batch_size=64, lr=0.01, max_epochs=10),
}


def make_config(dnn: str, **overrides) -> TrainConfig:
    """Config for a model with its preset applied, then ``MGWFBP_<FIELD>``
    environment and keyword overrides (None values are ignored)."""
    base = dict(PRESETS.get(dnn, {}))
    base["dnn"] = dnn
    for field in dataclasses.fields(TrainConfig):
        if field.name == "dnn":
            # the model comes from the caller; an MGWFBP_DNN left in the
            # environment would mix one model's name with another's preset
            continue
        env = os.environ.get(f"MGWFBP_{field.name.upper()}")
        if env is not None:
            base[field.name] = _coerce(env, field.type)
    base.update({k: v for k, v in overrides.items() if v is not None})
    for k, v in _DATASET_SGD.get(base.get("dataset", "cifar10"), {}).items():
        base.setdefault(k, v)
    return TrainConfig(**base)


def _coerce(value: str, typ) -> object:
    s = str(typ)
    if "int" in s:
        return int(value)
    if "float" in s:
        return float(value)
    if "bool" in s:
        return value.lower() in ("1", "true", "yes")
    return value
