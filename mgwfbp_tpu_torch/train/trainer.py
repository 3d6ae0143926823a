"""The trainer (counterpart of the ``all_reduce`` training path of
``mgwfbp_tpu/train/trainer.py``): loaders, model, optimizer, the merged
all-reduce and its backward profile, the train/eval loop and step commits,
for classifiers, language models and the speech model (``lstman4``, CTC).
A model with a BPTT carry (the LSTM) starts each epoch, and each
evaluation, from a zero carry and threads it through the steps; the
transformer trains through dense attention, as the JAX package trains it
(``models.for_training``). A ctc batch is a dict {x, y, input_lengths,
label_lengths}; its evaluation adds the greedy-decoded WER, decoded from
the logits of the loss's own forward. The train batches come through the
loader's ``batches(epoch, start, stop)``: a ``PrefetchLoader`` (the
default, ``data._wrap_prefetch``) assembles them ahead of the step.

One process per card; the world is whatever ``torch.distributed`` was
started with (``parallel.mesh.init_distributed``), one worker when it was
not started. At one worker there is no reducer: no communication exists
to schedule (the JAX trainer's single-device rule). The cost model is the
``--comm-profile`` resolved at the world size, else the ``connection``
prior; the measured backward profile is written to
``<logdir>/<tag>/tb_profile.json``. ``config.dtype`` bfloat16 runs the
step and evaluation at that compute dtype (the JAX step's mixed-precision
policy, ``train/step.py``); the TF32 setting comes from
``utils.device.set_matmul_precision`` and is logged. With ``telemetry`` on, each step
writes a ``step`` span and each epoch an ``epoch`` record (for a
language model both also hold its ``loss`` and ``perplexity``), the
``overlap``
accounting and one ``comm_group`` record per merge group
(``telemetry/overlap.py``).

Resilience (the JAX trainer's layer). With ``checkpoint_dir`` the trainer
commits shard-native checkpoints through ``checkpoint.Checkpointer``: at
epoch boundaries, every ``ckpt_every_steps`` optimizer steps (written by a
background thread when ``ckpt_async``; the payload is a host copy made at
the step boundary, so later in-place updates cannot reach it) and at a
preemption drain. A step holds what the JAX trainer's manifest holds
(params, batch statistics, the optimizer as the optax tree, the counters,
the schedule's anchor, the LM carry of a mid-epoch save), so either
package restores the other's; this package's generator states ride beside
it in files the JAX reader ignores. A new trainer resumes from the newest
step, replaying the data stream from its position (the loader is a pure
function of seed, epoch and batch index); ``pretrain`` loads the weights
and counters of another run and starts a fresh optimizer. SIGTERM and
SIGINT drain at a step boundary (at several processes, at deterministic
agreement points): a synchronous checkpoint, a ``preempt`` event, then
``Preempted``, which ``train_cli`` turns into rc 75. ``bad_step_limit``
consecutive non-finite steps roll back to the newest checkpoint; a second
rollback with no finite step between aborts. ``MGWFBP_FAULT_PLAN`` injects
NaN steps, preemptions, stalls, SIGKILLs and wedges deterministically
(``utils/faults.py``; ``kill`` and ``wedge`` fire only in the supervisor
incarnation they name, ``MGWFBP_INCARNATION``).

Supervision (the JAX trainer's runtime layer). ``fit`` arms the progress
watchdog (``utils/watchdog.py``, ``MGWFBP_WATCHDOG_S``): every step beats
it, the known-long silent phases take its allowances, and a stall emits a
``watchdog_stall`` event and turns /healthz 503 before an rc-86 abort.
``metrics_port`` starts the live plane (``telemetry/serve.py``: /healthz
and /status, fed by the event stream) that the supervisor's liveness
monitor scrapes. Under ``MGWFBP_ELASTIC_RESUME=1`` (the supervisor exports
it) a trainer that finds no checkpoint under its own tag resumes from a
sibling tag written at another world size (``_resume_cross_world``), the
LR schedule continuing from the manifest's anchor. ``update_nworker``
resizes only by relaunch (``runtime.ResizeUnsupported``). Autotune, the
rest of the telemetry plane and the serving shadow are not ported
(ROADMAP.md).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import signal as _signal
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from mgwfbp_tpu_torch import models as zoo
from mgwfbp_tpu_torch.checkpoint import (
    ORBAX_REFUSAL,
    SHARD_FORMAT_VERSION,
    TORCH_RNG_KEY,
    Checkpointer,
    Snapshot,
    TrainState,
    shape_only,
)
from mgwfbp_tpu_torch.config import TrainConfig
from mgwfbp_tpu_torch.convert import (
    flax_leaves,
    flax_shapes,
    host_leaves,
    keystr,
    momentum_from_flax,
    momentum_to_flax,
    state_from_flax,
)
from mgwfbp_tpu_torch.data import ShardInfo, data_prepare
from mgwfbp_tpu_torch.models.common import init_weights
from mgwfbp_tpu_torch.optim import (
    as_step_fn,
    make_optimizer,
    scaled_clip_threshold,
    sgd_state_layout,
)
from mgwfbp_tpu_torch.parallel.allreduce import (
    arrival_order,
    make_merged_allreduce,
)
from mgwfbp_tpu_torch.parallel.costmodel import (
    load_profile,
    lookup_alpha_beta,
    resolve_profile,
)
from mgwfbp_tpu_torch.parallel.mesh import rank, world_size
from mgwfbp_tpu_torch.parallel.solver import LayerSpec, size_prior_tb
from mgwfbp_tpu_torch.runtime import ResizeUnsupported
from mgwfbp_tpu_torch.runtime import coordination as coord
from mgwfbp_tpu_torch.profiling import (
    TbProfile,
    benchmark_backward,
    layer_profile_doc,
    save_layer_profile,
    trace_group_times,
)
from mgwfbp_tpu_torch.telemetry import EventWriter, stream_filename, summarize
from mgwfbp_tpu_torch.train.step import (
    TrainStep,
    ctc_eval_sums,
    eval_sums,
    forward_loss,
    lm_eval_sums,
)
from mgwfbp_tpu_torch.utils.device import resolve_device, set_matmul_precision
from mgwfbp_tpu_torch.utils.faults import FaultPlan, Preempted
from mgwfbp_tpu_torch.utils.logging import get_logger
from mgwfbp_tpu_torch.utils.platform import env_int
from mgwfbp_tpu_torch.utils.watchdog import (
    CHECKPOINT_ALLOW_S,
    COMPILE_ALLOW_S,
    ProgressWatchdog,
)

# after an abort-bound watchdog_stall event the process waits this long
# before the rc-86 exit, so that a /healthz prober polling faster than this
# reads 503, not a reset connection
WATCHDOG_ABORT_HOLD_S = 1.0


def derive_agree_interval(step_s: float, grace_s: float = 30.0) -> int:
    """Drain-agreement cadence from a measured step time: the group agrees
    every N-th step, so a drain lags by at most N steps; half the
    preemption grace goes to that lag. Clamped to [1, 1000]."""
    if step_s <= 0.0:
        return 1
    return int(min(max(grace_s * 0.5 / step_s, 1.0), 1000.0))


def _elastic_resume_enabled() -> bool:
    """True when a relaunch may resume from a sibling tag written at
    another world size. The supervisor exports MGWFBP_ELASTIC_RESUME=1 for
    the groups it launches (a resize-by-relaunch must find the old world's
    checkpoints); a standalone run keeps to its own tag unless asked."""
    raw = (os.environ.get("MGWFBP_ELASTIC_RESUME") or "").strip().lower()
    return raw in ("1", "true", "yes")


class _RollbackRequested(Exception):
    """K consecutive non-finite steps: unwind ``train_epoch`` so that
    ``_fit_epochs`` restores the newest checkpoint and continues."""

    def __init__(self, bad_steps: int):
        super().__init__(f"{bad_steps} consecutive non-finite steps")
        self.bad_steps = bad_steps


def _poison_batch(x) -> tuple:
    """NaN-fill a floating host batch (fault injection: every gradient
    after the reduction is then non-finite); a token batch has nothing to
    poison."""
    if isinstance(x, torch.Tensor):
        if x.is_floating_point():
            return torch.full_like(x, float("nan")), True
        return x, False
    if np.issubdtype(x.dtype, np.floating):
        return np.full_like(x, np.nan), True
    return x, False


CTC_FIELDS = ("x", "y", "input_lengths", "label_lengths")


def batch_fields(batch) -> tuple:
    """A loader batch as a tuple of arrays: (x, y), or (x, y,
    input_lengths, label_lengths) for a ctc batch's dict."""
    if isinstance(batch, dict):
        return tuple(batch[k] for k in CTC_FIELDS)
    return tuple(batch)


def _stack(parts: list):
    """Micro-batches stacked on a new leading axis (one batch: a view, so
    a pinned host tensor stays pinned)."""
    if len(parts) == 1:
        return parts[0][None]
    if isinstance(parts[0], torch.Tensor):
        return torch.stack(parts)
    return np.stack(parts)


def _env_interval(name: str, default: str) -> int:
    raw = (os.environ.get(name) or "").strip()
    try:
        return max(int(raw or default), 1)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer") from None


class Trainer:
    def __init__(
        self,
        config: TrainConfig,
        device=None,
        profile_backward: bool = True,
        synthetic_data: Optional[bool] = None,
    ):
        self.config = config
        self.device = resolve_device(device)
        self.world = world_size()
        self.rank = rank()
        config.nworkers = self.world
        # this process's faults; the hard kinds (kill, wedge) only of this
        # supervisor incarnation, so a healed relaunch, which resumes below
        # the fault's step, does not fire again the fault it died of
        self._faults = (
            FaultPlan.from_env()
            .for_process(self.rank)
            .for_incarnation(env_int("MGWFBP_INCARNATION", 0))
        )
        # refused before anything is built: a checkpoint format this
        # package cannot write
        if config.ckpt_format == "replicated":
            raise ValueError(f"--ckpt-format replicated: {ORBAX_REFUSAL}")
        if config.ckpt_format != "sharded":
            raise ValueError(
                f"ckpt_format {config.ckpt_format!r}: sharded or replicated"
            )
        self.log = get_logger(
            "mgwfbp.trainer",
            logfile=os.path.join(config.logdir, config.tag(), "train.log")
            if config.logdir else None,
        )
        # mixed-precision compute policy (the JAX trainer's: float32 or None
        # means no cast)
        self.compute_dtype = (
            getattr(torch, config.dtype)
            if config.dtype not in (None, "", "float32", "f32") else None
        )
        set_matmul_precision(self.compute_dtype, log=self.log)
        if config.deterministic:
            # warn_only: an op without a deterministic implementation says
            # so ("... does not have a deterministic implementation") and
            # runs, rather than ending the run
            torch.use_deterministic_algorithms(True, warn_only=True)
            self.log.info("deterministic algorithms on (CUBLAS_WORKSPACE_"
                          "CONFIG=%s)",
                          os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
        self._watchdog: Optional[ProgressWatchdog] = None
        self._stepped = False  # a train step ran in this process
        self._evaluated = False  # an evaluation ran in this process
        self._metrics_agg = None
        self._metrics_server = None
        self.telemetry = self._open_telemetry()
        self._measured_group_times: Optional[list[float]] = None
        self.shard = ShardInfo(self.rank, self.world)
        model, self.meta = zoo.create_model(config.dnn, dataset=config.dataset)
        image_hw = None
        if self.meta.task == "classify" and self.meta.input_shape[0] >= 256:
            image_hw = tuple(self.meta.input_shape[:2])  # the inceptions' 299
        self.bundle = data_prepare(
            config.dataset, data_dir=config.data_dir,
            batch_size=config.batch_size, shard=self.shard, seed=config.seed,
            synthetic=synthetic_data, augment=config.augment,
            num_steps=config.num_steps, image_hw=image_hw,
        )
        if self.bundle.num_classes != self.meta.num_classes:
            model, self.meta = zoo.create_model(
                config.dnn, dataset=config.dataset,
                num_classes=self.bundle.num_classes,
            )
        self.model = zoo.for_training(model)
        self._apply_lm_window()
        init_weights(self.model, torch.Generator().manual_seed(config.seed))
        # dropout draws from torch's global generator: a function of the
        # seed and the rank, so that ranks draw different masks (the JAX
        # step folds the device index into its dropout key)
        torch.manual_seed(
            int(np.random.SeedSequence([config.seed, self.rank])
                .generate_state(1)[0])
        )
        self.model.to(self.device)
        if self.world > 1:
            # identical replicas from rank 0, as the reference's
            # broadcast_parameters does
            with torch.no_grad():
                for t in self.model.state_dict().values():
                    dist.broadcast(t, 0)
        # the schedule's anchor: the step -> epoch conversion continues from
        # it (a checkpoint carries it; it moves only on elastic resizes)
        self._sched_step_offset = 0
        self._sched_epoch_offset = 0.0
        self.optimizer, self.lr_fn, self.epoch_schedule = make_optimizer(
            self.model.parameters(), config.lr,
            momentum=config.momentum, weight_decay=config.weight_decay,
            lr_schedule=config.lr_schedule, dataset=config.dataset,
            max_epochs=config.max_epochs, warmup_epochs=config.warmup_epochs,
            num_batches_per_epoch=max(self._steps_per_epoch(), 1),
        )
        self.cost_model = None
        self.tb: Optional[TbProfile] = None
        self.reducer = self._build_reducer(profile_backward)
        if self.reducer is not None:
            s = self.reducer.schedule
            self.log.info(
                "merge schedule: %d groups over %d tensors (policy=%s%s, "
                "predicted nonoverlap %.3g s)", s.num_groups,
                len(s.layer_names), config.policy,
                f" -> {s.policy_detail}" if s.policy_detail else "",
                s.predicted_nonoverlap_time,
            )
        self._sync_schedule_gauge()
        self.train_step = TrainStep(
            self.model, self.optimizer, self.lr_fn, reducer=self.reducer,
            nsteps_update=config.nsteps_update, grad_guard=config.grad_guard,
            norm_clip=(
                scaled_clip_threshold(config.norm_clip, self.world)
                if config.norm_clip is not None else None
            ),
            task=self.meta.task, compute_dtype=self.compute_dtype,
        )
        self.carry = self._zero_carry()
        self.start_epoch = 0
        self.iteration = 0
        self.losses: list[float] = []  # every optimizer step's mean loss
        self._init_resilience()

    # ------------------------------------------------------------------
    def _init_resilience(self) -> None:
        """The checkpointer, the fault plan, the drain and guard state, then
        the resume (or ``--pretrain``) from what the checkpointer holds."""
        cfg = self.config
        self.ckpt_dir = (
            os.path.join(cfg.checkpoint_dir, cfg.tag())
            if cfg.checkpoint_dir else None
        )
        self.checkpointer = (
            Checkpointer(self.ckpt_dir) if self.ckpt_dir else None
        )
        if self._faults:
            self.log.warning("fault plan armed: %s", self._faults.describe())
        self._preempt_signal: Optional[str] = None
        self._signals_armed = False
        self._prev_handlers: dict = {}
        # at several processes the group agrees on a drain every N-th step
        # (one tiny collective; the drain lags by at most N steps). Unset:
        # derived once from the first measured step time against
        # MGWFBP_PREEMPT_GRACE_S, process 0's choice broadcast
        self._agree_interval = _env_interval("MGWFBP_AGREE_INTERVAL", "1")
        self._agree_interval_auto = not (
            os.environ.get("MGWFBP_AGREE_INTERVAL") or ""
        ).strip()
        raw_grace = (os.environ.get("MGWFBP_PREEMPT_GRACE_S") or "").strip()
        try:
            self._preempt_grace_s = float(raw_grace or "30")
        except ValueError:
            raise ValueError(
                f"MGWFBP_PREEMPT_GRACE_S={raw_grace!r} is not a number"
            ) from None
        self._resume_epoch: Optional[int] = None  # mid-epoch resume target
        self._resume_skip_steps = 0  # optimizer steps already done there
        self._resume_carry = None
        self._bad_streak = 0  # consecutive non-finite steps
        self._warned_no_rollback = False
        # a second rollback with no finite step since the first means the
        # NaN source is deterministic: abort instead of looping
        self._last_rollback_iteration: Optional[int] = None
        self._good_step_since_rollback = True
        self._maybe_resume()

    # ------------------------------------------------------------------
    def _open_telemetry(self) -> Optional[EventWriter]:
        """The event stream and, with ``metrics_port``, the live plane it
        feeds (one aggregator and server per process; the server thread
        reads host state only, so no step syncs the card for it)."""
        cfg = self.config
        if cfg.metrics_port is not None and not cfg.telemetry:
            # the live plane's aggregator is fed by the event stream
            cfg.telemetry = True
        if not cfg.telemetry:
            return None
        tel_dir = cfg.telemetry_dir or (
            os.path.join(cfg.logdir, cfg.tag()) if cfg.logdir else None
        )
        run = {
            "model": cfg.dnn, "dataset": cfg.dataset,
            "world": self.world, "comm_op": "all_reduce",
            "policy": cfg.policy, "tag": cfg.tag(),
            "process_index": self.rank, "process_count": self.world,
            "device": str(self.device),
        }
        if cfg.metrics_port is not None and self._metrics_agg is None:
            from mgwfbp_tpu_torch.telemetry.serve import (
                MetricsAggregator,
                start_metrics_server,
            )

            self._metrics_agg = MetricsAggregator(run=run)
            self._metrics_server = start_metrics_server(
                self._metrics_agg, cfg.metrics_port, self.rank)
        if tel_dir is None:
            self.log.warning("telemetry requested but neither telemetry_dir "
                             "nor logdir is set; telemetry disabled")
            return None
        writer = EventWriter(
            os.path.join(tel_dir, stream_filename(self.rank, self.world)),
            run=run,
        )
        if self._metrics_agg is not None:
            writer.observer = self._metrics_agg.observe
        return writer

    def _sync_schedule_gauge(self) -> None:
        """Push the merge schedule into the /status aggregator."""
        if self._metrics_agg is None:
            return
        s = self.reducer.schedule if self.reducer is not None else None
        self._metrics_agg.set_schedule(
            "all_reduce", s.num_groups if s is not None else 0,
            s.policy_detail if s is not None else "")

    def _apply_lm_window(self) -> None:
        """Windowed-LM length override (``num_steps``): the meta the batches
        are built from, and a position table at least that long."""
        n = self.config.num_steps
        if not (n and self.meta.task == "lm" and not self.meta.has_carry):
            return
        self.meta = dataclasses.replace(self.meta, input_shape=(n,))
        if getattr(self.model, "max_len", n) < n:
            self.model = self.model.with_max_len(n)

    def _zero_carry(self):
        """A fresh zero carry at the per-worker batch (None for a model
        without one)."""
        if not self.meta.has_carry:
            return None
        return self.model.initial_carry(self.config.batch_size, self.device)

    def step_batch(self, x: torch.Tensor, y: torch.Tensor,
                   *lengths: torch.Tensor) -> dict:
        """One optimizer step on device batches; a carry model threads
        ``self.carry`` through it, a ctc batch brings its lengths."""
        if lengths:
            return self.train_step(x, y, lengths=lengths)
        if self.carry is None:
            return self.train_step(x, y)
        metrics, self.carry = self.train_step(x, y, self.carry)
        return metrics

    def _steps_per_epoch(self) -> int:
        steps = self.bundle.num_batches_per_epoch // max(
            self.config.nsteps_update, 1
        )
        if self.config.num_batches_per_epoch:
            steps = min(steps, self.config.num_batches_per_epoch)
        return steps

    def _to_device(self, x, y, *lengths):
        """Host batches (numpy, or pinned tensors from the prefetch; leading
        micro-step axis optional) -> tensors on the card: NHWC images
        become NCHW float32, permuted there; tokens and (B, T, F)
        spectrograms keep their layout; labels, targets and a ctc batch's
        lengths become int64."""

        def put(a, dtype=None):
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(a))
            t = t.to(self.device, non_blocking=True)
            return t if dtype is None else t.to(dtype)

        xt = put(x)
        rest = tuple(put(a, torch.int64) for a in (y, *lengths))
        if self.meta.task in ("lm", "ctc"):
            return (xt, *rest)
        return (xt.movedim(-1, -3).contiguous(), *rest)

    def _build_reducer(self, profile_backward: bool):
        cfg = self.config
        if cfg.policy in ("none", "xla"):
            return None  # one mean per leaf, no hooks
        if self.world == 1:
            self.log.info(
                "single device: skipping merged-allreduce scheduling "
                "(policy %s inert%s)", cfg.policy,
                f"; --comm-profile {cfg.comm_profile} unused"
                if cfg.comm_profile else "",
            )
            return None
        if cfg.comm_profile:
            self.cost_model = resolve_profile(
                load_profile(cfg.comm_profile), self.world
            )
            self.log.info(
                "cost model: %s resolved at world %d (%s, alpha %.4g s, "
                "beta %.4g s/B, gamma %.4g s, overlap %.3g)",
                cfg.comm_profile, self.world,
                type(self.cost_model).__name__, self.cost_model.alpha,
                self.cost_model.beta, self.cost_model.gamma,
                self.cost_model.overlap,
            )
        else:
            self.cost_model = lookup_alpha_beta(cfg.connection, self.world)
            self.log.info(
                "cost model: the %r prior at world %d (no --comm-profile)",
                cfg.connection, self.world,
            )
        if cfg.policy in ("mgwfbp", "auto") and profile_backward:
            self.tb = self._profile_backward()
        return make_merged_allreduce(
            self.model, policy=cfg.policy, tb=self.tb,
            cost_model=self.cost_model, threshold=cfg.threshold,
            comm_dtype=getattr(torch, cfg.comm_dtype) if cfg.comm_dtype else None,
        )

    def _arrival_leaves(self) -> tuple[list, list[int], list[str]]:
        """(leaf tensors, arrival permutation, leaf names), as the reducer
        orders them."""
        leaves = flax_leaves(self.model)
        names = [keystr(p) for p, _ in leaves]
        return [t for _, t in leaves], arrival_order(len(names), names=names), names

    def _profile_backward(self) -> TbProfile:
        """Backward benchmark at the per-worker batch. Measured times differ
        per rank, so rank 0's are broadcast: every rank must solve the
        identical schedule, or the ranks' collectives mismatch. Rank 0
        writes the profile to ``<logdir>/<tag>/tb_profile.json``."""
        x, y, *lengths = self._to_device(
            *batch_fields(self.bundle.train.load_batch(0, 0)))
        params, perm, names = self._arrival_leaves()
        carry = self._zero_carry()

        def loss_of():
            return forward_loss(self.model, self.meta.task, x, y, carry,
                                self.compute_dtype,
                                lengths=tuple(lengths) or None)[0]

        t0 = time.perf_counter()
        self.model.train()
        tb = benchmark_backward(
            self.model, loss_of, params, perm, warmup=2, iters=10,
        )
        if self.world > 1:
            vals = torch.tensor(list(tb), dtype=torch.float64, device=self.device)
            dist.broadcast(vals, 0)
            tb = TbProfile(vals.tolist(), source=tb.source)
        if self.rank == 0 and self.config.logdir:
            save_layer_profile(
                os.path.join(self.config.logdir, self.config.tag(),
                             "tb_profile.json"),
                layer_profile_doc(tb, [names[j] for j in perm]),
            )
        self.log.info(
            "backward benchmark: %.3g s total over %d tensors, per-layer "
            "source=%s (%.1f s)", sum(tb), len(tb), tb.source,
            time.perf_counter() - t0,
        )
        return tb

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int) -> dict:
        cfg = self.config
        loader = self.bundle.train
        loader.set_epoch(epoch)
        n = cfg.nsteps_update
        # a mid-epoch resume (preemption, rollback): (epoch, epoch_step)
        # names the deterministic loader's position, so starting at batch
        # epoch_step * nsteps_update replays the run from that step
        skip_micro = epoch_pos = 0
        resume_carry = None
        if self._resume_epoch is not None and epoch == self._resume_epoch:
            skip_micro = self._resume_skip_steps * n
            epoch_pos = self._resume_skip_steps
            resume_carry = self._resume_carry
            self.log.info(
                "epoch %d: resuming mid-epoch at step %d (skipping %d "
                "micro-batch(es))", epoch, epoch_pos, skip_micro,
            )
        self._resume_epoch = None
        self._resume_skip_steps = 0
        self._resume_carry = None
        # a fresh hidden state each epoch, carried across its steps, unless
        # a mid-epoch checkpoint carried one
        self.carry = (resume_carry if resume_carry is not None
                      else self._zero_carry())
        micro: list = []
        epoch_steps = window_iters = 0
        max_steps = cfg.num_batches_per_epoch or None
        # the batches this epoch will use, so that a capped epoch loads
        # (and prefetches) none it will not train on
        stop = (None if max_steps is None
                else skip_micro + max(max_steps - epoch_pos, 0) * n)
        log_interval = int(os.environ.get("MGWFBP_LOG_INTERVAL", "10"))
        metrics: dict = {}
        first_loss = None
        wd_phase = f"train epoch {epoch}"
        if self._stepped:
            self._beat(wd_phase)
        else:
            # the first step of this process is a long silent phase: the
            # loader's start-up (with the native library's g++ build at
            # its first batch) and cuDNN's and cuBLAS's first use
            self._beat(f"first train step (epoch {epoch})",
                       allow_s=COMPILE_ALLOW_S)
        t_epoch = t_window = time.time()
        with contextlib.closing(loader.batches(epoch, skip_micro, stop)) as it:
            for batch in it:
                micro.append(batch_fields(batch))
                if len(micro) < n:
                    continue
                fields = [_stack(list(f)) for f in zip(*micro)]
                micro = []
                metrics = self._train_on(epoch, fields)
                self._stepped = True
                self._beat(wd_phase)
                epoch_pos += 1
                epoch_steps += 1
                window_iters += 1
                if first_loss is None:
                    first_loss = metrics["loss"]
                if (cfg.ckpt_every_steps and self.checkpointer is not None
                        and epoch_pos % cfg.ckpt_every_steps == 0):
                    self._beat(f"step checkpoint iter {self.iteration}",
                               allow_s=CHECKPOINT_ALLOW_S)
                    self.save_step(epoch, epoch_pos,
                                   background=cfg.ckpt_async)
                    self._beat(wd_phase)
                # retire a finished async save; at several processes a
                # group vote, so on the agreement cadence, never on local
                # state
                if self.checkpointer is not None and (
                    self.world == 1
                    or self.iteration % self._agree_interval == 0
                ):
                    self._poll_async_ckpt()
                sig = self._faults.preempt_signal_after(self.iteration)
                if sig is not None:
                    self._deliver_preempt(sig)
                if self._faults.kill_after(self.iteration):
                    # a drain-less hard crash: no checkpoint, no flush; the
                    # supervisor's healer recovers the group
                    self.log.warning(
                        "fault injection: SIGKILL self after step %d "
                        "(drain-less hard crash)", self.iteration,
                    )
                    os.kill(os.getpid(), _signal.SIGKILL)
                if self._agreed_preempt():
                    self._graceful_drain(epoch, epoch_pos)  # raises Preempted
                if max_steps is not None and epoch_pos >= max_steps:
                    break
                if self.iteration % log_interval == 0:
                    dt = (time.time() - t_window) / max(window_iters, 1)
                    self._maybe_derive_agree_interval(dt)
                    metric = self.train_step.metric
                    self.log.info(
                        "epoch %d iter %d: loss %.4f%s | %.4f s/iter, %.1f "
                        "samples/s", epoch, self.iteration, metrics["loss"],
                        f", {metric} {metrics[metric]:.4f}" if metric else "",
                        dt, cfg.batch_size * self.world * n / dt,
                    )
                    t_window = time.time()
                    window_iters = 0
        if micro:
            self.log.info(
                "epoch %d: dropped %d trailing micro-batch(es)", epoch,
                len(micro),
            )
        out = {k: v for k, v in metrics.items() if k != "grads_nonfinite"}
        if first_loss is not None:
            out["first_loss"] = first_loss
        epoch_dur = time.time() - t_epoch
        if self.telemetry is not None and epoch_steps > 0:
            self.telemetry.emit("epoch", epoch=int(epoch), steps=epoch_steps,
                                dur_s=epoch_dur, **self._lm_fields(metrics))
            self._emit_overlap(epoch_dur / epoch_steps, epoch)
        self.log.info(
            "epoch %d done in %.1f s (lr %.5f)", epoch, epoch_dur,
            self.epoch_schedule(float(epoch)),
        )
        return out

    def _train_on(self, epoch: int, fields: list) -> dict:
        """One optimizer step on stacked host micro-batches (x, y[,
        lengths]): the fault plan's NaN, the copy to the card, the step,
        its telemetry span, the loss record and the guard (which raises
        _RollbackRequested after bad_step_limit non-finite steps)."""
        cfg = self.config
        stall_s = self._faults.stall_secs("train", self.iteration + 1)
        if stall_s > 0:
            self.log.warning("fault injection: stalling %.3g s before step "
                             "%d", stall_s, self.iteration + 1)
            time.sleep(stall_s)
        wedge_s = self._faults.wedge_secs(self.iteration + 1)
        if wedge_s > 0:
            self._wedge(wedge_s)
        if self._faults.nan_at(self.iteration + 1):
            fields[0], poisoned = _poison_batch(fields[0])
            self.log.warning(
                "fault injection: NaN batch for step %d%s",
                self.iteration + 1, "" if poisoned else
                " requested, but the batch has no floating input to poison",
            )
        tensors = self._to_device(*fields)
        t_step = self.telemetry.now() if self.telemetry else 0.0
        metrics = self.step_batch(*tensors)
        self.iteration += 1
        if self.telemetry is not None:
            self.telemetry.emit(
                "step", step=self.iteration, epoch=int(epoch),
                start_s=t_step, dur_s=self.telemetry.now() - t_step,
                **self._lm_fields(metrics),
            )
        self.losses.append(metrics["loss"])
        # the guard: the count is averaged across ranks, so every rank
        # takes the same branch
        if cfg.grad_guard:
            self._check_guard_value(self.iteration, epoch,
                                    metrics["grads_nonfinite"])
        return metrics

    def _lm_fields(self, metrics: dict) -> dict:
        """The loss and perplexity a language model's step and epoch
        records carry (nothing for a classifier)."""
        if self.meta.task != "lm" or not metrics:
            return {}
        return {"loss": metrics["loss"], "perplexity": metrics["perplexity"]}

    def _overlap_tb(self) -> list[float]:
        """The tb the schedule was solved on: measured, else the volume
        prior the solver fell back to."""
        if self.tb is not None:
            return list(self.tb)
        params, perm, names = self._arrival_leaves()
        return size_prior_tb(
            [LayerSpec(names[j], params[j].numel(), params[j].element_size())
             for j in perm],
            self.cost_model,
        )

    def _emit_overlap(self, step_s: float, epoch: int) -> None:
        """One ``overlap`` record and one ``comm_group`` record per merge
        group for this epoch's schedule (host arithmetic only)."""
        if self.reducer is None or self.cost_model is None or step_s <= 0.0:
            return
        summary = summarize(
            self.reducer, self.cost_model, self._overlap_tb(), step_s,
            measured=self._measured_group_times,
        )
        self.telemetry.emit("overlap", step=self.iteration, epoch=int(epoch),
                            **summary.to_event_fields())
        for fields in summary.group_event_fields(self.iteration):
            self.telemetry.emit("comm_group", **fields)
        self.log.info(
            "overlap (%s): %.4g s comm/step = %.4g hidden + %.4g exposed -> "
            "efficiency %.3f (starts replayed in the arrival permutation's "
            "order)", summary.attribution, summary.comm_s, summary.hidden_s,
            summary.exposed_s, summary.efficiency,
        )

    def _trace_group_times(self, iters: int = 2) -> None:
        """``MGWFBP_TELEMETRY_TRACE=1``: trace ``iters`` real training steps
        under torch.profiler before the first epoch (never inside it: the
        traced steps synchronise) and keep the per-group device times for
        the overlap records. Every rank takes the same steps; where the
        trace finds no collective kernel in some group's range (the CPU,
        NCCL over one rank) the records stay on the cost model."""
        want = float(os.environ.get("MGWFBP_TELEMETRY_TRACE") == "1")
        if self.world > 1:
            flag = torch.tensor([want], device=self.device)
            dist.all_reduce(flag, op=dist.ReduceOp.MIN)
            want = flag.item()
        if not want:
            return
        n = self.config.nsteps_update
        batches = [batch_fields(self.bundle.train.load_batch(0, k))
                   for k in range(iters * n)]

        def run():
            for i in range(iters):
                group = batches[i * n:(i + 1) * n]
                self.step_batch(*self._to_device(
                    *(_stack(list(f)) for f in zip(*group))))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        self._beat("telemetry group trace", allow_s=COMPILE_ALLOW_S)
        try:
            measured = trace_group_times(run, self.reducer.num_groups,
                                         iters=iters)
        except Exception as e:  # noqa: BLE001 — observability must never
            # kill the run it observes
            self.log.info("telemetry group trace failed (%s)", e)
            return
        self.iteration += iters
        if measured is None:
            self.log.info("telemetry trace: no device time of a collective "
                          "kernel in every group's range; overlap stays on "
                          "the cost model")
        else:
            self._measured_group_times = measured
            self.log.info("telemetry trace: %d group comm time(s) measured",
                          len(measured))

    def evaluate(self) -> dict:
        """Loss, top-1 and top-5 over every sample of the val loader,
        summed across ranks (a language model: ``_evaluate_lm``; the speech
        model: ``_evaluate_ctc``). The fault plan's eval stall lands here;
        the first evaluation of a process takes the watchdog's first-use
        allowance, and every batch beats it."""
        stall_s = self._faults.stall_secs("eval", self.iteration)
        if stall_s > 0:
            self.log.warning("fault injection: stalling %.3g s in eval",
                             stall_s)
            time.sleep(stall_s)
        if not self._evaluated:
            self._beat("first evaluation", allow_s=COMPILE_ALLOW_S)
        if self.meta.task == "lm":
            out = self._evaluate_lm()
        elif self.meta.task == "ctc":
            out = self._evaluate_ctc()
        else:
            out = self._evaluate_cls()
        self._evaluated = True
        return out

    def _evaluate_cls(self) -> dict:
        self.model.eval()
        sums = torch.zeros(4, device=self.device)
        try:
            for xb, yb in self.bundle.val:
                x, y = self._to_device(xb, yb)
                sums += eval_sums(self.model, x, y, self.compute_dtype)
                self._beat("evaluate")
        finally:
            self.model.train()
        if self.world > 1:
            dist.all_reduce(sums)
        loss, top1, top5, count = sums.tolist()
        c = max(count, 1.0)
        return {"loss": loss / c, "top1": top1 / c, "top5": top5 / c,
                "count": count}

    def _evaluate_lm(self) -> dict:
        """Loss (the mean over samples of each sample's mean token loss),
        count and ``perplexity = exp(loss)`` over the val loader, summed
        across ranks. A carry model threads its carry from zero through
        the batches and skips a batch of another size, which its carry
        cannot take."""
        self.model.eval()
        sums = torch.zeros(2, device=self.device)
        carry = self._zero_carry()
        try:
            for xb, yb in self.bundle.val:
                if carry is not None and len(xb) != self.config.batch_size:
                    self.log.warning(
                        "evaluate: skipping %d-sample batch (carry model "
                        "requires fixed batch %d)", len(xb),
                        self.config.batch_size,
                    )
                    continue
                x, y = self._to_device(xb, yb)
                batch_sums, carry = lm_eval_sums(self.model, x, y, carry,
                                                 self.compute_dtype)
                sums += batch_sums
                self._beat("evaluate")
        finally:
            self.model.train()
        if self.world > 1:
            dist.all_reduce(sums)
        loss, count = sums.tolist()
        loss /= max(count, 1.0)
        return {"loss": loss, "count": count,
                "perplexity": float(np.exp(loss))}

    def _evaluate_ctc(self) -> dict:
        """CTC loss (the mean over utterances) and WER over the val loader:
        each batch's logits and output lengths come out of the loss's own
        forward and are greedy-decoded on the host (the JAX trainer's
        fused WER, ``_decode_wer_batch``). At several ranks the loss, WER
        and utterance sums are added across ranks, so the WER is the mean
        over every rank's utterances."""
        from mgwfbp_tpu_torch.data.audio import greedy_decode, ids_to_text, wer

        self.model.eval()
        sums = torch.zeros(2, device=self.device)
        wer_total, wer_n = 0.0, 0
        try:
            for batch in self.bundle.val:
                fields = batch_fields(batch)
                x, y, ilen, llen = self._to_device(*fields)
                batch_sums, logits, out_lengths = ctc_eval_sums(
                    self.model, x, y, ilen, llen, self.compute_dtype)
                sums += batch_sums
                hyps = greedy_decode(logits.cpu().numpy(),
                                     out_lengths.cpu().numpy())
                ys, lab_lens = fields[1], fields[3]
                for j, hyp in enumerate(hyps):
                    wer_total += wer(hyp, ids_to_text(ys[j][:int(lab_lens[j])]))
                    wer_n += 1
                self._beat("evaluate")
        finally:
            self.model.train()
        totals = torch.cat([sums, torch.tensor(
            [wer_total, float(wer_n)], device=self.device)])
        if self.world > 1:
            dist.all_reduce(totals)
        loss, count, wer_total, wer_n = totals.tolist()
        return {"loss": loss / max(count, 1.0), "count": count,
                "wer": wer_total / max(wer_n, 1.0)}

    # ------------------------------------------------------------------
    # Resilience: checkpoints, the preemption drain, the guard, rollback
    # ------------------------------------------------------------------

    def _emit_event(self, event: str, **fields) -> None:
        if self.telemetry is not None:
            self.telemetry.emit(event, **fields)

    def _beat(self, phase: str, allow_s: float = 0.0) -> None:
        """Progress for the watchdog (a no-op when it is not armed)."""
        wd = self._watchdog
        if wd is not None:
            wd.beat(phase, allow_s=allow_s)

    def _on_watchdog_stall(self, phase: str, idle_s: float, timeout_s: float,
                           abort: bool) -> None:
        """A stall becomes a ``watchdog_stall`` event in the run's stream,
        which turns /healthz 503 through the aggregator; before an rc-86
        abort the process holds WATCHDOG_ABORT_HOLD_S so a prober reads the
        503, not a reset connection."""
        self._emit_event("watchdog_stall", phase=str(phase),
                         idle_s=float(idle_s), timeout_s=float(timeout_s),
                         abort=bool(abort))
        if abort and self._metrics_server is not None:
            time.sleep(WATCHDOG_ABORT_HOLD_S)

    def save(self, epoch: int) -> None:
        """Epoch-boundary checkpoint (the step key is the iteration the
        epoch ended on; the sidecar marks it a boundary). Synchronous."""
        if self.checkpointer is None:
            return
        stats = self._save_snapshot(epoch, 0, mid_epoch=False)
        self._emit_event("checkpoint", epoch=int(epoch),
                         iteration=int(self.iteration), mid_epoch=False,
                         **stats)

    def save_step(self, epoch: int, epoch_step: int = 0, wait: bool = False,
                  background: bool = False) -> Optional[str]:
        """Commit the current step under ``<checkpoint_dir>/<tag>``: with
        ``epoch_step`` > 0 a mid-epoch snapshot carrying the data position
        and the BPTT carry (a restart resumes from this exact step), with 0
        an epoch boundary. ``wait`` makes the commit durable (the drain);
        ``background`` hands a mid-epoch payload to the async writer, which
        commits at a later poll. Returns the step directory once the step
        is committed, None while it is in flight or without a
        checkpointer."""
        if self.checkpointer is None:
            return None
        mid = epoch_step > 0
        stats = self._save_snapshot(epoch, epoch_step, mid_epoch=mid,
                                    wait=wait, background=background)
        if stats is None:  # in flight: the event lands at its commit
            return None
        self._emit_event("checkpoint", epoch=int(epoch),
                         iteration=int(self.iteration), mid_epoch=mid,
                         epoch_step=int(epoch_step), **stats)
        return self.checkpointer._shard_step_dir(self.iteration)

    def _poll_async_ckpt(self, block: bool = False,
                         durable: bool = False) -> None:
        """Commit a finished async save (the collective commit runs here,
        on the step loop's thread) and emit its ``checkpoint`` event with
        the submit-to-commit span and the iteration it committed at."""
        if self.checkpointer is None:
            return
        evt = self.checkpointer.poll_async(block=block, durable=durable)
        if evt is None:
            return
        meta = evt.get("meta") or {}
        self._emit_event(
            "checkpoint", epoch=int(meta.get("epoch", 0)),
            iteration=int(evt["step"]),
            mid_epoch=bool(meta.get("mid_epoch", True)),
            epoch_step=int(meta.get("epoch_step", 0)),
            duration_s=float(evt["duration_s"]), bytes=int(evt["bytes"]),
            format="sharded", commit_iteration=int(self.iteration),
            **{"async": True},
        )

    def _save_snapshot(self, epoch: int, epoch_step: int, mid_epoch: bool,
                       wait: bool = False,
                       background: bool = False) -> Optional[dict]:
        """Write one snapshot; returns the ``checkpoint`` event's fields,
        or None when the save went to the async writer."""
        carry = self.carry if mid_epoch and self.carry is not None else None
        # retire an in-flight save first, so its event lands before this
        # one's; the drain (wait) makes that commit durable too
        self._poll_async_ckpt(block=True, durable=wait)
        t0 = time.perf_counter()
        manifest, files = self._shard_payload(epoch, epoch_step, mid_epoch,
                                              carry)
        copy_s = time.perf_counter() - t0
        if background and mid_epoch and not wait:
            stats = self.checkpointer.submit_sharded(manifest, files)
            if stats is None:
                return None
        else:
            stats = self.checkpointer.save_sharded(manifest, files, wait=wait)
        return {"duration_s": float(stats["duration_s"]) + copy_s,
                "bytes": int(stats["bytes"]), "format": "sharded"}

    def _opt_layout(self) -> tuple[list[str], list[str], str]:
        """(dotted parameter paths, their optax trace paths, the count's
        path) of the optimizer section."""
        cfg = self.config
        paths = list(flax_shapes(self.model, "params"))
        trace, count = sgd_state_layout(
            paths, momentum=cfg.momentum, weight_decay=cfg.weight_decay,
            norm_clip=cfg.norm_clip,
        )
        return paths, trace, count

    @staticmethod
    def _tree_leaf_docs(leaves: dict) -> list[dict]:
        """Manifest leaf docs of {keystr path: (shape, dtype name)}."""
        return [{"path": path, "shape": [int(x) for x in shape],
                 "dtype": dtype} for path, (shape, dtype) in leaves.items()]

    def _carry_runs_by_process(self, rows: int) -> dict[int, list[list[int]]]:
        """Each process's rows of the global carry batch, as runs: process
        r holds [r * rows, (r + 1) * rows) (the loader lays out the carry's
        batch per rank), the manifest's ``runs`` and the restore's slice."""
        return {r: [[r * rows, (r + 1) * rows]] for r in range(self.world)}

    def _shard_payload(self, epoch: int, epoch_step: int, mid_epoch: bool,
                       carry) -> tuple[dict, dict]:
        """(manifest, this process's files) for one save, as the JAX
        trainer writes them for an ``all_reduce`` run: the replicated
        params, optimizer (the optax tree) and batch statistics once, by
        process 0; each process its own rows of the carry and its own
        generator states. Every array is a fresh host copy."""
        cfg = self.config
        primary = self.rank == 0
        files: dict[str, np.ndarray] = {}
        p_shapes = flax_shapes(self.model, "params")
        b_shapes = flax_shapes(self.model, "batch_stats")
        paths, trace_paths, count_path = self._opt_layout()
        opt_leaves = {tp: (p_shapes[p], "float32")
                      for tp, p in zip(trace_paths, paths)}
        opt_leaves[count_path] = ((), "int32")
        step = int(self.train_step.step)
        manifest: dict = {
            "format_version": SHARD_FORMAT_VERSION,
            "step": int(self.iteration),
            "world": int(self.world),
            "process_count": int(self.world),
            "mesh_axes": {"data": int(self.world), "seq": 1},
            "comm_op": "all_reduce",
            "leaves": self._tree_leaf_docs({keystr(p): (s, "float32")
                                  for p, s in p_shapes.items()}),
            # the JAX reader's train-state key: PRNGKey(seed)'s raw form
            # (the dropout streams of the two packages differ anyway; this
            # package's own generator states ride in TORCH_RNG_KEY)
            "rng": [0, int(cfg.seed) & 0xFFFFFFFF],
            "meta": {
                "epoch": int(epoch),
                "iteration": int(self.iteration),
                "epoch_step": int(epoch_step),
                "mid_epoch": bool(mid_epoch),
                "train_step": step,
                "steps_per_epoch": int(max(self._steps_per_epoch(), 1)),
                "sched_step_offset": int(self._sched_step_offset),
                "sched_epoch_offset": float(self._sched_epoch_offset),
                "opt_count": step,
            },
            "params": {"kind": "replicated"},
            "opt": {
                "kind": "replicated",
                "leaves": self._tree_leaf_docs(opt_leaves),
                # slot s of parameter leaf j -> flat optax leaf
                "slot_leaf_index": (
                    [list(range(len(trace_paths)))] if trace_paths else []
                ),
            },
            "batch_stats": {
                "kind": "replicated",
                "leaves": self._tree_leaf_docs({keystr(p): (s, "float32")
                                      for p, s in b_shapes.items()}),
            },
        }
        if primary:
            for j, a in enumerate(host_leaves(self.model, "params").values()):
                files[f"params.l{j}"] = a
            if trace_paths:
                moms = momentum_to_flax(self.model, self.optimizer)
                for j, p in enumerate(paths):
                    files[f"opt.l{j}"] = moms[p]
            files[f"opt.l{len(trace_paths)}"] = np.asarray(step, np.int32)
            for j, a in enumerate(
                host_leaves(self.model, "batch_stats").values()
            ):
                files[f"batch_stats.l{j}"] = a
        if carry is not None:
            leaves = [t for layer in carry for t in layer]
            rows = int(leaves[0].shape[0])
            manifest["carry"] = {
                "leaves": self._tree_leaf_docs({
                    f"[{li // 2}][{li % 2}]":
                        ((rows * self.world,) + tuple(t.shape[1:]), "float32")
                    for li, t in enumerate(leaves)
                }),
                "runs": {str(r): runs for r, runs in
                         self._carry_runs_by_process(rows).items()},
            }
            for li, t in enumerate(leaves):
                files[f"carry.l{li}"] = t.detach().to(
                    "cpu", torch.float32, copy=True).numpy()
        kinds = ["cpu"] + (["cuda"] if self.device.type == "cuda" else [])
        manifest[TORCH_RNG_KEY] = {"world": int(self.world), "kinds": kinds}
        files[f"{TORCH_RNG_KEY}.cpu"] = torch.get_rng_state().numpy().copy()
        if self.device.type == "cuda":
            files[f"{TORCH_RNG_KEY}.cuda"] = (
                torch.cuda.get_rng_state(self.device).numpy().copy()
            )
        return manifest, files

    # -- restore ------------------------------------------------------------
    def _template(self, with_opt: bool = True) -> TrainState:
        """The restore template of this trainer's state (zero-byte leaves
        of the right shapes and dtypes)."""
        params = {p: shape_only(s, np.float32)
                  for p, s in flax_shapes(self.model, "params").items()}
        bstats = {p: shape_only(s, np.float32)
                  for p, s in flax_shapes(self.model, "batch_stats").items()}
        opt = None
        if with_opt:
            paths, trace_paths, count_path = self._opt_layout()
            opt = {tp: params[p] for tp, p in zip(trace_paths, paths)}
            opt[count_path] = shape_only((), np.int32)
        return TrainState(step=0, params=params, batch_stats=bstats,
                          opt_state=opt)

    def _carry_template(self) -> Optional[list]:
        """The carry's leaves at this world's global batch rows."""
        if not self.meta.has_carry:
            return None
        b = self.config.batch_size
        return [shape_only((b * self.world,) + tuple(t.shape[1:]), np.float32)
                for layer in self._zero_carry() for t in layer]

    def _localize_carry(self, snap: Optional[Snapshot]) -> Optional[Snapshot]:
        """The restored carry's rows of this process, as the tuple over
        layers of (c, h) on the device; a carry saved at another global
        batch re-initializes the epoch's hidden state."""
        if snap is None or snap.carry is None or not self.meta.has_carry:
            if snap is not None:
                snap.carry = None
            return snap
        b = self.config.batch_size
        have = int(snap.carry[0].shape[0])
        if have != b * self.world:
            self.log.warning(
                "carry in checkpoint covers %d global batch rows, this run "
                "wants %d: re-initializing the epoch's hidden state "
                "(params and optimizer restore exactly)", have, b * self.world,
            )
            snap.carry = None
            return snap
        ((start, stop),) = self._carry_runs_by_process(b)[self.rank]
        leaves = [torch.from_numpy(np.ascontiguousarray(a[start:stop])).to(
            self.device) for a in snap.carry]
        snap.carry = tuple((leaves[i], leaves[i + 1])
                           for i in range(0, len(leaves), 2))
        return snap

    def _restore_step(self, ckpt: Checkpointer,
                      step: Optional[int]) -> Optional[Snapshot]:
        snap = ckpt.restore(self._template(), step=step,
                            carry_template=self._carry_template())
        return self._localize_carry(snap)

    @torch.no_grad()
    def _install(self, state: TrainState, optimizer: bool = True) -> None:
        """Copy a restored state into the live modules in place (the
        optimizer and the reducer keep their tensors): parameters, batch
        statistics, the step counter and, with ``optimizer``, the
        momentum buffers."""
        self.model.load_state_dict(
            state_from_flax(self.model, state.params, state.batch_stats),
            strict=True,
        )
        self.train_step.step = int(state.step)
        if optimizer and state.opt_state is not None:
            paths, trace_paths, _ = self._opt_layout()
            if trace_paths:
                momentum_from_flax(self.model, self.optimizer, {
                    p: state.opt_state[tp]
                    for p, tp in zip(paths, trace_paths)
                })

    def _apply_snapshot(self, snap: Snapshot, source: str,
                        emit_resume: bool = True,
                        anchor: Optional[tuple] = None) -> None:
        """Install a restored snapshot: state, counters, the schedule's
        anchor (the manifest's, unless a cross-world resume passes the
        continued one), the generator states and, for a mid-epoch
        snapshot, the data position and carry that ``train_epoch`` resumes
        from (shared by resume and rollback; a rollback emits its own
        event)."""
        self._install(snap.state)
        meta = snap.manifest_meta or {}
        if anchor is None:
            anchor = (int(meta.get("sched_step_offset", 0)),
                      float(meta.get("sched_epoch_offset", 0.0)))
        if anchor != (self._sched_step_offset, self._sched_epoch_offset):
            self._sched_step_offset, self._sched_epoch_offset = anchor
            self.lr_fn = as_step_fn(
                self.epoch_schedule, max(self._steps_per_epoch(), 1),
                step_offset=anchor[0], epoch_offset=anchor[1],
            )
            self.train_step.lr_fn = self.lr_fn
        rng = snap.torch_rng or {}
        if "cpu" in rng:
            torch.set_rng_state(torch.from_numpy(rng["cpu"]))
        if "cuda" in rng and self.device.type == "cuda":
            torch.cuda.set_rng_state(torch.from_numpy(rng["cuda"]),
                                     self.device)
        self.iteration = snap.iteration
        if snap.mid_epoch:
            self.start_epoch = snap.epoch
            self._resume_epoch = snap.epoch
            self._resume_skip_steps = snap.epoch_step
            self._resume_carry = snap.carry
        else:
            self.start_epoch = snap.epoch + 1
            self._resume_epoch = None
            self._resume_skip_steps = 0
            self._resume_carry = None
        if emit_resume:
            self._emit_event("resume", epoch=int(snap.epoch),
                             iteration=int(snap.iteration),
                             mid_epoch=bool(snap.mid_epoch))
        self.log.info(
            "%s from epoch %d (iter %d%s)", source, snap.epoch,
            snap.iteration,
            f", mid-epoch at step {snap.epoch_step}" if snap.mid_epoch
            else "",
        )

    def _maybe_resume(self) -> None:
        snap = None
        if self.checkpointer is not None:
            snap = self._restore_step(self.checkpointer, None)
        # checkpoint visibility is uniform: every process reads the same
        # shared directory, and the commit barrier published it
        if snap is None and self.checkpointer is not None and (
            _elastic_resume_enabled()
        ):
            # relaunched at another world size: the checkpoint lives under
            # the old world's tag
            if self._resume_cross_world():
                return
        if snap is not None:
            self._apply_snapshot(snap, "resumed")
            return
        self._pretrain_init()

    # -- elastic cross-world resume ----------------------------------------
    def _sibling_resume_candidates(self) -> list[tuple[int, int, str]]:
        """(latest step, world, tag directory name) of every sibling tag
        under the checkpoint root that differs from this run's tag only in
        its worker count and holds committed steps."""
        from mgwfbp_tpu_torch.checkpoint import peek_steps

        root = self.config.checkpoint_dir
        parts = self.config.tag().split("-")
        try:
            i = parts.index(f"n{self.world}")
        except ValueError:
            return []
        try:
            names = os.listdir(root)
        except OSError:
            return []
        out = []
        for name in names:
            q = name.split("-")
            if (len(q) != len(parts) or q[:i] != parts[:i]
                    or q[i + 1:] != parts[i + 1:]):
                continue
            if not (q[i].startswith("n") and q[i][1:].isdigit()):
                continue
            world = int(q[i][1:])
            if world == self.world:
                continue
            steps = peek_steps(os.path.join(root, name))
            if steps:
                out.append((steps[-1], world, name))
        return sorted(out)

    def _resume_cross_world(self) -> bool:
        """Resume from a sibling tag written at another world size: the
        shard-native step is read at this world (replicated params and
        optimizer are world-independent; a carry of another global batch
        re-initializes), the LR schedule continues from the manifest's
        anchor, and a ``resize`` event records the transition. Returns True
        when a sibling step was applied. The optimizer and the reducer
        were built at the live world in ``__init__``; with an all-reduce
        lowering neither bakes the schedule in, so the continued anchor is
        all a new divisor changes (the step function's ``lr_fn``)."""
        t0 = time.perf_counter()
        best = self._sibling_resume_candidates()
        step, old_world = (best[-1][0], best[-1][1]) if best else (-1, -1)
        if self.world > 1:
            # the scan is file-system state: process 0's answer is the
            # group's
            step = int(coord.broadcast_flag(float(step)))
            old_world = int(coord.broadcast_flag(float(old_world)))
        if step < 0 or old_world < 0:
            return False
        parts = self.config.tag().split("-")
        parts[parts.index(f"n{self.world}")] = f"n{old_world}"
        sibling = os.path.join(self.config.checkpoint_dir, "-".join(parts))
        ckpt = Checkpointer(sibling)
        try:
            snap = self._restore_step(ckpt, step)
        finally:
            ckpt.close()
        if snap is None:
            return False
        meta = snap.manifest_meta or {}
        anchor = None
        old_nbpe = int(meta.get("steps_per_epoch", 0) or 0)
        if old_nbpe > 0:
            anchor_step = int(meta.get("sched_step_offset", 0))
            anchor_epoch = float(meta.get("sched_epoch_offset", 0.0))
            step_now = int(snap.iteration)
            new_epoch_off = anchor_epoch + (step_now - anchor_step) / old_nbpe
            new_nbpe = max(self._steps_per_epoch(), 1)
            if (abs(new_epoch_off - step_now / new_nbpe) > 1e-12
                    or old_nbpe != new_nbpe):
                anchor = (step_now, new_epoch_off)
        self._apply_snapshot(
            snap, f"resumed after resize ({old_world} -> {self.world})",
            anchor=anchor,
        )
        restore_s = time.perf_counter() - t0
        self._emit_event(
            "resize", old_world=int(old_world), new_world=int(self.world),
            schedule_source="relaunch-reshard",
            num_groups=(self.reducer.num_groups
                        if self.reducer is not None else 0),
            iteration=int(snap.iteration), restore_s=float(restore_s),
        )
        self.log.warning(
            "elastic resize: resumed iteration %d from %s (world %d -> %d; "
            "read at the live world in %.3f s)", snap.iteration, sibling,
            old_world, self.world, restore_s,
        )
        return True

    def update_nworker(self, nworkers: int) -> None:
        """Elastic worker-count resize (the reference's ``update_nworker``).
        A torch process drives one card, so the in-place re-mesh over one
        process's local devices that the JAX trainer does has no
        counterpart here: at the running world this is a no-op, any other
        count is resize-by-relaunch (``ResizeUnsupported`` carries the
        recipe, as the JAX trainer's multi-process branch raises)."""
        if nworkers == self.world:
            return
        raise ResizeUnsupported(
            f"update_nworker({nworkers}): this world runs {self.world} "
            "process(es), one card each, and cannot re-mesh in place",
            nworkers,
        )

    def load_checkpoint(self, directory: str,
                        epoch: Optional[int] = None) -> Snapshot:
        """The snapshot of a checkpoint directory (a run's tagged one): that
        epoch's boundary, else the newest step. Raises if none exists."""
        ckpt = Checkpointer(directory)
        try:
            snap = ckpt.restore(self._template(), epoch=epoch,
                                carry_template=self._carry_template())
        finally:
            ckpt.close()
        if snap is None:
            raise FileNotFoundError(
                f"no checkpoint found under {directory!r}"
                + (f" at epoch {epoch}" if epoch is not None else "")
            )
        return self._localize_carry(snap)

    def _pretrain_init(self) -> bool:
        """``--pretrain``: weights, batch statistics and the epoch and
        iteration counters from another run's checkpoint; the optimizer
        starts fresh (the reference never saves it)."""
        if not self.config.pretrain:
            return False
        pre = self.load_checkpoint(self.config.pretrain)
        self._install(pre.state, optimizer=False)
        self.start_epoch = pre.epoch + 1
        self.iteration = pre.iteration
        self.log.info("initialized from pretrain dir %s (epoch %d, iter %d)",
                      self.config.pretrain, pre.epoch, pre.iteration)
        return True

    # -- the preemption drain -------------------------------------------
    def _maybe_derive_agree_interval(self, step_s: float) -> None:
        """One-shot MGWFBP_AGREE_INTERVAL derivation from the first
        measured step-time window (several processes only); process 0's
        value is broadcast, since the cadence gates a collective."""
        if not self._agree_interval_auto or self.world == 1:
            return
        self._agree_interval_auto = False
        iv = derive_agree_interval(step_s, self._preempt_grace_s)
        self._agree_interval = max(int(coord.broadcast_flag(float(iv))), 1)
        self.log.info(
            "MGWFBP_AGREE_INTERVAL auto-derived: %d (measured %.4g s/step "
            "vs %.3g s preemption grace)", self._agree_interval, step_s,
            self._preempt_grace_s,
        )

    def _arm_signals(self) -> None:
        """SIGTERM/SIGINT -> the graceful drain. Main thread only."""
        if threading.current_thread() is not threading.main_thread():
            return
        try:
            self._prev_handlers = {
                s: _signal.signal(s, self._on_preempt_signal)
                for s in (_signal.SIGTERM, _signal.SIGINT)
            }
        except ValueError:
            return
        self._signals_armed = True

    def _disarm_signals(self) -> None:
        if not self._signals_armed:
            return
        for s, h in self._prev_handlers.items():
            try:
                _signal.signal(s, h)
            except ValueError:
                pass
        self._signals_armed = False

    def _on_preempt_signal(self, signum, frame) -> None:
        # signal context: set the flag; the loop drains at the next step
        # boundary. A second signal before that escalates: disarm (a third
        # kills outright) and interrupt now
        name = _signal.Signals(signum).name
        if self._preempt_signal is not None:
            self._disarm_signals()
            raise KeyboardInterrupt(
                f"second {name} during preemption drain — escalating "
                "(next signal kills outright)"
            )
        self._preempt_signal = name

    def _wedge(self, secs: float) -> None:
        """Fault injection: stop stepping for ``secs`` (the liveness
        monitor's signature: a frozen /status step while /healthz and
        /status keep serving from their thread). A sliced sleep, so that a
        delivered SIGTERM (the healer's) ends the wedge and the drain
        takes over at the step boundary; no watchdog beat, as a real wedge
        would not beat either."""
        self.log.warning(
            "fault injection: wedging for %.3g s before step %d (stepping "
            "stops; HTTP keeps serving)", secs, self.iteration + 1,
        )
        deadline = time.monotonic() + secs
        while time.monotonic() < deadline:
            if self._preempt_signal is not None:
                self.log.warning(
                    "wedge interrupted by %s; resuming the step loop (the "
                    "drain takes over at the boundary)", self._preempt_signal,
                )
                return
            time.sleep(min(0.2, max(deadline - time.monotonic(), 0.0)))

    def _deliver_preempt(self, sig: int) -> None:
        """Fault-plan preemption: the real signal to this process when the
        handler is armed (the production path), else the flag directly
        (``train_epoch`` called outside ``fit``)."""
        name = _signal.Signals(sig).name
        if (self._signals_armed
                and threading.current_thread() is threading.main_thread()):
            self.log.warning("fault injection: delivering %s to self", name)
            os.kill(os.getpid(), sig)
        else:
            self.log.warning("fault injection: simulating %s", name)
            self._preempt_signal = name

    def _agreed_preempt(self, at_boundary: bool = False) -> bool:
        """Should the whole group drain now? One process: its own flag,
        every step. Several: an ``agree_any`` over the flags at
        deterministic points only (every agree-interval-th step, and epoch
        boundaries), so that taking part never depends on the local flag;
        a process drained by a peer records the signal 'PEER'."""
        local = self._preempt_signal is not None
        if self.world == 1:
            return local
        if not at_boundary and self.iteration % self._agree_interval != 0:
            return False
        agreed = coord.agree_any(local)
        if agreed and not local:
            self._preempt_signal = "PEER"
        return agreed

    def _graceful_drain(self, epoch: int, epoch_pos: int) -> None:
        """The in-flight step is done: checkpoint the exact position and
        unwind with Preempted (``train_cli`` exits rc 75)."""
        name = self._preempt_signal or "SIGTERM"
        if self.checkpointer is not None:
            self._beat("preemption drain checkpoint",
                       allow_s=CHECKPOINT_ALLOW_S)
            self.save_step(epoch, epoch_pos, wait=True)
        else:
            self.log.warning(
                "preempted without --checkpoint-dir: progress NOT saved"
            )
        self._emit_event("preempt", signal=str(name), epoch=int(epoch),
                         iteration=int(self.iteration))
        self.log.warning(
            "preemption (%s): drained at epoch %d step %d (iter %d); "
            "exiting restart-friendly", name, epoch, epoch_pos,
            self.iteration,
        )
        raise Preempted(name, epoch, self.iteration)

    def _graceful_drain_boundary(self, epoch: int) -> None:
        """A preemption landing between epochs (evaluation or the boundary
        checkpoint): refresh the boundary checkpoint and unwind."""
        name = self._preempt_signal or "SIGTERM"
        if self.checkpointer is not None:
            self.save(epoch)
            self._poll_async_ckpt(block=True, durable=True)
        self._emit_event("preempt", signal=str(name), epoch=int(epoch),
                         iteration=int(self.iteration))
        self.log.warning("preemption (%s): drained at epoch %d boundary "
                         "(iter %d)", name, epoch, self.iteration)
        raise Preempted(name, epoch, self.iteration)

    # -- the guard and rollback -----------------------------------------
    def _check_guard_value(self, it: int, epoch: int, nonfinite: float) -> None:
        if nonfinite <= 0:
            self._bad_streak = 0
            self._good_step_since_rollback = True
            return
        self._bad_streak += 1
        self.log.warning(
            "non-finite gradients at iter %d (%g element(s)): update dropped "
            "by the step guard (bad streak %d)", it, nonfinite,
            self._bad_streak,
        )
        self._emit_event("bad_step", step=int(it), epoch=int(epoch),
                         nonfinite=float(nonfinite))
        limit = self.config.bad_step_limit
        if not limit or self._bad_streak < limit:
            return
        can_rollback = (self.checkpointer is not None
                        and self.checkpointer.latest_step() is not None)
        if self.world > 1:
            # whether a checkpoint exists is local file-system state: roll
            # back only when EVERY process can
            can_rollback = coord.agree_all(can_rollback)
        if can_rollback:
            raise _RollbackRequested(self._bad_streak)
        if not self._warned_no_rollback:
            self._warned_no_rollback = True
            self.log.error(
                "%d consecutive non-finite steps but no checkpoint to roll "
                "back to (--checkpoint-dir unset or nothing saved); "
                "continuing under the skip-step policy", self._bad_streak,
            )

    def _rollback(self, rb: _RollbackRequested) -> int:
        """Restore the newest checkpoint after K consecutive bad steps;
        returns the epoch to continue from."""
        # an in-flight save snapshots the suspect regime, and its step may
        # be re-reached after the replay: drop it uncommitted
        dropped = self.checkpointer.abandon_async()
        if dropped is not None:
            self.log.warning("rollback: abandoned in-flight async checkpoint "
                             "of step %d", dropped)
        step = self.checkpointer.latest_step()
        if self.world > 1:
            # every process replays from process 0's choice
            step = int(coord.broadcast_flag(
                float(step if step is not None else -1)))
            step = None if step < 0 else step
        snap = self._restore_step(self.checkpointer, step)
        if snap is None:
            raise RuntimeError(
                "rollback requested but the checkpoint vanished"
            ) from rb
        if self._last_rollback_iteration is not None and (
            snap.iteration == self._last_rollback_iteration
            or not self._good_step_since_rollback
        ):
            raise RuntimeError(
                f"persistent non-finite gradients: rollback to iter "
                f"{snap.iteration} follows a rollback to iter "
                f"{self._last_rollback_iteration} with no finite step "
                f"observed in between ({rb.bad_steps} consecutive bad steps "
                "again) — the NaN source is deterministic (check lr, input "
                "pipeline, precision config); aborting instead of looping"
            ) from rb
        self._last_rollback_iteration = snap.iteration
        self._good_step_since_rollback = False
        self._bad_streak = 0
        self._warned_no_rollback = False
        self._apply_snapshot(snap, "rolled back", emit_resume=False)
        self._emit_event("rollback", bad_steps=int(rb.bad_steps),
                         restored_iteration=int(snap.iteration),
                         restored_epoch=int(snap.epoch))
        self.log.warning(
            "rollback: %d consecutive non-finite steps -> restored iter %d "
            "(epoch %d%s)", rb.bad_steps, snap.iteration, snap.epoch,
            f" step {snap.epoch_step}" if snap.mid_epoch else " boundary",
        )
        return self.start_epoch

    # ------------------------------------------------------------------
    def fit(self, num_epochs: Optional[int] = None) -> dict:
        """Run ``num_epochs`` epochs from wherever the trainer is (a resume
        included); None runs through ``max_epochs``. SIGTERM/SIGINT drain
        and the progress watchdog (armed when ``MGWFBP_WATCHDOG_S`` is set)
        cover the whole fit.

        The silent first-use phases and the watchdog: the first NCCL
        communicator (the parameter broadcast) and the backward profile's
        first cuDNN calls run in ``__init__``, before the watchdog is
        armed; the first train step of the process (the loader's start-up,
        with the native library's g++ build at its first batch, and cuDNN's
        and cuBLAS's first use at the training shapes), the first
        evaluation and the telemetry trace's steps run under
        ``COMPILE_ALLOW_S``, checkpoints under ``CHECKPOINT_ALLOW_S``. Those
        phases happen inside ``fit``, so arming later is not an option, and
        the allowance keeps a short per-step timeout from aborting a cold
        machine. The flash kernel's nvcc build never runs in training
        (both packages train the transformer through dense attention)."""
        cfg = self.config
        end = (
            self.start_epoch + num_epochs
            if num_epochs is not None else cfg.max_epochs
        )
        try:
            with ProgressWatchdog(on_stall=self._on_watchdog_stall) as wd:
                self._watchdog = wd if wd.enabled else None
                self._arm_signals()
                if self.telemetry is not None and self.reducer is not None \
                        and self._measured_group_times is None:
                    self._trace_group_times()
                metrics = self._fit_epochs(self.start_epoch, end)
        except coord.CoordinationTimeout as ct:
            # a peer is dead or wedged: every further collective would
            # hang, the checkpoint barrier included
            self._emit_event("failure", **{"class": "coordination"},
                             target=f"p{self.rank}", step=int(self.iteration),
                             op=ct.op)
            self.log.error("coordination timeout in %r at step %d: %s",
                           ct.op, self.iteration, ct)
            raise
        finally:
            self._disarm_signals()
            self._watchdog = None
        self._poll_async_ckpt(block=True)
        self.start_epoch = end
        return metrics

    def _fit_epochs(self, start: int, end: int) -> dict:
        cfg = self.config
        metrics: dict = {}
        epoch = start
        while epoch < end:
            try:
                train_metrics = self.train_epoch(epoch)
            except _RollbackRequested as rb:
                epoch = self._rollback(rb)
                continue
            metrics = {"train": train_metrics}
            if (epoch + 1) % cfg.eval_every_epochs == 0:
                metrics["eval"] = self.evaluate()
                self.log.info(
                    "epoch %d eval: %s", epoch,
                    ", ".join(f"{k} {v:.4f}" for k, v in metrics["eval"].items()),
                )
            if (epoch + 1) % cfg.checkpoint_every_epochs == 0:
                self._beat(f"checkpoint epoch {epoch}",
                           allow_s=CHECKPOINT_ALLOW_S)
                self.save(epoch)
            if self._agreed_preempt(at_boundary=True):
                # the signal landed outside the step loop
                self._graceful_drain_boundary(epoch)
            epoch += 1
        return metrics

    def close(self) -> None:
        if self.checkpointer is not None:
            if self.world == 1:
                # land the in-flight save's commit and its event before the
                # stream closes (several processes: the checkpointer
                # abandons it rather than risk a collective against
                # departed peers)
                try:
                    self._poll_async_ckpt(block=True)
                except RuntimeError:
                    self.log.exception(
                        "in-flight async checkpoint failed during close"
                    )
            self.checkpointer.close()
        if self.reducer is not None:
            self.reducer.detach()
        if self.telemetry is not None:
            self.telemetry.close()
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None
