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
to schedule (the JAX trainer's single-device rule; ``--comm-op rs_opt_ag``
and ``rs_fwd_ag`` then run the replicated optimizer, since a one-rank
shard is the whole state). ``config.comm_op`` picks the lowering of the
merged collectives (``all_reduce``, ``rs_ag``, ``hier``, ``rs_opt_ag``,
``rs_fwd_ag``), ``config.compressor`` and
``config.density`` a top-k compressor (``--density 0``: the cost model's
choice, ``costmodel.choose_density``, which may fall back to dense). On
``rs_opt_ag`` the optimizer state lives as this rank's 1/world shards in
the reducer (``opt_state``): a checkpoint gathers it into the Flax layout
and writes each rank's rows of the sharded ``opt`` section; a restore
(resume, rollback, cross-world) scatters the replicated form, whoever wrote
it, onto this rank's shards. On ``rs_fwd_ag`` the parameters too live as
the reducer's shards between steps (``param_shards``): the module's
parameters are one update stale until the next step's forward gathers
them, so every other reader (evaluation, the checkpoint save and with it
the drain, the end of ``fit``) first calls ``_materialize``, and every
write of the parameters (resume, rollback, ``--pretrain``, a cross-world
resume) re-scatters the shards from them; a save writes each rank's rows
of a sharded ``params`` section, as the JAX trainer does. ``config.
dcn_slices`` splits the world into slices for ``hier``
(``parallel.mesh.two_level_groups``; ``update_nworker`` refuses a
multi-slice run) and prices a schedule on two links
(``TwoLevelAlphaBeta``: the profile's, else the ``ici`` and ``dcn``
priors); the drift detector and the /profile window compare a hier
group's range against its inner legs only (``_scope_comparable_
predictions``), since the cross-slice all-reduces have ranges of their
own. The cost model is the ``--comm-profile`` resolved at the world
size, else the ``connection`` prior; the measured backward profile (and,
on ``rs_fwd_ag``, the forward profile the cross-step schedule is priced
on, ``_tf_cache``) is written to ``<logdir>/<tag>/tb_profile.json``. ``config.dtype`` bfloat16 runs the
step and evaluation at that compute dtype (the JAX step's mixed-precision
policy, ``train/step.py``); the TF32 setting comes from
``utils.device.set_matmul_precision`` and is logged. With ``telemetry`` on, each step
writes a ``step`` span and each epoch an ``epoch`` record (for a
language model both also hold its ``loss`` and ``perplexity``), the
``overlap``
accounting and one ``comm_group`` record per merge group
(``telemetry/overlap.py``).

Sequence parallelism (the JAX trainer's seq axis): with
``config.seq_parallel`` S the world is (world / S) data workers of S ranks
each; rank r has data index r // S and ring position r % S, and ranks
[d S, (d + 1) S) form ring d (``parallel.mesh.seq_groups``). A ring's
members load the same windows (``ShardInfo(r // S, world / S)``), each
trains on its time slice of them (``_to_device``) through the ring's
attention (``TransformerLM.set_seq_group``), and every reduction spans the
world. The data extent names the run (``config.nworkers``, the tag) and
prices the cost model, as the JAX trainer's ``data_size`` does; the
backward and forward profiles time the model without its ring on the
slice; the evaluation reports true samples (``count / S``). A model
without seq support or with a carry, a window or a world that S does not
divide, and hier are refused in the JAX trainer's words.

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
``Preempted``, which ``train_cli`` turns into rc 75.

The step loop never waits on the card (the JAX trainer's zero-sync loop):
the step decides its non-finite guard on the device and returns its
metrics as device tensors, and the trainer queues each step's metrics as
a non-blocking copy to the host and reads them LATE (``_note_step``): once
more than ``MGWFBP_GUARD_CHECK_INTERVAL`` steps (default 1) are queued,
every step but the newest is drained in one read, and the queue is
drained at an epoch's end (and before a profile window or a race), and
cleared by a preemption drain and a rollback. A drained step appends its
loss to ``losses``, emits its ``health`` record and feeds the guard:
``bad_step_limit`` consecutive non-finite steps roll back to the newest
checkpoint; a second rollback with no finite step between aborts. The log
line (``MGWFBP_LOG_INTERVAL``) reads its step's metrics when it prints. ``MGWFBP_FAULT_PLAN`` injects
NaN steps, preemptions, stalls, SIGKILLs and wedges deterministically
(``utils/faults.py``; ``kill`` and ``wedge`` fire only in the supervisor
incarnation they name, ``MGWFBP_INCARNATION``).

Supervision (the JAX trainer's runtime layer). ``fit`` arms the progress
watchdog (``utils/watchdog.py``, ``MGWFBP_WATCHDOG_S``): every step beats
it, the known-long silent phases take its allowances, and a stall emits a
``watchdog_stall`` event and turns /healthz 503 before an rc-86 abort.
``metrics_port`` starts the live plane (``telemetry/serve.py``: /metrics,
/healthz, /status, /profile, /postmortems, fed by the event stream) that
the supervisor's liveness monitor and fleet fan-in scrape. Under
``MGWFBP_ELASTIC_RESUME=1`` (the supervisor exports it) a trainer that
finds no checkpoint under its own tag resumes from a sibling tag written
at another world size (``_resume_cross_world``), the LR schedule
continuing from the manifest's anchor. ``update_nworker`` resizes only by
relaunch (``runtime.ResizeUnsupported``).

The telemetry plane (the JAX trainer's, with telemetry on):
  * health: ``TrainStep(health_stats=...)`` (``config.health_stats``)
    computes the gradient norms and the update ratio on the device with
    the step's metrics; they drain with them, so a ``health`` record lands
    late with no added synchronisation, and feeds the health detector
    (``telemetry/health.py``), whose edges are ``health_alarm`` records;
  * drift and stragglers (``telemetry/drift.py``): each log window's step
    time, and the per-group comm against the cost model (absolute once a
    /profile window measured per-group device time), give ``drift_alarm``
    edges; at several processes every agree-interval step gathers each
    process's local busy seconds (``coordination.gather_values``) for the
    ``straggler`` probe. With ``MGWFBP_DRIFT_REAUTOTUNE=1`` a raised alarm
    arms a forced re-race of the schedule (``autotune(force=True)``) at the
    next agreed step boundary, after which the detector resets;
  * the flight recorder (``telemetry/recorder.py``), teed with the
    aggregator off the event stream: an alarm, a bad step or a stall writes
    a postmortem bundle under ``<tag dir>/postmortems``;
  * /profile?steps=N: the step loop takes the request at a step boundary
    (at several processes, agreed by ``gather_values`` at the agree
    interval) and runs N genuine steps under ``torch.profiler``
    (``_run_profile_window``): a Chrome trace under
    ``<logdir>/<tag>/profile/iterNNNNNNNN``, per-group device time from
    ``profiling.trace_group_times`` (``attribution: "none"`` where no
    group's range holds a collective kernel: the CPU, and one card, where
    no reducer exists), ``per_process_device_s`` gathered across ranks;
  * ``tensorboard``: the scalar stream (``utils/summary.py``);
  * ``serve_shadow``: the in-process serving plane with the shadow scorer.

Autotune (the JAX trainer's closed loop; ``parallel/autotune.py``).
``config.autotune`` makes ``fit`` call ``autotune()`` before the first
epoch: a cache hit (``parallel.autotune.cache_key``, every process
agreeing) installs the committed schedule; otherwise two burn-in steps,
then each candidate of ``build_candidates`` (the incumbent included) is
swapped in, its first step observed and checked by the schedule verifier
(``analysis.schedule_check``; a rejected candidate's step is undone and it
takes no other), and the verified ones take warmup + ``autotune_steps``
timed steps (``profiling.time_carried_steps``). The timings are agreed
across processes (each candidate at its slowest, ``coordination.
all_argmin``), the cost model is refitted from step-time deltas
(``costmodel.refit_from_observations``; per-group trace times on one
process, which has no reducer in this package), the re-solved schedule
races too, and the measured argmin is installed and written to the cache
by process 0, with ``autotune_race`` and ``autotune_commit`` records. A
swap (``_swap_reducer``) carries the live state across reducers in the
checkpoints' interchange form (``_interchange_state``: Flax layout, the
sharded optimizer gathered, rs_fwd_ag's parameters materialized), removes
the old reducer's hooks, attaches the new one's, builds a ``TrainStep``
over it and installs the state (re-scattering shards and the carry); a
failed install puts the old reducer back. ``config.comm_op`` stays the
configured lowering (the cache key reads it) while ``comm_op`` and the
sharded-optimizer and cross-step paths follow the live reducer, so a
checkpoint written after a swap describes the lowering that wrote it. A
race's steps are genuine optimizer steps (the iteration advances) on
batches of a reserved epoch range; their health statistics are dropped.
"""

from __future__ import annotations

import collections
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
from mgwfbp_tpu_torch.config import TrainConfig, check_hier
from mgwfbp_tpu_torch.convert import (
    _param_rules,
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
    SHARDED_OPS,
    arrival_order,
    make_merged_allreduce,
)
from mgwfbp_tpu_torch.parallel.compression import make_compressor
from mgwfbp_tpu_torch.parallel.costmodel import (
    TwoLevelAlphaBeta,
    choose_density,
    load_profile,
    lookup_alpha_beta,
    resolve_profile,
)
from mgwfbp_tpu_torch.parallel.mesh import (
    check_seq,
    rank,
    seq_groups,
    two_level_groups,
    world_size,
)
from mgwfbp_tpu_torch.parallel.solver import (
    LayerSpec,
    check_comm_op,
    is_two_level,
    singleton_dcn_groups,
    size_prior_tb,
    two_level_leg_costs,
)
from mgwfbp_tpu_torch.runtime import ResizeUnsupported
from mgwfbp_tpu_torch.runtime import coordination as coord
from mgwfbp_tpu_torch.profiling import (
    TbProfile,
    benchmark_backward,
    benchmark_forward,
    layer_profile_doc,
    save_layer_profile,
    trace_group_times,
)
from mgwfbp_tpu_torch.telemetry import EventWriter, stream_filename, summarize
from mgwfbp_tpu_torch.telemetry import spans
from mgwfbp_tpu_torch.telemetry.drift import (
    DriftConfig,
    DriftDetector,
    StragglerDetector,
    reautotune_enabled,
)
from mgwfbp_tpu_torch.telemetry.health import (
    HealthConfig,
    HealthDetector,
    health_enabled,
)
from mgwfbp_tpu_torch.train.step import (
    HEALTH_PREFIX,
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
    exit_mark,
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


def check_lowering(cfg: TrainConfig, world: int) -> None:
    """The checks of the configured lowering that the configuration and
    the world alone decide (the JAX trainer's messages): the comm op, the
    hier mesh, the mesh's divisibility by ``--seq-parallel`` and
    ``--dcn-slices``, a sharded lowering under
    a policy that builds no buckets, and, above one worker, a sharded
    lowering with a compressor. ``train_cli`` runs them before the
    rendezvous, so that every rank of a rejected launch fails alike."""
    check_comm_op(cfg.comm_op)
    check_hier(cfg.comm_op, cfg.dcn_slices, cfg.seq_parallel)
    check_seq(cfg.seq_parallel, world, cfg.dcn_slices)
    if cfg.dcn_slices < 1 or world % cfg.dcn_slices:
        raise ValueError(
            f"--dcn-slices {cfg.dcn_slices} does not divide the world "
            f"of {world} rank(s)")
    if cfg.policy in ("none", "xla"):
        if cfg.comm_op in SHARDED_OPS:
            raise ValueError(
                f"--comm-op {cfg.comm_op} requires a merge policy "
                "(mgwfbp/auto/threshold/single/wfbp); policy "
                f"{cfg.policy!r} issues no bucket collectives")
        return
    sparse = cfg.compressor not in (None, "", "none")
    if world > 1 and cfg.comm_op in SHARDED_OPS and sparse:
        raise ValueError(
            f"--comm-op {cfg.comm_op} cannot combine with --compressor "
            "(the shard update needs the dense reduction)")


def _elastic_resume_enabled() -> bool:
    """True when a relaunch may resume from a sibling tag written at
    another world size. The supervisor exports MGWFBP_ELASTIC_RESUME=1 for
    the groups it launches (a resize-by-relaunch must find the old world's
    checkpoints); a standalone run keeps to its own tag unless asked."""
    raw = (os.environ.get("MGWFBP_ELASTIC_RESUME") or "").strip().lower()
    return raw in ("1", "true", "yes")


def _host_metrics(metrics: dict) -> dict:
    """A step's metrics (0-dim device tensors) on the host: one read."""
    keys = list(metrics)
    return dict(zip(keys, torch.stack([metrics[k] for k in keys]).tolist()))


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


class Trainer:
    def __init__(
        self,
        config: TrainConfig,
        device=None,
        profile_backward: bool = True,
        synthetic_data: Optional[bool] = None,
    ):
        t_init = time.perf_counter()
        # the set-up's phases on the host clock (``telemetry.spans``),
        # logged in one line at the end
        setup = spans.SetupSpans()
        self.config = config
        self.device = resolve_device(device)
        self.world = world_size()
        self.rank = rank()
        # sequence parallelism (the JAX trainer's (data, seq) mesh): rings
        # of seq_parallel consecutive ranks share their batch rows and
        # shard each window's time dimension; rank r has data index r // S
        # and ring position r % S. The data extent names the run (the tag's
        # worker count) and sizes its cost model; every collective spans
        # the whole world
        self.seq_size = max(int(config.seq_parallel or 1), 1)
        check_seq(self.seq_size, self.world, config.dcn_slices)
        self.data_size = self.world // self.seq_size
        self.data_index, self.seq_index = divmod(self.rank, self.seq_size)
        self.seq_group = None  # this rank's ring (``_bind_seq_ring``)
        config.nworkers = self.data_size
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
        # MGWFBP_DRIFT_REAUTOTUNE=1: a raised drift alarm arms a forced
        # re-race at the next agreed step boundary
        # mgwfbp: group-uniform -- MGWFBP_DRIFT_REAUTOTUNE is group-uniform env (the supervisor exports one environment)
        self._drift_reautotune_enabled = reautotune_enabled()
        self._drift_reautotune_pending = False
        # mgwfbp: group-uniform -- set by autotune(): race winners ride all_argmin, cache hits agree_all
        self.autotune_report: Optional[dict] = None
        # the race's losses and the gate's per-candidate observations
        # (autotune)
        self._race_losses: Optional[list[torch.Tensor]] = None
        self._gate_log: list[dict] = []
        self._metrics_agg = None
        self._metrics_server = None
        self._recorder = None
        self.writer = None
        self._serve_plane = None
        # the lowering of the run's collectives, decided once (None: no
        # reducer is built and the step takes its own mean)
        self._reducer_op = self._resolve_comm_op()
        self.telemetry = self._open_telemetry()
        # drift, stragglers and health (telemetry/{drift,health}.py): host
        # arithmetic at the logging cadence; the straggler probe is a
        # collective, so its gate reads group-uniform state only
        # mgwfbp: group-uniform -- MGWFBP_* detector thresholds parse the one supervisor-exported environment
        self._drift_cfg = DriftConfig.from_env()
        self._drift_detector = (
            DriftDetector(self._drift_cfg) if config.telemetry else None
        )
        self._drift_window_seen = False
        self._straggler_detector = StragglerDetector(
            self._drift_cfg.straggler_band, self._drift_cfg.hysteresis,
            self._drift_cfg.straggler_min_excess_s,
        )
        self._straggler_enabled = (
            bool(config.telemetry) and self._drift_cfg.straggler_band > 0
        )
        self._health_on = bool(config.telemetry and config.health_stats)
        self._health_detector = (
            HealthDetector(HealthConfig.from_env())
            if self._health_on and health_enabled() else None
        )
        # every step's metrics (its loss, the guard's count, the health
        # statistics) are read LATE: each step queues a non-blocking copy
        # to the host, and everything but the newest is drained in one
        # read, so reading never waits for the step just launched.
        # MGWFBP_GUARD_CHECK_INTERVAL=N drains every N steps (detection
        # lags by at most N steps; the step's own guard protects the
        # state either way)
        # mgwfbp: group-uniform -- fills at the deterministic step cadence; identical length everywhere
        self._pending: collections.deque = collections.deque()
        self._guard_interval = max(
            int(os.environ.get("MGWFBP_GUARD_CHECK_INTERVAL", "1")), 1)
        self._last_metrics: dict = {}  # the newest drained step's, on the host
        # the straggler probe's signal: each process's LOCAL busy seconds
        # (loader wait, batch preparation, injected stalls; up to the
        # step's launch), which synchronous SGD does not equalise
        self._local_busy_s = 0.0
        self._t_anchor = time.perf_counter()
        self._probe_iter = 0
        self._probe_busy = 0.0
        self._measured_group_times: Optional[list[float]] = None
        # the S members of a ring load the same windows
        self.shard = ShardInfo(self.data_index, self.data_size)
        with setup.span("setup.model"):
            model, self.meta = zoo.create_model(config.dnn,
                                                dataset=config.dataset)
        image_hw = None
        if self.meta.task == "classify" and self.meta.input_shape[0] >= 256:
            image_hw = tuple(self.meta.input_shape[:2])  # the inceptions' 299
        with setup.span("setup.data"):
            self.bundle = data_prepare(
                config.dataset, data_dir=config.data_dir,
                batch_size=config.batch_size, shard=self.shard,
                seed=config.seed, synthetic=synthetic_data,
                augment=config.augment, num_steps=config.num_steps,
                image_hw=image_hw,
            )
        with setup.span("setup.model"):
            if self.bundle.num_classes != self.meta.num_classes:
                model, self.meta = zoo.create_model(
                    config.dnn, dataset=config.dataset,
                    num_classes=self.bundle.num_classes,
                )
            # the eval batch apart from the train batch (MGWFBP_EVAL_BATCH),
            # for carry-free models only: a carry's batch is its layout
            eval_bs = os.environ.get("MGWFBP_EVAL_BATCH")
            if eval_bs and not self.meta.has_carry:
                self.bundle.val.set_batch_size(max(int(eval_bs), 1))
            self.model = zoo.for_training(model)
            self._apply_lm_window()
            if self.seq_size > 1:
                self._bind_seq_ring()
            init_weights(self.model,
                         torch.Generator().manual_seed(config.seed))
            # dropout draws from torch's global generator: a function of
            # the seed and the rank, so that ranks draw different masks
            # (the JAX step folds the data index into its dropout key,
            # then the seq index)
            torch.manual_seed(
                int(np.random.SeedSequence(
                    [config.seed, self.rank] if self.seq_size == 1
                    else [config.seed, self.data_index, self.seq_index])
                    .generate_state(1)[0])
            )
            self.model.to(self.device)
        if self.world > 1:
            # identical replicas from rank 0, as the reference's
            # broadcast_parameters does (the run's first collective)
            with setup.span("setup.broadcast"), torch.no_grad():
                for t in self.model.state_dict().values():
                    dist.broadcast(t, 0)
        # the schedule's anchor: the step -> epoch conversion continues from
        # it (a checkpoint carries it; it moves only on elastic resizes)
        self._sched_step_offset = 0
        self._sched_epoch_offset = 0.0
        with setup.span("setup.optimizer"):
            (self.optimizer, self.lr_fn, self.epoch_schedule,
             self.optim_spec) = make_optimizer(
                self.model.parameters(), config.lr,
                momentum=config.momentum, weight_decay=config.weight_decay,
                lr_schedule=config.lr_schedule, dataset=config.dataset,
                max_epochs=config.max_epochs,
                warmup_epochs=config.warmup_epochs,
                num_batches_per_epoch=max(self._steps_per_epoch(), 1),
                norm_clip=config.norm_clip, world_size=self.data_size,
                return_spec=True,
            )
        self.cost_model = None
        self.tb: Optional[TbProfile] = None
        # the measured forward profile (rs_fwd_ag's schedule is priced on
        # it; None: the solver's tb/2 prior)
        self._tf_cache: Optional[TbProfile] = None
        # the top-k compressor and hier's process groups, made once and
        # shared by every reducer the autotuner builds
        self._compressor = None
        self._levels = None
        with setup.span("setup.reducer"):
            # mgwfbp: group-uniform -- the merge schedule solves from broadcast-identical profiles; later swaps ride group-agreed commits
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
        if self._sharded_opt:
            optim = self.reducer.optim
            self.log.info(
                "sharded optimizer (%s): opt-state %d B/device vs %d B "
                "replicated (%.2fx reduction over %d workers)",
                self.reducer.comm_op, optim.state_bytes_per_device(),
                optim.replicated_state_bytes(),
                optim.replicated_state_bytes()
                / max(optim.state_bytes_per_device(), 1), optim.world,
            )
        if self._cross_step:
            self.log.info(
                "cross-step pipelining (rs_fwd_ag): %d group gather(s) "
                "deferred into the next step's forward",
                self.reducer.num_groups,
            )
        self._sync_schedule_gauge()
        with setup.span("setup.train_step"):
            self.train_step = self._make_train_step()
        self.carry = self._zero_carry()
        self.start_epoch = 0
        # mgwfbp: group-uniform -- the step counter advances in lockstep; resume/rollback targets are broadcast-agreed
        self.iteration = 0
        self.losses: list[float] = []  # every optimizer step's mean loss,
        # appended as its metrics drain
        self._init_resilience()
        setup.publish()
        self.log.info("set-up: %s (Trainer.__init__ %.3f s)", ", ".join(
            f"{k} {v:.3f} s" for k, v in setup.seconds().items()),
            time.perf_counter() - t_init)

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
        raw_interval = (
            os.environ.get("MGWFBP_AGREE_INTERVAL") or ""
        ).strip()
        try:
            self._agree_interval = max(int(raw_interval or "1"), 1)
        except ValueError:
            raise ValueError(
                f"MGWFBP_AGREE_INTERVAL={raw_interval!r} is not an integer"
            ) from None
        self._agree_interval_auto = not raw_interval
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
    @property
    def _sharded_opt(self) -> bool:
        """True when the optimizer state is sharded over the ranks
        (rs_opt_ag, rs_fwd_ag)."""
        return self._reducer_op in SHARDED_OPS

    @property
    def _cross_step(self) -> bool:
        """True when the parameters, too, are carried as shards between
        steps (rs_fwd_ag)."""
        return self._reducer_op == "rs_fwd_ag"

    def _materialize(self) -> None:
        """Bring the module's parameters up to the carried shards before a
        reader sees them (rs_fwd_ag; a collective when they are stale,
        which every rank is at the same step)."""
        if self._cross_step:
            self.reducer.materialize()

    @property
    def comm_op(self) -> str:
        """The lowering the run's collectives take (all_reduce where no
        reducer is built: one worker, or policy none)."""
        return self._reducer_op or "all_reduce"

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
            "world": self.world, "comm_op": self.comm_op,
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
        agg = self._metrics_agg
        from mgwfbp_tpu_torch.telemetry.recorder import (
            FlightRecorder,
            recorder_enabled,
            tee_observers,
        )

        if recorder_enabled():
            # an alarm, a bad step or a stall dumps the ring with /status
            # and the schedule; several processes share the tag dir, so
            # their bundles carry a .pN suffix
            self._recorder = FlightRecorder(
                tel_dir,
                status_provider=agg.status if agg is not None else None,
                schedule_provider=self._schedule_state_doc,
                profile_armer=agg.arm_profile if agg is not None else None,
                event_sink=writer.emit,
                suffix=f".p{self.rank}" if self.world > 1 else "",
            )
        if agg is not None or self._recorder is not None:
            writer.observer = tee_observers(
                agg.observe if agg is not None else None,
                self._recorder.observe if self._recorder is not None
                else None,
            )
        if agg is not None:
            # a live trainer consumes /profile?steps=N requests
            agg.enable_profile()
        if cfg.tensorboard and cfg.logdir and self.rank == 0:
            from mgwfbp_tpu_torch.utils.summary import ScalarWriter

            self.writer = ScalarWriter(
                os.path.join(cfg.logdir, cfg.tag()), stream=writer)
        return writer

    def _schedule_state_doc(self) -> dict:
        """The committed schedule and cost model, JSON data (every
        postmortem bundle's ``schedule.json``), in the JAX trainer's
        shape."""
        from mgwfbp_tpu_torch.parallel import autotune as at

        doc: dict = {"iteration": int(self.iteration)}
        reducer = getattr(self, "reducer", None)
        if reducer is not None:
            s = reducer.schedule
            doc["schedule"] = {
                "comm_op": str(reducer.comm_op),
                "num_groups": int(reducer.layout.num_groups),
                "groups": [list(g) for g in reducer.layout.groups],
                "dcn_groups": [list(d) for d in s.dcn_groups],
                "policy_detail": str(s.policy_detail or self.config.policy),
                "predicted_nonoverlap_s": float(s.predicted_nonoverlap_time),
            }
        cm = getattr(self, "cost_model", None)
        if cm is not None:
            doc["cost_model"] = at.model_summary(cm)
        measured = getattr(self, "_measured_group_times", None)
        if measured is not None:
            doc["measured_group_times"] = [float(t) for t in measured]
        return doc

    def _sync_schedule_gauge(self) -> None:
        """Push the merge schedule into the /status aggregator."""
        if self._metrics_agg is None:
            return
        s = self.reducer.schedule if self.reducer is not None else None
        self._metrics_agg.set_schedule(
            self.comm_op, s.num_groups if s is not None else 0,
            s.policy_detail if s is not None else "",
            float(s.predicted_nonoverlap_time) if s is not None else None)

    def _make_train_step(self) -> TrainStep:
        """The train step over the live reducer (a schedule swap builds a
        new one; ``_install`` then sets its step counter)."""
        cfg = self.config
        return TrainStep(
            self.model, self.optimizer, self.lr_fn, reducer=self.reducer,
            nsteps_update=cfg.nsteps_update, grad_guard=cfg.grad_guard,
            norm_clip=(
                scaled_clip_threshold(cfg.norm_clip, self.data_size)
                if cfg.norm_clip is not None else None
            ),
            task=self.meta.task, compute_dtype=self.compute_dtype,
            health_stats=self._health_on, seq_group=self.seq_group,
        )

    def _bind_seq_ring(self) -> None:
        """Refuse what the JAX trainer refuses under a seq axis (a model
        without seq support or with a BPTT carry, a window the seq extent
        does not divide), then make the world's rings
        (``parallel.mesh.seq_groups``, a collective) and bind this rank's
        to the model."""
        if not hasattr(self.model, "seq_group") or self.meta.has_carry:
            raise ValueError(
                f"model {self.config.dnn!r} does not support sequence "
                "parallelism (needs a carry-free lm model with a "
                "seq_axis attribute, e.g. 'transformer')"
            )
        t = self.meta.input_shape[0]
        if t % self.seq_size != 0:
            raise ValueError(
                f"sequence length {t} not divisible by seq mesh extent "
                f"{self.seq_size}"
            )
        self.seq_group = seq_groups(self.seq_size, self.config.dcn_slices)
        self.model.set_seq_group(self.seq_group)
        self.log.info(
            "sequence parallelism: %d ring(s) of %d rank(s); this rank: "
            "data index %d, ring position %d, tokens [%d, %d) of %d",
            self.data_size, self.seq_size, self.data_index, self.seq_index,
            self.seq_index * t // self.seq_size,
            (self.seq_index + 1) * t // self.seq_size, t,
        )

    def _seq_free(self):
        """A context in which the model runs without its ring (the
        profiles time the seq-free model on the T/S slice, as the JAX
        trainer times its axis-free model): no ring traffic inside."""
        if self.seq_group is None:
            return contextlib.nullcontext()
        return self.model.seq_free()

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

        if self.seq_group is not None:
            # this ring position's time slice [s T/S, (s+1) T/S) of x and
            # y (the JAX batch spec P(None, data, seq))
            x, y = (self._time_slice(a) for a in (x, y))
        xt = put(x)
        rest = tuple(put(a, torch.int64) for a in (y, *lengths))
        if self.meta.task in ("lm", "ctc"):
            return (xt, *rest)
        return (xt.movedim(-1, -3).contiguous(), *rest)

    def _time_slice(self, a):
        """Tokens (..., T) -> this rank's slice (..., T/S) of the time
        axis."""
        t = a.shape[-1] // self.seq_size
        return a[..., self.seq_index * t:(self.seq_index + 1) * t]

    def _resolve_comm_op(self) -> Optional[str]:
        """The lowering the reducer will take, None where none is built
        (the JAX trainer's rules): none under policy none, which refuses
        rs_opt_ag (the sharded optimizer needs the buckets); none at one
        worker, where rs_opt_ag runs the replicated optimizer; rs_opt_ag
        takes no compressor."""
        cfg = self.config
        # fail fast: config and world alone decide these
        check_lowering(cfg, self.world)
        sparse = cfg.compressor not in (None, "", "none")
        if cfg.policy in ("none", "xla"):
            return None  # one mean per leaf, no hooks
        if self.world == 1:
            self.log.info(
                "single device: skipping merged-allreduce scheduling "
                "(policy %s inert%s%s%s)", cfg.policy,
                f"; --comm-profile {cfg.comm_profile} unused"
                if cfg.comm_profile else "",
                f"; --comm-op {cfg.comm_op} runs the replicated optimizer"
                if cfg.comm_op in SHARDED_OPS else "",
                f"; --compressor {cfg.compressor} unused, no density chosen"
                if sparse else "",
            )
            return None
        return cfg.comm_op

    def _build_reducer(self, profile_backward: bool):
        """The merged collectives of ``_resolve_comm_op``'s lowering (None
        where it builds none); ``--density 0`` asks ``choose_density`` and
        drops to dense when it says 1.0."""
        cfg = self.config
        if self._reducer_op is None:
            return None
        sparse = cfg.compressor not in (None, "", "none")
        dcn = int(cfg.dcn_slices)
        # the JAX trainer prices the data extent (the seq axis's ranks
        # share the link), while the reducer spans the world
        ici = self.data_size // dcn
        if cfg.comm_profile:
            self.cost_model = resolve_profile(
                load_profile(cfg.comm_profile), self.data_size
            )
            self.log.info(
                "cost model: %s resolved at world %d (%s, alpha %.4g s, "
                "beta %.4g s/B, gamma %.4g s, overlap %.3g)",
                cfg.comm_profile, self.data_size,
                type(self.cost_model).__name__, self.cost_model.alpha,
                # a two-level model has a beta per link, none overall
                getattr(self.cost_model, "beta", float("nan")),
                self.cost_model.gamma, self.cost_model.overlap,
            )
            if dcn > 1 and not isinstance(self.cost_model, TwoLevelAlphaBeta):
                self.log.warning(
                    "--comm-profile %s is a FLAT alpha-beta model but the "
                    "world is multi-slice (dcn=%d): the profile prices the "
                    "cross-slice hop as the inner link. Calibrate a "
                    "two-level profile (calibrate --two-level) for "
                    "trustworthy merge schedules.", cfg.comm_profile, dcn,
                )
        elif dcn > 1:
            # multi-slice: the inner link within a slice, the outer across
            self.cost_model = TwoLevelAlphaBeta(
                ici=lookup_alpha_beta("ici", ici),
                dcn=lookup_alpha_beta("dcn", dcn),
                ici_size=ici, dcn_size=dcn,
            )
            self.log.info(
                "cost model: the two-level ici/dcn priors at %d slice(s) of "
                "%d (no --comm-profile)", dcn, ici,
            )
        else:
            self.cost_model = lookup_alpha_beta(cfg.connection,
                                                 self.data_size)
            self.log.info(
                "cost model: the %r prior at world %d (no --comm-profile)",
                cfg.connection, self.data_size,
            )
        if cfg.policy in ("mgwfbp", "auto") and profile_backward:
            self.tb = self._profile_backward()
            if self._reducer_op == "rs_fwd_ag":
                # only the cross-step schedule reads the forward profile
                if self._tf_cache is None:
                    self._tf_cache = self._profile_forward()
        compressor = None
        if sparse:
            density = cfg.density
            if density <= 0:
                n_elems = sum(p.numel() for p in self.model.parameters())
                density = choose_density(n_elems, self.world, self.cost_model)
                self.log.info("auto density: %g for %d params over %d "
                              "workers", density, n_elems, self.world)
                if density >= 1.0:
                    self.log.info(
                        "auto density: dense all-reduce predicted cheaper "
                        "than top-k + allgather on this link; compression "
                        "disabled")
            if density < 1.0:
                compressor = self._compressor = make_compressor(
                    cfg.compressor, density)
                self.log.info("gradient compression: %s density=%g",
                              cfg.compressor, density)
        levels = None
        if self._reducer_op == "hier":
            levels = self._two_level()
        return make_merged_allreduce(
            self.model, policy=cfg.policy, tb=self.tb, tf=self._tf_cache,
            cost_model=self.cost_model, threshold=cfg.threshold,
            comm_dtype=getattr(torch, cfg.comm_dtype) if cfg.comm_dtype else None,
            comm_op=self._reducer_op, compressor=compressor,
            optim_spec=self.optim_spec if self._sharded_opt else None,
            world_size=self.world, levels=levels,
        )

    def _two_level(self):
        """The world's two-level process groups (``parallel.mesh.
        two_level_groups``), made at the first hier reducer: every rank
        reaches it at the same point."""
        if self._levels is None:
            dcn = int(self.config.dcn_slices)
            self._levels = two_level_groups(dcn)
            self.log.info("two-level groups: %d slice(s) of %d rank(s)",
                          dcn, self.world // dcn)
        return self._levels

    def _layer_specs(self) -> list[LayerSpec]:
        """The solver's layer specs of the model, in arrival order."""
        params, perm, names = self._arrival_leaves()
        return [LayerSpec(names[j], params[j].numel(),
                          params[j].element_size()) for j in perm]

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
        with self._seq_free():
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

    def _profile_forward(self) -> TbProfile:
        """The forward's seconds per leaf in arrival order
        (``profiling.benchmark_forward``) at the per-worker batch, rank 0's
        broadcast as tb is; rank 0 rewrites ``tb_profile.json`` with them
        (schema 2, ``tf_s``). Without one (no backward profile either:
        ``profile_backward`` off, or a policy that takes none) the
        cross-step schedule takes ``solver.forward_prior_tf(tb)``, as the
        JAX trainer does."""
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
        with self._seq_free():
            tf = benchmark_forward(self.model, loss_of, params, perm,
                                   warmup=2, iters=10)
        if self.world > 1:
            vals = torch.tensor(list(tf), dtype=torch.float64,
                                device=self.device)
            dist.broadcast(vals, 0)
            tf = TbProfile(vals.tolist(), source=tf.source)
        if self.rank == 0 and self.config.logdir and self.tb is not None:
            save_layer_profile(
                os.path.join(self.config.logdir, self.config.tag(),
                             "tb_profile.json"),
                layer_profile_doc(self.tb, [names[j] for j in perm], tf=tf),
            )
        self.log.info(
            "forward benchmark: %.3g s total over %d tensors, per-layer "
            "source=%s (%.1f s)", sum(tf), len(tf), tf.source,
            time.perf_counter() - t0,
        )
        return tf

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
        self._last_metrics = {}
        first = len(self.losses)  # this epoch's first step's loss, once read
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
        self._t_anchor = time.perf_counter()
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
                # the live plane, at group-uniform steps: the straggler
                # probe, an armed drift re-race, then an armed /profile
                # window
                self._maybe_straggler_probe()
                self._maybe_drift_reautotune()
                self._maybe_profile_window(epoch)
                if max_steps is not None and epoch_pos >= max_steps:
                    break
                if self.iteration % log_interval == 0:
                    # the log line reads this step's metrics (one read on
                    # the log cadence, as the JAX trainer's)
                    metrics = _host_metrics(metrics)
                    dt = (time.time() - t_window) / max(window_iters, 1)
                    self._maybe_derive_agree_interval(dt)
                    self._observe_drift_window(dt)
                    metric = self.train_step.metric
                    samples_s = cfg.batch_size * self.data_size * n / dt
                    self.log.info(
                        "epoch %d iter %d: loss %.4f%s | %.4f s/iter, %.1f "
                        "samples/s", epoch, self.iteration, metrics["loss"],
                        f", {metric} {metrics[metric]:.4f}" if metric else "",
                        dt, samples_s,
                    )
                    if self.writer is not None:
                        self.writer.add_scalars("train", {
                            k: v for k, v in metrics.items()
                            if k != "grads_nonfinite"}, self.iteration)
                        self.writer.add_scalar("train/sec_per_iter", dt,
                                               self.iteration)
                        self.writer.add_scalar("train/samples_per_sec",
                                               samples_s, self.iteration)
                    t_window = time.time()
                    window_iters = 0
                # what follows the step until the next batch is
                # group-coupled and stays out of the straggler signal
                self._t_anchor = time.perf_counter()
        if micro:
            self.log.info(
                "epoch %d: dropped %d trailing micro-batch(es)", epoch,
                len(micro),
            )
        # every step's metrics have been computed by now: the epoch's last
        # read (a tail of bad steps can still ask for the rollback here)
        self._drain_pending()
        out = {k: v for k, v in self._last_metrics.items()
               if k != "grads_nonfinite"}
        if len(self.losses) > first:
            out["first_loss"] = self.losses[first]
        epoch_dur = time.time() - t_epoch
        if self.telemetry is not None and epoch_steps > 0:
            self.telemetry.emit("epoch", epoch=int(epoch), steps=epoch_steps,
                                dur_s=epoch_dur, **self._lm_fields(out))
            self._emit_overlap(epoch_dur / epoch_steps, epoch)
        self.log.info(
            "epoch %d done in %.1f s (lr %.5f)", epoch, epoch_dur,
            self.epoch_schedule(float(epoch)),
        )
        return out

    def _train_on(self, epoch: int, fields: list) -> dict:
        """One optimizer step on stacked host micro-batches (x, y[,
        lengths]): the fault plan's NaN, the copy to the card, the step,
        its telemetry span and the late read of the metrics
        (``_note_step``: the loss record, the health statistics and the
        guard, which raises _RollbackRequested after bad_step_limit
        non-finite steps). Returns the step's metrics as device tensors,
        the health statistics taken out."""
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
        self._local_busy_s += time.perf_counter() - self._t_anchor
        t_step = self.telemetry.now() if self.telemetry else 0.0
        # mgwfbp: group-uniform -- the step's metrics ride its metrics_reduce all-reduce (train/step.py), so the nonfinite count is identical on every rank
        metrics = self.step_batch(*tensors)
        self.iteration += 1
        if self.telemetry is not None:
            # the span times the launch, not the device: nothing is read
            self.telemetry.emit(
                "step", step=self.iteration, epoch=int(epoch),
                start_s=t_step, dur_s=self.telemetry.now() - t_step,
            )
        self._note_step(epoch, metrics)
        return {k: v for k, v in metrics.items()
                if not k.startswith(HEALTH_PREFIX)}

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
        return size_prior_tb(self._layer_specs(), self.cost_model)

    def _emit_overlap(self, step_s: float, epoch: int) -> None:
        """One ``overlap`` record and one ``comm_group`` record per merge
        group for this epoch's schedule (host arithmetic only)."""
        if self.reducer is None or self.cost_model is None or step_s <= 0.0:
            return
        summary = summarize(
            self.reducer, self.cost_model, self._overlap_tb(), step_s,
            measured=self._measured_group_times, tf=self._tf_cache,
            order=self.reducer.launch_sequence,
            gather_order=self.reducer.gather_sequence,
        )
        self.telemetry.emit("overlap", step=self.iteration, epoch=int(epoch),
                            **summary.to_event_fields())
        for fields in summary.group_event_fields(self.iteration):
            self.telemetry.emit("comm_group", **fields)
        self.log.info(
            "overlap (%s): %.4g s comm/step = %.4g hidden + %.4g exposed -> "
            "efficiency %.3f (starts replayed along the reducer's launch "
            "sequence)", summary.attribution, summary.comm_s, summary.hidden_s,
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

    # ------------------------------------------------------------------
    # The late reads and the telemetry plane: guard, health, drift,
    # stragglers, /profile windows. Every emission is host arithmetic over
    # host data; the only device reads are the late drains of the steps'
    # metrics (whatever the guard and telemetry say, so neither adds a
    # read), the log line's and the windows.
    # ------------------------------------------------------------------

    def _note_step(self, epoch: int, metrics: dict) -> None:
        """Queue this step's metrics, copied to the host without waiting
        (a pinned copy and an event on the card), and drain every queued
        step but the newest once more than ``MGWFBP_GUARD_CHECK_INTERVAL``
        are queued: those copies were launched before this step, so the
        one read waits for nothing this step does."""
        keys = list(metrics)
        vec = torch.stack([metrics[k] for k in keys])
        ready = None
        if vec.is_cuda:
            vec = vec.to("cpu", non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        self._pending.append((self.iteration, int(epoch), keys, vec, ready))
        if len(self._pending) <= self._guard_interval:
            return
        items = [self._pending.popleft()
                 for _ in range(len(self._pending) - 1)]
        self._drain_items(items)

    def _drain_pending(self) -> None:
        """Read every queued step's metrics (at an epoch's end, and before
        steps that are not the loop's: a profile window, a race)."""
        items = list(self._pending)
        self._pending.clear()
        self._drain_items(items)

    def _drain_items(self, items: list) -> None:
        """One read of the queued steps' metrics, then per step in order:
        the loss record, the health record and the guard."""
        if not items:
            return
        if items[-1][4] is not None:
            items[-1][4].synchronize()  # the copies are in stream order
        flat = torch.cat([vec for *_, vec, _ in items]).tolist()
        off = 0
        for it, ep, keys, _, _ in items:
            # mgwfbp: group-uniform -- the metrics ride the step's metrics_reduce all-reduce (train/step.py): every rank reads the same values
            vals = dict(zip(keys, flat[off:off + len(keys)]))
            off += len(keys)
            health = {k: vals.pop(k) for k in
                      [k for k in vals if k.startswith(HEALTH_PREFIX)]}
            self.losses.append(vals["loss"])
            self._last_metrics = vals
            if health and self._health_on:
                self._emit_health((it, ep, vals["loss"]), health)
            # the count is the ranks' mean and the cadence deterministic,
            # so every rank reaches the same verdict at the same step
            if self.config.grad_guard:
                self._check_guard_value(it, ep, vals["grads_nonfinite"])
        if self._recorder is not None:
            # a bundle's `postmortem` record waits for the next record
            # (it must follow its trigger's row, which is out now): emit it
            # here, so /postmortems lists the bundle of a step read late
            # while the loop goes on, not when the next record comes
            self._recorder.flush_events()

    def _emit_health(self, pending: tuple, vals: dict) -> None:
        it, ep, loss = pending
        g_prefix = f"{HEALTH_PREFIX}gnorm_g"
        c_prefix = f"{HEALTH_PREFIX}comp_err_g"
        group_norms = [vals[k] for k in sorted(vals) if k.startswith(g_prefix)]
        comp = [vals[k] for k in sorted(vals) if k.startswith(c_prefix)]
        fields = {
            "step": int(it), "epoch": int(ep), "loss": float(loss),
            "grad_norm": float(vals.get(f"{HEALTH_PREFIX}grad_norm",
                                        float("nan"))),
            "update_ratio": float(vals.get(f"{HEALTH_PREFIX}update_ratio",
                                           float("nan"))),
        }
        if group_norms:
            fields["group_norms"] = [float(v) for v in group_norms]
        if comp:
            fields["compression_error"] = [float(v) for v in comp]
        self._emit_event("health", **fields)
        det = self._health_detector
        if det is None:
            return
        for a in det.observe(loss=fields["loss"],
                             grad_norm=fields["grad_norm"],
                             compression_errors=comp or None):
            self.log.warning(
                "health %s: %s alarm (value %.3g vs band %.3g) at iter %d",
                "RAISED" if a.active else "cleared", a.kind, a.value,
                a.band, it,
            )
            self._emit_event("health_alarm", kind=a.kind, step=int(it),
                             value=float(a.value), band=float(a.band),
                             active=bool(a.active), group=int(a.group))

    def _reset_health_detector(self) -> None:
        """After a rollback: resolve raised alarms and forget the
        baselines (they describe a model that is gone)."""
        det = self._health_detector
        if det is None:
            return
        for a in det.clear_alarms():
            self._emit_event("health_alarm", kind=a.kind,
                             step=int(self.iteration), value=float(a.value),
                             band=float(a.band), active=False,
                             group=int(a.group))
        det.reset()

    def _scope_comparable_predictions(self) -> tuple[list, list]:
        """(predicted seconds, bytes) per group, comparable with the time
        a trace attributes to the group's ``mgwfbp_groupNNNN`` range. On
        hier the cross-slice all-reduces have ranges of their own
        (``mgwfbp_dcngroupNNNN``), so a group's range holds its inner
        legs only and its prediction is theirs (a whole-collective one
        would read as drift on a perfectly calibrated model); on every
        other lowering the range covers the whole collective."""
        from mgwfbp_tpu_torch.telemetry import group_comm_times

        predicted, nbytes, _ = group_comm_times(self.reducer,
                                                self.cost_model)
        if self.reducer.comm_op == "hier" and is_two_level(self.cost_model):
            rs_c, _, ag_c = two_level_leg_costs(self.cost_model)
            predicted = [rs_c(b) + ag_c(b) for b in nbytes]
        return predicted, nbytes

    def _observe_drift_window(self, step_s: float) -> None:
        """One log window's step time into the drift detector, and the
        per-group comm against the cost model: absolute against measured
        group times once a trace gave them, else baseline-relative against
        the step's non-backward share (measured tb only). Alarm edges
        become ``drift_alarm`` records."""
        det = self._drift_detector
        if det is None or step_s <= 0.0:
            return
        if not self._drift_window_seen:
            # the first window holds the first step's one-off start-up
            self._drift_window_seen = True
            return
        alarms = list(det.observe_step_window(step_s))
        if self.reducer is not None and self.cost_model is not None:
            predicted, _ = self._scope_comparable_predictions()
            measured = self._measured_group_times
            if measured is not None and len(measured) == len(predicted):
                alarms += det.observe_comm(predicted, measured_s=measured)
            elif self.tb is not None:
                measured_total = step_s - float(sum(self.tb))
                if measured_total > 0.0:
                    alarms += det.observe_comm(
                        predicted, measured_total_s=measured_total)
        for a in alarms:
            self.log.warning(
                "drift %s: %s alarm (residual %.3g vs band %.3g%s)",
                "RAISED" if a.active else "cleared", a.kind, a.residual,
                a.band, f", group {a.group}" if a.group >= 0 else "",
            )
            self._emit_event("drift_alarm", kind=a.kind,
                             step=int(self.iteration),
                             residual=float(a.residual), band=float(a.band),
                             active=bool(a.active), group=int(a.group))
            if a.active and self._drift_reautotune_enabled:
                self._drift_reautotune_pending = True

    def _maybe_straggler_probe(self) -> None:
        """At every agree-interval step of a group, gather each process's
        local busy seconds per step since the last probe
        (``coordination.gather_values``, a collective every process
        reaches) and name a process consistently slower than the fastest
        (``straggler`` records, identical on every process)."""
        if not self._straggler_enabled or self.world == 1:
            return
        if self.iteration % self._agree_interval != 0:
            return
        steps = self.iteration - self._probe_iter
        if steps <= 0:
            return
        local = (self._local_busy_s - self._probe_busy) / steps
        self._probe_iter = self.iteration
        self._probe_busy = self._local_busy_s
        alarm = self._straggler_detector.observe(coord.gather_values(local))
        if alarm is None:
            return
        self.log.warning(
            "straggler %s: process %d is %.4g s/step slower than the "
            "fastest (%.4g vs %.4g)",
            "RAISED" if alarm.active else "cleared", alarm.slow_process,
            alarm.excess_s, alarm.step_s_max, alarm.step_s_min,
        )
        self._emit_event(
            "straggler", step=int(self.iteration),
            slow_process=int(alarm.slow_process),
            excess_s=float(alarm.excess_s),
            step_s_max=float(alarm.step_s_max),
            step_s_min=float(alarm.step_s_min), active=bool(alarm.active),
        )

    def _maybe_profile_window(self, epoch: int) -> None:
        """Take an armed /profile request at this step boundary. One
        process: every step. Several: the window's steps are collective
        steps every process must enter together, so at every
        agree-interval step the group gathers its locally armed step
        counts (the gate reads group-uniform state only) and runs the
        agreed maximum. The HTTP handler never runs the window."""
        if self.config.metrics_port is None:
            return
        agg = self._metrics_agg
        if self.world == 1:
            req = agg.take_profile_request() if agg is not None else None
            if req:
                self._run_profile_window(int(req), epoch)
            return
        if self.iteration % self._agree_interval != 0:
            return
        local = float((agg.take_profile_request() or 0)
                      if agg is not None else 0)
        steps = int(max(coord.gather_values(local)))
        if steps > 0:
            self._run_profile_window(steps, epoch)

    def _window_batches(self):
        """Endless stacked train batches for a profile window, from a
        reserved epoch range far above any training epoch: the window's
        steps are extra genuine steps, not a replay of the epoch's
        stream (which ``load_batch`` reads as a pure function of the
        epoch and the batch index)."""
        n = self.config.nsteps_update
        per_epoch = max(self.bundle.num_batches_per_epoch, 1)
        k = getattr(self, "_window_batch_index", 0)
        while True:
            micro = []
            for _ in range(n):
                micro.append(batch_fields(self.bundle.train.load_batch(
                    (1 << 20) + k // per_epoch, k % per_epoch)))
                k += 1
            self._window_batch_index = k
            yield [_stack(list(f)) for f in zip(*micro)]

    def _run_profile_window(self, steps: int, epoch: int) -> None:
        """Trace ``steps`` genuine optimizer steps under torch.profiler,
        write the Chrome trace under ``<logdir>/<tag>/profile/iterNNNNNNNN``
        (``trace.json``; ``trace.pN.json`` for process N of a group),
        attribute per-group device time (``profiling.trace_group_times``),
        gather it across processes (a zero row where a process attributed
        nothing: the lockstep shape), add each group's median
        ``ready_to_done_ms`` and ``after_backward_ms`` and the window's
        median ``comm_tail_ms`` from the span recorder's marks
        (``telemetry.spans``: the window's steps run under the profiler,
        so the recorder is armed), hand the result to the aggregator and
        emit a ``profile`` record. The window synchronises the card;
        it runs on demand only, under the watchdog's compile allowance.
        The JAX trainer's join with the compiled step's HLO text has no
        counterpart (there is no HLO here)."""
        from mgwfbp_tpu_torch.telemetry.serve import PROFILE_MAX_STEPS

        steps = max(1, min(int(steps), PROFILE_MAX_STEPS))
        agg = self._metrics_agg
        num_groups = self.reducer.num_groups if self.reducer is not None else 0
        trace_dir = None
        if self.config.logdir:
            trace_dir = os.path.join(self.config.logdir, self.config.tag(),
                                     "profile", f"iter{self.iteration:08d}")
            try:
                os.makedirs(trace_dir, exist_ok=True)
            except OSError as e:
                self.log.warning("profile: cannot create %s (%s); the trace "
                                 "will not be kept", trace_dir, e)
                trace_dir = None
        # the loop's queued steps first: the window's own metrics are not
        # a step of the loop's and are dropped. The drain may end a bad
        # streak in a rollback (group-uniform: every rank raises here);
        # the taken request then fails, so /profile can be armed again
        try:
            self._drain_pending()
        except _RollbackRequested as rb:
            if agg is not None:
                agg.fail_profile(f"rolled back after {rb.bad_steps} bad "
                                 "step(s) before the window began")
            raise
        self.log.info("profile window: tracing %d live step(s) at iter %d%s",
                      steps, self.iteration,
                      f" -> {trace_dir}" if trace_dir else "")
        self._beat(f"profile window ({steps} steps)",
                   allow_s=COMPILE_ALLOW_S)
        batches = self._window_batches()

        def run():
            for _ in range(steps):
                self.step_batch(*self._to_device(*next(batches)))
                # each window step is a genuine optimizer step
                self.iteration += 1
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        from mgwfbp_tpu_torch.profiling import trace_group_rows, trace_group_times

        # every process of a group writes its own trace into the window's
        # directory
        trace_name = (f"trace.p{self.rank}.json" if self.world > 1
                      else "trace.json")
        t0 = time.perf_counter()
        try:
            if num_groups:
                measured = trace_group_times(run, num_groups, iters=steps,
                                             logdir=trace_dir,
                                             trace_name=trace_name)
            else:
                trace_group_rows(run, logdir=trace_dir, trace_name=trace_name)
                measured = None
        except Exception as e:  # noqa: BLE001 — observability must never
            # kill the run it observes
            self.log.warning("profile window failed (%s)", e)
            if agg is not None:
                agg.fail_profile(str(e))
            return
        finally:
            self._beat("profile window done")
        wall_s = time.perf_counter() - t0
        attribution = "trace" if measured is not None else "none"
        # the window's steps ran under the profiler, so the span recorder
        # marked each group's ready and done events (``telemetry.spans``)
        marked, tail_ms = spans.group_medians(spans.recent_steps(steps))
        groups_doc: list[dict] = []
        if self.reducer is not None:
            predicted = nbytes = None
            if self.cost_model is not None:
                predicted, nbytes = self._scope_comparable_predictions()
            layout = self.reducer.layout
            for gi in range(num_groups):
                row = {"group": gi,
                       "nbytes": int(layout.group_sizes[gi])
                       * int(layout.dtypes[gi].itemsize)}
                if predicted is not None:
                    row["predicted_s"] = float(predicted[gi])
                if measured is not None:
                    row["device_s"] = float(measured[gi])
                row.update(marked.get(gi, {}))
                groups_doc.append(row)
        per_process = None
        if self.world > 1 and num_groups:
            row = ([float(t) for t in measured]
                   if measured is not None and len(measured) == num_groups
                   else [0.0] * num_groups)
            per_process = coord.gather_vectors(row)
        if measured is not None and len(measured) == num_groups:
            # the drift detector's comm channel turns absolute
            self._measured_group_times = [float(t) for t in measured]
        result = {
            "steps": int(steps),
            "iteration": int(self.iteration),
            "wall_s": float(wall_s),
            "attribution": attribution,
            "trace_dir": trace_dir,
            "groups": groups_doc,
            "comm_tail_ms": tail_ms,
        }
        if per_process is not None:
            result["per_process_device_s"] = {
                str(pi): [float(t) for t in vec]
                for pi, vec in enumerate(per_process)
            }
        if agg is not None:
            agg.set_profile_result(result)
        self._emit_event(
            "profile", step=int(self.iteration), steps=int(steps),
            attribution=attribution,
            device_s=[float(t) for t in measured] if measured is not None
            else [], trace_dir=trace_dir or "",
        )
        self.log.info("profile window done: %d step(s) in %.3g s, "
                      "attribution=%s", steps, wall_s, attribution)

    # ------------------------------------------------------------------
    # Closed-loop schedule autotuning (the JAX trainer's): the verified
    # race on the live job, the refit, the commit and the schedule cache,
    # the hot swap through the checkpoints' interchange form, and drift's
    # forced re-race.
    # ------------------------------------------------------------------

    def autotune(self, steps_per_candidate: Optional[int] = None,
                 force: bool = False) -> Optional[dict]:
        """Close the solver's loop on the live job (the JAX trainer's
        ``autotune``): race verified candidate schedules for warmup + k
        real training steps each (no step is paused or lost), refit the
        cost model from the measurements, re-solve once, and commit the
        measured argmin, persisting it in the schedule cache under
        ``parallel.autotune.cache_key``. A later run with the same key
        installs the committed schedule and skips the race.

        Returns the report (also ``self.autotune_report``), or None when
        there is nothing to tune (no reducer: one process, or policy none).
        ``force=True`` re-races even on a cache hit (drift's re-race: the
        entry describes a model the detector just called stale) and the
        winner overwrites the entry; it must be group-uniform, as the drift
        trigger's agree_any makes it. Every process of the group runs the
        same sequence of candidates in lockstep: the candidates derive from
        identical inputs (tb and tf are process 0's, the cost model is
        resolved alike), and only the wall-clock timings are per process,
        reduced to one agreed vector before anything reads them."""
        from mgwfbp_tpu_torch.parallel import autotune as at
        from mgwfbp_tpu_torch.parallel.costmodel import (
            refit_from_observations,
            refit_two_level_from_observations,
        )
        from mgwfbp_tpu_torch.parallel.solver import build_schedule

        cfg = self.config
        if self.reducer is None:
            self.log.info(
                "autotune: nothing to tune (no merged reducer: policy %r or "
                "single device)", cfg.policy,
            )
            return None
        if self.world > 1:
            self.log.info(
                "autotune: multi-process race — per-candidate timings will "
                "be reduced to a cross-process argmin before commit"
            )
        key, path = self._schedule_cache_path()
        entry = at.load_cache_entry(path)
        names_now = list(self.reducer.schedule.layer_names)
        cache_hit = (not force and entry is not None
                     and entry.get("layer_names") == names_now)
        if self.world > 1:
            # the cache is file-system state: a hit counts only when every
            # process has it, else all race together
            cache_hit = coord.agree_all(cache_hit)
        if cache_hit:
            groups, entry_dcn = self._install_entry(entry, "autotune-cache")
            self.log.info(
                "autotune: cache hit %s — committed schedule loaded (%d "
                "groups, comm_op=%s), race skipped", path, len(groups),
                entry["comm_op"],
            )
            mgt = entry.get("measured_group_times")
            if mgt:
                # the entry's trace-attributed group times describe the
                # schedule just installed
                self._measured_group_times = [float(t) for t in mgt]
            self._emit_event(
                "autotune_commit", winner=str(entry.get("winner")),
                comm_op=str(entry["comm_op"]), num_groups=len(groups),
                source="cache",
            )
            self.autotune_report = {
                "source": "cache", "cache_path": path,
                "comm_op": entry["comm_op"],
                "groups": [list(g) for g in groups],
                "dcn_groups": [list(d) for d in entry_dcn or ()],
                "winner": entry.get("winner"),
            }
            return self.autotune_report
        if entry is not None:
            if force:
                self.log.info("autotune: forced re-race — committed entry "
                              "%s will be overwritten by the new winner",
                              path)
            else:
                self.log.warning("autotune: cache entry %s was tuned for a "
                                 "different parameter set; re-tuning", path)

        # ---- frontier ------------------------------------------------
        specs = self._layer_specs()
        # mgwfbp: group-uniform -- the cost model is the configured prior or the broadcast-identical profile; refits solve from the agreed observations
        cost_model = self.cost_model
        tb = (list(self.tb) if self.tb is not None
              else size_prior_tb(specs, cost_model))
        tf = list(self._tf_cache) if self._tf_cache is not None else None
        # a sparsifying compressor replaces the bucket collective: only
        # the configured all_reduce path races under it
        comm_ops = (
            ("all_reduce",) if self._compressor is not None
            # hier candidates need the (ici, dcn) mesh and no seq ring
            else at.allowed_comm_ops(
                cfg.comm_op,
                multi_slice=cfg.dcn_slices > 1 and self.seq_group is None)
        )
        candidates = at.build_candidates(
            specs, tb, cost_model, comm_ops, tf=tf,
            max_candidates=max(int(cfg.autotune_candidates), 1),
            incumbent=(self.reducer.schedule.groups, cfg.comm_op,
                       self.reducer.schedule.dcn_groups),
        )
        steps = max(int(steps_per_candidate if steps_per_candidate
                        is not None else cfg.autotune_steps), 1)
        self.log.info(
            "autotune: racing %d candidate(s), %d timed step(s) each "
            "(cache key %s)", len(candidates), steps, key,
        )
        # the loop's queued steps first; the race's own metrics are not
        # the loop's (only their losses are kept, read after the race)
        self._drain_pending()
        t_race = time.perf_counter()
        self._race_losses = []
        self._gate_log = []
        original = self.reducer
        batch_iter = self._autotune_batches()
        try:
            # burn-in on the incumbent: the process's first real steps carry
            # one-off host warm-up that would bias whichever candidate races
            # first; they are genuine training steps all the same
            for _ in range(2):
                self._apply_train_step(next(batch_iter))
            entries = []
            raced_shapes: set = set()
            for c in candidates:
                e = self._race_candidate(c, batch_iter, steps)
                entries.append(e)
                # both the requested and the issued (post-layout) shape: the
                # refit re-solve emits pre-layout groups
                raced_shapes.add((c.comm_op, tuple(map(tuple, c.groups)),
                                  tuple(map(tuple, c.dcn_groups))))
                raced_shapes.add((e.comm_op, tuple(map(tuple, e.groups)),
                                  tuple(map(tuple, e.dcn_groups))))
            # every process reads the same agreed times from here on
            self._sync_entry_times(entries)

            # ---- refit from observations + one re-solve ------------------
            refit_info = None
            measured_groups = None
            traced_schedule = None
            timed = [e for e in entries if e.measured_step_s is not None]
            if timed and cost_model is not None:
                best = min(timed, key=lambda e: e.measured_step_s)
                if not self._reducer_is_live(best.groups, best.comm_op,
                                             best.dcn_groups or None):
                    self._swap_reducer(self._reducer_for(
                        best.groups, best.comm_op,
                        detail=f"autotune:{best.label}",
                        dcn_groups=best.dcn_groups or None,
                    ))
                total_bytes = float(sum(s.nbytes for s in specs))
                # mgwfbp: group-uniform -- on several processes the observations are step deltas of the agreed entry times (_sync_entry_times); traces refit only a one-process run
                observed = self._group_observations(
                    batch_iter, entries, total_bytes, float(sum(tb)))
                obs, obs_source, measured_groups, dcn_obs = observed
                # whose groups a trace's per-group seconds belong to
                traced_schedule = (
                    self.reducer.comm_op,
                    tuple(map(tuple, self.reducer.layout.groups)),
                    tuple(map(tuple, self.reducer.schedule.dcn_groups)),
                )
                if len(obs) >= 2:
                    try:
                        if is_two_level(cost_model):
                            # a two-level model stays two-level: the hier
                            # lowering's group ranges time the inner legs
                            # alone (trace, with the DCN ranges' own samples);
                            # step deltas and a flat lowering's ranges are
                            # whole-collective and rescale both links
                            if (obs_source == "trace"
                                    and self.reducer.comm_op == "hier"):
                                new_model = refit_two_level_from_observations(
                                    cost_model, [], ici_observations=obs,
                                    dcn_observations=dcn_obs,
                                )
                            else:
                                new_model = refit_two_level_from_observations(
                                    cost_model, obs)
                        else:
                            new_model = refit_from_observations(
                                cost_model, obs, cfg.comm_op)
                    except ValueError as e:
                        self.log.info("autotune: refit skipped (%s)", e)
                    else:
                        refit_info = {
                            "before": at.model_summary(cost_model),
                            "after": at.model_summary(new_model),
                            "source": obs_source,
                            "observations": [[float(b), float(t)]
                                             for b, t in obs],
                        }
                        self.cost_model = new_model
                        # mgwfbp: group-uniform -- a pure re-solve of the uniform specs, profile and refit model
                        resolved = build_schedule(
                            specs, tb, tf=tf, policy="auto",
                            cost_model=new_model, comm_op=cfg.comm_op,
                        )
                        shape = tuple(tuple(g) for g in resolved.groups)
                        dcn_shape = tuple(
                            tuple(d) for d in resolved.dcn_groups)
                        if (cfg.comm_op, shape, dcn_shape) not in raced_shapes:
                            cand = at.Candidate(
                                label=(f"{cfg.comm_op}:refit->"
                                       f"{resolved.policy_detail or 'auto'}"),
                                groups=shape, comm_op=cfg.comm_op,
                                predicted_total_s=float(
                                    resolved.predicted_total_time),
                                dcn_groups=dcn_shape,
                            )
                            entries.append(self._race_candidate(
                                cand, batch_iter, steps))
        finally:
            batch_iter.close()  # stops its prefetch
        # the re-solve may have raced one more candidate (idempotent for
        # the entries already agreed)
        self._sync_entry_times(entries)
        timed = [e for e in entries if e.measured_step_s is not None]
        race_s = time.perf_counter() - t_race
        losses, self._race_losses = self._race_losses, None
        # the race's losses: one read, after its timed windows
        losses = torch.stack(losses).tolist() if losses else []

        # ---- commit the measured argmin + persist --------------------
        if not timed:
            self.log.warning("autotune: no candidate survived verification/"
                             "racing; keeping the solved schedule")
            if self.reducer is not original:
                self._swap_reducer(original)
            for e in entries:
                self._emit_event("autotune_race", **e.to_json())
            self.autotune_report = {
                "source": "race", "cache_path": None,
                "race": [e.to_json() for e in entries],
                "gate": self._gate_log, "race_s": race_s,
                "losses": losses,
            }
            return self.autotune_report
        winner = min(timed, key=lambda e: e.measured_step_s)
        if measured_groups is not None and traced_schedule != (
            winner.comm_op, tuple(map(tuple, winner.groups)),
            tuple(map(tuple, winner.dcn_groups)),
        ):
            measured_groups = None  # traced another schedule's groups
        if not self._reducer_is_live(winner.groups, winner.comm_op,
                                     winner.dcn_groups or None):
            self._swap_reducer(self._reducer_for(
                winner.groups, winner.comm_op,
                detail=f"autotune:{winner.label}",
                dcn_groups=winner.dcn_groups or None,
            ))
        cache_entry = {
            "key": key,
            "model": cfg.dnn,
            "world": self.world,
            "comm_op": winner.comm_op,
            "dtype": cfg.dtype,
            "layer_names": names_now,
            "winner": winner.label,
            "groups": [list(g) for g in winner.groups],
            "dcn_groups": [list(d) for d in winner.dcn_groups],
            "measured_step_s": winner.measured_step_s,
            "tb_source": (getattr(self.tb, "source", "volume-prior")
                          if self.tb is not None else "size-prior"),
            "race": [e.to_json() for e in entries],
            "refit": refit_info,
            "solved_group_times": [
                [int(b), float(t)]
                for b, t in self.reducer.schedule.predicted_group_times
            ],
            "measured_group_times": measured_groups,
        }
        if self.rank == 0:
            # one writer: the cache file is shared state (a miss re-races,
            # and a hit needs every process's agreement)
            at.save_cache_entry(path, cache_entry)
        self._measured_group_times = (
            [float(t) for t in measured_groups]
            if measured_groups is not None else None)
        for e in entries:
            self._emit_event("autotune_race", **e.to_json())
        self._emit_event("autotune_commit", winner=winner.label,
                         comm_op=winner.comm_op,
                         num_groups=len(winner.groups), source="race")
        self.log.info(
            "autotune: committed %s (%d groups, comm_op=%s, %.4g s/step) "
            "-> %s", winner.label, len(winner.groups), winner.comm_op,
            winner.measured_step_s, path,
        )
        self.autotune_report = {
            "source": "race", "cache_path": path,
            **{k: cache_entry[k] for k in (
                "winner", "groups", "dcn_groups", "comm_op",
                "measured_step_s", "race", "refit")},
            "gate": self._gate_log, "race_s": race_s,
            "losses": losses,
        }
        return self.autotune_report

    def _schedule_cache_path(self) -> tuple[str, str]:
        """(key, entry path) of this run's schedule-cache entry: the
        configured lowering, model, world and numerics
        (``parallel.autotune.cache_key``) under ``config.schedule_cache``
        (default ``profiles/schedule_cache``)."""
        from mgwfbp_tpu_torch.parallel import autotune as at

        cfg = self.config
        cache_dir = cfg.schedule_cache or os.path.join("profiles",
                                                       "schedule_cache")
        key = at.cache_key(
            cfg.dnn, self.world, cfg.comm_op, cfg.dtype,
            comm_dtype=cfg.comm_dtype, compressor=cfg.compressor,
            density=cfg.density, batch_size=cfg.batch_size,
            nsteps_update=cfg.nsteps_update, dcn_slices=cfg.dcn_slices,
        )
        return key, at.entry_path(cache_dir, key)

    def _cached_schedule_entry(self) -> Optional[tuple[dict, str]]:
        """(entry, path) of a committed schedule for this run's cache key
        whose layer set matches the live model, else None (an unreadable
        entry is logged): the cross-world resume consults it before
        settling for the freshly solved schedule."""
        from mgwfbp_tpu_torch.parallel import autotune as at

        if self.reducer is None:
            return None
        _, path = self._schedule_cache_path()
        try:
            entry = at.load_cache_entry(path)
        except ValueError as e:
            self.log.warning("schedule cache entry unreadable: %s", e)
            return None
        if entry is None or entry.get("layer_names") != list(
                self.reducer.schedule.layer_names):
            return None
        return entry, path

    def _install_cached_schedule(self) -> bool:
        """Install the cached schedule of this run's key when every process
        has one (``_cached_schedule_entry``); True when it is live."""
        cached = self._cached_schedule_entry()
        if not coord.agree_all(cached is not None):
            return False
        entry, path = cached
        self._install_entry(entry, "schedule-cache")
        self.log.info("tuned schedule loaded from %s (%d groups, comm_op=%s)",
                      path, self.reducer.num_groups, self.reducer.comm_op)
        return True

    def _install_entry(self, entry: dict, source: str) -> tuple:
        """Make a committed cache entry's schedule live (nothing to do when
        it is already); returns its (groups, DCN groups or None)."""
        groups = tuple(tuple(int(i) for i in g) for g in entry["groups"])
        dcn = tuple(tuple(int(i) for i in d)
                    for d in entry.get("dcn_groups") or ()) or None
        if not self._reducer_is_live(groups, entry["comm_op"], dcn):
            self._swap_reducer(self._reducer_for(
                groups, entry["comm_op"],
                detail=f"{source}:{entry.get('winner', 'winner')}",
                dcn_groups=dcn,
            ))
        return groups, dcn

    def _sync_entry_times(self, entries) -> None:
        """Replace each race entry's time with the group-agreed one, its
        maximum over the processes (a synchronous group runs at its
        straggler's pace; unmeasured anywhere -> None), so the argmin, the
        refit's inputs and the cache entry are identical everywhere. No-op
        on one process and on an empty race."""
        if self.world == 1 or not entries:
            return
        idx, reduced = coord.all_argmin([e.measured_step_s for e in entries])
        for e, t in zip(entries, reduced):
            e.measured_step_s = float(t) if np.isfinite(t) else None
        self.log.info("autotune: cross-process argmin -> candidate %d (%s)",
                      idx, entries[idx].label)

    def _reducer_for(self, groups, comm_op: str, detail: str = "",
                     dcn_groups=None):
        """A reducer of an explicit grouping (a raced candidate, a cache
        hit) with the live cost model, tb, tf, wire dtype, compressor and
        process groups, its hooks not attached (``_swap_reducer`` attaches
        them). For hier, ``dcn_groups`` is the outer partition (None: one
        cross-slice all-reduce per group)."""
        cfg = self.config
        reducer = make_merged_allreduce(
            self.model, policy="auto", tb=self.tb, tf=self._tf_cache,
            cost_model=self.cost_model,
            comm_dtype=getattr(torch, cfg.comm_dtype) if cfg.comm_dtype
            else None,
            comm_op=comm_op, compressor=self._compressor,
            optim_spec=self.optim_spec if comm_op in SHARDED_OPS else None,
            world_size=self.world,
            levels=self._two_level() if comm_op == "hier" else None,
            groups=groups,
            dcn_groups=dcn_groups if comm_op == "hier" else None,
            policy_detail=detail,
        )
        reducer.detach()
        return reducer

    def _reducer_is_live(self, groups, comm_op: str, dcn_groups=None) -> bool:
        """True when the live reducer already issues exactly this schedule
        (the same lowering and groups, and for hier the same outer
        partition): rebuilding it would only cost a state round trip."""
        live = self.reducer
        shape = tuple(tuple(int(i) for i in g) for g in groups)
        if comm_op != live.comm_op or shape not in (
            tuple(map(tuple, live.layout.groups)),
            tuple(map(tuple, live.schedule.groups)),
        ):
            return False
        if comm_op == "hier" and dcn_groups is not None:
            want = tuple(tuple(int(i) for i in d) for d in dcn_groups)
            live_dcn = live.schedule.dcn_groups or tuple(
                tuple(d) for d in singleton_dcn_groups(len(shape)))
            if want != live_dcn:
                return False
        return True

    def _interchange_state(self) -> TrainState:
        """The live train state in the form a checkpoint holds
        (``TrainState``: parameters and batch statistics in Flax layout,
        the optimizer as the optax tree), in host memory: what a schedule
        swap carries from one reducer to another. On rs_opt_ag and
        rs_fwd_ag a collective: the sharded optimizer state is gathered
        (and rs_fwd_ag's parameters materialized first)."""
        self._materialize()
        paths, trace_paths, count_path = self._opt_layout()
        step = int(self.train_step.step)
        opt: dict = {}
        if self._sharded_opt:
            state = self.reducer.opt_state
            slots = self.reducer.optim.gather(state)
            to_flax = [rule[1] for rule in _param_rules(self.model).values()]
            if trace_paths:
                opt = {tp: f(torch.from_numpy(a)).contiguous().numpy()
                       for tp, f, a in zip(trace_paths, to_flax, slots[0])}
            count = int(state.count)
        else:
            if trace_paths:
                moms = momentum_to_flax(self.model, self.optimizer)
                opt = {tp: moms[p] for p, tp in zip(paths, trace_paths)}
            count = step
        opt[count_path] = np.asarray(count, np.int32)
        return TrainState(step=step,
                          params=host_leaves(self.model, "params"),
                          batch_stats=host_leaves(self.model, "batch_stats"),
                          opt_state=opt)

    def _swap_reducer(self, reducer,
                      state: Optional[TrainState] = None) -> None:
        """Hot-swap the live merge schedule (the JAX trainer's seam): the
        live state in the interchange form, taken under the OLD reducer
        (``state``, when the caller took it already), the old reducer's
        hooks removed and the new one's attached, a train step built over
        it (``_reducer_op`` follows it, and with it the sharded-optimizer
        and cross-step paths) and the state installed onto its layout (the
        sharded optimizer and rs_fwd_ag's carry re-scattered).
        Transactional: if that fails, the old reducer, a step over it and
        the state are put back before the error propagates."""
        old = self.reducer
        if state is None:
            state = self._interchange_state()
        self._measured_group_times = None  # measured under the old schedule
        old.detach()
        try:
            self._go_live(reducer, state)
        except Exception:
            reducer.detach()
            self._go_live(old, state)
            raise
        self._sync_schedule_gauge()
        # the drift detector's baselines described the old schedule
        self._reset_drift_baselines()

    def _go_live(self, reducer, state: TrainState) -> None:
        """Attach ``reducer``, build the train step over it and install
        ``state`` (the optimizer state with it)."""
        self.reducer = reducer.attach()
        self._reducer_op = reducer.comm_op
        self.train_step = self._make_train_step()
        self._install(state)

    def _apply_train_step(self, batch) -> dict:
        """One live train step on stacked host batches (the race's), the
        carry threaded through; a genuine optimizer step (the iteration
        advances), whose health statistics are dropped and whose loss is
        kept on the device (read once, after the race)."""
        metrics = self.step_batch(*self._to_device(*batch))
        for k in [k for k in metrics if k.startswith(HEALTH_PREFIX)]:
            metrics.pop(k)
        self.iteration += 1
        if self._race_losses is not None:
            self._race_losses.append(metrics["loss"])
        return metrics

    def _autotune_batches(self):
        """Endless stacked train batches for the tuning phase: real data,
        read as an epoch reads it (the loader's ``batches``, through the
        prefetch), from a reserved epoch range (1 << 20 on), so the race's
        steps are extra passes over the data, not a replay of an epoch's
        batch sequence. Close it to stop its prefetch."""
        n = self.config.nsteps_update
        epoch = 1 << 20
        while True:
            with contextlib.closing(self.bundle.train.batches(epoch)) as it:
                micro: list = []
                for batch in it:
                    micro.append(batch_fields(batch))
                    if len(micro) == n:
                        yield [_stack(list(f)) for f in zip(*micro)]
                        micro = []
            epoch += 1

    def _verify_live_step(self, batch_iter) -> list:
        """Observe the live reducer's next step (and, on rs_fwd_ag, the
        next forward's gathers) and check it against the reducer
        (``analysis.schedule_check``): the gate every candidate passes
        before it races. The step is a real one; the caller undoes it
        when the gate rejects."""
        from mgwfbp_tpu_torch.analysis.schedule_check import (
            verify_step_against_reducer,
        )

        reducer = self.reducer
        # the observed window starts from current parameters, so that
        # rs_fwd_ag's gathers fall in the next forward
        self._materialize()
        params, _, _ = self._arrival_leaves()
        tag = reducer.schedule.policy_detail or self.config.policy
        findings, records = verify_step_against_reducer(
            lambda: self._apply_train_step(next(batch_iter)), reducer,
            [params[j] for j in reducer.perm], file=f"<live step {tag}>",
        )
        kinds: dict[str, int] = {}
        for r in records:
            kinds[r.kind] = kinds.get(r.kind, 0) + 1
        self._gate_log.append({
            "comm_op": reducer.comm_op, "num_groups": reducer.num_groups,
            "collectives": len(records), "kinds": kinds,
            "threads": sorted({r.thread for r in records}),
            "rules": sorted({f.rule_id for f in findings}),
        })
        return findings

    def _race_candidate(self, cand, batch_iter, steps: int):
        """Verify one candidate, then give it warmup + ``steps`` real
        training steps and record the measured step time. The verifier
        observes the candidate's first step; when it rejects, the state
        from before that step is put back (with the previous reducer), so
        a rejected candidate takes no step."""
        from mgwfbp_tpu_torch.analysis.rules import ERROR
        from mgwfbp_tpu_torch.parallel import autotune as at
        from mgwfbp_tpu_torch.profiling import time_carried_steps

        pred = float(cand.predicted_total_s)
        entry = at.RaceEntry(
            label=cand.label, comm_op=cand.comm_op,
            num_groups=len(cand.groups),
            predicted_total_s=None if pred != pred else pred,
            groups=cand.groups,
        )
        is_live = self._reducer_is_live(cand.groups, cand.comm_op,
                                        cand.dcn_groups or None)
        if is_live:
            reducer = self.reducer
        else:
            try:
                reducer = self._reducer_for(
                    cand.groups, cand.comm_op,
                    detail=f"autotune:{cand.label}",
                    dcn_groups=cand.dcn_groups or None,
                )
            except Exception as e:  # noqa: BLE001 — a bad candidate must
                # not take down the tuning phase; recorded and skipped
                self.log.warning("autotune: candidate %s failed to build: "
                                 "%s", cand.label, e)
                return entry
        # the layout may split dtype-mixed groups: race what is issued
        entry.groups = reducer.layout.groups
        entry.num_groups = reducer.layout.num_groups
        entry.dcn_groups = reducer.schedule.dcn_groups
        self._beat(f"autotune candidate {cand.label}",
                   allow_s=COMPILE_ALLOW_S)
        previous = self.reducer
        before = (self._interchange_state(), self.carry, self.iteration)
        try:
            if not is_live:
                self._swap_reducer(reducer, state=before[0])
            findings = self._verify_live_step(batch_iter)
        except Exception as e:  # noqa: BLE001 — same contract as above
            self.log.warning("autotune: candidate %s failed to swap/verify: "
                             "%s", cand.label, e)
            self._undo_candidate(previous, before)
            return entry
        errors = [f for f in findings if f.severity == ERROR]
        # every process takes the same branch
        if not coord.agree_all(not errors):
            self.log.warning(
                "autotune: candidate %s REJECTED by the schedule verifier "
                "(%s)", cand.label,
                "; ".join(f"{f.rule_id}: {f.message}" for f in errors[:3])
                or "rejected on another process",
            )
            self._undo_candidate(previous, before)
            return entry
        entry.verified = True

        def step_once(state):
            self._apply_train_step(next(batch_iter))
            return state

        try:
            _, dt = time_carried_steps(step_once, None, steps, warmup=1,
                                       device=self.device)
        except Exception as e:  # noqa: BLE001 — a candidate that cannot
            # run its steps is skipped, not fatal: the job trains without it
            self.log.warning("autotune: candidate %s failed during its timed "
                             "steps (%s); skipping", cand.label, e)
            self.reducer.discard()
            return entry
        entry.measured_step_s = float(dt)
        self.log.info(
            "autotune: %s — %d group(s), verified, measured %.4g s/step%s",
            cand.label, entry.num_groups, dt,
            f" (predicted {entry.predicted_total_s:.4g})"
            if entry.predicted_total_s else "",
        )
        return entry

    def _undo_candidate(self, previous, before: tuple) -> None:
        """Put back the reducer and the state from before a candidate's
        observed step: its parameters, batch statistics, optimizer state,
        step counter, carry and iteration."""
        state, carry, iteration = before
        if self.reducer is not previous:
            self._swap_reducer(previous, state=state)
        else:
            self.reducer.discard()
            self._install(state)
        self.carry = carry
        self.iteration = iteration

    def _group_observations(self, batch_iter, entries, total_bytes: float,
                            tb_total: float):
        """(observations, source, measured group times, DCN observations)
        for the cost-model refit (the JAX trainer's). On one process: a
        profiler trace of two more live steps, each group charged its
        range's collective kernel (``profiling.trace_group_times``; on
        hier the DCN ranges too, ``trace_two_level_group_times``, so the
        outer link refits from its own samples). On several processes, as
        always in this package when a reducer exists: step-time deltas
        across the raced schedules (``autotune.step_delta_observations``),
        read from the agreed entry times, so the refit is identical on
        every process (per-process traces are not); the DCN observations
        are then None and a two-level model rescales both links."""
        from mgwfbp_tpu_torch.parallel import autotune as at
        from mgwfbp_tpu_torch.profiling import (
            dcn_shard_nbytes,
            trace_group_times,
            trace_two_level_group_times,
        )

        reducer = self.reducer
        num_groups = reducer.layout.num_groups
        iters = 2

        def run():
            for _ in range(iters):
                self._apply_train_step(next(batch_iter))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        measured = dcn_measured = None
        hier = reducer.comm_op == "hier"
        dcn_part = ([list(d) for d in reducer.schedule.dcn_groups]
                    or [[gi] for gi in range(num_groups)]) if hier else []
        if self.world > 1:
            self.log.info("autotune: multi-process — trace attribution "
                          "skipped, refitting from agreed step deltas")
        else:
            try:
                if hier:
                    measured, dcn_measured = trace_two_level_group_times(
                        run, num_groups, len(dcn_part), iters=iters)
                else:
                    measured = trace_group_times(run, num_groups, iters=iters)
            except Exception as e:  # noqa: BLE001 — profiling must never
                # kill the tuning phase; the step-delta fallback applies
                self.log.info("autotune: group trace failed (%s); using step "
                              "deltas", e)
        dcn_obs = None
        if hier and dcn_measured is not None:
            dcn_bytes = dcn_shard_nbytes(
                reducer.layout, dcn_part,
                self.world // int(self.config.dcn_slices),
                reducer.comm_dtype)
            dcn_obs = list(zip(dcn_bytes, dcn_measured))
        if measured is not None and num_groups >= 2:
            layout = reducer.layout
            nbytes = [int(layout.group_sizes[gi]) * layout.dtypes[gi].itemsize
                      for gi in range(num_groups)]
            return list(zip(nbytes, measured)), "trace", measured, dcn_obs
        if self.tb is None:
            # step deltas subtract the backward's compute from each step;
            # the size prior is a communication estimate, not compute
            self.log.info("autotune: refit skipped — step-delta "
                          "observations need a measured backward profile "
                          "(run without --no-profile-backward)")
            return [], "step-deltas", measured, dcn_obs
        return (at.step_delta_observations(entries, total_bytes, tb_total),
                "step-deltas", measured, dcn_obs)

    def _maybe_drift_reautotune(self) -> None:
        """Fire an armed drift re-race at a deterministic step boundary: on
        several processes every process joins the agreement at every
        agree-interval step (the gate reads group-uniform state only), so
        one process's alarm pulls the group into the same race."""
        if not self._drift_reautotune_enabled:
            return
        if self.world == 1:
            if self._drift_reautotune_pending:
                self._drift_reautotune()
            return
        if self.iteration % self._agree_interval != 0:
            return
        if coord.agree_any(self._drift_reautotune_pending):
            self._drift_reautotune()

    def _drift_reautotune(self) -> None:
        """Re-race the schedule on the live job (``autotune(force=True)``):
        the race re-measures, the refit corrects the cost model and the
        measured argmin replaces the drifted schedule; the detector then
        resets (its residuals described the old model)."""
        self._drift_reautotune_pending = False
        if self.reducer is None:
            return
        self.log.warning("cost-model drift: re-autotuning the merge schedule "
                         "on the live job (MGWFBP_DRIFT_REAUTOTUNE=1)")
        try:
            self.autotune(force=True)
        except _RollbackRequested:
            # the race's first drain ended a bad streak: race after the
            # rollback
            self._drift_reautotune_pending = True
            raise
        self._reset_drift_baselines()

    def _reset_drift_baselines(self) -> None:
        """Resolve raised drift alarms and forget the detector's baselines
        (a re-race installed a corrected model, or a swap changed the
        schedule they described); the next log window is skipped, as the
        run's first is."""
        det = self._drift_detector
        if det is None:
            return
        for a in det.clear_alarms():
            self._emit_event("drift_alarm", kind=a.kind,
                             step=int(self.iteration),
                             residual=float(a.residual), band=float(a.band),
                             active=False, group=int(a.group))
        det.reset()
        self._drift_window_seen = False

    def _start_serve_plane(self) -> None:
        """The in-process serving plane (``serve_shadow``): a ServingModel,
        the reload watcher, the /predict dispatcher and the shadow scorer
        on this process's HTTP plane, hot-reloading the run's committed
        checkpoints on their own threads. One process only (a group serves
        from standalone replicas, ``supervise --serve-replicas``); needs a
        checkpoint directory and the event stream."""
        if not self.config.serve_shadow or self._serve_plane is not None:
            return
        if self.world != 1:
            self.log.warning("--serve-shadow is single-process only "
                             "(standalone replicas serve a group); serving "
                             "disabled")
            return
        if self.checkpointer is None or self.telemetry is None:
            self.log.warning("--serve-shadow needs --checkpoint-dir and "
                             "telemetry; serving disabled")
            return
        from mgwfbp_tpu_torch.serving.model import ServingModel
        from mgwfbp_tpu_torch.serving.plane import ServePlane

        module, meta = zoo.create_model(self.config.dnn,
                                        dataset=self.config.dataset)
        try:
            serving_model = ServingModel(module, meta, device=self.device)
        except ValueError as e:
            self.log.warning("--serve-shadow: %s; serving disabled", e)
            return
        agg = self._metrics_agg
        train_loss_fn = None
        if agg is not None:
            def train_loss_fn():
                v = agg.values().get("mgwfbp_health_loss")
                return float(v) if v is not None else None
        self._serve_plane = ServePlane(
            serving_model, self.ckpt_dir,
            emit=lambda ev, f: self._emit_event(ev, **f),
            server=self._metrics_server, shadow=True,
            train_loss_fn=train_loss_fn,
        )
        self._serve_plane.start()
        self.log.info(
            "serving plane up: hot-reloading committed checkpoints, "
            "shadow-eval on, /predict %s (slot %d)",
            "attached" if self._metrics_server is not None
            else "unattached (no metrics port)", serving_model.max_batch,
        )

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
        self._materialize()
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
        # a ring counts each sample once per member (its loss sums carry
        # the same factor, so the mean is exact): report true samples
        return {"loss": loss, "count": count / self.seq_size,
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
        self._materialize()
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
            "mesh_axes": self._mesh_axes(),
            "comm_op": self.comm_op,
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
        if self._sharded_opt:
            self._sharded_opt_payload(manifest, files)
        if self._cross_step:
            self._sharded_params_payload(manifest, files)
        elif primary:
            for j, a in enumerate(host_leaves(self.model, "params").values()):
                files[f"params.l{j}"] = a
        if primary:
            for j, a in enumerate(
                host_leaves(self.model, "batch_stats").values()
            ):
                files[f"batch_stats.l{j}"] = a
        if primary and not self._sharded_opt:
            if trace_paths:
                moms = momentum_to_flax(self.model, self.optimizer)
                for j, p in enumerate(paths):
                    files[f"opt.l{j}"] = moms[p]
            files[f"opt.l{len(trace_paths)}"] = np.asarray(step, np.int32)
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

    def _mesh_axes(self) -> dict:
        """The extents of the JAX trainer's mesh for this world: (dcn,)
        data, seq."""
        dcn = int(self.config.dcn_slices)
        axes = {"dcn": dcn} if dcn > 1 else {}
        axes.update(data=int(self.data_size // dcn), seq=int(self.seq_size))
        return axes

    def _sharded_opt_payload(self, manifest: dict, files: dict) -> None:
        """The sharded ``opt`` section of an rs_opt_ag run, as the JAX
        trainer writes it: the slots gathered (one all-gather per group
        and slot), each leaf turned to its Flax layout, re-packed onto this
        run's bucket layout, and this rank's row of every group written;
        the manifest gets the layout and each process's rows."""
        reducer = self.reducer
        optim, state = reducer.optim, reducer.opt_state
        to_flax = [rule[1] for rule in _param_rules(self.model).values()]
        for s, leaves in enumerate(optim.gather(state)):
            flax = [f(torch.from_numpy(a)).contiguous().numpy()
                    for f, a in zip(to_flax, leaves)]
            for gi, buf in enumerate(optim.pack_slot(flax)):
                files[f"opt.s{s}.g{gi}"] = np.ascontiguousarray(
                    buf[self.rank:self.rank + 1])
        manifest["world"] = int(optim.world)
        manifest["layout"] = optim.manifest_layout()
        manifest["processes"] = {str(r): {"rows": [r]}
                                 for r in range(optim.world)}
        manifest["opt"] = {"kind": "sharded", "slots": int(optim.num_slots)}
        manifest["meta"]["opt_count"] = int(state.count)

    def _sharded_params_payload(self, manifest: dict, files: dict) -> None:
        """The sharded ``params`` section of an rs_fwd_ag run, as the JAX
        trainer writes its carry: the (materialized) parameters in Flax
        layout packed onto this run's bucket layout, and this rank's row
        of every group (``_sharded_opt_payload`` wrote the layout and the
        rows' owners)."""
        optim = self.reducer.optim
        leaves = list(host_leaves(self.model, "params").values())
        for gi, buf in enumerate(optim.pack_slot(leaves)):
            files[f"params.g{gi}"] = np.ascontiguousarray(
                buf[self.rank:self.rank + 1])
        manifest["params"] = {"kind": "sharded"}

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
        if self._cross_step:
            # the carry re-scattered onto this run's layout and world
            self.reducer.scatter_params()
        if self._sharded_opt:
            self._install_sharded_opt(
                state if optimizer and state.opt_state is not None else None,
                int(state.step))
        elif optimizer and state.opt_state is not None:
            paths, trace_paths, _ = self._opt_layout()
            if trace_paths:
                momentum_from_flax(self.model, self.optimizer, {
                    p: state.opt_state[tp]
                    for p, tp in zip(paths, trace_paths)
                })

    def _install_sharded_opt(self, state: Optional[TrainState],
                             step: int) -> None:
        """Scatter a restored optimizer (the optax tree in Flax layout) onto
        this rank's shards; without one (``--pretrain``, a weights-only
        step) the shards stay as they are and the count takes the
        restored step."""
        reducer = self.reducer
        optim = reducer.optim
        if state is None:
            reducer.opt_state.count = step
            return
        paths, trace_paths, count_path = self._opt_layout()
        rules = _param_rules(self.model)
        slots = [[rules[p][2](torch.from_numpy(np.asarray(
            state.opt_state[tp], np.float32))).contiguous().numpy()
                  for p, tp in zip(paths, trace_paths)]] if trace_paths else []
        count = int(np.asarray(state.opt_state.get(count_path, step)))
        reducer.opt_state = optim.scatter(slots, count, self.rank,
                                          self.device)

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
            # mgwfbp: group-uniform -- the restore step is group-agreed (broadcast / sibling-probe agreement)
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
        # mgwfbp: group-uniform -- checkpoint visibility is uniform on the shared checkpoint FS (the commit barrier publishes the manifest and the sidecar before any process proceeds)
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
            i = parts.index(f"n{self.data_size}")
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
            if world == self.data_size:
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
        parts[parts.index(f"n{self.data_size}")] = f"n{old_world}"
        sibling = os.path.join(self.config.checkpoint_dir, "-".join(parts))
        ckpt = Checkpointer(sibling)
        try:
            snap = self._restore_step(ckpt, step)
        finally:
            ckpt.close()
        # mgwfbp: group-uniform -- the agreed step is read from the shared checkpoint FS, whose commit barrier published it to every process
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
            snap, f"resumed after resize ({old_world} -> {self.data_size})",
            anchor=anchor,
        )
        # a schedule the autotuner committed at this world's key beats the
        # freshly solved one
        source = ("schedule-cache" if self._install_cached_schedule()
                  else "relaunch-reshard")
        restore_s = time.perf_counter() - t0
        self._emit_event(
            "resize", old_world=int(old_world), new_world=int(self.data_size),
            schedule_source=source,
            num_groups=(self.reducer.num_groups
                        if self.reducer is not None else 0),
            iteration=int(snap.iteration), restore_s=float(restore_s),
        )
        self.log.warning(
            "elastic resize: resumed iteration %d from %s (world %d -> %d; "
            "read at the live world in %.3f s)", snap.iteration, sibling,
            old_world, self.data_size, restore_s,
        )
        return True

    def update_nworker(self, nworkers: int) -> None:
        """Elastic worker-count resize (the reference's ``update_nworker``).
        A torch process drives one card, so the in-place re-mesh over one
        process's local devices that the JAX trainer does has no
        counterpart here: at the running world this is a no-op, any other
        count is resize-by-relaunch (``ResizeUnsupported`` carries the
        recipe, as the JAX trainer's multi-process branch raises)."""
        if nworkers == self.data_size:
            return
        if self.config.dcn_slices > 1:
            raise ResizeUnsupported(
                "update_nworker cannot re-mesh a multi-slice (dcn) run in "
                "place; relaunch with new --dcn-slices",
                nworkers,
            )
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
        # mgwfbp: thread-safe -- GIL-atomic bool store; the signal context
        # only ever flips it False, so the worst interleaving with the
        # main-thread arm/disarm pair is one redundant disarm
        self._signals_armed = False

    def _on_preempt_signal(self, signum, frame) -> None:
        # signal context: set the flag; the loop drains at the next step
        # boundary. A second signal before that escalates: disarm (a third
        # kills outright) and interrupt now
        name = _signal.Signals(signum).name
        exit_mark(f"{name} handled at step {self.iteration}")
        if self._preempt_signal is not None:
            self._disarm_signals()
            raise KeyboardInterrupt(
                f"second {name} during preemption drain — escalating "
                "(next signal kills outright)"
            )
        # mgwfbp: thread-safe -- one-word flag store is GIL-atomic; the
        # signal context is the only concurrent writer and the step loop
        # consumes the flag at boundaries, so a lost re-set at worst delays
        # the drain by the one step the escalation path covers
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
        self._pending.clear()  # a drain outranks the bad-step policy
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
        self._pending.clear()  # the queued steps' state is gone
        self._warned_no_rollback = False
        self._apply_snapshot(snap, "rolled back", emit_resume=False)
        self._reset_health_detector()
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
                self._start_serve_plane()
                if cfg.autotune and self.autotune_report is None:
                    # the race takes the first real steps (a cache hit
                    # skips it)
                    self.autotune()
                if self.telemetry is not None and self.reducer is not None \
                        and self._measured_group_times is None:
                    self._trace_group_times()
                metrics = self._fit_epochs(self.start_epoch, end)
                # whoever reads the model after training reads it current
                self._materialize()
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
            if self.writer is not None:
                self.writer.add_scalars("epoch", train_metrics, epoch)
                self.writer.add_scalar(
                    "epoch/lr", float(self.epoch_schedule(float(epoch))),
                    epoch)
            if (epoch + 1) % cfg.eval_every_epochs == 0:
                metrics["eval"] = self.evaluate()
                self.log.info(
                    "epoch %d eval: %s", epoch,
                    ", ".join(f"{k} {v:.4f}" for k, v in metrics["eval"].items()),
                )
                if self.writer is not None:
                    self.writer.add_scalars("eval", metrics["eval"], epoch)
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
        if self._serve_plane is not None:
            self._serve_plane.close()
            self._serve_plane = None
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
        if self.writer is not None:
            self.writer.close()
            self.writer = None
        if self._recorder is not None:
            # a bundle's deferred `postmortem` record lands before the
            # stream closes
            self._recorder.flush_events()
        if self.telemetry is not None:
            self.telemetry.close()
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None
