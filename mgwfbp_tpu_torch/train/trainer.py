"""The trainer (counterpart of the ``all_reduce`` training path of
``mgwfbp_tpu/train/trainer.py``): loaders, model, optimizer, the merged
all-reduce and its backward profile, the train/eval loop and step commits,
for classifiers and language models. A model with a BPTT carry (the LSTM)
starts each epoch, and each evaluation, from a zero carry and threads it
through the steps; the transformer trains through dense attention, as the
JAX package trains it (``models.for_training``).

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
(``telemetry/overlap.py``). Resume, preemption, rollback, autotune, the
rest of the telemetry plane, the serving shadow and elastic resize are not
ported (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from mgwfbp_tpu_torch import models as zoo
from mgwfbp_tpu_torch.checkpoint import save_replicated_step
from mgwfbp_tpu_torch.config import TrainConfig
from mgwfbp_tpu_torch.convert import flax_leaves, keystr, variables_to_flax
from mgwfbp_tpu_torch.data import ShardInfo, data_prepare
from mgwfbp_tpu_torch.models.common import init_weights
from mgwfbp_tpu_torch.optim import make_optimizer, scaled_clip_threshold
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
    eval_sums,
    forward_loss,
    lm_eval_sums,
)
from mgwfbp_tpu_torch.utils.device import resolve_device, set_matmul_precision
from mgwfbp_tpu_torch.utils.logging import get_logger


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
        self.telemetry = self._open_telemetry()
        self._measured_group_times: Optional[list[float]] = None
        self.shard = ShardInfo(self.rank, self.world)
        self.bundle = data_prepare(
            config.dataset, data_dir=config.data_dir,
            batch_size=config.batch_size, shard=self.shard, seed=config.seed,
            synthetic=synthetic_data, augment=config.augment,
            num_steps=config.num_steps,
        )
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
        self.ckpt_dir = (
            os.path.join(config.checkpoint_dir, config.tag())
            if config.checkpoint_dir else None
        )
        self.start_epoch = 0
        self.iteration = 0
        self.losses: list[float] = []  # every optimizer step's mean loss

    # ------------------------------------------------------------------
    def _open_telemetry(self) -> Optional[EventWriter]:
        cfg = self.config
        if not cfg.telemetry:
            return None
        tel_dir = cfg.telemetry_dir or (
            os.path.join(cfg.logdir, cfg.tag()) if cfg.logdir else None
        )
        if tel_dir is None:
            self.log.warning("telemetry requested but neither telemetry_dir "
                             "nor logdir is set; telemetry disabled")
            return None
        return EventWriter(
            os.path.join(tel_dir, stream_filename(self.rank, self.world)),
            run={
                "model": cfg.dnn, "dataset": cfg.dataset,
                "world": self.world, "comm_op": "all_reduce",
                "policy": cfg.policy, "tag": cfg.tag(),
                "process_index": self.rank, "process_count": self.world,
                "device": str(self.device),
            },
        )

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

    def step_batch(self, x: torch.Tensor, y: torch.Tensor) -> dict:
        """One optimizer step on device batches; a carry model threads
        ``self.carry`` through it."""
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

    def _to_device(self, x: np.ndarray, y: np.ndarray):
        """Numpy batches (leading micro-step axis optional) -> tensors on
        the card: NHWC images become NCHW float32, permuted there; tokens
        stay (B, T); labels and targets become int64."""
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(
            self.device, non_blocking=True
        )
        yt = torch.from_numpy(np.asarray(y, np.int64)).to(
            self.device, non_blocking=True
        )
        if self.meta.task == "lm":
            return xt, yt
        return xt.movedim(-1, -3).contiguous(), yt

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
        x, y = self.bundle.train.load_batch(0, 0)
        x, y = self._to_device(x, y)
        params, perm, names = self._arrival_leaves()
        carry = self._zero_carry()

        def loss_of():
            return forward_loss(self.model, self.meta.task, x, y, carry,
                                self.compute_dtype)[0]

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
        # a fresh hidden state each epoch, carried across its steps
        self.carry = self._zero_carry()
        n = cfg.nsteps_update
        micro: list = []
        epoch_pos = 0
        max_steps = cfg.num_batches_per_epoch or None
        log_interval = int(os.environ.get("MGWFBP_LOG_INTERVAL", "10"))
        metrics: dict = {}
        first_loss = None
        t_epoch = t_window = time.time()
        for xb, yb in loader:
            micro.append((xb, yb))
            if len(micro) < n:
                continue
            x, y = self._to_device(
                np.stack([m[0] for m in micro]), np.stack([m[1] for m in micro])
            )
            micro = []
            t_step = self.telemetry.now() if self.telemetry else 0.0
            metrics = self.step_batch(x, y)
            self.iteration += 1
            if self.telemetry is not None:
                self.telemetry.emit(
                    "step", step=self.iteration, epoch=int(epoch),
                    start_s=t_step, dur_s=self.telemetry.now() - t_step,
                    **self._lm_fields(metrics),
                )
            epoch_pos += 1
            self.losses.append(metrics["loss"])
            if first_loss is None:
                first_loss = metrics["loss"]
            if metrics["grads_nonfinite"]:
                self.log.warning(
                    "step %d: %g non-finite gradient values; update skipped",
                    self.iteration, metrics["grads_nonfinite"],
                )
            if self.iteration % log_interval == 0:
                dt = (time.time() - t_window) / log_interval
                metric = self.train_step.metric
                self.log.info(
                    "epoch %d iter %d: loss %.4f, %s %.4f | %.4f "
                    "s/iter, %.1f samples/s", epoch, self.iteration,
                    metrics["loss"], metric, metrics[metric], dt,
                    cfg.batch_size * self.world * n / dt,
                )
                t_window = time.time()
            if max_steps is not None and epoch_pos >= max_steps:
                break
        if micro:
            self.log.info(
                "epoch %d: dropped %d trailing micro-batch(es)", epoch,
                len(micro),
            )
        out = {k: v for k, v in metrics.items() if k != "grads_nonfinite"}
        if first_loss is not None:
            out["first_loss"] = first_loss
        epoch_dur = time.time() - t_epoch
        if self.telemetry is not None and epoch_pos > 0:
            self.telemetry.emit("epoch", epoch=int(epoch), steps=epoch_pos,
                                dur_s=epoch_dur, **self._lm_fields(metrics))
            self._emit_overlap(epoch_dur / epoch_pos, epoch)
        self.log.info(
            "epoch %d done in %.1f s (lr %.5f)", epoch, epoch_dur,
            self.epoch_schedule(float(epoch)),
        )
        return out

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
        batches = [self.bundle.train.load_batch(0, k) for k in range(iters * n)]

        def run():
            for i in range(iters):
                group = batches[i * n:(i + 1) * n]
                self.step_batch(*self._to_device(
                    np.stack([b[0] for b in group]),
                    np.stack([b[1] for b in group]),
                ))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

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
        summed across ranks (a language model: ``_evaluate_lm``)."""
        if self.meta.task == "lm":
            return self._evaluate_lm()
        self.model.eval()
        sums = torch.zeros(4, device=self.device)
        try:
            for xb, yb in self.bundle.val:
                x, y = self._to_device(xb, yb)
                sums += eval_sums(self.model, x, y, self.compute_dtype)
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
        finally:
            self.model.train()
        if self.world > 1:
            dist.all_reduce(sums)
        loss, count = sums.tolist()
        loss /= max(count, 1.0)
        return {"loss": loss, "count": count,
                "perplexity": float(np.exp(loss))}

    def save_step(self, epoch: int, epoch_step: int = 0) -> Optional[str]:
        """Commit the current step (params + batch statistics, replicated,
        written by rank 0, manifest last) under ``<checkpoint_dir>/<tag>``.
        Returns the step directory on rank 0."""
        if self.ckpt_dir is None:
            return None
        out = None
        if self.rank == 0:
            params, batch_stats = variables_to_flax(self.model)
            out = save_replicated_step(
                self.ckpt_dir, self.iteration, params,
                batch_stats=batch_stats,
                meta={
                    "epoch": int(epoch),
                    "iteration": int(self.iteration),
                    "epoch_step": int(epoch_step),
                    "mid_epoch": bool(epoch_step),
                    "train_step": int(self.train_step.step),
                    "steps_per_epoch": int(max(self._steps_per_epoch(), 1)),
                },
            )
        if self.world > 1:
            dist.barrier()
        return out

    def fit(self, num_epochs: Optional[int] = None) -> dict:
        cfg = self.config
        end = (
            self.start_epoch + num_epochs
            if num_epochs is not None else cfg.max_epochs
        )
        metrics: dict = {}
        if self.telemetry is not None and self.reducer is not None and (
            self._measured_group_times is None
        ):
            self._trace_group_times()
        for epoch in range(self.start_epoch, end):
            metrics = {"train": self.train_epoch(epoch)}
            if (epoch + 1) % cfg.eval_every_epochs == 0:
                metrics["eval"] = self.evaluate()
                self.log.info(
                    "epoch %d eval: %s", epoch,
                    ", ".join(f"{k} {v:.4f}" for k, v in metrics["eval"].items()),
                )
            if (epoch + 1) % cfg.checkpoint_every_epochs == 0:
                self.save_step(epoch)
        self.start_epoch = end
        return metrics

    def close(self) -> None:
        if self.reducer is not None:
            self.reducer.detach()
        if self.telemetry is not None:
            self.telemetry.close()
