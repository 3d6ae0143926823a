"""The trainer (counterpart of the ``all_reduce`` training path of
``mgwfbp_tpu/train/trainer.py``): loaders, model, optimizer, the merged
all-reduce and its backward profile, the train/eval loop and step commits.

One process per card; the world is whatever ``torch.distributed`` was
started with (``parallel.mesh.init_distributed``), one worker when it was
not started. At one worker there is no reducer: no communication exists
to schedule (the JAX trainer's single-device rule). Resume, preemption,
rollback, autotune, telemetry, the serving shadow and elastic resize are
not ported (ROADMAP.md).
"""

from __future__ import annotations

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
from mgwfbp_tpu_torch.parallel.costmodel import load_profile, lookup_alpha_beta
from mgwfbp_tpu_torch.parallel.mesh import rank, world_size
from mgwfbp_tpu_torch.profiling import TbProfile, benchmark_backward
from mgwfbp_tpu_torch.train.step import TrainStep, cross_entropy, eval_sums
from mgwfbp_tpu_torch.utils.device import resolve_device
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
        self.shard = ShardInfo(self.rank, self.world)
        self.bundle = data_prepare(
            config.dataset, data_dir=config.data_dir,
            batch_size=config.batch_size, shard=self.shard, seed=config.seed,
            synthetic=synthetic_data, augment=config.augment,
        )
        self.model, self.meta = zoo.create_model(
            config.dnn, dataset=config.dataset,
            num_classes=self.bundle.num_classes,
        )
        if self.meta.task != "classify":
            raise ValueError(
                f"training {config.dnn!r} ({self.meta.task}) is not ported "
                "yet: the port trains classifiers (ROADMAP.md)"
            )
        init_weights(self.model, torch.Generator().manual_seed(config.seed))
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
        )
        self.ckpt_dir = (
            os.path.join(config.checkpoint_dir, config.tag())
            if config.checkpoint_dir else None
        )
        self.start_epoch = 0
        self.iteration = 0
        self.losses: list[float] = []  # every optimizer step's mean loss

    # ------------------------------------------------------------------
    def _steps_per_epoch(self) -> int:
        steps = self.bundle.num_batches_per_epoch // max(
            self.config.nsteps_update, 1
        )
        if self.config.num_batches_per_epoch:
            steps = min(steps, self.config.num_batches_per_epoch)
        return steps

    def _to_device(self, x: np.ndarray, y: np.ndarray):
        """NHWC numpy batches (leading micro-step axis optional) -> NCHW
        float32 and int64 tensors on the card, permuted there."""
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(
            self.device, non_blocking=True
        )
        yt = torch.from_numpy(np.asarray(y, np.int64)).to(
            self.device, non_blocking=True
        )
        return xt.movedim(-1, -3).contiguous(), yt

    def _build_reducer(self, profile_backward: bool):
        cfg = self.config
        if cfg.policy in ("none", "xla"):
            return None  # one mean per leaf, no hooks
        if self.world == 1:
            self.log.info(
                "single device: skipping merged-allreduce scheduling "
                "(policy %s inert)", cfg.policy,
            )
            return None
        if cfg.comm_profile:
            self.cost_model = load_profile(cfg.comm_profile)
        else:
            self.cost_model = lookup_alpha_beta(cfg.connection, self.world)
        if cfg.policy in ("mgwfbp", "auto") and profile_backward:
            self.tb = self._profile_backward()
        return make_merged_allreduce(
            self.model, policy=cfg.policy, tb=self.tb,
            cost_model=self.cost_model, threshold=cfg.threshold,
            comm_dtype=getattr(torch, cfg.comm_dtype) if cfg.comm_dtype else None,
        )

    def _profile_backward(self) -> TbProfile:
        """Backward benchmark at the per-worker batch. Measured times differ
        per rank, so rank 0's are broadcast: every rank must solve the
        identical schedule, or the ranks' collectives mismatch."""
        x, y = self.bundle.train.load_batch(0, 0)
        x, y = self._to_device(x, y)
        leaves = flax_leaves(self.model)
        perm = arrival_order(len(leaves), names=[keystr(p) for p, _ in leaves])

        def loss_of():
            return cross_entropy(self.model(x), y)

        t0 = time.perf_counter()
        self.model.train()
        tb = benchmark_backward(
            self.model, loss_of, [t for _, t in leaves], perm,
            warmup=2, iters=10,
        )
        if self.world > 1:
            vals = torch.tensor(list(tb), dtype=torch.float64, device=self.device)
            dist.broadcast(vals, 0)
            tb = TbProfile(vals.tolist(), source=tb.source)
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
            metrics = self.train_step(x, y)
            self.iteration += 1
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
                self.log.info(
                    "epoch %d iter %d: loss %.4f, accuracy %.4f | %.4f "
                    "s/iter, %.1f samples/s", epoch, self.iteration,
                    metrics["loss"], metrics["accuracy"], dt,
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
        self.log.info(
            "epoch %d done in %.1f s (lr %.5f)", epoch,
            time.time() - t_epoch, self.epoch_schedule(float(epoch)),
        )
        return out

    def evaluate(self) -> dict:
        """Loss, top-1 and top-5 over every sample of the val loader,
        summed across ranks."""
        self.model.eval()
        sums = torch.zeros(4, device=self.device)
        try:
            for xb, yb in self.bundle.val:
                x, y = self._to_device(xb, yb)
                sums += eval_sums(self.model, x, y)
        finally:
            self.model.train()
        if self.world > 1:
            dist.all_reduce(sums)
        loss, top1, top5, count = sums.tolist()
        c = max(count, 1.0)
        return {"loss": loss / c, "top1": top1 / c, "top5": top5 / c,
                "count": count}

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
