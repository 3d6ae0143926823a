"""Offline evaluation over saved checkpoints (counterpart of
``mgwfbp_tpu/evaluate.py``).

Rebuild the trainer for a model, restore a checkpoint's weights and batch
statistics into it and run its evaluation: loss, top-1 and top-5 for the
classifiers, loss and perplexity for the language models, CTC loss and the
greedy-decoded WER for the speech model ``lstman4``. The checkpoint
directory is the run's tagged one (``<checkpoint-dir>/<tag>``), written by
either package. Only the weights are restored and checked against the
model (the optimizer section is not needed to evaluate).

    python -m mgwfbp_tpu_torch.evaluate --dnn resnet20 \\
        --checkpoint-dir ckpts/<tag> [--epoch N | --all-epochs] [--synthetic]
    python -m mgwfbp_tpu_torch.evaluate --dnn resnet20 \\
        --average-dirs runA/<tag> runB/<tag>
    python -m mgwfbp_tpu_torch.evaluate --dnn lstman4 \\
        --data-dir data/an4_memcheck --checkpoint-dir ckpts/<tag> --all-epochs

Evaluation runs on the card unless ``--device cpu`` asks for the CPU; each
result is one JSON line (``--all-epochs`` adds a ``{"best": ...}`` line).
"""

from __future__ import annotations

import argparse
import json
from typing import Iterator, Optional

import numpy as np

from mgwfbp_tpu_torch.config import make_config


def _trainer(dnn: str, synthetic: Optional[bool], device, **overrides):
    from mgwfbp_tpu_torch.train.trainer import Trainer

    # no checkpoint directory (nothing to resume) and no log directory
    # (evaluation writes nothing)
    cfg = make_config(dnn, logdir="", **overrides)
    cfg.checkpoint_dir = cfg.pretrain = None
    return Trainer(cfg, device=device, profile_backward=False,
                   synthetic_data=synthetic)


def _restore_or_raise(ckpt, root: str, trainer, epoch: Optional[int]):
    if epoch is None:
        # the newest epoch boundary (evaluation is per epoch), else the
        # newest step of any kind
        epoch = ckpt.latest_epoch()
    snap = ckpt.restore(trainer._template(with_opt=False), epoch=epoch,
                        carry_template=trainer._carry_template())
    if snap is None:
        raise FileNotFoundError(
            f"no checkpoint under {root!r}"
            + (f" at epoch {epoch}" if epoch is not None else "")
        )
    return snap


def _install_and_eval(trainer, state) -> dict:
    trainer._install(state, optimizer=False)
    return trainer.evaluate()


def _eval_snapshots(dnn: str, checkpoint_root: str, pick_epochs,
                    synthetic: Optional[bool] = None, device=None,
                    **overrides) -> Iterator[dict]:
    """Build one trainer, then restore and evaluate each epoch
    ``pick_epochs(ckpt)`` selects, yielding metrics as they come."""
    from mgwfbp_tpu_torch.checkpoint import Checkpointer

    trainer = _trainer(dnn, synthetic, device, **overrides)
    ckpt = Checkpointer(checkpoint_root)
    try:
        for e in pick_epochs(ckpt):
            snap = _restore_or_raise(ckpt, checkpoint_root, trainer, e)
            metrics = _install_and_eval(trainer, snap.state)
            metrics["epoch"] = snap.epoch
            yield metrics
    finally:
        ckpt.close()
        trainer.close()


def evaluate(dnn: str, checkpoint_root: str, epoch: Optional[int] = None,
             synthetic: Optional[bool] = None, device=None,
             **overrides) -> dict:
    """Evaluate one checkpoint (the newest epoch boundary by default)."""
    for metrics in _eval_snapshots(dnn, checkpoint_root, lambda ck: [epoch],
                                   synthetic=synthetic, device=device,
                                   **overrides):
        return metrics
    raise FileNotFoundError(f"no checkpoint under {checkpoint_root!r}")


def evaluate_all(dnn: str, checkpoint_root: str,
                 synthetic: Optional[bool] = None, device=None,
                 **overrides) -> Iterator[dict]:
    """Metrics for every saved epoch boundary of a run, in order."""

    def pick(ckpt):
        epochs = ckpt.all_epochs()
        if not epochs:
            raise FileNotFoundError(f"no checkpoints under {checkpoint_root!r}")
        return epochs

    yield from _eval_snapshots(dnn, checkpoint_root, pick,
                               synthetic=synthetic, device=device,
                               **overrides)


def model_average_evaluate(dnn: str, checkpoint_roots: list[str],
                           epoch: Optional[int] = None,
                           synthetic: Optional[bool] = None, device=None,
                           **overrides) -> dict:
    """Average the weights and batch statistics of several runs'
    checkpoints (in float32), then evaluate the average. Every root must
    hold the same epoch; with ``epoch`` None each root's newest is taken
    and a mismatch raises."""
    from mgwfbp_tpu_torch.checkpoint import Checkpointer, TrainState

    if not checkpoint_roots:
        raise ValueError("model_average_evaluate: no checkpoint dirs given")
    trainer = _trainer(dnn, synthetic, device, **overrides)
    try:
        snaps = []
        for root in checkpoint_roots:
            ckpt = Checkpointer(root)
            try:
                snaps.append(_restore_or_raise(ckpt, root, trainer, epoch))
            finally:
                ckpt.close()
        epochs = sorted({s.epoch for s in snaps})
        if len(epochs) > 1:
            raise ValueError(
                "model_average_evaluate: checkpoint roots are at different "
                f"epochs {epochs}; pass --epoch to pick a common one"
            )

        def mean(part: str) -> dict:
            trees = [getattr(s.state, part) for s in snaps]
            return {k: (sum(t[k].astype(np.float32) for t in trees)
                        / np.float32(len(trees))).astype(trees[0][k].dtype)
                    for k in trees[0]}

        state = TrainState(step=snaps[0].state.step, params=mean("params"),
                           batch_stats=mean("batch_stats"))
        metrics = _install_and_eval(trainer, state)
        metrics["epoch"] = snaps[0].epoch
        metrics["averaged_over"] = len(snaps)
        return metrics
    finally:
        trainer.close()


def main(argv: Optional[list[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="mgwfbp-evaluate-torch")
    p.add_argument("--dnn", required=True)
    p.add_argument("--checkpoint-dir", dest="checkpoint_dir", default=None,
                   help="the run's tagged checkpoint directory (required "
                        "unless --average-dirs is used)")
    p.add_argument("--epoch", type=int, default=None,
                   help="epoch to evaluate (default: the newest)")
    p.add_argument("--all-epochs", action="store_true",
                   help="evaluate every saved epoch (one JSON line each, "
                        "then a {\"best\": ...} line)")
    p.add_argument("--average-dirs", dest="average_dirs", nargs="+",
                   default=None,
                   help="average weights across these runs' checkpoints "
                        "before evaluating")
    p.add_argument("--dataset", default=None)
    p.add_argument("--data-dir", dest="data_dir", default=None)
    p.add_argument("--batch-size", dest="batch_size", type=int, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    overrides = {k: getattr(args, k) for k in ("dataset", "data_dir",
                                               "batch_size")
                 if getattr(args, k) is not None}
    if args.all_epochs and args.epoch is not None:
        p.error("--all-epochs and --epoch are mutually exclusive")
    if args.average_dirs and args.all_epochs:
        p.error("--average-dirs and --all-epochs are mutually exclusive")
    if not args.average_dirs and not args.checkpoint_dir:
        p.error("--checkpoint-dir is required (or use --average-dirs)")
    synthetic = True if args.synthetic else None
    if args.average_dirs:
        print(json.dumps(model_average_evaluate(
            args.dnn, args.average_dirs, epoch=args.epoch,
            synthetic=synthetic, device=args.device, **overrides)))
        return 0
    if args.all_epochs:
        best = best_epoch = key = None
        lower_better = False
        for metrics in evaluate_all(args.dnn, args.checkpoint_dir,
                                    synthetic=synthetic, device=args.device,
                                    **overrides):
            print(json.dumps(metrics), flush=True)
            if key is None:
                # the metric is a property of the model's task
                key, lower_better = next(
                    ((k, lower) for k, lower in (("wer", True),
                                                 ("perplexity", True))
                     if k in metrics), ("top1", False))
            v = metrics.get(key)
            if v is not None and (best is None or (
                    v < best if lower_better else v > best)):
                best, best_epoch = v, metrics.get("epoch")
        if best is not None:
            print(json.dumps({"best": {key: best, "epoch": best_epoch}}))
        return 0
    print(json.dumps(evaluate(args.dnn, args.checkpoint_dir,
                              epoch=args.epoch, synthetic=synthetic,
                              device=args.device, **overrides)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
