"""Training (counterpart of ``mgwfbp_tpu/train``)."""

from mgwfbp_tpu_torch.train.step import TrainStep, cross_entropy, eval_sums
from mgwfbp_tpu_torch.train.trainer import Trainer

__all__ = ["TrainStep", "Trainer", "cross_entropy", "eval_sums"]
