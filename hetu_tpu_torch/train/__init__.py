"""Training (counterpart of ``hetu_tpu/train``): the Executor, its
TrainState, checkpoints in the reference's format, and ``gradients``."""

from hetu_tpu_torch.train import checkpoint
from hetu_tpu_torch.train.executor import Executor, TrainState, gradients

__all__ = ["Executor", "TrainState", "checkpoint", "gradients"]
