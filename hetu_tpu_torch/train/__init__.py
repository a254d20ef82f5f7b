"""Training (counterpart of ``hetu_tpu/train``): the Executor, its
TrainState and checkpoints in the reference's format."""

from hetu_tpu_torch.train import checkpoint
from hetu_tpu_torch.train.executor import Executor, TrainState

__all__ = ["Executor", "TrainState", "checkpoint"]
