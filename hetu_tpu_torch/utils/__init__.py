"""Utilities (counterpart of ``hetu_tpu/utils``): evaluation metrics and
the training metric logger."""

from hetu_tpu_torch.utils import metrics
from hetu_tpu_torch.utils.logger import MetricLogger

__all__ = ["metrics", "MetricLogger"]
