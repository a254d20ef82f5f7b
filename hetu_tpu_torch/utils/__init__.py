"""Utilities (counterpart of ``hetu_tpu/utils``): evaluation metrics."""

from hetu_tpu_torch.utils import metrics

__all__ = ["metrics"]
