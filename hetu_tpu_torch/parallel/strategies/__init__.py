"""Parallel strategies (counterpart of ``hetu_tpu/parallel/strategies``).
The searchers and the graph planner come with the profiler."""

from hetu_tpu_torch.parallel.strategies.base import Strategy
from hetu_tpu_torch.parallel.strategies.simple import (
    DataParallel, MegatronLM, ModelParallel4CNN, ModelParallel4LM,
    OneWeirdTrick4CNN,
)

__all__ = ["Strategy", "DataParallel", "MegatronLM", "ModelParallel4CNN",
           "ModelParallel4LM", "OneWeirdTrick4CNN"]
