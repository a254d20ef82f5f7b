"""Optimizers (counterpart of ``hetu_tpu/optim``)."""

from hetu_tpu_torch.optim.optimizer import (
    AdaGradOptimizer, AdamOptimizer, AdamWOptimizer, AMSGradOptimizer,
    LambOptimizer, MomentumOptimizer, NesterovOptimizer, Optimizer,
    SGDOptimizer,
)

__all__ = ["Optimizer", "SGDOptimizer", "MomentumOptimizer",
           "NesterovOptimizer", "AdaGradOptimizer", "AdamOptimizer",
           "AMSGradOptimizer", "AdamWOptimizer", "LambOptimizer"]
