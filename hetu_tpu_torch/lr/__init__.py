"""LR schedulers (counterpart of ``hetu_tpu/lr``).

Each scheduler is a callable ``step -> lr``.  The reference traces them
into the train step in float32; here each is computed with float32 tensors
and returned as a Python float holding that float32 value.
"""

from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


class LRScheduler:
    def __call__(self, step) -> float:
        raise NotImplementedError


class ConstantScheduler(LRScheduler):
    def __init__(self, lr):
        self.lr = lr

    def __call__(self, step):
        return float(_f32(self.lr))


class StepScheduler(LRScheduler):
    """lr * gamma^(step // step_size)."""

    def __init__(self, lr, step_size: int, gamma: float = 0.1):
        self.lr, self.step_size, self.gamma = lr, step_size, gamma

    def __call__(self, step):
        e = _f32(int(step) // self.step_size)
        return float(self.lr * _f32(self.gamma) ** e)


class MultiStepScheduler(LRScheduler):
    """lr decayed by gamma at each milestone."""

    def __init__(self, lr, milestones, gamma: float = 0.1):
        self.lr, self.gamma = lr, gamma
        self.milestones = sorted(milestones)

    def __call__(self, step):
        n = _f32(sum(int(step) >= m for m in self.milestones))
        return float(self.lr * _f32(self.gamma) ** n)


class ExponentialScheduler(LRScheduler):
    def __init__(self, lr, gamma: float = 0.99):
        self.lr, self.gamma = lr, gamma

    def __call__(self, step):
        return float(self.lr * _f32(self.gamma) ** _f32(int(step)))


class CosineScheduler(LRScheduler):
    """Cosine anneal between lr and min_lr over t_max steps, with an
    optional linear warmup."""

    def __init__(self, lr, t_max: int, min_lr: float = 0.0, warmup: int = 0):
        self.lr, self.t_max, self.min_lr, self.warmup = lr, t_max, min_lr, warmup

    def __call__(self, step):
        s = _f32(int(step))
        warm = self.lr * s / max(self.warmup, 1)
        prog = torch.clip((s - self.warmup) / max(self.t_max - self.warmup, 1),
                          0.0, 1.0)
        cos = self.min_lr + 0.5 * (self.lr - self.min_lr) * (
            1 + torch.cos(math.pi * prog))
        return float(torch.where(s < self.warmup, warm, cos))


class LambdaScheduler(LRScheduler):
    def __init__(self, lr, fn):
        self.lr, self.fn = lr, fn

    def __call__(self, step):
        return float(self.lr * self.fn(step))


__all__ = ["LRScheduler", "ConstantScheduler", "StepScheduler",
           "MultiStepScheduler", "ExponentialScheduler", "CosineScheduler",
           "LambdaScheduler"]
