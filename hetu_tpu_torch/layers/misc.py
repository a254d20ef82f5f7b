"""Pooling, activation, dropout and reshape layers (counterpart of
``hetu_tpu/layers/misc.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from hetu_tpu_torch import ops
from hetu_tpu_torch.layers.base import Module


class MaxPool2d(Module):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size, self.stride, self.padding = \
            kernel_size, stride, padding

    def forward(self, x):
        return ops.max_pool2d(x, self.kernel_size, self.stride, self.padding)


class AvgPool2d(Module):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size, self.stride, self.padding = \
            kernel_size, stride, padding

    def forward(self, x):
        return ops.avg_pool2d(x, self.kernel_size, self.stride, self.padding)


class Relu(Module):
    def forward(self, x):
        return ops.relu(x)


class Gelu(Module):
    def forward(self, x):
        return ops.gelu(x)


class Tanh(Module):
    def forward(self, x):
        return ops.tanh(x)


class Sigmoid(Module):
    def forward(self, x):
        return ops.sigmoid(x)


class DropOut(Module):
    """Dropout at ``rate``; training needs a generator (on ``x``'s
    device), as the reference's needs a key."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate

    def forward(self, x, *, train: bool = False,
                generator: Optional[torch.Generator] = None):
        if train and generator is None:
            raise ValueError("DropOut needs a generator in train mode")
        return ops.dropout(x, self.rate, generator, train=train)


class Flatten(Module):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)
