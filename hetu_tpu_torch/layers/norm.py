"""Normalization layers (counterpart of ``hetu_tpu/layers/norm.py``)."""

from __future__ import annotations

import torch
from torch import nn

from hetu_tpu_torch import ops
from hetu_tpu_torch.layers.base import Module


class BatchNorm(Module):
    """Batch norm over the channels.  Parameters ``scale`` and ``bias``
    (in ``dtype``, float32 by default); the running statistics ``mean`` and
    ``var`` are float32 buffers and the model's state (the reference's
    state names).  Built on the CPU, like :class:`LayerNorm`; the model
    moves it.

    A training call normalizes by the batch's statistics and writes the
    new running statistics into the buffers, in place and without
    gradient; the Executor keeps the buffers as ``TrainState.model_state``
    and restores them after a skipped guarded step."""

    state_names = ("mean", "var")

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(num_features, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(num_features, dtype=dtype))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x, *, train: bool = False):
        y, rm, rv = ops.batch_norm(x, self.scale, self.bias, self.mean,
                                   self.var, momentum=self.momentum,
                                   eps=self.eps, train=train)
        if train:
            with torch.no_grad():
                self.mean.copy_(rm)
                self.var.copy_(rv)
        return y


class LayerNorm(Module):
    """Parameters ``scale`` and ``bias`` (the reference's names) in
    ``dtype``, float32 by default, also in a bf16 model: the statistics
    run in float32 and the result is cast back to the input's type."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(num_features, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(num_features, dtype=dtype))

    def forward(self, x):
        return ops.layer_norm(x, self.scale, self.bias, eps=self.eps)


class InstanceNorm2d(Module):
    def __init__(self, eps: float = 1e-7):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        return ops.instance_norm2d(x, eps=self.eps)
