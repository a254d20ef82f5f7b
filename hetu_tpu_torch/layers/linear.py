"""Linear layer (counterpart of ``hetu_tpu/layers/linear.py``)."""

from __future__ import annotations

import torch
from torch import nn

from hetu_tpu_torch import init as initializers
from hetu_tpu_torch import ops
from hetu_tpu_torch.layers.base import Module


class Linear(Module):
    """``y = x W^T + b`` with ``weight`` laid out ``[out, in]`` (the
    ``nn.Linear`` layout; the reference stores ``[in, out]`` —
    :mod:`hetu_tpu_torch.interop` transposes).  Xavier-uniform weight and
    zero bias, as the reference's defaults.  Computes in ``dtype``."""

    compute_params = ("weight", "bias")

    def __init__(self, in_features: int, out_features: int, *,
                 generator: torch.Generator, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(initializers.xavier_uniform()(
            generator, (out_features, in_features)))
        self.bias = nn.Parameter(initializers.zeros()(
            generator, (out_features,)))

    def forward(self, x):
        return ops.linear(x.to(self.dtype), self.weight.to(self.dtype).t(),
                          self.bias.to(self.dtype))
