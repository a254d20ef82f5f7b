"""LayerNorm layer (counterpart of ``hetu_tpu/layers/norm.py``)."""

from __future__ import annotations

import torch
from torch import nn

from hetu_tpu_torch import ops
from hetu_tpu_torch.layers.base import Module


class LayerNorm(Module):
    """Parameters ``scale`` and ``bias`` (the reference's names), kept in
    float32 even in a bf16 model: the statistics run in float32 and the
    result is cast back to the input's type."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        return ops.layer_norm(x, self.scale, self.bias, eps=self.eps)
