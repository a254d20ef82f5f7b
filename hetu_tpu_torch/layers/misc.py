"""Activation layers (counterpart of ``hetu_tpu/layers/misc.py``): what
the CTR towers use."""

from __future__ import annotations

from hetu_tpu_torch import ops
from hetu_tpu_torch.layers.base import Module


class Relu(Module):
    def forward(self, x):
        return ops.relu(x)
