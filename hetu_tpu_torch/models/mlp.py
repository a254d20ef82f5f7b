"""MLP (counterpart of ``hetu_tpu/models/mlp.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from hetu_tpu_torch import layers
from hetu_tpu_torch.models.ctr_common import default_generator


def MLP(in_features: int = 784, hidden: tuple = (256, 256),
        num_classes: int = 10, dropout: float = 0.0, *,
        generator: Optional[torch.Generator] = None, device="cuda"):
    """Linear + Relu (+ DropOut) for each hidden width, then the head; a
    :class:`~hetu_tpu_torch.layers.Sequential` built from ``generator``
    (default: a CPU generator seeded 0) on ``device``."""
    g = default_generator(generator)
    mods = []
    prev = in_features
    for h in hidden:
        mods += [layers.Linear(prev, h, generator=g), layers.Relu()]
        if dropout:
            mods.append(layers.DropOut(dropout))
        prev = h
    mods.append(layers.Linear(prev, num_classes, generator=g))
    return layers.Sequential(*mods).to(device)
