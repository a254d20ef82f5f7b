"""Activations (counterpart of ``hetu_tpu/ops/activations.py``).

The reference's formulas, which in places round or differentiate
differently from ``torch.nn.functional``'s: GELU's tanh form, ``relu``'s
derivative of 1/2 at 0, ``leaky_relu``'s slope of 1 at 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x):
    """tanh-approximate GELU, the reference's default (its Gelu kernel and
    ``jax.nn.gelu`` use the tanh form).  ``F.gelu``'s own default is the
    exact erf form, which is NOT the reference's function."""
    return F.gelu(x, approximate="tanh")


def silu(x):
    """``x * sigmoid(x)`` in ``x``'s type, the composition
    ``jax.nn.silu`` computes."""
    return x * torch.sigmoid(x)


def relu(x):
    """``max(x, 0)`` as the reference writes it (``jnp.maximum``), whose
    derivative at 0 is 1/2 (``torch.maximum`` splits a tie as JAX does;
    ``torch.relu``'s derivative there is 0)."""
    return torch.maximum(x, x.new_zeros(()))


def leaky_relu(x, alpha: float = 0.01):
    """``x`` where ``x >= 0``, else ``alpha * x`` (slope 1 at 0)."""
    return torch.where(x >= 0, x, alpha * x)


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def softmax(x, axis: int = -1):
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis: int = -1):
    return torch.log_softmax(x, dim=axis)
