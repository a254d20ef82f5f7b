"""Activations (counterpart of ``hetu_tpu/ops/activations.py``).

What the ported models run: the GPT and BERT MLPs' GELU, Llama's
SwiGLU gate (``silu``) and the CTR towers' ``relu``.
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
