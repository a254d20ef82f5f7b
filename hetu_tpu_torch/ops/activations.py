"""Activations (counterpart of ``hetu_tpu/ops/activations.py``).

Only what the serving slice runs: the GPT MLP's GELU.
"""

from __future__ import annotations

import torch.nn.functional as F


def gelu(x):
    """tanh-approximate GELU, the reference's default (its Gelu kernel and
    ``jax.nn.gelu`` use the tanh form).  ``F.gelu``'s own default is the
    exact erf form, which is NOT the reference's function."""
    return F.gelu(x, approximate="tanh")
