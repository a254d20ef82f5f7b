"""Normalization (counterpart of ``hetu_tpu/ops/norm.py``)."""

from __future__ import annotations

import torch


def layer_norm(x, scale, bias, *, eps: float = 1e-5):
    """Layer norm over the trailing axis.

    Statistics in float32 whatever the input type (bf16 mean/var
    underflows), the POPULATION variance (``correction=0``, as ``jnp.var``),
    and the result cast back to ``x.dtype`` so a bf16 residual stream stays
    bf16 end to end.
    """
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.reciprocal(torch.sqrt(var + eps))
    return (y * scale + bias).to(x.dtype)
