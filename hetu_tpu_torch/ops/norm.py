"""Normalization (counterpart of ``hetu_tpu/ops/norm.py``).

The functional cores; a :class:`~hetu_tpu_torch.layers.BatchNorm` keeps
the running statistics.
"""

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


def rms_norm(x, scale, *, eps: float = 1e-6):
    """RMSNorm over the trailing axis: ``x / rms(x) * scale``, no mean and
    no bias (the Llama norm).  The reference's order and rounding points:
    the mean square in float32, ``xf * rsqrt(ms + eps) * scale_f32``, then
    one cast back to ``x.dtype``."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def batch_norm(x, scale, bias, running_mean, running_var, *,
               momentum: float = 0.1, eps: float = 1e-5, train: bool = True):
    """Batch norm over the channel axis 1 of an NCHW (or ``[N, C]``)
    ``x``.  Returns ``(y, new_running_mean, new_running_var)``.

    Training normalizes by the batch's mean and POPULATION variance
    (``jnp.var``'s, ``correction=0``) and moves the running statistics by
    ``new = (1 - momentum) * running + momentum * batch``, as the
    reference does; ``F.batch_norm`` would fold in the unbiased variance,
    and write the running tensors in place.  The new statistics carry no
    gradient.  Evaluation normalizes by the running statistics and returns
    them unchanged."""
    shape = (1, -1, 1, 1) if x.ndim == 4 else (1, -1)
    if train:
        axes = (0, 2, 3) if x.ndim == 4 else (0,)
        mean = x.mean(dim=axes)
        var = x.var(dim=axes, correction=0)
        new_rm = (1 - momentum) * running_mean + momentum * mean.detach()
        new_rv = (1 - momentum) * running_var + momentum * var.detach()
    else:
        mean, var = running_mean, running_var
        new_rm, new_rv = running_mean, running_var
    y = (x - mean.reshape(shape)) * torch.reciprocal(
        torch.sqrt(var.reshape(shape) + eps))
    y = y * scale.reshape(shape) + bias.reshape(shape)
    return y, new_rm, new_rv


def instance_norm2d(x, *, eps: float = 1e-7):
    """Per sample and channel, over H and W: ``(x - mean) /
    sqrt(var + eps)`` with the population variance."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, correction=0)
    return (x - mean) * torch.reciprocal(torch.sqrt(var + eps))
