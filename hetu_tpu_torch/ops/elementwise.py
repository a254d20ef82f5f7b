"""Elementwise ops (counterpart of ``hetu_tpu/ops/elementwise.py``).

One PyTorch op each, with numpy's broadcasting and type promotion, under
the reference's names.  Arguments are tensors or Python scalars (a
constant's side of ``add_const``, ``const_minus``, ...).
"""

from __future__ import annotations

import torch


def abs_(x):
    return torch.abs(x)


def add(a, b):
    return torch.add(a, b)


def add_const(x, c):
    return x + c


def minus(a, b):
    return torch.sub(a, b)


def minus_const(x, c):
    return x - c


def const_minus(c, x):
    return c - x


def multiply(a, b):
    return torch.mul(a, b)


def mul_const(x, c):
    return x * c


def divide(a, b):
    """True division (an integer input gives a float)."""
    return torch.div(a, b)


def div_const(x, c):
    return x / c


def const_div(c, x):
    return c / x


def opposite(x):
    return torch.neg(x)


def exp(x):
    return torch.exp(x)


def log(x):
    return torch.log(x)


def pow_(a, b):
    return torch.pow(a, b)


def const_pow(c, x):
    return torch.pow(c, x)


def power(x, p):
    return torch.pow(x, p)


def sqrt(x):
    return torch.sqrt(x)


def rsqrt(x):
    return torch.rsqrt(x)


def sin(x):
    return torch.sin(x)


def cos(x):
    return torch.cos(x)


def floor(x):
    return torch.floor(x)


def ceil(x):
    return torch.ceil(x)


def clamp(x, min=None, max=None):  # noqa: A002 - the reference's names
    """``x`` limited to ``[min, max]``; a bound of None is open."""
    if min is None and max is None:
        return x
    return torch.clamp(x, min, max)


def sign(x):
    return torch.sign(x)


def bool_(x):
    """1.0 where ``x`` is non-zero, else 0.0 (float32)."""
    return (x != 0).to(torch.float32)


def where(cond, a, b):
    return torch.where(cond, a, b)


def masked_fill(x, mask, value):
    """``value`` (in ``x``'s type) where ``mask`` is non-zero, else ``x``."""
    return torch.where(mask.to(torch.bool),
                       torch.tensor(value, dtype=x.dtype, device=x.device), x)


def mask(x, mask):  # noqa: A002
    """``x * mask`` with the mask cast to ``x``'s type."""
    return x * mask.to(x.dtype)
