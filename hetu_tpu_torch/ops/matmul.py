"""Matmul family (counterpart of ``hetu_tpu/ops/matmul.py``).

The products stay ``torch.matmul`` (cuBLAS), as the reference leaves them
to XLA.  Both operands are cast to their promoted type; cuBLAS accumulates
bf16 products in float32 and rounds the result once to bf16, which is the
reference's ``preferred_element_type`` contract.  ``addmm`` and
``baddbmm`` are ``beta * input + alpha * (a @ b)`` as written, not the
fused ``torch.addmm``, as the reference computes them.
"""

from __future__ import annotations

import torch


def _mm(a, b):
    """``a @ b`` in the promoted type of the two."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def matmul(a, b, trans_a: bool = False, trans_b: bool = False):
    """2-D matmul with transpose flags."""
    return _mm(a.t() if trans_a else a, b.t() if trans_b else b)


def linear(x, w, bias=None, trans_w: bool = False):
    """``x @ w (+ bias)`` with ``w`` laid out ``[in, out]`` (``[out, in]``
    with ``trans_w``).  The bias is added after the product is rounded
    (not fused into the GEMM epilogue), matching the reference's rounding
    points."""
    y = _mm(x, w.t() if trans_w else w)
    if bias is not None:
        y = y + bias
    return y


def batch_matmul(a, b, trans_a: bool = False, trans_b: bool = False):
    """Batched matmul; the flags transpose the last two axes."""
    return _mm(a.transpose(-1, -2) if trans_a else a,
               b.transpose(-1, -2) if trans_b else b)


def addmm(input_, a, b, alpha: float = 1.0, beta: float = 1.0):
    """``beta * input + alpha * (a @ b)``."""
    return beta * input_ + alpha * torch.matmul(a, b)


def baddbmm(input_, a, b, alpha: float = 1.0, beta: float = 1.0):
    """Batched :func:`addmm`."""
    return beta * input_ + alpha * torch.matmul(a, b)


def matrix_dot(a, b):
    """The elementwise product, summed over the last axis."""
    return (a * b).sum(dim=-1)
