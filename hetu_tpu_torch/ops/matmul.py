"""Matmul (counterpart of ``hetu_tpu/ops/matmul.py``).

The large products stay ``torch.matmul`` (cuBLAS), as the reference leaves
them to XLA.  cuBLAS accumulates bf16 products in float32 and rounds the
result once to bf16, which is the reference's ``preferred_element_type``
contract.
"""

from __future__ import annotations

import torch


def linear(x, w, bias=None):
    """``x @ w (+ bias)`` with ``w`` laid out ``[in, out]``, result in the
    inputs' type.  The bias is added after the product is rounded (not
    fused into the GEMM epilogue), matching the reference's rounding
    points."""
    y = torch.matmul(x, w)
    if bias is not None:
        y = y + bias
    return y
