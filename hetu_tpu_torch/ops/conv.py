"""Convolution and pooling (counterpart of ``hetu_tpu/ops/conv.py``).

NCHW activations and OIHW weights, as in the reference.  No TPU kernel lies
here: the reference lowers these to XLA's convolution and reduce-window,
and the port to cuDNN's (``F.conv2d``, ``F.max_pool2d``,
``F.avg_pool2d``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def conv2d(x, w, stride=1, padding=0):
    """NCHW convolution with an OIHW ``w``.  bf16 operands accumulate in
    float32 and the result stays float32, as the reference's
    ``preferred_element_type`` makes it: they are cast to float32 first
    (a product of two bf16 values is exact in float32), where a bf16 cuDNN
    convolution would round its output to bf16."""
    if x.dtype == torch.bfloat16:
        x, w = x.float(), w.float()
    return F.conv2d(x, w, stride=_pair(stride), padding=_pair(padding))


def conv2d_add_bias(x, w, bias, stride=1, padding=0):
    """:func:`conv2d` plus a per-channel ``bias``, added after the
    convolution is rounded."""
    return conv2d(x, w, stride=stride, padding=padding) \
        + bias.reshape(1, -1, 1, 1)


def _pad(x, padding, value):
    """``x`` padded by ``padding`` (rows, columns) on both sides with
    ``value``: the reference pads before the window reduction, at any
    width (the pools' own padding stops at half the window)."""
    p = _pair(padding)
    if not any(p):
        return x
    return F.pad(x, (p[1], p[1], p[0], p[0]), value=value)


def max_pool2d(x, kernel_size, stride=None, padding=0):
    """NCHW max pool, ``stride`` the window by default; padding is -inf
    (the integer minimum for an integer ``x``), so it never wins."""
    k = _pair(kernel_size)
    s = _pair(stride if stride is not None else kernel_size)
    low = float("-inf") if x.is_floating_point() \
        else torch.iinfo(x.dtype).min
    return F.max_pool2d(_pad(x, padding, low), k, s)


def avg_pool2d(x, kernel_size, stride=None, padding=0):
    """NCHW average pool: each window's sum over ``kh·kw``, padding
    counted as zeros (``count_include_pad=True``), as the reference's
    kernel divides."""
    k = _pair(kernel_size)
    s = _pair(stride if stride is not None else kernel_size)
    return F.avg_pool2d(_pad(x, padding, 0.0), k, s)
