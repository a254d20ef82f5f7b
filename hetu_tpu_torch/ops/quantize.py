"""Quantization and pruning ops of the embedding-compression stack
(counterpart of ``hetu_tpu/ops/quantize.py``).

int8 storage with a scale and a zero point.  Stochastic rounding draws its
noise from an explicit ``torch.Generator`` on the tensor's device, where
the reference takes a JAX key; the two draw different numbers, so the
rounding matches the reference only in distribution.

Ids: a negative id counts from the end, as in the reference; an id out of
range raises ``IndexError`` (one check, and on the card one
synchronisation, per call), where the reference's ``jnp.take`` fills the
int8 row with -128.
"""

from __future__ import annotations

from typing import Optional

import torch

from hetu_tpu_torch.ops.shape import _ids


def table_ids(ids, table) -> torch.Tensor:
    """``ids`` of ``table``'s rows as int64 on its device, negatives
    counted from the end; raises ``IndexError`` for one outside ``[-N,
    N)``."""
    return _ids(ids, table.shape[0], table.device)


def true_div(x, c) -> torch.Tensor:
    """``x / c`` rounded once, as the reference divides.  A Python number
    (or a CPU scalar) divisor would take PyTorch's CUDA shortcut, ``x *
    (1 / c)``, which rounds twice and can differ in the last bit; a 0-d
    divisor on ``x``'s device takes the true division."""
    return x / torch.as_tensor(c, dtype=x.dtype).to(x.device)


def quantize(x, bits: int = 8, *, scale=None, zero_point=0.0,
             generator: Optional[torch.Generator] = None):
    """Uniform quantization to signed ``bits``; returns ``(q int8,
    scale)``.  ``scale`` defaults to ``max|x| / qmax`` (at least 1e-8 /
    qmax).  With a ``generator``, rounds stochastically: uniform noise in
    ``[-0.5, 0.5)`` is added before rounding to nearest even."""
    qmax = 2 ** (bits - 1) - 1
    if scale is None:
        scale = true_div(torch.clamp(x.abs().max(), min=1e-8), qmax)
    scaled = true_div(x - zero_point, scale)
    if generator is not None:
        noise = torch.rand(x.shape, generator=generator,
                           device=x.device) - 0.5
        scaled = scaled + noise
    q = torch.clamp(torch.round(scaled), -qmax - 1, qmax).to(torch.int8)
    return q, scale


def dequantize(q, scale, zero_point=0.0, dtype=torch.float32):
    return q.to(dtype) * scale + zero_point


def quantize_embedding_lookup(q_table, scale, indices, zero_point=0.0,
                              dtype=torch.float32):
    """Gather rows of an int8 table, then dequantize with a per-row
    ``scale [N]`` or one scalar scale."""
    idx = table_ids(indices, q_table)
    rows = q_table[idx]
    s = scale[idx][..., None] if torch.as_tensor(scale).ndim > 0 else scale
    return rows.to(dtype) * s + zero_point


def prune_low_magnitude(x, rate: float):
    """Zero the smallest-|x| fraction ``rate`` of ``x`` (DeepLight): keep
    the elements at least as large as the k-th largest magnitude, k =
    ``int(numel * (1 - rate))``."""
    k = int(x.numel() * (1.0 - rate))
    if k <= 0:
        return torch.zeros_like(x)
    mag = x.abs()
    # the k-th largest, whatever order ties take
    thresh = torch.kthvalue(mag.reshape(-1), x.numel() - k + 1).values
    return torch.where(mag >= thresh, x, x.new_zeros(()))


def param_clip(x, min_val, max_val):
    return torch.clamp(x, min_val, max_val)
