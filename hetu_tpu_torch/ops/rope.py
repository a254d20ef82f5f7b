"""Rotary position embedding (counterpart of ``hetu_tpu/ops/rope.py``).

The half-rotation layout of HF Llama: the head dim splits ``[x1 | x2]``
(not interleaved pairs) and rotates as ``(x1 cos - x2 sin, x2 cos + x1
sin)``.  The tables are float32 ``[S, D/2]`` and are cast to ``x``'s type
before the rotation, as in the reference, so bf16 q and k rotate in bf16.
"""

from __future__ import annotations

import torch


def rope_tables(seq_len: int, head_dim: int, *, theta: float = 10000.0,
                dtype=torch.float32, device="cuda"):
    """cos/sin tables ``[seq_len, head_dim / 2]`` for :func:`apply_rope`,
    made on ``device``."""
    if head_dim % 2:
        raise ValueError(f"RoPE needs an even head_dim, got {head_dim}")
    inv_freq = 1.0 / theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim)
    ang = torch.outer(torch.arange(seq_len, dtype=torch.float32,
                                   device=device), inv_freq)
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def _rotate(x, cos, sin):
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x, cos, sin):
    """Rotate ``x [..., S, D]`` by position; cos/sin ``[S, D/2]`` broadcast
    over the leading dims."""
    return _rotate(x, cos.to(x.dtype), sin.to(x.dtype))


def apply_rope_at(x, cos, sin, positions):
    """Rotate ``x [B, H, S, D]`` at per-sequence absolute positions: token
    ``i`` of sequence ``b`` sits at ``positions[b] + i`` and takes that row
    of the full tables ``[T_max, D/2]``.  Positions past the table clamp to
    its last row (only a padded tail reaches them), as the reference
    clamps its gather."""
    s = x.shape[-2]
    pos = positions.to(x.device).long()[:, None] + torch.arange(
        s, device=x.device)
    pos = pos.clamp(0, cos.shape[0] - 1)
    return _rotate(x, cos[pos][:, None].to(x.dtype),
                   sin[pos][:, None].to(x.dtype))
