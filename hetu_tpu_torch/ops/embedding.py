"""Embedding gather (counterpart of ``hetu_tpu/ops/embedding.py``)."""

from __future__ import annotations

import torch


def embedding_lookup(table, indices):
    """Dense gather ``table[indices]``; out-of-range ids give zero rows,
    like the reference.  Torch indexing raises on the CPU and asserts on
    the device for a bad id, so ids are clamped into range first and the
    rows masked after."""
    idx = indices.long()
    in_range = (idx >= 0) & (idx < table.shape[0])
    rows = table[idx.clamp(0, table.shape[0] - 1)]
    return torch.where(in_range[..., None], rows, rows.new_zeros(()))
