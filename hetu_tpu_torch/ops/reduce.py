"""Segment reductions of the SAM gate (counterpart of ``sam_group_sum`` and
``sam_max`` in ``hetu_tpu/ops/reduce.py``).

The reference computes both with ``jax.ops.segment_sum`` /
``segment_max``, outside any Pallas kernel; here they are
``index_add`` and ``scatter_reduce("amax")``.  An empty segment gives 0
for the sum and, as XLA's segment max does, the lowest value of the type
for the max: ``-inf`` for a float, the type's minimum for an integer.
Rows whose segment id lies outside ``[0, num_groups)`` are dropped, as
XLA drops them (without a host sync: such a row adds 0, or the lowest
value, to a clamped segment).  The rest of ``reduce.py`` belongs to the
op zoo's slice.
"""

from __future__ import annotations

import torch


def _lowest(dtype):
    return float("-inf") if dtype.is_floating_point \
        else torch.iinfo(dtype).min


def _clamped(x, group_idx, num_groups: int, fill):
    """``(rows, ids)``: ids as int64 on ``x``'s device, clamped into range,
    and the rows of out-of-range ids replaced by ``fill``."""
    ids = group_idx.reshape(-1).to(device=x.device, dtype=torch.long)
    keep = ((ids >= 0) & (ids < num_groups)).reshape(-1, *[1] * (x.dim() - 1))
    rows = torch.where(keep, x, torch.full((), fill, dtype=x.dtype,
                                           device=x.device))
    return rows, ids.clamp(0, num_groups - 1)


def sam_group_sum(x, group_idx, num_groups: int):
    """``[num_groups, *x.shape[1:]]``: the sum of the rows of ``x`` in each
    segment (0 where a segment is empty); differentiable in ``x``."""
    rows, ids = _clamped(x, group_idx, num_groups, 0)
    return x.new_zeros((num_groups, *x.shape[1:])).index_add(0, ids, rows)


def sam_max(x, group_idx, num_groups: int):
    """``[num_groups, *x.shape[1:]]``: the elementwise max of the rows of
    ``x`` in each segment; an empty segment holds ``-inf`` (a float) or
    the type's minimum (an integer)."""
    lowest = _lowest(x.dtype)
    rows, ids = _clamped(x, group_idx, num_groups, lowest)
    out = torch.full((num_groups, *x.shape[1:]), lowest, dtype=x.dtype,
                     device=x.device)
    index = ids.reshape(-1, *[1] * (x.dim() - 1)).expand_as(rows)
    return out.scatter_reduce(0, index, rows, "amax", include_self=False)
