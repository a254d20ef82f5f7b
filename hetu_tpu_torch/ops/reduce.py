"""Reductions, sorting, top-k, unique (counterpart of
``hetu_tpu/ops/reduce.py``).

``axes`` is None (every axis), an int or a sequence of ints.  A sum or
product of integers keeps their type; a mean of integers is float32.
Sorts are stable: ``argsort(descending=True)`` is the flip of the
ascending sort, so ties come out in reverse index order, as in the
reference; ``topk`` orders ties lowest index first, as ``lax.top_k`` (a
stable sort, since ``torch.topk`` leaves ties unordered on the card).
``unique`` has a static size, as the reference's.

The segment reductions of the SAM gate, ``sam_group_sum`` and ``sam_max``
(``jax.ops.segment_sum`` / ``segment_max`` in the reference), are
``index_add`` and ``scatter_reduce("amax")``.  An empty segment gives 0
for the sum and, as XLA's segment max does, the lowest value of the type
for the max: ``-inf`` for a float, the type's minimum for an integer.
Rows whose segment id lies outside ``[0, num_groups)`` are dropped, as
XLA drops them (without a host sync: such a row adds 0, or the lowest
value, to a clamped segment).
"""

from __future__ import annotations

import torch


def _ax(axes):
    """``axes`` as a tuple of ints, or None for every axis."""
    if axes is None:
        return None
    return (axes,) if isinstance(axes, int) else tuple(axes)


def _int_type(x):
    """``x``'s type for a sum or product of integers (torch widens them
    to int64), else None."""
    return None if x.is_floating_point() or x.is_complex() \
        or x.dtype == torch.bool else x.dtype


def reduce_sum(x, axes=None, keepdims: bool = False):
    axes = _ax(axes)
    if axes is None and not keepdims:
        return x.sum(dtype=_int_type(x))
    return x.sum(dim=axes, keepdim=keepdims, dtype=_int_type(x))


def reduce_mean(x, axes=None, keepdims: bool = False):
    if not (x.is_floating_point() or x.is_complex()):
        x = x.float()
    axes = _ax(axes)
    return x.mean() if axes is None and not keepdims \
        else x.mean(dim=axes, keepdim=keepdims)


def reduce_min(x, axes=None, keepdims: bool = False):
    return torch.amin(x, dim=_ax(axes) or (), keepdim=keepdims)


def reduce_max(x, axes=None, keepdims: bool = False):
    return torch.amax(x, dim=_ax(axes) or (), keepdim=keepdims)


def reduce_mul(x, axes=None, keepdims: bool = False):
    """The product over ``axes``, one axis at a time (``torch.prod``
    reduces one)."""
    axes = _ax(axes)
    axes = range(x.ndim) if axes is None else axes
    for d in sorted((a % x.ndim for a in axes), reverse=True):
        x = x.prod(dim=d, keepdim=keepdims, dtype=_int_type(x))
    return x


def reduce_norm1(x, axes=None, keepdims: bool = False):
    return reduce_sum(torch.abs(x), axes, keepdims)


def reduce_norm2(x, axes=None, keepdims: bool = False):
    return torch.sqrt(reduce_sum(x * x, axes, keepdims))


def reduce_sum_axis_zero(x):
    """The axis-0 sum of gradient accumulation."""
    return reduce_sum(x, 0)


def norm(x, ord: int = 2):  # noqa: A002
    """The whole tensor's p-norm."""
    if ord == 1:
        return torch.abs(x).sum()
    if ord == 2:
        return torch.sqrt((x * x).sum())
    return torch.pow(torch.pow(torch.abs(x), ord).sum(), 1.0 / ord)


def max_(x, axis=None, keepdims: bool = False):
    return reduce_max(x, axis, keepdims)


def min_(x, axis=None, keepdims: bool = False):
    return reduce_min(x, axis, keepdims)


def argmax(x, axis: int = -1):
    """The first index of the largest value along ``axis``."""
    return torch.argmax(x, dim=axis)


def argsort(x, axis: int = -1, descending: bool = False):
    """The stable ascending sort's indices, flipped when
    ``descending``."""
    s = torch.argsort(x, dim=axis, stable=True)
    return torch.flip(s, (axis,)) if descending else s


def topk(x, k: int, axis: int = -1):
    """``(values, indices)`` of the ``k`` largest along ``axis``, largest
    first, ties lowest index first."""
    v, i = torch.sort(x, dim=axis, descending=True, stable=True)
    return v.narrow(axis, 0, k), i.narrow(axis, 0, k)


def topk_idx(x, k: int, axis: int = -1):
    return topk(x, k, axis)[1]


def topk_val(x, k: int, axis: int = -1):
    return topk(x, k, axis)[0]


def unique(x, size: int, fill_value=0):
    """``(uniques, inverse)``: the sorted distinct values of the flattened
    ``x``, cut or padded with ``fill_value`` (None: ``x``'s minimum) to
    ``size``, and each element's place among them (``x``'s shape)."""
    u, inv = torch.unique(x.reshape(-1), sorted=True, return_inverse=True)
    if fill_value is None:
        fill_value = x.min()
    pad = u.new_full((max(size - u.numel(), 0),), fill_value)
    return torch.cat([u[:size], pad]), inv.reshape(x.shape)


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
