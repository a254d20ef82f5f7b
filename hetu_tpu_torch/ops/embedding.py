"""Embedding lookup and the sparse-gradient machinery (counterpart of
``hetu_tpu/ops/embedding.py``).

A table's gradient stays in ``(indices, values)`` form, an
:class:`IndexedSlices`, and the optimizer's ``apply_indexed`` updates only
the rows it names: a step over a ``[V, D]`` table never holds a ``[V, D]``
gradient.  The duplicate sum of :meth:`IndexedSlices.deduplicate` runs
through the scatter-add kernel's sorted route on a CUDA tensor.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from hetu_tpu_torch.parallel.spec import (
    gather_dim, is_dtensor, local_call, unpartial,
)

# jax.ops.segment_max's value for an empty int32 segment
_INT32_MIN = -2 ** 31


def int32_ids(ids, what: str):
    """``ids`` as int32.  An int64 id outside int32's range would wrap onto
    another row, so it raises (reading the range synchronises with the
    card; int32 ids pass through untouched)."""
    if ids.dtype == torch.int32:
        return ids
    if ids.dtype == torch.int64 and ids.numel():
        lo, hi = (int(v) for v in torch.aminmax(ids))
        if lo < _INT32_MIN or hi > 2 ** 31 - 1:
            raise ValueError(f"{what}: ids span [{lo}, {hi}], which does "
                             f"not fit in int32")
    return ids.to(torch.int32)


def embedding_lookup(table, indices):
    """Dense gather ``table[indices]``; out-of-range ids give zero rows,
    like the reference.  Torch indexing raises on the CPU and asserts on
    the device for a bad id, so ids are clamped into range first and the
    rows masked after.  A DTensor table is looked up vocab-parallel
    (:func:`_sharded_lookup`)."""
    if is_dtensor(table):
        return _sharded_lookup(table, indices)
    idx = indices.long()
    in_range = (idx >= 0) & (idx < table.shape[0])
    rows = table[idx.clamp(0, table.shape[0] - 1)]
    return torch.where(in_range[..., None], rows, rows.new_zeros(()))


def _sharded_lookup(table, indices):
    """The lookup of a DTensor table, Megatron's vocab-parallel embedding:
    a table split by rows over some mesh axes looks up, on each rank, the
    ids in its own rows (zeros for the others), and the rows are a partial
    sum over those axes; the batch keeps the ids' split.  Runs on the
    local tensors (``local_map``), with no DTensor indexing."""
    from torch.distributed.tensor import Partial, Replicate

    table = gather_dim(unpartial(table), 1)
    mesh = table.device_mesh
    start, rows = 0, table.shape[0]
    for i, p in enumerate(table.placements):
        if p.is_shard(0):  # an even split (Strategy._fit's rule)
            rows //= mesh.size(i)
            start += mesh.get_local_rank(i) * rows
    ids_pl = list(indices.placements) if is_dtensor(indices) \
        else [Replicate()] * mesh.ndim
    out_pl = [Partial() if t.is_shard(0) else b
              for t, b in zip(table.placements, ids_pl)]
    grad_pl = [Partial() if b.is_shard() else t
               for t, b in zip(table.placements, ids_pl)]
    v = table.shape[0]

    def lookup(t, ids):
        idx = ids.long()
        mine = (idx >= start) & (idx < start + t.shape[0]) & (idx < v)
        got = t[(idx - start).clamp(0, t.shape[0] - 1)]
        return torch.where(mine[..., None], got, got.new_zeros(()))
    return local_call(lookup, lambda *_: out_pl, table, indices,
                      in_grad_placements=(grad_pl, ids_pl))


@dataclass
class IndexedSlices:
    """A sparse gradient: ``values[i]`` is the gradient of table row
    ``indices[i]``; an index < 0 names no row.

    indices ``[n]`` int; values ``[n, dim]``; dense_shape ``(num_rows,
    dim)``."""

    indices: torch.Tensor
    values: torch.Tensor
    dense_shape: tuple

    def deduplicate(self) -> "IndexedSlices":
        """Duplicate indices merged by summing their rows, at the same
        length: the unique indices in ascending order come first, each with
        its sum; the slots after them get index ``-2**31`` and zero rows
        (the reference's ``segment_max`` of an empty segment).

        The ids are sorted stably, and each run of equal ids is one segment,
        summed by :func:`~hetu_tpu_torch.ops.cuda_kernels.
        embedding_scatter_add` on its sorted route (ids: the segment
        numbers, ascending; ``num_rows = n``): each segment's rows in f32,
        in their sorted order, rounded once.  For f32 values that is the
        reference's ``segment_sum`` after its stable ``argsort``: the same
        additions in the same order.  A run of ids < 0 sums too and keeps
        an index < 0."""
        from hetu_tpu_torch.ops.cuda_kernels import embedding_scatter_add
        idx = int32_ids(self.indices, "IndexedSlices.deduplicate")
        n = idx.shape[0]
        sidx, order = torch.sort(idx, stable=True)
        first = torch.ones(n, dtype=torch.bool, device=idx.device)
        first[1:] = sidx[1:] != sidx[:-1]
        seg = torch.cumsum(first, 0, dtype=torch.int32) - 1
        summed = embedding_scatter_add(self.values[order], seg, n)
        out_idx = torch.full((n,), _INT32_MIN, dtype=torch.int32,
                             device=idx.device).scatter_reduce_(
            0, seg.long(), torch.where(first, sidx, -1), "amax")
        return IndexedSlices(out_idx, summed, self.dense_shape)

    def to_dense(self):
        """The ``dense_shape`` gradient: each valid row added onto its row
        of zeros; indices outside ``[0, num_rows)`` drop."""
        out = torch.zeros(self.dense_shape, dtype=self.values.dtype,
                          device=self.values.device)
        return assign_with_indexed_slices(out, self, add=True)


def sparse_embedding_lookup(table, indices):
    """The PS path's lookup: the forward of :func:`embedding_lookup`; the
    caller builds the sparse gradient from the output's cotangent with
    :func:`take_grad_indexed`."""
    return embedding_lookup(table, indices)


def take_grad_indexed(indices, grad_out, num_rows: int) -> IndexedSlices:
    """The lookup's gradient as :class:`IndexedSlices`: ``grad_out [...,
    dim]`` row by row against the flattened ``indices``."""
    return IndexedSlices(indices.reshape(-1),
                         grad_out.reshape(-1, grad_out.shape[-1]),
                         (num_rows, grad_out.shape[-1]))


def sum_sparse_gradient(*slices_list: IndexedSlices) -> IndexedSlices:
    """Several :class:`IndexedSlices` of one table as one (concatenated;
    :meth:`IndexedSlices.deduplicate` sums them)."""
    return IndexedSlices(torch.cat([s.indices for s in slices_list]),
                         torch.cat([s.values for s in slices_list]),
                         slices_list[0].dense_shape)


def assign_with_indexed_slices(table, slices: IndexedSlices, *,
                               add: bool = False):
    """Write ``slices``' rows into ``table`` IN PLACE (the reference returns
    a new table) and return it: set each named row, or with ``add=True``
    add onto it (duplicates accumulate).  Indices outside ``[0,
    num_rows)`` touch nothing.  The reference's set writes such a slot's
    old row 0 back, which can undo a valid write to row 0 in the same
    call; here it is skipped.  Where duplicates set one row, which value
    lands is unspecified, in both packages."""
    idx = slices.indices.long()
    valid = (idx >= 0) & (idx < table.shape[0])
    vals = slices.values.to(table.dtype)
    if add:
        return table.index_add_(0, idx[valid], vals[valid])
    table[idx[valid]] = vals[valid]
    return table
