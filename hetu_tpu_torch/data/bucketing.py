"""Bucketed padding for batches of varying size (counterpart of
``hetu_tpu/data/bucketing.py``, copied: the port imports nothing of the
JAX package).

Every batch is padded up to the nearest power-of-two bucket and the step
masks the padding, so a stream of varying batch sizes meets at most
``log2(max_batch) + 1`` shapes.  The reference needs that to bound its jit
programs; the port runs eagerly and keeps the same contract.

Padding contract:
- dense arrays pad with zeros (their loss terms are masked out),
- integer id arrays pad with ``-1`` — the optimizer's ``apply_indexed``
  drops negative rows, so padded rows update neither parameters nor slots,
- the true row count rides along as ``n_valid`` for the in-step mask.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np


def pow2_bucket(n: int, max_size: int) -> int:
    """Smallest power-of-two >= n, capped at max_size (n <= max_size)."""
    if n <= 0:
        raise ValueError(f"batch size must be positive, got {n}")
    if n > max_size:
        raise ValueError(f"batch of {n} exceeds max_size {max_size}")
    b = 1
    while b < n:
        b <<= 1
    return min(b, max_size)


def pad_batch(arrays: Sequence[np.ndarray], bucket: int):
    """Pad each array's leading dim up to ``bucket``.

    Returns ``(padded_arrays, n_valid)``.  Integer arrays pad with -1
    (dropped by sparse updates), everything else with zeros.
    """
    n = arrays[0].shape[0]
    if any(a.shape[0] != n for a in arrays):
        raise ValueError("arrays disagree on leading dim")
    if n == bucket:
        return list(arrays), n
    out = []
    for a in arrays:
        fill = -1 if np.issubdtype(a.dtype, np.integer) else 0
        pad = np.full((bucket - n, *a.shape[1:]), fill, a.dtype)
        out.append(np.concatenate([a, pad], axis=0))
    return out, n


class BucketedLoader:
    """Wrap an iterable of (tuple-of-array) batches with bucketed padding.

    Yields ``(*padded_arrays, n_valid)`` with at most
    ``log2(max_batch) + 1`` distinct leading dims across any stream.

        step = model.masked_step_fn(optimizer)
        for dx, ids, y, n_valid in BucketedLoader(batches, 2048):
            loss, logit = step(dx, ids, y, n_valid)
    """

    def __init__(self, batches: Iterable, max_batch: int):
        self.batches = batches
        self.max_batch = int(max_batch)

    def __iter__(self):
        for batch in self.batches:
            arrays = [np.asarray(a) for a in
                      (batch if isinstance(batch, (tuple, list))
                       else [batch])]
            bucket = pow2_bucket(arrays[0].shape[0], self.max_batch)
            padded, n_valid = pad_batch(arrays, bucket)
            yield (*padded, n_valid)

    @property
    def max_distinct_shapes(self) -> int:
        """Exact upper bound on distinct leading dims this wrapper can
        emit: every power of two up to max_batch, plus max_batch itself
        when it is not a power of two (pow2_bucket caps there)."""
        k = int(np.log2(self.max_batch)) + 1
        return k if self.max_batch & (self.max_batch - 1) == 0 else k + 1
