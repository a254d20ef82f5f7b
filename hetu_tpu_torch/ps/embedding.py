"""PS-backed embedding for training loops, the hybrid path (counterpart of
``hetu_tpu/ps/embedding.py``).

The dense parameters train on the card while the embedding table lives on
the parameter server: a worker pulls the batch's rows before the step,
the step takes them as an input and returns their gradients, and the host
pushes those back.  The pull is host work, so :meth:`PSEmbedding.prefetch`
overlaps the next batch's pull with the current step.

Only the in-process tier is ported: the table in this process's host RAM,
with the HET cache in front of it if asked.  The remote tiers
(``endpoints=``, ``scheduler=``) need the van, which comes with the fleet
slice (``ROADMAP.md``, Queue 1).
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from hetu_tpu_torch.ps.client import CacheSparseTable, PSTable


def _host_ids(indices) -> np.ndarray:
    """Indices (numpy, list or a tensor on any device) as a numpy copy."""
    if isinstance(indices, torch.Tensor):
        return indices.detach().cpu().numpy().copy()
    return np.array(indices, copy=True)


class PSEmbedding:
    """A ``num_embeddings x dim`` table on the in-process parameter
    server, updated there by ``optimizer`` at ``lr``, with the HET cache
    in front of it when ``cache_capacity`` is given (``cache_policy``,
    ``pull_bound``).

    :meth:`pull` returns the rows as a float32 CPU tensor, in pinned
    memory with ``pin_memory=True`` (so that the copy to the card does not
    block the host); :meth:`push` takes the rows' gradients as a tensor
    from either device (or a numpy array)."""

    def __init__(self, num_embeddings: int, dim: int, *,
                 optimizer: str = "sgd", lr: float = 0.01,
                 cache_capacity: Optional[int] = None,
                 cache_policy: str = "lfuopt", pull_bound: int = 0,
                 init: str = "normal", init_b: float = 0.01, seed: int = 0,
                 endpoints=None, scheduler=None, table_id=None,
                 dtype: str = "f32", pin_memory: bool = False):
        if endpoints is not None or scheduler is not None \
                or table_id is not None:
            raise NotImplementedError(
                "PSEmbedding's remote tiers (endpoints=, scheduler=, "
                "table_id=) need the van, which hetu_tpu_torch has not "
                "ported yet (ROADMAP.md, Queue 1: the host-side fleet "
                "planes); the in-process tier takes none of them")
        self.table = PSTable(num_embeddings, dim, init=init, init_b=init_b,
                             seed=seed, optimizer=optimizer, lr=lr,
                             dtype=dtype)
        self.cache = (CacheSparseTable(self.table, cache_capacity,
                                       cache_policy, pull_bound=pull_bound)
                      if cache_capacity else None)
        self.dim = dim
        self.pin_memory = pin_memory
        # one worker thread: a prefetch overlaps the NEXT batch's pull with
        # the current step
        self._prefetcher = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None

    def pull(self, indices) -> torch.Tensor:
        """The rows of this batch: ``[*indices.shape, dim]`` float32 on the
        CPU (pinned if the embedding was made with ``pin_memory``)."""
        idx = _host_ids(indices)
        out = torch.empty((idx.size, self.dim), dtype=torch.float32,
                          pin_memory=self.pin_memory)
        if self.cache is not None:
            self.cache.embedding_lookup(idx, out=out.numpy())
        else:
            self.table.sparse_pull(idx, out=out.numpy())
        return out.reshape(*idx.shape, self.dim)

    def prefetch(self, indices) -> None:
        """Start pulling ``indices`` on the worker thread;
        :meth:`pull_prefetched` collects.  Push a step's gradients BEFORE
        prefetching rows they touch, so that the pull sees them (the cache
        tier tolerates the race within its bound)."""
        if self._pending is not None:
            raise RuntimeError(
                "previous prefetch not collected; call pull_prefetched() "
                "first (silently dropping it would misalign the pipeline)")
        self._pending = self._prefetcher.submit(self.pull,
                                                _host_ids(indices))

    def pull_prefetched(self) -> torch.Tensor:
        if self._pending is None:
            raise RuntimeError("no prefetch in flight")
        out = self._pending.result()
        self._pending = None
        return out

    def push(self, indices, row_grads) -> None:
        """Apply ``d(loss)/d(rows)`` on the server, or into the cache."""
        idx = _host_ids(indices)
        if isinstance(row_grads, torch.Tensor):
            row_grads = row_grads.detach().to("cpu", torch.float32).numpy()
        if self.cache is not None:
            self.cache.embedding_update(idx, row_grads)
        else:
            self.table.sparse_push(idx, row_grads)

    def flush(self) -> None:
        """Send the cache's accumulated gradients to the table."""
        if self.cache is not None:
            self.cache.flush()

    def save(self, path) -> None:
        self.flush()
        self.table.save(path)

    def load(self, path) -> None:
        self.table.load(path)
        # the load bumped every row version, so the cache re-pulls; its old
        # hit ratios describe a dead epoch
        if self.cache is not None:
            self.cache.reset_stats()

    def close(self) -> None:
        """Wait for a prefetch in flight, then flush the cache."""
        self._prefetcher.shutdown(wait=True)
        self._pending = None
        self.flush()

    def __del__(self):  # interpreter-shutdown best effort
        try:
            self._prefetcher.shutdown(wait=False)
        except Exception:
            pass
