"""PS-backed embedding for training loops, the hybrid path (counterpart of
``hetu_tpu/ps/embedding.py``).

The dense parameters train on the card while the embedding table lives on
the parameter server: a worker pulls the batch's rows before the step,
the step takes them as an input and returns their gradients, and the host
pushes those back.  The pull is host work, so :meth:`PSEmbedding.prefetch`
overlaps the next batch's pull with the current step, and
:meth:`PSEmbedding.prefetch_layered` issues a batch's pulls in segments
by the layer that uses them first (P3's priority pull).

Three tiers, one surface: the table in this process's host RAM (the
default), key-range-partitioned over van servers (``endpoints=``), or
over the servers a scheduler lists (``scheduler=``); each with the HET
cache in front of it if asked (``CacheSparseTable`` in process,
``RemoteCacheTable`` over the wire).
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from hetu_tpu_torch.ps.client import CacheSparseTable, PSTable
from hetu_tpu_torch.ps.van import PartitionedPSTable, RemoteCacheTable


def _host_ids(indices) -> np.ndarray:
    """Indices (numpy, list or a tensor on any device) as a numpy copy."""
    if isinstance(indices, torch.Tensor):
        return indices.detach().cpu().numpy().copy()
    return np.array(indices, copy=True)


class PSEmbedding:
    """A ``num_embeddings x dim`` table on the parameter server, updated
    there by ``optimizer`` at ``lr``, with the HET cache in front of it
    when ``cache_capacity`` is given (``cache_policy``, ``pull_bound``).

    The tier: this process's table by default; with ``endpoints``
    (``"host:port,host:port"`` or ``[(host, port), ...]``) a table
    key-range-partitioned over those van servers; with ``scheduler=(host,
    port, n_servers)`` over the servers the scheduler lists (a server may
    rejoin at another address).  ``table_id`` names a remote table shared
    by several workers (a fresh id otherwise).  ``dtype`` is the rows'
    storage on every tier; pulled rows are f32.

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
        if table_id is not None and endpoints is None and scheduler is None:
            raise ValueError(
                "table_id applies to the remote tiers only (the in-process "
                "PSTable assigns its own id); pass endpoints= or "
                "scheduler=, or drop table_id")
        if endpoints is not None and scheduler is not None:
            raise ValueError(
                "pass endpoints= OR scheduler=, not both (the scheduler "
                "resolves the endpoints itself)")
        kw = dict(init=init, init_b=init_b, seed=seed, optimizer=optimizer,
                  lr=lr, dtype=dtype)
        if scheduler is not None:
            host, port, n_servers = scheduler
            self.table = PartitionedPSTable.from_scheduler(
                host, port, n_servers, num_embeddings, dim,
                table_id=table_id, **kw)
            cache_cls = RemoteCacheTable
        elif endpoints is not None:
            self.table = PartitionedPSTable(endpoints, num_embeddings, dim,
                                            table_id=table_id, **kw)
            cache_cls = RemoteCacheTable
        else:
            self.table = PSTable(num_embeddings, dim, **kw)
            cache_cls = CacheSparseTable
        try:
            self.cache = (cache_cls(self.table, cache_capacity,
                                    cache_policy, pull_bound=pull_bound)
                          if cache_capacity else None)
        except Exception:
            # the native group and its heartbeat thread must not leak
            if hasattr(self.table, "close"):
                self.table.close()
            raise
        self.dim = dim
        self.pin_memory = pin_memory
        # one worker thread: a prefetch overlaps the NEXT batch's pull with
        # the current step, and layered segments complete in issue order
        self._prefetcher = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None
        self._layered: dict = {}  # layer index -> Future

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

    def prefetch_layered(self, segments) -> None:
        """P3's priority pull: ``segments`` is an iterable of
        ``(layer_idx, indices)``; the pulls go to the prefetch worker in
        ascending ``layer_idx``, so the rows the model uses first arrive
        first and compute can start while later segments are in flight.
        Collect each with :meth:`pull_layered`, in any order."""
        if self._layered:
            raise RuntimeError(
                "previous layered prefetch not fully collected; call "
                "pull_layered() for every segment first")
        segs = [(int(li), _host_ids(idx)) for li, idx in segments]
        if len({li for li, _ in segs}) != len(segs):
            raise ValueError("duplicate segment layer index")
        for li, idx in sorted(segs, key=lambda t: t[0]):
            self._layered[li] = self._prefetcher.submit(self.pull, idx)

    def pull_layered(self, layer_idx: int) -> torch.Tensor:
        """One segment of :meth:`prefetch_layered`; waits on that segment
        only."""
        fut = self._layered.pop(int(layer_idx), None)
        if fut is None:
            raise RuntimeError(
                f"no layered prefetch in flight for layer {layer_idx}")
        return fut.result()

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
        """Wait for the prefetches in flight (they hold the native cache
        and group), flush the cache, close the cache, close the table.  A
        flush that fails because the servers are gone is dropped: nothing
        durable is left to save."""
        self._prefetcher.shutdown(wait=True)
        self._pending = None
        self._layered.clear()
        try:
            self.flush()
        except RuntimeError:
            pass
        if self.cache is not None and hasattr(self.cache, "close"):
            self.cache.close()
        if hasattr(self.table, "close"):
            self.table.close()

    def __del__(self):  # interpreter-shutdown best effort
        try:
            self._prefetcher.shutdown(wait=False)
        except Exception:
            pass
