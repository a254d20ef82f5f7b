"""The parameter server (counterpart of ``hetu_tpu/ps``): the C++ core,
its van and its remote tiers, built with g++ on first use; the in-process
table and HET cache, SSP clocks and partial reduce (:mod:`client`); the
remote tables, the partitioned table, the remote HET cache, the scheduler
role and the blob channel (:mod:`van`); and the hybrid path's
``PSEmbedding`` over any tier.

``PSEmbedding`` (the one part that needs ``torch``) loads on first use: a
van server process imports this package and must start without
``torch``."""

from hetu_tpu_torch.ps import van
from hetu_tpu_torch.ps.binding import lib
from hetu_tpu_torch.ps.client import (
    CacheSparseTable, PartialReduce, PSTable, SSPController,
)
from hetu_tpu_torch.ps.van import (
    PartitionedPSTable, RemoteCacheTable, RemotePReduce, RemotePSTable,
    RemoteSSP, scheduler_map, serve, serve_and_register,
)

__all__ = ["lib", "van", "serve", "serve_and_register", "scheduler_map",
           "PSTable", "CacheSparseTable", "SSPController", "PartialReduce",
           "RemotePSTable", "PartitionedPSTable", "RemoteCacheTable",
           "RemoteSSP", "RemotePReduce", "PSEmbedding"]


def __getattr__(name):
    if name == "PSEmbedding":
        from hetu_tpu_torch.ps.embedding import PSEmbedding
        return PSEmbedding
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
