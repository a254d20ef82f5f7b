"""The parameter server (counterpart of ``hetu_tpu/ps``): the C++ core
and its van, built with g++ on first use; the in-process tier's table and
HET cache, the hybrid path's ``PSEmbedding``, and the van's blob channel
(:mod:`van`), the transport of the serving front end and the migration
wire.  The remote tiers wait for a later slice."""

from hetu_tpu_torch.ps import van
from hetu_tpu_torch.ps.binding import lib
from hetu_tpu_torch.ps.client import CacheSparseTable, PSTable
from hetu_tpu_torch.ps.embedding import PSEmbedding
from hetu_tpu_torch.ps.van import serve

__all__ = ["lib", "van", "serve", "PSTable", "CacheSparseTable",
           "PSEmbedding"]
