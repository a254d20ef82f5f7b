"""The parameter server's in-process tier (counterpart of
``hetu_tpu/ps``): the C++ core built with g++ on first use, its table and
HET cache, and the hybrid path's ``PSEmbedding``."""

from hetu_tpu_torch.ps.binding import lib
from hetu_tpu_torch.ps.client import CacheSparseTable, PSTable
from hetu_tpu_torch.ps.embedding import PSEmbedding

__all__ = ["lib", "PSTable", "CacheSparseTable", "PSEmbedding"]
