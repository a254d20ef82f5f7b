"""Inference serving: KV-cache decode + continuous batching (counterpart of
``hetu_tpu/serve``, the slot and paged engine paths).

  * :mod:`kv_cache` — the slot allocator (:class:`KVCache`) and the paged
    pool (:class:`PagedKVCache`: page tables, refcounted prefix sharing
    with copy-on-write, an LRU prefix index);
  * :mod:`engine` — bucketed prefill + fixed-shape single-token decode
    (:class:`ServeEngine`, flash-attention prefill on the card), and
    :class:`PagedServeEngine`: chunked prefill and paged decode over the
    pool, a drop-in for the slot engine under the scheduler;
  * :mod:`scheduler` — continuous batching: admit into free slots every
    decode step, evict on EOS/max_tokens/deadline, token-budget (slot)
    or page-budget (paged) backpressure, chunked prefill interleaved with
    decode;
  * :mod:`metrics` — TTFT / tokens-per-sec / queue depth / occupancy /
    prefix hits;
  * :mod:`migrate` — live KV-slot migration in one process: slot export
    and import (:class:`KVSlotSnapshot`), the self-describing payload and
    its codecs (byte-compatible with the reference's), and
    ``migrate_inflight`` between two schedulers, slot or paged.

The van wire of migration, the front-end server and the serving pools
wait for later slices.
"""

from hetu_tpu_torch.serve import migrate
from hetu_tpu_torch.serve.engine import PagedServeEngine, ServeEngine
from hetu_tpu_torch.serve.kv_cache import (
    KVCache, KVCacheSpec, KVSlotSnapshot, PagedKVCache, PagePoolExhausted,
)
from hetu_tpu_torch.serve.metrics import ServeMetrics
from hetu_tpu_torch.serve.migrate import MigrationError
from hetu_tpu_torch.serve.scheduler import ContinuousBatchingScheduler, Request

__all__ = ["ServeEngine", "PagedServeEngine", "KVCache", "KVCacheSpec",
           "KVSlotSnapshot", "PagedKVCache", "PagePoolExhausted",
           "ServeMetrics", "MigrationError", "migrate",
           "ContinuousBatchingScheduler", "Request"]
