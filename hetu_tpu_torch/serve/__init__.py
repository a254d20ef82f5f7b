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
  * :mod:`migrate` — live KV-slot migration: slot export and import
    (:class:`KVSlotSnapshot`), the self-describing payload and its codecs
    (byte-compatible with the reference's), the chunked wire over a van
    blob channel, and ``migrate_inflight`` between two schedulers, slot or
    paged, in one process or over a wire;
  * :mod:`server` — the front end over the van: :class:`InferenceServer`
    (engine loop, one listener per client channel pair, crash requeue and
    failover grace, dedup of a retried submit) and
    :class:`InferenceClient`;
  * :mod:`pool` — :class:`ServingPool`: least-loaded routing over N
    listener-less servers, planned drain with live KV migration (zero
    re-prefill), unplanned engine-death failover with re-prefill, and
    the chaos hooks that apply ``resilience.faults`` serve events;
  * :mod:`crosshost` — :class:`CrossProcessServingPool`: the pool with
    each member an OS process of its own, membership leased on a van
    blackboard, the controller's state journaled on the van (a takeover
    adopts a dead controller's fleet), drains over the wire;
  * :mod:`recsys` — online CTR serving: the bounded-staleness serving
    cache over the PS (:class:`ServingEmbeddingCache`), the bucketed
    Wide & Deep / DeepFM engine on the card (:class:`RecsysEngine`), the
    micro-batcher, its wire front end and :class:`RecsysPool`.
"""

from hetu_tpu_torch.serve import migrate
from hetu_tpu_torch.serve.crosshost import CrossProcessServingPool
from hetu_tpu_torch.serve.engine import PagedServeEngine, ServeEngine
from hetu_tpu_torch.serve.kv_cache import (
    KVCache, KVCacheSpec, KVSlotSnapshot, PagedKVCache, PagePoolExhausted,
)
from hetu_tpu_torch.serve.metrics import ServeMetrics
from hetu_tpu_torch.serve.migrate import MigrationError
from hetu_tpu_torch.serve.pool import EngineKilled, ServingPool
from hetu_tpu_torch.serve.recsys import (
    NOT_CACHED, STALENESS_BUCKETS, EngineKilledError, RecsysBatcher,
    RecsysClient, RecsysEngine, RecsysPool, RecsysRequest, RecsysServer,
    ServingEmbeddingCache, recsys_member_factory,
)
from hetu_tpu_torch.serve.scheduler import ContinuousBatchingScheduler, Request
from hetu_tpu_torch.serve.server import (
    InferenceClient, InferenceServer, request_channel, response_channel,
)

__all__ = ["ServeEngine", "PagedServeEngine", "KVCache", "KVCacheSpec",
           "KVSlotSnapshot", "PagedKVCache", "PagePoolExhausted",
           "ServeMetrics", "MigrationError", "migrate",
           "ContinuousBatchingScheduler", "Request", "InferenceServer",
           "InferenceClient", "request_channel", "response_channel",
           "ServingPool", "EngineKilled", "CrossProcessServingPool",
           "ServingEmbeddingCache", "RecsysEngine", "RecsysBatcher",
           "RecsysRequest", "RecsysServer", "RecsysClient", "RecsysPool",
           "recsys_member_factory", "EngineKilledError", "NOT_CACHED",
           "STALENESS_BUCKETS"]
