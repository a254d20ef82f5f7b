"""Inference serving: KV-cache decode + continuous batching (counterpart of
``hetu_tpu/serve``, the slot engine path).

  * :mod:`kv_cache` — the slot allocator (:class:`KVCache`);
  * :mod:`engine` — bucketed prefill + fixed-shape single-token decode
    (:class:`ServeEngine`), flash-attention prefill on the card;
  * :mod:`scheduler` — continuous batching: admit into free slots every
    decode step, evict on EOS/max_tokens/deadline, token-budget
    backpressure;
  * :mod:`metrics` — TTFT / tokens-per-sec / queue depth / occupancy.

The paged engine, the van front-end server, pools and migration wait for
later slices.
"""

from hetu_tpu_torch.serve.engine import ServeEngine
from hetu_tpu_torch.serve.kv_cache import KVCache, KVCacheSpec
from hetu_tpu_torch.serve.metrics import ServeMetrics
from hetu_tpu_torch.serve.scheduler import ContinuousBatchingScheduler, Request

__all__ = ["ServeEngine", "KVCache", "KVCacheSpec", "ServeMetrics",
           "ContinuousBatchingScheduler", "Request"]
