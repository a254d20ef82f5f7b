"""Slot-allocated KV cache for decoder-LM serving (counterpart of
``hetu_tpu/serve/kv_cache.py``).

:class:`KVCache` is the whole-sequence slot allocator: ONE pair of device
tensors ``[L, num_slots, max_len, kv_heads, head_dim]`` and a free list of
slots.  Admitted sequences take a slot and release it on eviction, so
finished sequences hand their memory to queued requests at once
(continuous batching, scheduler.py).

The reference's arrays are immutable and swapped wholesale after each
jitted step (donated, so XLA updates them in place).  Here the engine and
the model's decode step write into these tensors directly.

GQA-aware: the cache stores the model's ``num_kv_heads`` heads un-repeated;
``ops.decode_attention`` repeats them at read time.

The paged allocator (``PagedKVCache``, prefix sharing, copy-on-write) and
slot export/import for migration wait for a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class KVCacheSpec:
    """Per-layer cache geometry, derived from a model config."""

    num_layers: int
    num_kv_heads: int
    head_dim: int
    dtype: torch.dtype = torch.float32

    @staticmethod
    def from_model(model) -> "KVCacheSpec":
        """Read the geometry off a model config: configs with
        ``num_kv_heads`` are GQA (cache the un-repeated heads); the rest
        cache all ``num_heads``."""
        c = model.c
        nkv = getattr(c, "num_kv_heads", None) or c.num_heads
        return KVCacheSpec(
            num_layers=c.num_layers, num_kv_heads=nkv,
            head_dim=c.hidden_size // c.num_heads, dtype=c.dtype)


class KVCache:
    """Slot-allocated K/V tensors + free list.

    ``k``/``v``: ``[L, num_slots, max_len, kv_heads, head_dim]`` on
    ``device``, updated in place.  ``lengths``: host-side int32 per slot —
    tokens currently cached.
    """

    def __init__(self, spec: KVCacheSpec, num_slots: int, max_len: int, *,
                 device="cuda"):
        if num_slots < 1 or max_len < 2:
            raise ValueError(f"need >=1 slot and max_len >= 2, got "
                             f"{num_slots}/{max_len}")
        self.spec = spec
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        shape = (spec.num_layers, num_slots, max_len, spec.num_kv_heads,
                 spec.head_dim)
        self.k = torch.zeros(shape, dtype=spec.dtype, device=device)
        self.v = torch.zeros(shape, dtype=spec.dtype, device=device)
        self.lengths = np.zeros(num_slots, np.int32)
        # LIFO keeps hot slots hot
        self._free = list(range(num_slots - 1, -1, -1))

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def occupancy(self) -> float:
        return 1.0 - len(self._free) / self.num_slots

    @property
    def active_tokens(self) -> int:
        """Tokens currently cached across occupied slots (the scheduler's
        token-budget currency)."""
        return int(self.lengths.sum())

    def alloc(self) -> int:
        """Claim a free slot (length reset); raises if none are free —
        callers gate admission on ``num_free``."""
        if not self._free:
            raise RuntimeError("KV cache has no free slots")
        slot = self._free.pop()
        self.lengths[slot] = 0
        return slot

    def free(self, slot: int) -> None:
        """Release a slot.  The K/V bytes are NOT zeroed — decode masks
        positions beyond ``lengths`` and prefill overwrites from position
        0, so stale rows are unreachable."""
        if slot in self._free:
            raise ValueError(f"slot {slot} double-freed")
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range")
        self.lengths[slot] = 0
        self._free.append(slot)


def pow2_ceil(n: int, cap: int) -> int:
    """Smallest power of two >= n, clamped to [1, cap]."""
    b = 1
    while b < n:
        b *= 2
    return max(min(b, cap), 1)


class PagePoolExhausted(RuntimeError):
    """A paged KV pool has no free page and nothing reclaimable.  The
    scheduler catches exactly this type to preempt a victim; only the
    paged engine (a later slice) raises it."""
