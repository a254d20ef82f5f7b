"""Bucketed prefill + single-token decode over the model forwards
(counterpart of ``hetu_tpu/serve/engine.py``, the slot ``ServeEngine``).

Prompts are right-padded to power-of-two BUCKETS (plus the cache's
``max_len`` as the last bucket), exactly as in the reference: the numbers
then equal the reference's (the same padded shapes), and the set of prefill
shapes stays bounded by ``len(buckets)`` — what a later CUDA-graph capture
needs.  ``prefill_compiles`` counts the buckets seen (PyTorch compiles
nothing; the metric keeps its reference name).

Prefill runs one request at a time (batch 1); decode steps ALL cache slots
at once with fixed shapes (``[num_slots]`` tokens/lengths), so continuous
batching admissions never change the decode shape.  Free slots ride along
masked.

Both steps run under ``torch.inference_mode()`` on a copy of the model
whose matmul weights were cast to the compute type ONCE, when the engine
was built (:meth:`GPTModel.inference_copy`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hetu_tpu_torch.serve.kv_cache import KVCache, KVCacheSpec
from hetu_tpu_torch.serve.metrics import ServeMetrics
from hetu_tpu_torch.telemetry import trace


def _pow2_buckets(lo: int, hi: int) -> tuple:
    out = []
    b = lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(out)


class ServeEngine:
    """Owns the serving copy of the model, the KV cache and the steps.

    model: a ``GPTModel`` (anything with ``inference_copy`` /
    ``prefill_with_cache`` / ``decode_with_cache``).  num_slots bounds
    concurrent sequences; max_len bounds tokens per sequence (prompt +
    generation), defaulting to the model's max_position.  The engine runs
    on ``device`` (the card unless the caller asks for the CPU).
    """

    def __init__(self, model, *, num_slots: int = 8,
                 max_len: Optional[int] = None, min_bucket: int = 16,
                 metrics: Optional[ServeMetrics] = None, device="cuda"):
        self.metrics = metrics or ServeMetrics()
        c = model.c
        max_len = int(max_len or c.max_position)
        if max_len > c.max_position:
            raise ValueError(f"max_len {max_len} exceeds the model's "
                             f"max_position {c.max_position}")
        self.device = torch.device(device)
        self.model = model.inference_copy().to(self.device)
        self.buckets = _pow2_buckets(min(min_bucket, max_len), max_len)
        self.cache = KVCache(KVCacheSpec.from_model(model), num_slots,
                             max_len, device=self.device)
        # newest token per slot (decode feeds all slots every step)
        self.last_tokens = np.zeros(num_slots, np.int32)
        self.active = np.zeros(num_slots, bool)
        self._seen_buckets = set()
        self._decoded = False

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt of {n} tokens exceeds max_len "
                         f"{self.cache.max_len}")

    def _tensor(self, array):
        return torch.tensor(array, dtype=torch.int64, device=self.device)

    # ---- serving steps ----
    def prefill(self, slot: int, prompt_ids) -> int:
        """Run the prompt through the bucketed prefill into ``slot``;
        returns the first generated (greedy) token."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        n = prompt.shape[0]
        if n < 1:
            raise ValueError("empty prompt")
        if n >= self.cache.max_len:
            raise ValueError(f"prompt of {n} tokens leaves no room to "
                             f"generate within max_len {self.cache.max_len}")
        s = self.bucket_for(n)
        if s not in self._seen_buckets:
            self._seen_buckets.add(s)
            self.metrics.inc("prefill_compiles")
            trace.instant("serve.recompile",
                          {"kind": "prefill", "bucket": s})
        with trace.span("serve.prefill") as sp, torch.inference_mode():
            sp.set("slot", int(slot))
            sp.set("tokens", n)
            sp.set("bucket", s)
            ids = np.zeros((1, s), np.int32)
            ids[0, :n] = prompt
            # last_index: only the final real position's logits are
            # computed — the padded tail's head matmul is skipped
            logits, k, v = self.model.prefill_with_cache(
                self._tensor(ids), last_index=n - 1)
            # k: [L, 1, S, nkv, hd] — batch 1 IS the slot's row
            self.cache.k[:, slot, :s] = k[:, 0]
            self.cache.v[:, slot, :s] = v[:, 0]
            # the host fetch is the sync point: inside the span, so the
            # span covers device execution, not just the launches
            first = int(torch.argmax(logits[0]))
        self.cache.lengths[slot] = n
        self.last_tokens[slot] = first
        self.active[slot] = True
        self.metrics.inc("prefill_tokens", n)
        return first

    def decode(self) -> dict:
        """One decode step over every slot; returns {slot: token} for the
        active ones.  Inactive slots compute masked garbage (the shapes
        stay fixed) and are ignored."""
        if not self.active.any():
            return {}
        if (self.cache.lengths[self.active] >= self.cache.max_len).any():
            raise RuntimeError(
                "an active slot is at max_len; the scheduler must evict "
                "before decoding further")
        if not self._decoded:
            self._decoded = True
            self.metrics.inc("decode_compiles")
            trace.instant("serve.recompile", {"kind": "decode"})
        with trace.span("serve.decode") as sp, torch.inference_mode():
            if trace.enabled():  # the reduction is attr-only: skip when off
                sp.set("active", int(self.active.sum()))
            logits, _, _ = self.model.decode_with_cache(
                self._tensor(self.last_tokens), self.cache.k, self.cache.v,
                self._tensor(self.cache.lengths))
            # host fetch = the sync point; inside the span (see prefill)
            nxt = torch.argmax(logits, -1).cpu().numpy()
        out = {}
        for slot in np.nonzero(self.active)[0]:
            self.cache.lengths[slot] += 1
            self.last_tokens[slot] = nxt[slot]
            out[int(slot)] = int(nxt[slot])
        self.metrics.inc("decode_steps")
        self.metrics.observe_decode(len(out))
        return out

    # ---- slot lifecycle (delegates; engine keeps its masks in sync) ----
    def alloc_slot(self) -> int:
        slot = self.cache.alloc()
        self.active[slot] = False
        return slot

    def release(self, slot: int) -> None:
        self.active[slot] = False
        self.last_tokens[slot] = 0
        self.cache.free(slot)
