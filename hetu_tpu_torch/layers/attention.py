"""Multi-head attention layer (counterpart of
``hetu_tpu/layers/attention.py``).

One fused QKV projection, the attention core, the output projection, with
the reference's choice of core:

* no mask, causal: the causal core (:meth:`MultiHeadAttention._causal_core`,
  shared with the serving prefill);
* no mask, bidirectional: the flash kernels with ``causal=False``, or the
  plain :func:`ops.attention`;
* an explicit mask (``1`` = keep, broadcastable to ``[B, heads, S, S]``):
  the plain :func:`ops.attention`, ANDed with the causal mask when the
  layer is causal.  The reference's flash path covers only the unmasked
  cases, so ``attention_impl="flash"`` with a mask warns and takes the
  plain path for that call, as the reference does.

``attention_impl="flash"`` routes the unmasked cores through the
hand-written CUDA kernels, forward and backward
(:mod:`hetu_tpu_torch.ops.cuda_kernels`); ``"xla"`` keeps the reference's
name for the plain composition.  When training, the attention output is
dropped out before the output projection, as in the reference.
"""

from __future__ import annotations

import warnings

import torch

from hetu_tpu_torch import ops
from hetu_tpu_torch.layers.base import Module
from hetu_tpu_torch.layers.linear import Linear
from hetu_tpu_torch.ops.cuda_kernels import flash_attention
from hetu_tpu_torch.parallel.spec import (
    gather_dim, heads_for_cache, local_call, moved_heads, shard_heads,
)


class MultiHeadAttention(Module):
    def __init__(self, hidden_size: int, num_heads: int, *,
                 generator: torch.Generator, dropout_rate: float = 0.0,
                 causal: bool = False, dtype=torch.float32,
                 attention_impl: str = "xla"):
        super().__init__()
        if attention_impl not in ("xla", "flash"):
            raise ValueError(f"attention_impl must be 'xla' or 'flash', "
                             f"got {attention_impl!r}")
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} is not divisible "
                             f"by num_heads {num_heads}")
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.dropout_rate = dropout_rate
        self.causal = causal
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.qkv = Linear(hidden_size, 3 * hidden_size, generator=generator,
                          dtype=dtype)
        self.out = Linear(hidden_size, hidden_size, generator=generator,
                          dtype=dtype)

    def _qkv(self, x):
        """Fused projection split into q/k/v in cache layout
        ``[B, S, nh, hd]``."""
        b, s, _ = x.shape
        # under MegatronLM the projection's output is split over tp at a
        # point that is no head boundary: gather it, then give each rank
        # its own heads
        qkv = gather_dim(self.qkv(x.to(self.dtype)), -1).reshape(
            b, s, 3, self.num_heads, self.head_dim)
        return tuple(shard_heads(qkv[:, :, i], 2) for i in range(3))

    def _out(self, out, b, s):
        return self.out(out.transpose(1, 2).reshape(b, s, self.hidden_size))

    def _causal_core(self, q, k, v):
        """The unmasked causal core, honouring ``attention_impl``."""
        if self.attention_impl == "flash":
            return flash_attention(q, k, v, causal=True)
        return ops.causal_attention(q, k, v)

    def _core(self, q, k, v, mask):
        """The attention core for ``q, k, v [B, nh, S, hd]`` and an
        optional keep-mask, chosen as the reference chooses it."""
        if mask is None:
            if self.causal:
                return self._causal_core(q, k, v)
            if self.attention_impl == "flash":
                return flash_attention(q, k, v, causal=False)
            return ops.attention(q, k, v)
        if self.attention_impl == "flash":
            warnings.warn(
                "attention_impl='flash' ignores explicit masks; falling "
                "back to the xla path for this call (flash covers the "
                "causal/unmasked cases)", stacklevel=2)
        if self.causal:
            s_q, s_k = q.shape[-2], k.shape[-2]
            mask = mask.bool() & torch.ones(
                s_q, s_k, dtype=torch.bool, device=q.device).tril()
        return ops.attention(q, k, v, mask=mask)

    def _attend(self, x, *, mask=None, train: bool = False, generator=None):
        """The one body of :meth:`forward` and :meth:`prefill_step`, so
        serving cannot drift from the full forward: (y, k, v)."""
        b, s, _ = x.shape
        q, k, v = self._qkv(x)
        out = self._core(*(t.transpose(1, 2) for t in (q, k, v)), mask)
        out = ops.dropout(out, self.dropout_rate, generator, train=train)
        return self._out(out, b, s), k, v

    def forward(self, x, *, mask=None, train: bool = False, generator=None):
        """x ``[B, S, H]`` → ``[B, S, H]``; ``mask`` (1 = keep) broadcasts
        to ``[B, heads, S, S]``; ``generator`` draws the dropout mask when
        training."""
        return self._attend(x, mask=mask, train=train,
                            generator=generator)[0]

    # ---- serving (hetu_tpu_torch/serve): KV-cache prefill / decode ----

    def _require_causal(self):
        if not self.causal:
            raise NotImplementedError("KV-cache decode is causal-LM only")

    def prefill_step(self, x):
        """Causal prefill that also returns the chunk's K/V for a cache:
        x ``[B, S, H]`` → (y ``[B, S, H]``, k, v ``[B, S, nh, hd]``)."""
        self._require_causal()
        return self._attend(x)

    def _cached_step(self, core, x, k_cache, v_cache, starts):
        self._require_causal()
        # under tp the cache holds this rank's heads (or all of them when
        # tp does not divide them): the cache write and the core run on
        # each rank's local tensors
        q, k, v = (heads_for_cache(t, 2, k_cache.shape[2])
                   for t in self._qkv(x))

        def step(q, k, v, k_cache, v_cache, starts):
            ops.cache_update(k_cache, v_cache, k, v, starts)
            return core(q.transpose(1, 2), k_cache, v_cache, starts)
        out = local_call(step, moved_heads(2, 1), q, k, v, k_cache, v_cache,
                         starts)
        return self._out(out, *x.shape[:2]), k_cache, v_cache

    def prefill_chunk_step(self, x, k_cache, v_cache, starts):
        """Chunked prefill against a cache (the paged engine's prefill).

        x ``[B, S_c, H]`` — a chunk whose token ``i`` sits at absolute
        position ``starts[b] + i``; k_cache/v_cache ``[B, T, nh, hd]``
        holding the tokens before the chunk, the chunk's K/V written IN
        PLACE at ``starts`` (a start past ``T - S_c`` clamps, as in the
        reference).  Attends over the history and the chunk's causal
        triangle.  Returns (y, k_cache, v_cache); with ``starts == 0`` and
        ``S_c == T`` the numbers are :meth:`prefill_step`'s."""
        return self._cached_step(ops.chunk_attention, x, k_cache, v_cache,
                                 starts)

    def decode_step(self, x, k_cache, v_cache, lengths):
        """One-token decode against a slot cache.

        x ``[B, 1, H]``; k_cache/v_cache ``[B, T, nh, hd]``, written IN
        PLACE at ``lengths`` (the reference returns new arrays); lengths
        ``[B]`` = tokens already cached.  Returns (y, k_cache, v_cache).
        """
        return self._cached_step(ops.decode_attention, x, k_cache, v_cache,
                                 lengths)
