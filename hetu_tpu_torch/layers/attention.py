"""Multi-head attention layer (counterpart of
``hetu_tpu/layers/attention.py``).

One fused QKV projection, the attention core, the output projection.
Causal self-attention only, the form the GPT decoder runs; the reference's
explicit masks and bidirectional form come with the slices that use them.
``attention_impl="flash"`` routes the causal core through the hand-written
CUDA kernels, forward and backward (:mod:`hetu_tpu_torch.ops.cuda_kernels`);
``"xla"`` keeps the reference's name for the plain composition
(:func:`ops.causal_attention`).  When training, the attention output is
dropped out before the output projection, as in the reference.
"""

from __future__ import annotations

import torch

from hetu_tpu_torch import ops
from hetu_tpu_torch.layers.base import Module
from hetu_tpu_torch.layers.linear import Linear
from hetu_tpu_torch.ops.cuda_kernels import flash_attention


class MultiHeadAttention(Module):
    def __init__(self, hidden_size: int, num_heads: int, *,
                 generator: torch.Generator, dropout_rate: float = 0.0,
                 dtype=torch.float32, attention_impl: str = "xla"):
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
        qkv = self.qkv(x.to(self.dtype)).reshape(b, s, 3, self.num_heads,
                                                 self.head_dim)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    def _out(self, out, b, s):
        return self.out(out.transpose(1, 2).reshape(b, s, self.hidden_size))

    def _causal_core(self, q, k, v):
        """The causal core, honouring ``attention_impl``."""
        if self.attention_impl == "flash":
            return flash_attention(q, k, v, causal=True)
        return ops.causal_attention(q, k, v)

    def _attend(self, x, *, train: bool = False, generator=None):
        """The one body of :meth:`forward` and :meth:`prefill_step`, so
        serving cannot drift from the full forward: (y, k, v)."""
        b, s, _ = x.shape
        q, k, v = self._qkv(x)
        out = self._causal_core(*(t.transpose(1, 2) for t in (q, k, v)))
        out = ops.dropout(out, self.dropout_rate, generator, train=train)
        return self._out(out, b, s), k, v

    def forward(self, x, *, train: bool = False, generator=None):
        """x ``[B, S, H]`` → ``[B, S, H]``; ``generator`` draws the dropout
        mask when training."""
        return self._attend(x, train=train, generator=generator)[0]

    # ---- serving (hetu_tpu_torch/serve): KV-cache prefill / decode ----

    def prefill_step(self, x):
        """Causal prefill that also returns the chunk's K/V for a cache:
        x ``[B, S, H]`` → (y ``[B, S, H]``, k, v ``[B, S, nh, hd]``)."""
        return self._attend(x)

    def decode_step(self, x, k_cache, v_cache, lengths):
        """One-token decode against a slot cache.

        x ``[B, 1, H]``; k_cache/v_cache ``[B, T, nh, hd]``, written IN
        PLACE at ``lengths`` (the reference returns new arrays); lengths
        ``[B]`` = tokens already cached.  Returns (y, k_cache, v_cache).
        """
        q, k, v = self._qkv(x)
        ops.cache_update(k_cache, v_cache, k, v, lengths)
        out = ops.decode_attention(q.transpose(1, 2), k_cache, v_cache,
                                   lengths)
        return self._out(out, x.shape[0], 1), k_cache, v_cache
