"""Transformer block (counterpart of ``hetu_tpu/layers/transformer.py``).

The pre-LN causal block the GPT decoder runs, with the reference's dropout
on the attention output and on the MLP output when training; the post-LN
(BERT) layout comes with the slice that uses it.
"""

from __future__ import annotations

import torch

from hetu_tpu_torch import ops
from hetu_tpu_torch.layers.attention import MultiHeadAttention
from hetu_tpu_torch.layers.base import Module, child_generator
from hetu_tpu_torch.layers.linear import Linear
from hetu_tpu_torch.layers.norm import LayerNorm


class TransformerBlock(Module):
    """Pre-LN block: causal MHA + a GELU MLP, each with a residual."""

    def __init__(self, hidden_size: int, num_heads: int, ffn_size: int, *,
                 generator: torch.Generator, dropout_rate: float = 0.0,
                 dtype=torch.float32, attention_impl: str = "xla"):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.attn = MultiHeadAttention(
            hidden_size, num_heads, generator=generator,
            dropout_rate=dropout_rate, dtype=dtype,
            attention_impl=attention_impl)
        self.ln1 = LayerNorm(hidden_size)
        self.ffn_in = Linear(hidden_size, ffn_size, generator=generator,
                             dtype=dtype)
        self.ffn_out = Linear(ffn_size, hidden_size, generator=generator,
                              dtype=dtype)
        self.ln2 = LayerNorm(hidden_size)

    def _mlp(self, x, *, train: bool = False, generator=None):
        h = self.ffn_out(ops.gelu(self.ffn_in(self.ln2(x))))
        return x + ops.dropout(h, self.dropout_rate, generator, train=train)

    def forward(self, x, *, train: bool = False, generator=None):
        """x ``[B, S, H]`` → ``[B, S, H]``; sub-layer 0 (attention) and 1
        (MLP) draw their dropout masks from children of ``generator``."""
        x = x + self.attn(self.ln1(x), train=train,
                          generator=child_generator(generator, 0))
        return self._mlp(x, train=train,
                         generator=child_generator(generator, 1))

    # ---- serving (hetu_tpu_torch/serve): KV-cache prefill / decode ----

    def prefill_step(self, x):
        """x ``[B, S, H]`` → (out ``[B, S, H]``, k, v ``[B, S, nh, hd]``)."""
        a, k, v = self.attn.prefill_step(self.ln1(x))
        return self._mlp(x + a), k, v

    def decode_step(self, x, k_cache, v_cache, lengths):
        """x ``[B, 1, H]``, caches ``[B, T, nh, hd]`` updated in place →
        (out, k_cache, v_cache)."""
        a, k_cache, v_cache = self.attn.decode_step(
            self.ln1(x), k_cache, v_cache, lengths)
        return self._mlp(x + a), k_cache, v_cache
