"""Transformer block (counterpart of ``hetu_tpu/layers/transformer.py``).

Pre-LN (the GPT decoder's) or post-LN (the original BERT encoder's): MHA
and a two-layer MLP, each with a residual, with the reference's dropout on
the attention output and on the MLP output when training.  The KV-cache
steps serve pre-LN causal blocks only, as in the reference.
"""

from __future__ import annotations

import torch

from hetu_tpu_torch import ops
from hetu_tpu_torch.layers.attention import MultiHeadAttention
from hetu_tpu_torch.layers.base import Module, child_generator
from hetu_tpu_torch.layers.linear import Linear
from hetu_tpu_torch.layers.norm import LayerNorm


class TransformerBlock(Module):
    """Pre- or post-LN block: MHA + a tanh-GELU MLP, each with a
    residual."""

    def __init__(self, hidden_size: int, num_heads: int, ffn_size: int, *,
                 generator: torch.Generator, dropout_rate: float = 0.0,
                 causal: bool = False, pre_norm: bool = False,
                 dtype=torch.float32, attention_impl: str = "xla"):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.pre_norm = pre_norm
        self.attn = MultiHeadAttention(
            hidden_size, num_heads, generator=generator,
            dropout_rate=dropout_rate, causal=causal, dtype=dtype,
            attention_impl=attention_impl)
        self.ln1 = LayerNorm(hidden_size)
        self.ffn_in = Linear(hidden_size, ffn_size, generator=generator,
                             dtype=dtype)
        self.ffn_out = Linear(ffn_size, hidden_size, generator=generator,
                              dtype=dtype)
        self.ln2 = LayerNorm(hidden_size)

    def _ffn(self, x, *, train: bool = False, generator=None):
        h = self.ffn_out(ops.gelu(self.ffn_in(x)))
        return ops.dropout(h, self.dropout_rate, generator, train=train)

    def _mlp(self, x, *, train: bool = False, generator=None):
        """The pre-LN MLP with its residual."""
        return x + self._ffn(self.ln2(x), train=train, generator=generator)

    def forward(self, x, *, mask=None, train: bool = False, generator=None):
        """x ``[B, S, H]`` → ``[B, S, H]``; ``mask`` goes to the attention;
        sub-layer 0 (attention) and 1 (MLP) draw their dropout masks from
        children of ``generator``."""
        g_attn = child_generator(generator, 0)
        g_mlp = child_generator(generator, 1)
        if self.pre_norm:
            x = x + self.attn(self.ln1(x), mask=mask, train=train,
                              generator=g_attn)
            return self._mlp(x, train=train, generator=g_mlp)
        # post-LN (the original BERT)
        x = self.ln1(x + self.attn(x, mask=mask, train=train,
                                   generator=g_attn))
        return self.ln2(x + self._ffn(x, train=train, generator=g_mlp))

    # ---- serving (hetu_tpu_torch/serve): KV-cache prefill / decode ----

    def _require_pre_norm(self):
        if not self.pre_norm:
            raise NotImplementedError("KV-cache decode needs pre-LN blocks")

    def prefill_step(self, x):
        """x ``[B, S, H]`` → (out ``[B, S, H]``, k, v ``[B, S, nh, hd]``)."""
        self._require_pre_norm()
        a, k, v = self.attn.prefill_step(self.ln1(x))
        return self._mlp(x + a), k, v

    def prefill_chunk_step(self, x, k_cache, v_cache, starts):
        """A chunk x ``[B, S_c, H]`` at absolute positions ``starts[b] +
        i``, caches ``[B, T, nh, hd]`` holding everything before it and
        written in place → (out, k_cache, v_cache)."""
        self._require_pre_norm()
        a, k_cache, v_cache = self.attn.prefill_chunk_step(
            self.ln1(x), k_cache, v_cache, starts)
        return self._mlp(x + a), k_cache, v_cache

    def decode_step(self, x, k_cache, v_cache, lengths):
        """x ``[B, 1, H]``, caches ``[B, T, nh, hd]`` updated in place →
        (out, k_cache, v_cache)."""
        self._require_pre_norm()
        a, k_cache, v_cache = self.attn.decode_step(
            self.ln1(x), k_cache, v_cache, lengths)
        return self._mlp(x + a), k_cache, v_cache
