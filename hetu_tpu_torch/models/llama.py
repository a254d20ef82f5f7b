"""Llama-family decoder LM: RMSNorm, SwiGLU, RoPE and GQA (counterpart of
``hetu_tpu/models/llama.py``).

Pre-RMSNorm residual blocks with no biases anywhere, one fused QKV weight,
rotary position embedding on q and k, grouped-query attention (each of the
``num_kv_heads`` K/V heads serves ``num_heads / num_kv_heads`` query heads)
and an UNTIED LM head.  The reference stacks its blocks ``[L, ...]`` and
runs them under ``lax.scan``; here they are an ``nn.ModuleList`` walked by
a Python loop, each block recomputed in the backward pass when
``config.remat`` asks.

Training runs :meth:`LlamaModel.lm_loss_fn` (the fused chunked LM-head
cross-entropy against ``lm_head``, or the unfused head + CE); serving runs
the KV-cache methods on a :meth:`LlamaModel.inference_copy`.  The cache
holds the ROTATED keys and the ``num_kv_heads`` un-repeated heads;
``ops.decode_attention`` repeats them at read time.

Still to port: ``HeteroLlama`` (with slice 8d of the multi-GPU port).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from hetu_tpu_torch import init as initializers
from hetu_tpu_torch import ops
from hetu_tpu_torch.layers.base import Module, require_own_parameters
from hetu_tpu_torch.ops.cuda_kernels import flash_attention
from hetu_tpu_torch.parallel.spec import (
    gather_dim, is_dtensor, local_call, moved_heads, shard_heads,
)


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None  # < num_heads = GQA; None = MHA
    ffn_size: int = 11008               # SwiGLU intermediate
    max_position: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    dtype: torch.dtype = torch.float32  # compute type; weights stay f32
    attention_impl: str = "xla"         # 'flash' = the CUDA kernels
    remat: bool = False                 # recompute each block backward
    fused_ce: bool = True
    ce_row_chunk: int = 2048

    def __post_init__(self):
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads
        if self.num_heads % self.num_kv_heads:
            raise ValueError(
                f"num_heads {self.num_heads} must be a multiple of "
                f"num_kv_heads {self.num_kv_heads}")
        if self.hidden_size % self.num_heads:
            raise ValueError(
                f"num_heads {self.num_heads} must divide hidden_size "
                f"{self.hidden_size}")


class LlamaAttention(Module):
    """Causal RoPE attention with GQA and no biases: ``qkv_weight`` ``[(nh
    + 2 nkv) hd, H]`` (q heads, then k heads, then v heads) and
    ``out_weight`` ``[H, H]``, in the ``[out, in]`` layout."""

    compute_params = ("qkv_weight", "out_weight")

    def __init__(self, c: LlamaConfig, generator: torch.Generator):
        super().__init__()
        if c.attention_impl not in ("xla", "flash"):
            raise ValueError(f"attention_impl must be 'xla' or 'flash', "
                             f"got {c.attention_impl!r}")
        self.num_heads, self.num_kv_heads = c.num_heads, c.num_kv_heads
        self.head_dim = c.hidden_size // c.num_heads
        self.dtype = c.dtype
        self.attention_impl = c.attention_impl
        w_init = initializers.xavier_uniform()
        n_qkv = (c.num_heads + 2 * c.num_kv_heads) * self.head_dim
        self.qkv_weight = nn.Parameter(w_init(generator,
                                              (n_qkv, c.hidden_size)))
        self.out_weight = nn.Parameter(
            w_init(generator, (c.hidden_size, c.hidden_size)))

    def qkv(self, x):
        """The fused projection split into q ``[B, S, nh, hd]`` and k, v
        ``[B, S, nkv, hd]`` (the cache layout)."""
        b, s, _ = x.shape
        hd, nh, nkv = self.head_dim, self.num_heads, self.num_kv_heads
        # gathered over tp: the fused split is no head boundary
        qkv = gather_dim(ops.linear(x, self.qkv_weight.to(self.dtype).t()),
                         -1)
        return (qkv[..., :nh * hd].reshape(b, s, nh, hd),
                qkv[..., nh * hd:(nh + nkv) * hd].reshape(b, s, nkv, hd),
                qkv[..., (nh + nkv) * hd:].reshape(b, s, nkv, hd))

    def out(self, o):
        """``[B, nh, S, hd]`` → the output projection ``[B, S, H]``."""
        b, _, s, _ = o.shape
        o = o.transpose(1, 2).reshape(b, s, self.num_heads * self.head_dim)
        return ops.linear(o.to(self.dtype), self.out_weight.to(self.dtype).t())

    def forward(self, x, cos, sin):
        """The one causal body of training and the serving prefill: x
        ``[B, S, H]`` and the tables of positions ``0..S-1`` → (y, k, v),
        k rotated and k, v un-repeated ``[B, S, nkv, hd]``."""
        q, k, v = (t.transpose(1, 2) for t in self.qkv(x))
        q = ops.apply_rope(q, cos, sin)
        k = ops.apply_rope(k, cos, sin)
        kr, vr = k, v
        if self.num_kv_heads != self.num_heads:
            # each kv head serves its group of query heads in place (the
            # reference's jnp.repeat), not the heads tiled
            rep = self.num_heads // self.num_kv_heads
            kr = k.repeat_interleave(rep, dim=1)
            vr = v.repeat_interleave(rep, dim=1)
        # under tp each rank attends with its own query heads and their
        # kv heads
        q, kr, vr = (shard_heads(t, 1) for t in (q, kr, vr))
        if self.attention_impl == "flash":
            o = flash_attention(q, kr, vr, causal=True)
        else:
            o = ops.causal_attention(q, kr, vr)
        return self.out(o), k.transpose(1, 2), v.transpose(1, 2)


class LlamaBlock(Module):
    """Pre-RMSNorm residual block: RoPE attention (``attn``), then the
    SwiGLU MLP ``ffn_down(silu(ffn_gate(h)) * ffn_up(h))``; the RMS scales
    ``rms1_scale`` and ``rms2_scale`` stay float32."""

    compute_params = ("ffn_gate", "ffn_up", "ffn_down")

    def __init__(self, c: LlamaConfig, generator: torch.Generator):
        super().__init__()
        self.c = c
        self.dtype = c.dtype
        w_init = initializers.xavier_uniform()
        h, f = c.hidden_size, c.ffn_size
        self.attn = LlamaAttention(c, generator)
        self.rms1_scale = nn.Parameter(initializers.ones()(generator, (h,)))
        self.rms2_scale = nn.Parameter(initializers.ones()(generator, (h,)))
        self.ffn_gate = nn.Parameter(w_init(generator, (f, h)))
        self.ffn_up = nn.Parameter(w_init(generator, (f, h)))
        self.ffn_down = nn.Parameter(w_init(generator, (h, f)))

    def _norm1(self, x):
        return ops.rms_norm(x, self.rms1_scale, eps=self.c.rms_eps)

    def _mlp(self, x):
        hn = ops.rms_norm(x, self.rms2_scale, eps=self.c.rms_eps)
        w = lambda p: p.to(self.dtype).t()
        gate = ops.linear(hn, w(self.ffn_gate))
        up = ops.linear(hn, w(self.ffn_up))
        return x + ops.linear(ops.silu(gate) * up, w(self.ffn_down))

    def forward(self, x, cos, sin):
        return self.prefill_step(x, cos, sin)[0]

    # ---- serving (hetu_tpu_torch/serve): KV-cache prefill / decode ----

    def prefill_step(self, x, cos, sin):
        """x ``[B, S, H]``, tables ``[S, hd/2]`` → (out, k rotated, v), k
        and v ``[B, S, nkv, hd]``."""
        a, k, v = self.attn(self._norm1(x), cos, sin)
        return self._mlp(x + a), k, v

    def _cached_step(self, core, x, k_cache, v_cache, starts, cos, sin):
        q, k, v = self.attn.qkv(self._norm1(x))
        # under tp a cache with this rank's kv heads takes this rank's
        # query heads; a replicated cache (tp does not divide the kv
        # heads) takes all of them
        q = ops.apply_rope_at(q.transpose(1, 2), cos, sin, starts)
        k = ops.apply_rope_at(k.transpose(1, 2), cos, sin, starts)
        if is_dtensor(k) and k_cache.shape[2] < k.shape[1]:
            q, k = shard_heads(q, 1), shard_heads(k, 1)
            v = shard_heads(v, 2)

        def step(q, k, v, k_cache, v_cache, starts):
            ops.cache_update(k_cache, v_cache, k.transpose(1, 2), v, starts)
            return core(q, k_cache, v_cache, starts)
        o = local_call(step, moved_heads(1, 1), q, k, v, k_cache, v_cache,
                       starts)
        return self._mlp(x + self.attn.out(o)), k_cache, v_cache

    def prefill_chunk_step(self, x, k_cache, v_cache, starts, cos, sin):
        """A chunk x ``[B, S_c, H]`` whose token ``i`` sits at ``starts[b]
        + i``; caches ``[B, T, nkv, hd]`` holding everything before it,
        the chunk's rotated K and V written IN PLACE at ``starts``;
        cos/sin the FULL tables ``[T_max, hd/2]``, gathered at each
        token's absolute position."""
        return self._cached_step(ops.chunk_attention, x, k_cache, v_cache,
                                 starts, cos, sin)

    def decode_step(self, x, k_cache, v_cache, lengths, cos, sin):
        """One token a sequence: x ``[B, 1, H]``; caches ``[B, T, nkv,
        hd]``, written IN PLACE at ``lengths`` (the new token's position);
        cos/sin the FULL tables ``[T_max, hd/2]``."""
        return self._cached_step(ops.decode_attention, x, k_cache, v_cache,
                                 lengths, cos, sin)


class LlamaModel(Module):
    """Parameters (state_dict names): ``tok_emb`` ``[V, H]``, the untied
    ``lm_head`` ``[V, H]``, ``blocks.<i>.*`` and ``rms_f_scale``.  Built
    from ``generator`` (default: a CPU generator seeded 0) on the
    generator's device, then moved to ``device``: a generator on the card
    draws the weights there."""

    compute_params = ("lm_head",)

    def __init__(self, config: LlamaConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        c = self.c = config
        g = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        w_init = initializers.normal(stddev=0.02)
        self.dtype = c.dtype
        self.tok_emb = nn.Parameter(w_init(g, (c.vocab_size, c.hidden_size)))
        self.lm_head = nn.Parameter(w_init(g, (c.vocab_size, c.hidden_size)))
        self.blocks = nn.ModuleList(LlamaBlock(c, g)
                                    for _ in range(c.num_layers))
        self.rms_f_scale = nn.Parameter(
            initializers.ones()(g, (c.hidden_size,)))
        self._rope = None  # RoPE tables, made at first use (_tables)
        self.to(device)

    def inference_copy(self) -> "LlamaModel":
        """A copy for serving with the matmul weights and the head in the
        compute type, cast once here (bitwise the results of casting at
        each use); ``tok_emb`` and the RMS scales stay float32, as in the
        reference.  Each weight is cast straight from this model's tensor:
        no second float32 copy of the model exists on the way."""
        return self.cast_copy()

    def _tables(self, s):
        """cos/sin rows for positions ``[0, s)``: slices of tables of
        ``max(s, max_position)`` rows made once per model and device, so a
        decode step builds none.  Rows of a longer table are bitwise those
        of a shorter one.  They are made outside inference mode, so a table
        first made while serving still serves a training step."""
        c, dev = self.c, self.tok_emb.device
        t = self._rope
        if t is None or t[0].shape[0] < s or t[0].device != dev:
            with torch.inference_mode(False):
                t = self._rope = ops.rope_tables(
                    max(s, c.max_position), c.hidden_size // c.num_heads,
                    theta=c.rope_theta, device=dev)
        return t[0][:s], t[1][:s]

    def _embed(self, input_ids):
        return ops.embedding_lookup(self.tok_emb, input_ids).to(self.dtype)

    def _final(self, h):
        return ops.rms_norm(h, self.rms_f_scale, eps=self.c.rms_eps)

    def _head(self, h):
        return ops.linear(h, self.lm_head.to(self.dtype).t())

    def hidden_states(self, input_ids, *, train: bool = False,
                      generator: Optional[torch.Generator] = None):
        """Final hidden states ``[B, S, H]`` after the last RMSNorm.  No
        dropout, so ``train`` and ``generator`` only mirror the reference's
        signature."""
        h = self._embed(input_ids)
        cos, sin = self._tables(input_ids.shape[1])
        for blk in self.blocks:
            if self.c.remat:
                h = checkpoint(blk, h, cos, sin, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                h = blk(h, cos, sin)
        return self._final(h)

    def forward(self, input_ids, *, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """Logits ``[B, S, V]`` (the reference's ``apply``)."""
        return self._head(self.hidden_states(input_ids, train=train,
                                             generator=generator))

    def lm_loss_fn(self):
        """Next-token LM loss, the reference's ``lm_loss_fn``:
        ``fn(params, model_state, batch, generator, train) -> (loss,
        ({}, model_state))`` with ``batch = (input_ids,)`` or ``input_ids``
        and ``params`` this model's own parameters.  With
        ``config.fused_ce`` the untied head and the CE run through
        :func:`ops.lm_head_cross_entropy`; otherwise the logits are formed
        whole and the CE is averaged over the labels that are not -1."""
        def fn(params, model_state, batch, generator, train):
            require_own_parameters(self, params)
            ids = batch[0] if isinstance(batch, (tuple, list)) else batch
            c = self.c
            if c.fused_ce:
                h = self.hidden_states(ids, train=train, generator=generator)
                loss = ops.lm_head_cross_entropy(
                    h[:, :-1], self.lm_head, ids[:, 1:],
                    row_chunk=c.ce_row_chunk)
            else:
                logits = self(ids, train=train, generator=generator)
                per = ops.softmax_cross_entropy_sparse(logits[:, :-1],
                                                       ids[:, 1:])
                loss = per.sum() / (ids[:, 1:] != -1).sum().clamp_min(1)
            return loss, ({}, model_state)
        return fn

    # ---- serving (hetu_tpu_torch/serve): KV-cache prefill / decode ----

    def prefill_with_cache(self, input_ids, *, last_index=None):
        """Full-prompt forward that also returns every layer's rotated K
        and V: input_ids ``[B, S]`` → (logits, k ``[L, B, S, nkv, hd]``,
        v), logits ``[B, S, V]``, or ``[B, V]`` at ``last_index`` (the last
        real prompt position)."""
        h = self._embed(input_ids)
        cos, sin = self._tables(input_ids.shape[1])
        ks, vs = [], []
        for blk in self.blocks:
            h, k, v = blk.prefill_step(h, cos, sin)
            ks.append(k)
            vs.append(v)
        h = self._final(h)
        if last_index is not None:
            h = h[:, last_index]
        return self._head(h), torch.stack(ks), torch.stack(vs)

    def prefill_chunk_with_cache(self, input_ids, k_cache, v_cache, start,
                                 *, last_index=None):
        """Chunked prefill (see :meth:`GPTModel.prefill_chunk_with_cache`):
        input_ids ``[B, S_c]`` at absolute positions ``start ..
        start + S_c - 1``, caches ``[L, B, T, nkv, hd]`` with positions
        ``< start`` written, the chunk's rows written IN PLACE.  The RoPE
        tables cover ``max_position`` and are gathered at each token's
        position; a pad tail past them clamps to the last row.  Returns
        (logits ``[B, V]`` at chunk-relative ``last_index``, k_cache,
        v_cache)."""
        b, s = input_ids.shape
        h = self._embed(input_ids)
        cos, sin = self._tables(self.c.max_position)
        starts = torch.full((b,), start, dtype=torch.long,
                            device=input_ids.device)
        for layer, blk in enumerate(self.blocks):
            h, _, _ = blk.prefill_chunk_step(h, k_cache[layer],
                                             v_cache[layer], starts, cos, sin)
        h = self._final(h)
        idx = s - 1 if last_index is None else last_index
        return self._head(h[:, idx]), k_cache, v_cache

    def decode_with_cache(self, input_ids, k_cache, v_cache, lengths):
        """One decode step: input_ids ``[B]``, caches ``[L, B, T, nkv,
        hd]`` written IN PLACE, lengths ``[B]`` tokens already cached.
        Returns (logits ``[B, V]``, k_cache, v_cache)."""
        h = self._embed(input_ids[:, None])
        cos, sin = self._tables(self.c.max_position)
        for layer, blk in enumerate(self.blocks):
            h, _, _ = blk.decode_step(h, k_cache[layer], v_cache[layer],
                                      lengths, cos, sin)
        return self._head(self._final(h)[:, 0]), k_cache, v_cache


def llama2_7b(*, generator: Optional[torch.Generator] = None, device="cuda",
              **kw) -> LlamaModel:
    """Llama-2-7B (the config's defaults); ``kw`` overrides config
    fields."""
    return LlamaModel(LlamaConfig(**kw), generator=generator, device=device)
