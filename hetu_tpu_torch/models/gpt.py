"""GPT decoder-only LM (counterpart of ``hetu_tpu/models/gpt.py``).

Pre-LN causal transformer with a tied LM head.  The reference stacks its
blocks ``[L, ...]`` with ``vmap`` and runs them under ``lax.scan``; here
they are an ``nn.ModuleList`` walked by a Python loop.

Training runs :meth:`GPTModel.lm_loss_fn` (the fused chunked LM-head
cross-entropy or the unfused head + CE), with dropout and per-block
recomputation (``torch.utils.checkpoint``) as the config asks; serving runs
the KV-cache methods on an :meth:`GPTModel.inference_copy`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from hetu_tpu_torch import init as initializers
from hetu_tpu_torch import ops
from hetu_tpu_torch.layers.base import (
    Module, child_generator, require_own_parameters,
)
from hetu_tpu_torch.layers.norm import LayerNorm
from hetu_tpu_torch.layers.transformer import TransformerBlock
from hetu_tpu_torch.parallel.spec import is_dtensor


@dataclass
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_size: int = 3072
    max_position: int = 1024
    dropout_rate: float = 0.1
    dtype: torch.dtype = torch.float32  # compute type; weights stay f32
    attention_impl: str = "xla"  # 'flash' = the CUDA kernels
    remat: bool = False  # recompute each block in the backward pass
    remat_policy: str = "full"  # 'full' = save only block inputs; 'dots'
    # = also save the matmul outputs (recompute the elementwise ops only)
    fused_ce: bool = True  # lm_loss_fn through ops.lm_head_cross_entropy:
    # the [B*S, V] logits never exist whole
    ce_row_chunk: int = 2048


# the reference's 'dots' policy saves dot products with no batch dimensions
# (jax.checkpoint_policies.dots_with_no_batch_dims_saveable): the weight
# GEMMs; attention's batched products and the flash kernels recompute
_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


class GPTModel(Module):
    """Parameters (state_dict names): ``tok_emb`` ``[V, H]``, ``pos_emb``
    ``[P, H]``, ``blocks.<i>.*`` and ``ln_f.*``; the LM head is
    ``tok_emb`` itself (tied).  Built from ``generator`` (default: a CPU
    generator seeded 0) and moved to ``device``."""

    def __init__(self, config: GPTConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        c = self.c = config
        if c.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy must be 'full' or 'dots', got "
                             f"{c.remat_policy!r}")
        g = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        w_init = initializers.normal(stddev=0.02)
        self.dtype = c.dtype
        self.tok_emb = nn.Parameter(w_init(g, (c.vocab_size, c.hidden_size)))
        self.pos_emb = nn.Parameter(
            w_init(g, (c.max_position, c.hidden_size)))
        self.blocks = nn.ModuleList(
            TransformerBlock(c.hidden_size, c.num_heads, c.ffn_size,
                             generator=g, dropout_rate=c.dropout_rate,
                             causal=True, pre_norm=True, dtype=c.dtype,
                             attention_impl=c.attention_impl)
            for _ in range(c.num_layers))
        self.ln_f = LayerNorm(c.hidden_size)
        # the tied head in the compute type, set by inference_copy(); None
        # means "cast tok_emb at each use", as the reference does
        self.register_buffer("head_weight", None, persistent=False)
        self.to(device)

    def inference_copy(self) -> "GPTModel":
        """A copy for serving whose matmul weights (and the tied head) are
        stored in the compute type, cast ONCE here instead of at every
        step.  The results are bitwise those of casting at each use (the
        reference casts the same f32 values every time).  Embedding tables
        and LayerNorm parameters stay f32, as in the reference."""
        m = self.cast_copy()
        if self.dtype != self.tok_emb.dtype:
            m.head_weight = m.tok_emb.detach().to(self.dtype)
        return m

    def _head(self, h):
        w = self.head_weight if self.head_weight is not None \
            else self.tok_emb.to(self.dtype)
        return ops.linear(h, w.t())

    def _embed(self, input_ids, pos, *, train: bool = False,
               generator: Optional[torch.Generator] = None):
        h = ops.embedding_lookup(self.tok_emb, input_ids) + pos
        h = ops.dropout(h, self.c.dropout_rate, generator, train=train)
        return h.to(self.dtype)

    def hidden_states(self, input_ids, *, train: bool = False,
                      generator: Optional[torch.Generator] = None):
        """Final pre-head hidden states ``[B, S, H]`` (post final LN).

        When training, ``generator`` (on the model's device) draws the
        dropout masks: child 999 for the embeddings, child ``i`` for block
        ``i``.  With ``config.remat`` each block runs under
        ``torch.utils.checkpoint`` and recomputes in the backward pass."""
        c = self.c
        s = input_ids.shape[1]
        h = self._embed(input_ids, self.pos_emb[None, :s], train=train,
                        generator=child_generator(generator, 999))
        for i, blk in enumerate(self.blocks):
            kw = dict(train=train, generator=child_generator(generator, i))
            if c.remat:
                # the masks come from generators seeded afresh inside the
                # block, so the global RNG state need not be replayed
                h = checkpoint(
                    blk, h, **kw, use_reentrant=False,
                    preserve_rng_state=False,
                    **({"context_fn": _dots_context}
                       if c.remat_policy == "dots" else {}))
            else:
                h = blk(h, **kw)
        return self.ln_f(h)

    def forward(self, input_ids, *, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """Logits ``[B, S, V]`` — the reference's ``apply`` (whose name
        ``nn.Module`` already uses for something else)."""
        return self._head(self.hidden_states(input_ids, train=train,
                                             generator=generator))

    def lm_loss_fn(self):
        """Next-token LM loss, the reference's ``lm_loss_fn``:
        ``fn(params, model_state, batch, generator, train) -> (loss,
        ({}, model_state))`` with ``batch = (input_ids,)`` or ``input_ids``.

        ``params`` are this model's own parameters
        (``dict(model.named_parameters())``, as ``Executor.init_state``
        holds them): a module owns its parameters, and the recomputed
        blocks read them again in the backward pass.  With
        ``config.fused_ce`` the head and the CE run through
        :func:`ops.lm_head_cross_entropy`; otherwise the logits are formed
        whole and the per-row CE is summed over the rows whose label is not
        -1 and divided by their count, as the fused path does."""
        def fn(params, model_state, batch, generator, train):
            require_own_parameters(self, params)
            ids = batch[0] if isinstance(batch, (tuple, list)) else batch
            c = self.c
            if c.fused_ce:
                h = self.hidden_states(ids, train=train, generator=generator)
                loss = ops.lm_head_cross_entropy(
                    h[:, :-1], self.tok_emb, ids[:, 1:],
                    row_chunk=c.ce_row_chunk)
            else:
                logits = self(ids, train=train, generator=generator)
                per = ops.softmax_cross_entropy_sparse(logits[:, :-1],
                                                       ids[:, 1:])
                n_valid = (ids[:, 1:] != -1).sum()
                loss = per.sum() / n_valid.clamp_min(1)
            return loss, ({}, model_state)
        return fn

    # ---- serving (hetu_tpu_torch/serve): KV-cache prefill / decode ----

    def prefill_with_cache(self, input_ids, *, last_index=None):
        """Full-prompt forward that also returns every layer's K/V.

        input_ids ``[B, S]`` (right-padded to the serving bucket; pad
        positions produce junk K/V that decode masks or overwrites).
        Returns (logits, k ``[L, B, S, nh, hd]``, v) where logits is
        ``[B, S, V]`` — or ``[B, V]`` at ``last_index`` (the last real
        prompt position), so the head skips the positions serving throws
        away.
        """
        s = input_ids.shape[1]
        # a DTensor table is gathered, not sliced: a view of it cannot be
        # made under inference mode
        pos = self.pos_emb[torch.arange(s, device=input_ids.device)] \
            if is_dtensor(self.pos_emb) else self.pos_emb[:s]
        h = self._embed(input_ids, pos[None])
        ks, vs = [], []
        for blk in self.blocks:
            h, k, v = blk.prefill_step(h)
            ks.append(k)
            vs.append(v)
        h = self.ln_f(h)
        if last_index is not None:
            h = h[:, last_index]
        return self._head(h), torch.stack(ks), torch.stack(vs)

    def prefill_chunk_with_cache(self, input_ids, k_cache, v_cache, start,
                                 *, last_index=None):
        """Chunked prefill: ONE chunk of the prompt against a cache already
        holding everything before it (earlier chunks, or a shared prefix
        adopted from the prefix cache).

        input_ids ``[B, S_c]`` at absolute positions ``start ..
        start + S_c - 1`` (right-padded within the chunk bucket; pad
        positions produce junk K/V that decode masks or overwrites);
        k_cache/v_cache ``[L, B, T, nh, hd]`` with positions ``< start``
        written, the chunk's rows written IN PLACE.  Returns (logits
        ``[B, V]`` at chunk-relative ``last_index``, default ``S_c - 1``,
        k_cache, v_cache).  With ``start == 0`` and one chunk covering the
        prompt the numbers are :meth:`prefill_with_cache`'s.
        """
        b, s = input_ids.shape
        # a per-index gather clamped to the table, not a slice: a final
        # chunk's pad tail may run past max_position, and clamping a
        # slice's start would shift the real tokens' positions
        pos = torch.arange(start, start + s, device=input_ids.device)
        pos = self.pos_emb[pos.clamp(0, self.c.max_position - 1)]
        h = self._embed(input_ids, pos[None])
        starts = torch.full((b,), start, dtype=torch.long,
                            device=input_ids.device)
        for layer, blk in enumerate(self.blocks):
            h, _, _ = blk.prefill_chunk_step(h, k_cache[layer],
                                             v_cache[layer], starts)
        h = self.ln_f(h)
        idx = s - 1 if last_index is None else last_index
        return self._head(h[:, idx]), k_cache, v_cache

    def decode_with_cache(self, input_ids, k_cache, v_cache, lengths):
        """One decode step for a batch of cached sequences.

        input_ids ``[B]`` newest token per sequence; k_cache/v_cache
        ``[L, B, T, nh, hd]``, written IN PLACE (the reference returns new
        arrays); lengths ``[B]`` tokens already cached (the new token's
        position).  Returns (logits ``[B, V]``, k_cache, v_cache).
        """
        # an index past the table clamps, like the reference's x[idx]
        pos = self.pos_emb[lengths.long().clamp(0, self.c.max_position - 1)]
        h = self._embed(input_ids[:, None], pos[:, None])
        for layer, blk in enumerate(self.blocks):
            h, _, _ = blk.decode_step(h, k_cache[layer], v_cache[layer],
                                      lengths)
        h = self.ln_f(h)
        return self._head(h[:, 0]), k_cache, v_cache


def gpt2_small(*, generator: Optional[torch.Generator] = None,
               device="cuda", **kw) -> GPTModel:
    """GPT-2 small (``GPTConfig``'s defaults, ``kw`` overriding fields)."""
    return GPTModel(GPTConfig(**kw), generator=generator, device=device)
