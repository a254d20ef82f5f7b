"""MoE transformer LM (counterpart of ``hetu_tpu/models/moe_transformer.py``).

Pre-LN causal layers whose FFN is an MoE layer: attention, then the top-k
gate, the gather dispatch, the stacked experts and the gather combine.  No
final LayerNorm; the LM head is ``tok_emb`` (tied) in f32.  The reference
builds one attention, LayerNorm and MoE module and applies it with each
layer's parameters; here each layer owns its modules
(``layers.<l>.{attn, ln1, ln2, moe}``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from hetu_tpu_torch import init as initializers
from hetu_tpu_torch import ops
from hetu_tpu_torch.layers.attention import MultiHeadAttention
from hetu_tpu_torch.layers.base import Module, require_own_parameters
from hetu_tpu_torch.layers.moe import Expert, MoELayer, TopKGate
from hetu_tpu_torch.layers.norm import LayerNorm


@dataclass
class MoEConfig:
    vocab_size: int = 32000
    hidden_size: int = 512
    num_layers: int = 4
    num_heads: int = 8
    ffn_size: int = 2048
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    max_position: int = 512
    dtype: torch.dtype = torch.float32  # compute type; weights stay f32


class MoELayerBlock(Module):
    """One layer: causal attention and an MoE FFN, each with a residual."""

    def __init__(self, c: MoEConfig, generator: torch.Generator):
        super().__init__()
        self.attn = MultiHeadAttention(c.hidden_size, c.num_heads,
                                       generator=generator, causal=True,
                                       dtype=c.dtype)
        self.ln1 = LayerNorm(c.hidden_size)
        self.ln2 = LayerNorm(c.hidden_size)
        self.moe = MoELayer(
            TopKGate(c.hidden_size, c.num_experts, c.top_k,
                     generator=generator),
            Expert(c.num_experts, c.hidden_size, c.ffn_size,
                   generator=generator, dtype=c.dtype),
            capacity_factor=c.capacity_factor)

    def forward(self, h):
        """h ``[B, S, H]`` in the compute type → (h, aux)."""
        h = h + self.attn(self.ln1(h))
        m, aux = self.moe(self.ln2(h))
        return h + m.to(h.dtype), aux


class MoETransformer(Module):
    """Parameters (state_dict names): ``tok_emb [V, H]``, ``pos_emb [P,
    H]`` and ``layers.<l>.*``.  Built from ``generator`` (default: a CPU
    generator seeded 0) and moved to ``device``."""

    def __init__(self, config: MoEConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        c = self.c = config
        g = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        w_init = initializers.normal(stddev=0.02)
        self.tok_emb = nn.Parameter(w_init(g, (c.vocab_size, c.hidden_size)))
        self.pos_emb = nn.Parameter(
            w_init(g, (c.max_position, c.hidden_size)))
        self.layers = nn.ModuleList(MoELayerBlock(c, g)
                                    for _ in range(c.num_layers))
        self.to(device)

    def forward(self, input_ids):
        """``(logits [B, S, V]`` in f32, the summed aux loss``)`` — the
        reference's ``apply``."""
        s = input_ids.shape[1]
        h = ops.embedding_lookup(self.tok_emb, input_ids) \
            + self.pos_emb[None, :s]
        h = h.to(self.c.dtype)
        total_aux = 0.0
        for layer in self.layers:
            h, aux = layer(h)
            total_aux = total_aux + aux
        return ops.linear(h.float(), self.tok_emb.t()), total_aux

    def lm_loss_fn(self):
        """The reference's ``lm_loss_fn``: ``fn(params, model_state, batch,
        generator, train) -> (lm + aux, ({"lm_loss", "aux_loss"},
        model_state))``, where ``lm`` is the mean next-token CE over every
        row (no label is ignored) and ``params`` are this model's own
        parameters (``dict(model.named_parameters())``)."""
        def fn(params, model_state, batch, generator, train):
            require_own_parameters(self, params)
            ids = batch[0] if isinstance(batch, (tuple, list)) else batch
            logits, aux = self(ids)
            lm = ops.softmax_cross_entropy_sparse(logits[:, :-1],
                                                  ids[:, 1:]).mean()
            return lm + aux, ({"lm_loss": lm.detach(),
                               "aux_loss": aux.detach()}, model_state)
        return fn
