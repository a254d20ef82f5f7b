"""BERT encoder with the MLM and NSP pretraining heads (counterpart of
``hetu_tpu/models/bert.py``, BASELINE.json's config #3).

Token, position and segment embeddings, LayerNorm and dropout, then
post-LN bidirectional :class:`TransformerBlock`s; the sequence output is
float32 whatever the compute type.  The MLM head is tied to ``tok_emb``;
the NSP head reads the pooled first token.  Without an attention mask the
blocks run the non-causal flash kernels when ``attention_impl="flash"``;
with one, the reference's flash path does not apply and every block warns
and takes the plain path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from hetu_tpu_torch import init as initializers
from hetu_tpu_torch import ops
from hetu_tpu_torch.layers.base import (
    Module, child_generator, require_own_parameters,
)
from hetu_tpu_torch.layers.linear import Linear
from hetu_tpu_torch.layers.norm import LayerNorm
from hetu_tpu_torch.layers.transformer import TransformerBlock


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    dropout_rate: float = 0.1
    dtype: torch.dtype = torch.float32  # compute type; weights stay f32
    attention_impl: str = "xla"  # 'flash' = the CUDA kernels, for calls
    # with no attention_mask (masked calls warn and take the plain path)


class BertModel(Module):
    """Parameters (state_dict names): ``tok_emb``, ``pos_emb``,
    ``seg_emb``, ``emb_ln.*``, ``blocks.<i>.*``, ``pooler.*``,
    ``mlm_dense.*``, ``mlm_ln.*``, ``mlm_bias`` and ``nsp.*``; embeddings
    and head weights drawn from a normal truncated at 2σ (σ 0.02), the
    blocks' weights as the reference's blocks draw them.  Built from
    ``generator`` (default: a CPU generator seeded 0) and moved to
    ``device``."""

    def __init__(self, config: BertConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        c = self.c = config
        g = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        w_init = initializers.truncated_normal(stddev=0.02)
        h = c.hidden_size
        self.tok_emb = nn.Parameter(w_init(g, (c.vocab_size, h)))
        self.pos_emb = nn.Parameter(w_init(g, (c.max_position, h)))
        self.seg_emb = nn.Parameter(w_init(g, (c.type_vocab_size, h)))
        self.emb_ln = LayerNorm(h)
        self.blocks = nn.ModuleList(
            TransformerBlock(h, c.num_heads, c.ffn_size, generator=g,
                             dropout_rate=c.dropout_rate, causal=False,
                             pre_norm=False, dtype=c.dtype,
                             attention_impl=c.attention_impl)
            for _ in range(c.num_layers))
        self.pooler = Linear(h, h, generator=g, weight_init=w_init)
        self.mlm_dense = Linear(h, h, generator=g, weight_init=w_init)
        self.mlm_ln = LayerNorm(h)
        self.mlm_bias = nn.Parameter(
            initializers.zeros()(g, (c.vocab_size,)))
        self.nsp = Linear(h, 2, generator=g, weight_init=w_init)
        self.to(device)

    def encode(self, input_ids, token_type_ids=None, attention_mask=None, *,
               train: bool = False,
               generator: Optional[torch.Generator] = None):
        """Sequence output ``[B, S, H]`` in float32.  ``attention_mask``
        ``[B, S]`` (1 = a real token) masks keys; when training,
        ``generator`` draws the dropout masks (child 999 for the
        embeddings, child ``i`` for block ``i``)."""
        c = self.c
        s = input_ids.shape[1]
        h = ops.embedding_lookup(self.tok_emb, input_ids) \
            + self.pos_emb[None, :s]
        if token_type_ids is not None:
            h = h + ops.embedding_lookup(self.seg_emb, token_type_ids)
        h = ops.dropout(self.emb_ln(h), c.dropout_rate,
                        child_generator(generator, 999), train=train)
        h = h.to(c.dtype)
        mask = None if attention_mask is None \
            else attention_mask[:, None, None, :]
        for i, blk in enumerate(self.blocks):
            h = blk(h, mask=mask, train=train,
                    generator=child_generator(generator, i))
        return h.float()

    def _pool(self, seq):
        return torch.tanh(self.pooler(seq[:, 0]))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        """(sequence output ``[B, S, H]``, pooled ``[B, H]``), the
        reference's ``apply``."""
        seq = self.encode(input_ids, token_type_ids, attention_mask,
                          train=train, generator=generator)
        return seq, self._pool(seq)

    def mlm_logits(self, seq):
        """MLM logits ``[B, S, V]`` through the head tied to ``tok_emb``."""
        h = self.mlm_ln(ops.gelu(self.mlm_dense(seq)))
        return ops.linear(h, self.tok_emb.t(), self.mlm_bias)

    def pretrain_loss_fn(self):
        """MLM + NSP loss: ``fn(params, model_state, batch, generator,
        train) -> (loss, ({"mlm_loss", "nsp_loss"}, model_state))`` with
        ``batch = (input_ids, token_type_ids, attention_mask, mlm_labels,
        nsp_labels)`` (mask may be None; an MLM label of -1 is not
        predicted) and ``params`` this model's own parameters."""
        def fn(params, model_state, batch, generator, train):
            require_own_parameters(self, params)
            input_ids, tok_type, attn_mask, mlm_labels, nsp_labels = batch
            seq = self.encode(input_ids, tok_type, attn_mask, train=train,
                              generator=generator)
            per_tok = ops.softmax_cross_entropy_sparse(
                self.mlm_logits(seq), mlm_labels, ignored_index=-1)
            mlm_loss = per_tok.sum() / (mlm_labels != -1).sum().clamp_min(1)
            nsp_loss = ops.softmax_cross_entropy_sparse(
                self.nsp(self._pool(seq)), nsp_labels).mean()
            return mlm_loss + nsp_loss, (
                {"mlm_loss": mlm_loss.detach(),
                 "nsp_loss": nsp_loss.detach()}, model_state)
        return fn


def bert_base(*, generator: Optional[torch.Generator] = None, device="cuda",
              **kw) -> BertModel:
    return BertModel(BertConfig(**kw), generator=generator, device=device)


def bert_large(*, generator: Optional[torch.Generator] = None,
               device="cuda", **kw) -> BertModel:
    kw.setdefault("hidden_size", 1024)
    kw.setdefault("num_layers", 24)
    kw.setdefault("num_heads", 16)
    kw.setdefault("ffn_size", 4096)
    return BertModel(BertConfig(**kw), generator=generator, device=device)
