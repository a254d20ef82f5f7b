"""Wide & Deep for CTR (counterpart of ``hetu_tpu/models/wdl.py``).

:class:`WideDeep` holds only the dense parameters and takes the embedding
rows as an input: the PS-hybrid path, where the table lives on the
parameter server (:class:`hetu_tpu_torch.ps.PSEmbedding`) and the step
returns the rows' gradients for the host to push.

:class:`WideDeepDevice` keeps the table on the card.  The lookup is
``Embedding(impl="auto")``, the gather kernel, and the table's update is
sparse: the gradient with respect to the gathered rows becomes
:class:`~hetu_tpu_torch.ops.embedding.IndexedSlices`, which the
optimizer's ``apply_indexed`` applies to the touched rows only (its
duplicate sum is the scatter-add kernel's), never through a dense ``[V,
D]`` gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

from hetu_tpu_torch import ops
from hetu_tpu_torch.layers.base import Module
from hetu_tpu_torch.layers.linear import Embedding, Linear
from hetu_tpu_torch.models.ctr_common import (
    default_generator, make_hybrid_step, mlp_tower, on_device,
)
from hetu_tpu_torch.ops.embedding import IndexedSlices


class WideDeep(Module):
    """Parameters: ``deep.<i>.weight/bias`` (the tower over the flattened
    rows and the dense features, a 1-wide head) and ``wide.weight/bias``
    (a linear map of the dense features), the reference's tree paths."""

    def __init__(self, num_sparse_fields: int, emb_dim: int, dense_dim: int,
                 hidden=(256, 256), *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        g = default_generator(generator)
        self.num_sparse_fields = num_sparse_fields
        self.emb_dim = emb_dim
        self.dense_dim = dense_dim
        self.deep = mlp_tower(num_sparse_fields * emb_dim + dense_dim,
                              hidden, out_dim=1, generator=g)
        self.wide = Linear(dense_dim, 1, generator=g)
        self.to(device)

    def forward(self, dense_x, emb_rows):
        """dense_x ``[B, dense_dim]``; emb_rows ``[B, fields, emb_dim]`` →
        logit ``[B]``."""
        flat = emb_rows.reshape(emb_rows.shape[0], -1)
        deep_out = self.deep(torch.cat([flat, dense_x], dim=-1))
        return (deep_out + self.wide(dense_x))[:, 0]

    def hybrid_step_fn(self, optimizer):
        """``step(dense_x, rows, labels) -> (loss, logit, row_grads)``
        (:func:`~hetu_tpu_torch.models.ctr_common.make_hybrid_step`)."""
        return make_hybrid_step(self, optimizer, n_sparse_inputs=1)


class WideDeepDevice(Module):
    """Device-resident Wide & Deep: parameters ``emb.weight [V, emb_dim]``
    and ``net.*`` (a :class:`WideDeep`), the reference's tree paths.  With
    a generator on the card the table is drawn there."""

    def __init__(self, vocab_size: int, num_sparse_fields: int, emb_dim: int,
                 dense_dim: int, hidden=(256, 256), emb_impl: str = "auto",
                 *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        g = default_generator(generator)
        self.vocab_size = vocab_size
        self.emb = Embedding(vocab_size, emb_dim, impl=emb_impl, generator=g)
        self.net = WideDeep(num_sparse_fields, emb_dim, dense_dim, hidden,
                            generator=g, device=device)
        self.to(device)

    def forward(self, dense_x, sparse_ids):
        """dense_x ``[B, dense_dim]``; sparse_ids ``[B, fields]`` → logit
        ``[B]``."""
        return self.net(dense_x, self.emb(sparse_ids))

    def sparse_step_fn(self, optimizer):
        """``step(dense_x, sparse_ids, labels) -> (loss, logit)``: one train
        step, the table updated sparsely and every parameter in place
        (optimizer state ``step.opt_state``).  The gradient is taken with
        respect to the gathered rows, not the table, so a step costs
        O(B · fields · D) whatever the vocabulary."""
        return self._step_fn(optimizer, masked=False)

    def masked_step_fn(self, optimizer):
        """``step(dense_x, sparse_ids, labels, n_valid) -> (loss, logit)``
        for a batch padded to a bucket (``data.bucketing``): rows at index
        ``>= n_valid`` are padding (zero features, ids -1).  Their loss
        terms are masked out; the gather reads row 0 for a -1 id, but the
        IndexedSlices keep the -1, so the optimizer drops those rows.  A
        padded batch steps as its unpadded batch does."""
        return self._step_fn(optimizer, masked=True)

    def _step_fn(self, optimizer, *, masked: bool):
        params = dict(self.named_parameters())
        net = dict(self.net.named_parameters())
        device = self.emb.weight.device
        state = optimizer.init_state(params)

        def run(dense_x, sparse_ids, labels, n_valid):
            dense_x = on_device(dense_x, device, torch.float32)
            ids = on_device(sparse_ids, device)
            labels = on_device(labels, device, torch.float32)
            with torch.no_grad():
                rows = self.emb(ids if n_valid is None
                                else torch.where(ids >= 0, ids, 0))
            rows.requires_grad_()
            logit = self.net(dense_x, rows)
            per = ops.binary_cross_entropy_with_logits(logit, labels)
            if n_valid is None:
                loss = per.mean()
            else:
                mask = (torch.arange(per.shape[0], device=device)
                        < n_valid).to(per.dtype)
                loss = (per * mask).sum() / max(int(n_valid), 1)
            g_rows, *g_net = torch.autograd.grad(loss, [rows, *net.values()])
            d = g_rows.shape[-1]
            grads = {"emb.weight": IndexedSlices(
                ids.reshape(-1), g_rows.reshape(-1, d),
                (self.vocab_size, d)),
                **{f"net.{n}": g for n, g in zip(net, g_net)}}
            state.update(optimizer.update(grads, state, params)[1])
            return loss.detach(), logit.detach()

        if masked:
            def step(dense_x, sparse_ids, labels, n_valid):
                return run(dense_x, sparse_ids, labels, n_valid)
        else:
            def step(dense_x, sparse_ids, labels):
                return run(dense_x, sparse_ids, labels, None)
        step.opt_state = state
        return step
