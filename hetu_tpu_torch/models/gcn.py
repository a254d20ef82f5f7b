"""GCN for node classification (counterpart of
``hetu_tpu/models/gcn.py``): two :func:`~hetu_tpu_torch.ops.graph_ops.gcn_conv`
layers without bias, a ReLU and dropout between them, trained over the
whole graph or over sampled subgraphs
(:mod:`hetu_tpu_torch.data.graph_sampler`)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hetu_tpu_torch import init as initializers
from hetu_tpu_torch import ops
from hetu_tpu_torch.layers.base import Module, require_own_parameters
from hetu_tpu_torch.models.ctr_common import default_generator
from hetu_tpu_torch.ops.graph_ops import gcn_conv


class GCN(Module):
    """Parameters ``w1 [F, hidden]`` and ``w2 [hidden, classes]``, laid
    out ``[in, out]`` as in the reference and drawn Xavier uniform from
    ``generator`` (default: a CPU generator seeded 0), on ``device``."""

    def __init__(self, in_features: int, hidden: int, num_classes: int, *,
                 dropout_rate: float = 0.5,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.dims = (in_features, hidden, num_classes)
        self.dropout_rate = dropout_rate
        g = default_generator(generator)
        w_init = initializers.xavier_uniform()
        self.w1 = nn.Parameter(w_init(g, (in_features, hidden)))
        self.w2 = nn.Parameter(w_init(g, (hidden, num_classes)))
        self.to(device)

    def forward(self, x, edge_src, edge_dst, edge_weight, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        """Logits ``[N, classes]`` of ``x [N, F]`` over edges normalised by
        :func:`~hetu_tpu_torch.ops.graph_ops.gcn_norm`; dropout (from
        ``generator``) only when training."""
        n = x.shape[0]
        h = gcn_conv(x, self.w1, edge_src, edge_dst, edge_weight, n)
        h = ops.relu(h)
        if train and self.dropout_rate > 0:
            h = ops.dropout(h, self.dropout_rate, generator, train=True)
        return gcn_conv(h, self.w2, edge_src, edge_dst, edge_weight, n)

    def loss_fn(self, edge_src, edge_dst, edge_weight):
        """The Executor's loss over ``batch = (x, labels, mask)`` on the
        closed-over edges: the softmax cross entropy and the accuracy,
        each averaged over the nodes of ``mask`` (the semi-supervised
        setting)."""
        def fn(params, model_state, batch, generator, train):
            require_own_parameters(self, params)
            x, labels, mask = batch
            logits = self(x, edge_src, edge_dst, edge_weight, train=train,
                          generator=generator)
            mask = mask.to(logits.dtype)
            count = mask.sum().clamp_min(1)
            per = ops.softmax_cross_entropy_sparse(logits, labels)
            loss = (per * mask).sum() / count
            acc = ((logits.argmax(-1) == labels) * mask).sum() / count
            return loss, ({"acc": acc.detach()}, model_state)
        return fn
