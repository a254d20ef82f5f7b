"""The CTR zoo beyond Wide & Deep: DeepFM, Deep Crossing and DCN
(counterpart of ``hetu_tpu/models/ctr_zoo.py``).

Each holds only dense parameters, named by the reference's tree paths,
and takes the PS-pulled embedding rows as inputs; its
``hybrid_step_fn`` returns the rows' gradients for the host's push, as
:class:`~hetu_tpu_torch.models.wdl.WideDeep`'s does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hetu_tpu_torch import init as initializers
from hetu_tpu_torch import ops
from hetu_tpu_torch.layers.base import Module
from hetu_tpu_torch.layers.linear import Linear
from hetu_tpu_torch.models.ctr_common import (
    default_generator, make_hybrid_step, mlp_tower,
)


def _features(dense_x, emb_rows):
    """``[B, fields · emb_dim + dense_dim]``: the flattened rows, then the
    dense features."""
    return torch.cat([emb_rows.reshape(emb_rows.shape[0], -1), dense_x],
                     dim=-1)


class DeepFM(Module):
    """FM second-order interactions plus a deep MLP.  Inputs: dense_x
    ``[B, dense_dim]``; emb_rows ``[B, fields, emb_dim]`` (the FM latent
    vectors); fm_linear_rows ``[B, fields, 1]`` (each feature id's
    first-order weight, a PS table of width 1).  Parameters ``deep.*`` and
    ``lin.*`` (the dense features' linear term)."""

    def __init__(self, num_sparse_fields: int, emb_dim: int, dense_dim: int,
                 hidden=(256, 256), *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        g = default_generator(generator)
        self.fields = num_sparse_fields
        self.emb_dim = emb_dim
        self.deep = mlp_tower(num_sparse_fields * emb_dim + dense_dim,
                              hidden, out_dim=1, generator=g)
        self.lin = Linear(dense_dim, 1, generator=g)
        self.to(device)

    def forward(self, dense_x, emb_rows, fm_linear_rows):
        # FM second order: 0.5 * ((sum v)^2 - sum v^2), summed over emb dim
        sum_v = emb_rows.sum(dim=1)
        fm2 = 0.5 * (sum_v * sum_v - (emb_rows * emb_rows).sum(dim=1)).sum(
            dim=-1)
        fm1 = fm_linear_rows[..., 0].sum(dim=1)
        deep_out = self.deep(_features(dense_x, emb_rows))
        return fm1 + fm2 + deep_out[:, 0] + self.lin(dense_x)[:, 0]

    def hybrid_step_fn(self, optimizer):
        """``step(dense_x, rows, fm_linear_rows, labels) -> (loss, logit,
        row_grads, fm_linear_grads)``."""
        return make_hybrid_step(self, optimizer, n_sparse_inputs=2)


class ResidualUnit(Module):
    """Deep Crossing's residual unit, ``relu(x + relu(x w1 + b1) w2 +
    b2)``, with ``w1 [dim, hidden]`` and ``w2 [hidden, dim]`` in the
    reference's layout (drawn N(0, 0.1)) and zero biases."""

    def __init__(self, dim: int, hidden: int, *, generator: torch.Generator):
        super().__init__()
        w_init = initializers.normal(stddev=0.1)
        self.w1 = nn.Parameter(w_init(generator, (dim, hidden)))
        self.b1 = nn.Parameter(initializers.zeros()(generator, (hidden,)))
        self.w2 = nn.Parameter(w_init(generator, (hidden, dim)))
        self.b2 = nn.Parameter(initializers.zeros()(generator, (dim,)))

    def forward(self, x):
        h = ops.relu(x @ self.w1 + self.b1)
        return ops.relu(x + h @ self.w2 + self.b2)


class DeepCrossing(Module):
    """A stack of residual units over the concatenated features and a
    linear head: parameters ``unit<i>.*`` and ``head.*``."""

    def __init__(self, num_sparse_fields: int, emb_dim: int, dense_dim: int,
                 hidden: int = 64, n_units: int = 3, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        g = default_generator(generator)
        self.in_dim = num_sparse_fields * emb_dim + dense_dim
        self.n_units = n_units
        for i in range(n_units):
            self.add_module(f"unit{i}",
                            ResidualUnit(self.in_dim, hidden, generator=g))
        self.head = Linear(self.in_dim, 1, generator=g)
        self.to(device)

    def forward(self, dense_x, emb_rows):
        x = _features(dense_x, emb_rows)
        for i in range(self.n_units):
            x = getattr(self, f"unit{i}")(x)
        return self.head(x)[:, 0]

    def hybrid_step_fn(self, optimizer):
        return make_hybrid_step(self, optimizer, n_sparse_inputs=1)


class CrossNet(Module):
    """DCN's cross layers, ``x_{l+1} = x0 · (x_l · w_l) + b_l + x_l``:
    ``w [n_layers, dim]`` drawn N(0, 0.01), ``b [n_layers, dim]`` zero."""

    def __init__(self, dim: int, n_layers: int = 3, *,
                 generator: torch.Generator):
        super().__init__()
        self.n = n_layers
        self.w = nn.Parameter(initializers.normal(stddev=0.01)(
            generator, (n_layers, dim)))
        self.b = nn.Parameter(initializers.zeros()(generator,
                                                   (n_layers, dim)))

    def forward(self, x0):
        x = x0
        for layer in range(self.n):
            xw = (x @ self.w[layer])[:, None]
            x = x0 * xw + self.b[layer] + x
        return x


class DCN(Module):
    """Deep & Cross Network: the cross net and a deep MLP on the
    concatenated features, then a linear head on both: parameters
    ``cross.*``, ``deep.*`` and ``head.*``."""

    def __init__(self, num_sparse_fields: int, emb_dim: int, dense_dim: int,
                 hidden=(256, 256), n_cross: int = 3, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        g = default_generator(generator)
        self.in_dim = num_sparse_fields * emb_dim + dense_dim
        self.cross = CrossNet(self.in_dim, n_cross, generator=g)
        self.deep = mlp_tower(self.in_dim, hidden, generator=g)
        self.head = Linear(hidden[-1] + self.in_dim, 1, generator=g)
        self.to(device)

    def forward(self, dense_x, emb_rows):
        x0 = _features(dense_x, emb_rows)
        return self.head(torch.cat([self.cross(x0), self.deep(x0)],
                                   dim=-1))[:, 0]

    def hybrid_step_fn(self, optimizer):
        return make_hybrid_step(self, optimizer, n_sparse_inputs=1)
