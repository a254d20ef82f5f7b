"""Linear and Embedding layers (counterpart of
``hetu_tpu/layers/linear.py``)."""

from __future__ import annotations

import torch
from torch import nn

from hetu_tpu_torch import init as initializers
from hetu_tpu_torch import ops
from hetu_tpu_torch.layers.base import Module


class Linear(Module):
    """``y = x W^T + b`` with ``weight`` laid out ``[out, in]`` (the
    ``nn.Linear`` layout; the reference stores ``[in, out]`` —
    :mod:`hetu_tpu_torch.interop` transposes).  ``weight_init`` draws the
    weight (Xavier uniform by default) and the bias is zero, as in the
    reference.  Computes in ``dtype``."""

    compute_params = ("weight", "bias")

    def __init__(self, in_features: int, out_features: int, *,
                 generator: torch.Generator, dtype=torch.float32,
                 weight_init=None):
        super().__init__()
        self.dtype = dtype
        w_init = weight_init or initializers.xavier_uniform()
        self.weight = nn.Parameter(w_init(generator,
                                          (out_features, in_features)))
        self.bias = nn.Parameter(initializers.zeros()(
            generator, (out_features,)))

    def forward(self, x):
        return ops.linear(x.to(self.dtype), self.weight.to(self.dtype).t(),
                          self.bias.to(self.dtype))


class Embedding(Module):
    """A dense embedding table ``weight [num_embeddings, embedding_dim]``,
    drawn by ``weight_init`` (normal, std 0.01, by default) in ``dtype``
    (its storage type), as in the reference.

    ``impl="auto"`` or ``"pallas"`` routes the lookup through
    :func:`~hetu_tpu_torch.ops.cuda_kernels.routed_gather`: the gather
    kernel forward and the scatter-add kernel backward on a CUDA tensor
    (or raise), their plain versions on a CPU tensor.  ``"xla"`` takes the
    plain :func:`~hetu_tpu_torch.ops.embedding_lookup`.  Invalid ids give
    zero rows on every route."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 generator: torch.Generator, weight_init=None,
                 dtype=torch.float32, impl: str = "xla"):
        super().__init__()
        if impl not in ("auto", "xla", "pallas"):
            raise ValueError(f"impl {impl!r}: 'auto', 'xla' or 'pallas'")
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.dtype = dtype
        self.impl = impl
        w_init = weight_init or initializers.normal(stddev=0.01)
        self.weight = nn.Parameter(w_init(
            generator, (num_embeddings, embedding_dim), dtype))

    def forward(self, indices):
        if self.impl == "xla":
            return ops.embedding_lookup(self.weight, indices)
        from hetu_tpu_torch.ops.cuda_kernels import routed_gather
        rows = routed_gather(self.weight, indices.reshape(-1))
        return rows.reshape(*indices.shape, self.embedding_dim)
