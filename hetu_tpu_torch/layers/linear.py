"""Linear, convolution and Embedding layers (counterpart of
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


class Conv2d(Module):
    """NCHW convolution with an OIHW ``weight`` (the reference's layout,
    kept as it is), drawn He normal by default, and an optional zero
    ``bias``.  Computes in ``dtype``: the input and the weight are cast to
    it, while the bias stays float32 (a bf16 convolution returns float32,
    :func:`~hetu_tpu_torch.ops.conv2d`, so the sum is float32).
    ``activation`` is applied to the result when given."""

    compute_params = ("weight",)

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, *, generator: torch.Generator,
                 bias: bool = True, weight_init=None, bias_init=None,
                 activation=None, dtype=torch.float32):
        super().__init__()
        ks = (kernel_size, kernel_size) if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        self.stride = stride
        self.padding = padding
        self.activation = activation
        self.dtype = dtype
        w_init = weight_init or initializers.he_normal()
        self.weight = nn.Parameter(w_init(
            generator, (out_channels, in_channels) + ks))
        self.bias = nn.Parameter((bias_init or initializers.zeros())(
            generator, (out_channels,))) if bias else None

    def forward(self, x):
        w = self.weight.to(self.dtype)
        x = x.to(self.dtype)
        if self.bias is not None:
            y = ops.conv2d_add_bias(x, w, self.bias, stride=self.stride,
                                    padding=self.padding)
        else:
            y = ops.conv2d(x, w, stride=self.stride, padding=self.padding)
        return y if self.activation is None else self.activation(y)


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
