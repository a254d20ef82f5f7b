"""Functional ops on torch tensors (counterpart of ``hetu_tpu/ops``).

What the GPT serving and training slices run.  Hand-written CUDA kernels
live in :mod:`hetu_tpu_torch.ops.cuda_kernels`.
"""

from hetu_tpu_torch.ops.activations import gelu
from hetu_tpu_torch.ops.attention import (
    attention, cache_update, causal_attention, decode_attention,
)
from hetu_tpu_torch.ops.dropout import dropout
from hetu_tpu_torch.ops.embedding import embedding_lookup
from hetu_tpu_torch.ops.losses import (
    lm_head_cross_entropy, softmax_cross_entropy_sparse,
)
from hetu_tpu_torch.ops.matmul import linear
from hetu_tpu_torch.ops.norm import layer_norm

__all__ = [
    "gelu", "attention", "causal_attention", "cache_update",
    "decode_attention", "dropout", "embedding_lookup",
    "lm_head_cross_entropy", "linear", "layer_norm",
    "softmax_cross_entropy_sparse",
]
