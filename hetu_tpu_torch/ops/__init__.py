"""Functional ops on torch tensors (counterpart of ``hetu_tpu/ops``).

What the ported slices run: GPT serving and training, MoE training (the
five gates), Llama serving and training, BERT pretraining, CTR training,
and the CNN family's convolutions, pools and batch norm.
Hand-written CUDA kernels live in :mod:`hetu_tpu_torch.ops.cuda_kernels`.
"""

from hetu_tpu_torch.ops.activations import (
    gelu, leaky_relu, log_softmax, relu, sigmoid, silu, softmax, tanh,
)
from hetu_tpu_torch.ops.attention import (
    attention, cache_update, causal_attention, chunk_attention,
    decode_attention,
)
from hetu_tpu_torch.ops.conv import (
    avg_pool2d, conv2d, conv2d_add_bias, max_pool2d,
)
from hetu_tpu_torch.ops.dropout import dropout
from hetu_tpu_torch.ops.embedding import (
    IndexedSlices, assign_with_indexed_slices, embedding_lookup,
    sparse_embedding_lookup, sum_sparse_gradient, take_grad_indexed,
)
from hetu_tpu_torch.ops.losses import (
    binary_cross_entropy, binary_cross_entropy_with_logits, cross_entropy,
    cross_entropy_sparse, lm_head_cross_entropy, nll_loss,
    softmax_cross_entropy, softmax_cross_entropy_sparse,
)
from hetu_tpu_torch.ops.matmul import linear
from hetu_tpu_torch.ops.moe_ops import (
    balance_assignment, balance_log_plan, gather_combine, gather_dispatch,
    layout_transform, make_dispatch_combine, make_slot_routes,
    make_slot_routing, reverse_layout_transform, top_k_idx_gate,
)
from hetu_tpu_torch.ops.norm import (
    batch_norm, instance_norm2d, layer_norm, rms_norm,
)
from hetu_tpu_torch.ops.reduce import sam_group_sum, sam_max
from hetu_tpu_torch.ops.rope import apply_rope, apply_rope_at, rope_tables

__all__ = [
    "gelu", "relu", "silu", "leaky_relu", "sigmoid", "tanh", "softmax",
    "log_softmax", "conv2d", "conv2d_add_bias", "max_pool2d",
    "avg_pool2d", "batch_norm", "instance_norm2d", "cross_entropy",
    "cross_entropy_sparse", "softmax_cross_entropy", "nll_loss",
    "attention", "causal_attention", "cache_update",
    "chunk_attention", "decode_attention", "dropout", "embedding_lookup",
    "IndexedSlices",
    "sparse_embedding_lookup", "take_grad_indexed", "sum_sparse_gradient",
    "assign_with_indexed_slices", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "lm_head_cross_entropy", "linear",
    "layer_norm", "rms_norm",
    "rope_tables", "apply_rope", "apply_rope_at",
    "softmax_cross_entropy_sparse", "gather_combine", "gather_dispatch",
    "layout_transform", "make_dispatch_combine", "make_slot_routes",
    "make_slot_routing",
    "reverse_layout_transform", "top_k_idx_gate", "balance_assignment",
    "balance_log_plan", "sam_group_sum", "sam_max",
]
