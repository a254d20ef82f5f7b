"""Functional ops on torch tensors (counterpart of ``hetu_tpu/ops``).

What the ported slices run: GPT serving and training, MoE training (the
five gates), Llama serving and training, BERT pretraining, CTR training,
the CNN family's convolutions, pools and batch norm, GCN's message
passing, the reference's elementwise, shape, reduce and matmul
families under its names, and the quantization and pruning ops of the
embedding-compression zoo.
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
from hetu_tpu_torch.ops.elementwise import (
    abs_, add, add_const, bool_, ceil, clamp, const_div, const_minus,
    const_pow, cos, div_const, divide, exp, floor, log, mask, masked_fill,
    minus, minus_const, mul_const, multiply, opposite, pow_, power, rsqrt,
    sign, sin, sqrt, where,
)
from hetu_tpu_torch.ops.embedding import (
    IndexedSlices, assign_with_indexed_slices, embedding_lookup,
    sparse_embedding_lookup, sum_sparse_gradient, take_grad_indexed,
)
from hetu_tpu_torch.ops.losses import (
    binary_cross_entropy, binary_cross_entropy_with_logits, cross_entropy,
    cross_entropy_sparse, lm_head_cross_entropy, nll_loss,
    softmax_cross_entropy, softmax_cross_entropy_sparse,
)
from hetu_tpu_torch.ops.graph_ops import coo_spmm, gcn_conv, gcn_norm
from hetu_tpu_torch.ops.matmul import (
    addmm, baddbmm, batch_matmul, linear, matmul, matrix_dot,
)
from hetu_tpu_torch.ops.moe_ops import (
    balance_assignment, balance_log_plan, gather_combine, gather_dispatch,
    layout_transform, make_dispatch_combine, make_slot_routes,
    make_slot_routing, reverse_layout_transform, top_k_idx_gate,
)
from hetu_tpu_torch.ops.quantize import (
    dequantize, param_clip, prune_low_magnitude, quantize,
    quantize_embedding_lookup,
)
from hetu_tpu_torch.ops.norm import (
    batch_norm, instance_norm2d, layer_norm, rms_norm,
)
from hetu_tpu_torch.ops.reduce import (
    argmax, argsort, max_, min_, norm, reduce_max, reduce_mean, reduce_min,
    reduce_mul, reduce_norm1, reduce_norm2, reduce_sum, reduce_sum_axis_zero,
    sam_group_sum, sam_max, topk, topk_idx, topk_val, unique,
)
from hetu_tpu_torch.ops.rope import apply_rope, apply_rope_at, rope_tables
from hetu_tpu_torch.ops.shape import (
    arange, broadcast_shape, broadcast_to, concat, concatenate, cumsum, flip,
    full, full_like, gather, gather_elements, indexing, interpolate,
    one_hot, ones_like, pad, repeat, reshape, roll, scatter, scatter1d,
    slice_, slice_assign, slice_by_matrix, split, tile, transpose, tril,
    tril_lookup, triu, zeros_like,
)

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
    # elementwise
    "abs_", "add", "add_const", "minus", "minus_const", "const_minus",
    "multiply", "mul_const", "divide", "div_const", "const_div", "opposite",
    "exp", "log", "pow_", "const_pow", "power", "sqrt", "rsqrt", "sin",
    "cos", "floor", "ceil", "clamp", "sign", "bool_", "where",
    "masked_fill", "mask",
    # matmul
    "matmul", "batch_matmul", "addmm", "baddbmm", "matrix_dot",
    # shape
    "reshape", "transpose", "concat", "concatenate", "split", "slice_",
    "slice_assign", "slice_by_matrix", "pad", "tile", "repeat", "roll",
    "broadcast_shape", "broadcast_to", "gather", "gather_elements",
    "scatter", "scatter1d", "indexing", "one_hot", "arange", "full",
    "full_like", "ones_like", "zeros_like", "cumsum", "interpolate", "flip",
    "tril_lookup", "triu", "tril",
    # reduce
    "reduce_sum", "reduce_mean", "reduce_min", "reduce_max", "reduce_mul",
    "reduce_norm1", "reduce_norm2", "reduce_sum_axis_zero", "norm", "max_",
    "min_", "argmax", "argsort", "topk_idx", "topk_val", "topk", "unique",
    # graph
    "coo_spmm", "gcn_norm", "gcn_conv",
    # quantization and pruning
    "quantize", "dequantize", "quantize_embedding_lookup",
    "prune_low_magnitude", "param_clip",
]
