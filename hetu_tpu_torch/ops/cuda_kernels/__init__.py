"""Hand-written CUDA kernels for Hopper (counterpart of
``hetu_tpu/ops/pallas_kernels``).

Each kernel module holds the wrappers (checks, allocation, launch on the
current stream, a ``launches`` counter per kernel) and the plain PyTorch
versions that CPU tensors run.  Sources are in ``hetu_tpu_torch/csrc``;
:mod:`.build` compiles them with nvcc on first use.
"""

from hetu_tpu_torch.ops.cuda_kernels.embedding import (
    embedding_gather, embedding_gather_plain, embedding_scatter_add,
    embedding_scatter_add_inverse_plain, embedding_scatter_add_plain,
    routed_gather, topk_gating, topk_gating_plain,
)
from hetu_tpu_torch.ops.cuda_kernels.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_dkdv,
    flash_attention_bwd_dq, flash_attention_bwd_plain, flash_attention_plain,
)

__all__ = ["embedding_gather", "embedding_gather_plain",
           "embedding_scatter_add", "embedding_scatter_add_inverse_plain",
           "embedding_scatter_add_plain",
           "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_dkdv", "flash_attention_bwd_dq",
           "flash_attention_bwd_plain", "flash_attention_plain",
           "routed_gather", "topk_gating", "topk_gating_plain"]
