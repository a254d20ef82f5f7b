"""Hand-written CUDA kernels for Hopper (counterpart of
``hetu_tpu/ops/pallas_kernels``).

Each kernel module holds the wrappers (checks, allocation, launch on the
current stream, a ``launches`` counter per kernel) and the plain PyTorch
versions that CPU tensors run.  Sources are in ``hetu_tpu_torch/csrc``;
:mod:`.build` compiles them with nvcc on first use.
"""

from hetu_tpu_torch.ops.cuda_kernels.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_dkdv,
    flash_attention_bwd_dq, flash_attention_bwd_plain, flash_attention_plain,
)

__all__ = ["flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_dkdv", "flash_attention_bwd_dq",
           "flash_attention_bwd_plain", "flash_attention_plain"]
