"""Ulysses (DeepSpeed-style) sequence parallelism (counterpart of
``hetu_tpu/parallel/ulysses.py``): a head <-> sequence all-to-all.

Attention inputs arrive sequence-split, ``[B, H, S/n, D]`` on each of the
``n`` ranks of the axis; an all-to-all re-splits them by heads, ``[B, H/n,
S, D]``; each rank runs the flash kernels (:func:`flash_attention`, the
ports of the TPU's ``_flash_fwd_kernel`` and its two backward kernels) on
its heads over the whole sequence; the reverse all-to-all restores the
sequence split.  The heads must divide the axis.  Differentiable: the
all-to-all's gradient is the reverse all-to-all, the kernels' their
backward kernels.
"""

from __future__ import annotations

from hetu_tpu_torch.ops.cuda_kernels.flash_attention import flash_attention
from hetu_tpu_torch.parallel import collectives


def ulysses_attention(q, k, v, mesh=None, *, axis: str = "sp",
                      causal: bool = False, scale=None):
    """This rank's ``[B, H, S/n, D]`` blocks of q, k and v, sequence-split
    over mesh axis ``axis`` → this rank's block of O.  Raises
    ``ValueError`` when the heads do not divide the axis."""
    n = collectives.axis_size(axis, mesh)
    if q.shape[1] % n != 0:
        raise ValueError(f"num_heads {q.shape[1]} not divisible by "
                         f"{axis}={n}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if n == 1:
        return flash_attention(q, k, v, causal=causal, scale=scale)

    def to_heads(x):  # [B, H, S/n, D] -> [B, H/n, S, D]
        return collectives.all_to_all(x, axis, split_dim=1, concat_dim=2,
                                      mesh=mesh)

    oh = flash_attention(to_heads(q), to_heads(k), to_heads(v),
                         causal=causal, scale=scale)
    return collectives.all_to_all(oh, axis, split_dim=2, concat_dim=1,
                                  mesh=mesh)
