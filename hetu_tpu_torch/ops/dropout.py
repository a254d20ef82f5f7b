"""Dropout (counterpart of ``hetu_tpu/ops/dropout.py``).

The generator is explicit, as the reference's PRNG key is: the same
generator state gives the same mask.  The two frameworks draw different
bits from the same seed, so no dropout mask of the port matches the JAX
package's; the parity tests run with rate 0.
"""

from __future__ import annotations

import torch


def dropout(x, rate: float, generator, *, train: bool = True):
    """Zero each element with probability ``rate`` and scale the kept ones
    by ``1 / (1 - rate)``, in ``x``'s type; the identity when not training
    or at rate 0.  ``generator`` lives on ``x``'s device."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout while training needs a generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)
