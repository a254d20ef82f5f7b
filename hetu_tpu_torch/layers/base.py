"""Module base (counterpart of ``hetu_tpu/layers/base.py``).

The reference's modules are pure functions over parameter pytrees
(``init(key)`` / ``apply(variables, x, train=, rng=)``); the port's are
``nn.Module``s that own real parameters, built from an explicit
``torch.Generator`` and called as ``module(x, train=, generator=)``.

Parameters are float32 master weights; a layer's ``dtype`` is its COMPUTE
type, applied at each use as in the reference.  Serving does not want that
cast on every step, so :meth:`Module.cast_compute_params_` stores the
parameters a layer would cast, once, in its compute type.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hetu_tpu_torch.rng import derive_seed


def child_generator(generator: Optional[torch.Generator],
                    i: int) -> Optional[torch.Generator]:
    """The ``i``-th sub-layer's generator, a fresh one seeded from the
    parent's seed and ``i`` (the reference's ``child_rng``, a
    ``fold_in``).  It depends on the parent's seed, not on how much the
    parent has drawn, so a block recomputed under checkpointing draws the
    same masks again.  ``None`` stays ``None``."""
    if generator is None:
        return None
    return torch.Generator(device=generator.device).manual_seed(
        derive_seed(generator.initial_seed(), i))


class Module(nn.Module):
    #: names of the parameters ``forward`` casts to ``self.dtype`` at use
    compute_params: tuple = ()

    def cast_compute_params_(self) -> "Module":
        """Store every (sub)layer's compute parameters in its compute type,
        in place.  Bitwise the same results as casting at every use."""
        for m in self.modules():
            for name in getattr(m, "compute_params", ()):
                p = getattr(m, name)
                p.data = p.data.to(m.dtype)
        return self
