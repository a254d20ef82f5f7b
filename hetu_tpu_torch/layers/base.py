"""Module base (counterpart of ``hetu_tpu/layers/base.py``).

The reference's modules are pure functions over parameter pytrees
(``init(key)`` / ``apply(variables, x)``); the port's are ``nn.Module``s
that own real parameters, built from an explicit ``torch.Generator`` and
called as ``module(x)``.

Parameters are float32 master weights; a layer's ``dtype`` is its COMPUTE
type, applied at each use as in the reference.  Serving does not want that
cast on every step, so :meth:`Module.cast_compute_params_` stores the
parameters a layer would cast, once, in its compute type.
"""

from __future__ import annotations

from torch import nn


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
