"""Initializers (counterpart of ``hetu_tpu/init``).

Each initializer is ``fn(generator, shape, dtype=float32) -> Tensor``: the
reference's ``fn(key, shape, dtype)`` with an explicit ``torch.Generator``
in place of the JAX key.  The two frameworks draw different numbers from
the same seed, so parity tests make weights with numpy and load them
through :mod:`hetu_tpu_torch.interop`.  Tensors are made on the
generator's device.
"""

from __future__ import annotations

import math

import torch


def _empty(generator, shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device=generator.device)


def zeros():
    def init(generator, shape, dtype=torch.float32):
        return _empty(generator, shape, dtype).zero_()
    return init


def ones():
    def init(generator, shape, dtype=torch.float32):
        return _empty(generator, shape, dtype).fill_(1.0)
    return init


def normal(mean=0.0, stddev=0.05):
    def init(generator, shape, dtype=torch.float32):
        return _empty(generator, shape, dtype).normal_(
            mean, stddev, generator=generator)
    return init


def truncated_normal(mean=0.0, stddev=0.05):
    """Normal(mean, stddev) redrawn into ``mean ± 2 stddev``, as the
    reference's ``truncated_normal`` (``jax.random.truncated_normal`` on
    [-2, 2], scaled and shifted)."""
    def init(generator, shape, dtype=torch.float32):
        return torch.nn.init.trunc_normal_(
            _empty(generator, shape, dtype), mean, stddev,
            mean - 2.0 * stddev, mean + 2.0 * stddev, generator=generator)
    return init


def _fans(shape):
    """(fan_in, fan_out) by the reference's rule: a 2-D ``[in, out]``
    shape's two sides; an OIHW convolution weight's ``I·kh·kw`` and
    ``O·kh·kw``; ``int(sqrt(prod(shape)))`` for both otherwise (the 3-D
    stacked expert weights)."""
    if len(shape) == 2:
        return shape[0], shape[1]
    if len(shape) == 4:
        rf = shape[2] * shape[3]
        return shape[1] * rf, shape[0] * rf
    fan = int(math.sqrt(math.prod(shape)))
    return fan, fan


def xavier_uniform(gain: float = 1.0):
    """Glorot uniform, limit ``gain * sqrt(6 / (fan_in + fan_out))``.  For
    a 2-D weight the sum is the same for the port's ``[out, in]`` as for
    the reference's ``[in, out]``."""
    def init(generator, shape, dtype=torch.float32):
        fan_in, fan_out = _fans(shape)
        limit = gain * math.sqrt(6.0 / (fan_in + fan_out))
        return _empty(generator, shape, dtype).uniform_(
            -limit, limit, generator=generator)
    return init


def he_normal(gain: float = 1.0):
    """He (Kaiming) normal, std ``gain * sqrt(2 / fan_in)``, with the
    reference's fans (:func:`_fans`): a 2-D ``[in, out]`` shape's ``in``,
    an OIHW convolution weight's ``I·kh·kw``."""
    def init(generator, shape, dtype=torch.float32):
        fan_in, _ = _fans(shape)
        return _empty(generator, shape, dtype).normal_(
            0.0, gain * math.sqrt(2.0 / fan_in), generator=generator)
    return init


__all__ = ["zeros", "ones", "normal", "truncated_normal", "xavier_uniform",
           "he_normal"]
