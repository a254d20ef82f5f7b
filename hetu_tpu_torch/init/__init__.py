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


def xavier_uniform(gain: float = 1.0):
    """Glorot uniform for a 2-D weight.  The limit depends on
    ``fan_in + fan_out`` only, so it is the same for the port's
    ``[out, in]`` weights as for the reference's ``[in, out]``."""
    def init(generator, shape, dtype=torch.float32):
        if len(shape) != 2:
            raise ValueError(f"xavier_uniform takes a 2-D shape, got {shape}")
        limit = gain * math.sqrt(6.0 / (shape[0] + shape[1]))
        return _empty(generator, shape, dtype).uniform_(
            -limit, limit, generator=generator)
    return init


def he_normal(gain: float = 1.0):
    """He (Kaiming) normal, std ``gain * sqrt(2 / fan_in)``, with the
    reference's fans: a 2-D ``[in, out]`` shape's ``in``, and
    ``int(sqrt(prod(shape)))`` for the 3-D stacked expert weights."""
    def init(generator, shape, dtype=torch.float32):
        if len(shape) == 2:
            fan_in = shape[0]
        elif len(shape) == 4:
            raise ValueError("he_normal: convolution weights are not ported")
        else:
            fan_in = int(math.sqrt(math.prod(shape)))
        return _empty(generator, shape, dtype).normal_(
            0.0, gain * math.sqrt(2.0 / fan_in), generator=generator)
    return init


__all__ = ["zeros", "ones", "normal", "truncated_normal", "xavier_uniform",
           "he_normal"]
