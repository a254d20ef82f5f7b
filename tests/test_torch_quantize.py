"""The quantization and pruning ops of hetu_tpu_torch against hetu_tpu's
(``ops/quantize.py``), on the CPU, from numpy inputs drawn from a seed.

The deterministic paths are held bitwise: ``quantize`` (its scale too),
``dequantize``, ``quantize_embedding_lookup`` (per-row and scalar scale,
ids with duplicates and -1), ``prune_low_magnitude`` (with ties at the
threshold) and ``param_clip``.  Stochastic rounding draws from a
``torch.Generator``, which cannot reproduce JAX's draws, so it is held by
its properties: every value lies within one step of the deterministic
rounding and inside the clip bounds, and over 4000 draws the mean of the
dequantized values is unbiased within 0.05 of a step (the mean of 4000
uniform roundings has a standard deviation of 0.0046 step).  An id out of
range raises ``IndexError`` (the reference fills the int8 row with -128).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu import ops as jops
from hetu_tpu_torch import ops

torch.set_num_threads(2)

IDS = np.array([[1, 5, 19], [0, 5, -1]])


def _x(seed=0, shape=(20, 16)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _same(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("scale,zero_point", [(None, 0.0), (0.01, 0.0),
                                              (None, 0.25)])
def test_quantize_and_dequantize_bitwise(bits, scale, zero_point):
    x = _x(bits)
    q_ref, s_ref = jops.quantize(jnp.asarray(x), bits, scale=scale,
                                 zero_point=zero_point)
    q, s = ops.quantize(torch.tensor(x), bits, scale=scale,
                        zero_point=zero_point)
    _same(q, q_ref)
    if scale is None:
        _same(s, s_ref)
    _same(ops.dequantize(q, s, zero_point),
          jops.dequantize(q_ref, s_ref, zero_point))


def test_quantize_stochastic_by_its_properties():
    x = _x(1, (64,)) * 0.5
    step = float(np.abs(x).max()) / 127
    det, scale = ops.quantize(torch.tensor(x))
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([ops.quantize(torch.tensor(x), generator=gen)[0]
                         for _ in range(4000)]).int()
    assert (draws - det.int()).abs().max() <= 1
    assert draws.min() >= -128 and draws.max() <= 127
    mean = (draws.double() * float(scale)).mean(0).numpy()
    assert np.abs(mean - x).max() <= 0.05 * step
    # the stochastic rounding differs from the deterministic one somewhere
    assert (draws != det.int()).any()


@pytest.mark.parametrize("per_row", [True, False])
def test_quantize_embedding_lookup_bitwise(per_row):
    x = _x(2)
    if per_row:
        scale = (np.abs(x).max(1) / 127).astype(np.float32)
        q = np.clip(np.round(x / scale[:, None]), -128, 127).astype(np.int8)
    else:
        q, scale = (np.asarray(a) for a in jops.quantize(jnp.asarray(x)))
    ref = jops.quantize_embedding_lookup(jnp.asarray(q), jnp.asarray(scale),
                                         jnp.asarray(IDS))
    got = ops.quantize_embedding_lookup(torch.tensor(q), torch.tensor(scale),
                                        torch.tensor(IDS))
    _same(got, ref)


def test_quantize_embedding_lookup_raises_out_of_range():
    q = torch.zeros((20, 4), dtype=torch.int8)
    for bad in (20, -21):
        with pytest.raises(IndexError):
            ops.quantize_embedding_lookup(q, torch.ones(20),
                                          torch.tensor([0, bad]))


@pytest.mark.parametrize("rate", [0.0, 0.3, 0.5, 0.9, 1.0])
def test_prune_low_magnitude_bitwise(rate):
    x = _x(3)
    x[0, :6] = 0.5  # ties at a kept magnitude
    x[1, :3] = -0.5
    _same(ops.prune_low_magnitude(torch.tensor(x), rate),
          jops.prune_low_magnitude(jnp.asarray(x), rate))


def test_param_clip_bitwise():
    x = _x(4)
    _same(ops.param_clip(torch.tensor(x), -0.5, 0.75),
          jops.param_clip(jnp.asarray(x), -0.5, 0.75))
