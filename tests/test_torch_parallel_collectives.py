"""The port's collectives (``hetu_tpu_torch.parallel.collectives``) and
the quantized wire's block codec against hetu_tpu on the CPU.

Every collective runs per rank in a ``gloo`` world of 2 (and of 4 for the
two-level all-to-all), on the ranks' blocks of one numpy array, and is
held forward and backward against the reference's function in a
``shard_map`` over the same mesh shape (the first 2 or 4 of the 8 virtual
CPU devices): the outputs concatenated over the ranks, and the gradient
of ``sum(out * w)``.  The reference's ``quantized_psum`` tests pass
``check_rep``, which jax 0.9 no longer takes, so the oracle here is that
function inside a ``shard_map(..., check_vma=False)`` of this file's own.
Tolerances: 1e-6 relative (two- and four-way f32 sums in another order),
the int8 codes and scales bitwise.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh, PartitionSpec as JP

import torch_parallel_bodies as bodies
from hetu_tpu.parallel import collectives as jc
from hetu_tpu.quantwire import jnp_block_decode, jnp_block_encode
from hetu_tpu_torch import quantwire
from hetu_tpu_torch.parallel import ranks

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

RTOL = 1e-6


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# (port function, port kwargs, reference function of x, input shape,
#  gradient checked)
CASES2 = {
    "psum": ("psum", dict(axis="dp"), lambda x: lax.psum(x, "i"), (8, 6)),
    "pmean": ("pmean", dict(axis="dp"), lambda x: lax.pmean(x, "i"), (8, 6)),
    "all_gather0": ("all_gather", dict(axis="dp", tiled_dim=0),
                    lambda x: jc.all_gather(x, "i", tiled_dim=0), (8, 6)),
    "all_gather1": ("all_gather", dict(axis="dp", tiled_dim=1),
                    lambda x: jc.all_gather(x, "i", tiled_dim=1), (8, 6)),
    "reduce_scatter0": ("reduce_scatter", dict(axis="dp", scatter_dim=0),
                        lambda x: jc.reduce_scatter(x, "i", scatter_dim=0),
                        (8, 6)),
    "reduce_scatter1": ("reduce_scatter", dict(axis="dp", scatter_dim=1),
                        lambda x: jc.reduce_scatter(x, "i", scatter_dim=1),
                        (8, 6)),
    "all_to_all01": ("all_to_all", dict(axis="dp", split_dim=0,
                                        concat_dim=1),
                     lambda x: jc.all_to_all(x, "i", split_dim=0,
                                             concat_dim=1), (8, 6)),
    "all_to_all10": ("all_to_all", dict(axis="dp", split_dim=1,
                                        concat_dim=0),
                     lambda x: jc.all_to_all(x, "i", split_dim=1,
                                             concat_dim=0), (8, 6)),
    "ppermute1": ("ppermute_shift", dict(axis="dp", shift=1),
                  lambda x: jc.ppermute_shift(x, "i", 1), (8, 6)),
    "ppermute_1": ("ppermute_shift", dict(axis="dp", shift=-1),
                   lambda x: jc.ppermute_shift(x, "i", -1), (8, 6)),
    "grouped_allreduce": ("grouped_allreduce", dict(axis="dp"),
                          lambda x: lax.psum(x, "i"), (8, 6)),
    "quantized_psum_f32": ("quantized_psum", dict(axis="dp", wire="f32"),
                           lambda x: jc.quantized_psum(x, "i", wire="f32"),
                           (8, 64)),
    "quantized_psum_bf16": ("quantized_psum", dict(axis="dp", wire="bf16"),
                            lambda x: jc.quantized_psum(x, "i",
                                                        wire="bf16"),
                            (2, 257)),
    "quantized_psum_int8": ("quantized_psum", dict(axis="dp", wire="int8",
                                                   block=128),
                            lambda x: jc.quantized_psum(x, "i", wire="int8",
                                                        block=128),
                            (2, 1000)),
    "quantized_pmean_int8": ("quantized_pmean", dict(axis="dp",
                                                     wire="int8"),
                             lambda x: jc.quantized_pmean(x, "i",
                                                          wire="int8"),
                             (4, 300)),
}

CASES4 = {
    "hierarchical": ("hierarchical_all_to_all",
                     dict(outer_axis="dp", inner_axis="tp"),
                     lambda x: jc.hierarchical_all_to_all(x, "o", "i"),
                     (16, 3)),
    "flat_composite": ("all_to_all", dict(axis=("dp", "tp")),
                       lambda x: lax.all_to_all(x, ("o", "i"), 0, 0,
                                                tiled=True), (16, 3)),
    "psum_composite": ("psum", dict(axis=("dp", "tp")),
                       lambda x: lax.psum(x, ("o", "i")), (8, 2)),
}


def _inputs(cases):
    return {cid: (_x(i, shape), _x(100 + i, shape))
            for i, (cid, (_, _, _, shape)) in enumerate(cases.items())}


def _reference(fn, x, w, n, two_level, grad=True):
    """The reference's function in a shard_map over ``n`` CPU devices:
    outputs (per-device blocks concatenated) and d sum(out * w) / dx."""
    devs = np.array(jax.devices()[:n])
    if two_level:
        mesh, spec = Mesh(devs.reshape(2, 2), ("o", "i")), JP(("o", "i"))
    else:
        mesh, spec = Mesh(devs, ("i",)), JP("i")
    f = shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec,
                  check_vma=False)
    y = np.asarray(jax.jit(f)(x))
    if not grad:
        return y, None

    def loss(a):
        out = f(a)
        return jnp.sum(out * jnp.reshape(jnp.resize(w, out.shape),
                                         out.shape))
    g = np.asarray(jax.jit(jax.grad(loss))(x))
    return y, g


def _port_cases(cases, inputs, n):
    """Each case's input and the cotangent of its whole output (w resized
    to the reference's output shape, as its loss does); each rank takes
    its dim-0 block of both."""
    out = {}
    for cid, (name, kw, fn, _) in cases.items():
        x, w = inputs[cid]
        y, _ = _reference(fn, x, w, n, n == 4, grad=False)
        out[cid] = (name, kw, x,
                    None if "quantized" in cid else np.resize(w, y.shape))
    return out


@pytest.fixture(scope="module")
def worlds():
    in2, in4 = _inputs(CASES2), _inputs(CASES4)
    r2 = ranks.run(bodies.run_cases, 2, threads=1, timeout_s=300, args=(
        {"c": ("collectives", dict(mesh={"dp": 2},
                                   cases=_port_cases(CASES2, in2, 2)))},))
    r4 = ranks.run(bodies.run_cases, 4, threads=1, timeout_s=300, args=(
        {"c": ("collectives", dict(mesh={"dp": 2, "tp": 2},
                                   cases=_port_cases(CASES4, in4, 4)))},))
    return {2: (r2, in2), 4: (r4, in4)}


def _check(cid, world, cases, worlds):
    res, inputs = worlds[world]
    x, w = inputs[cid]
    fn = cases[cid][2]
    y_ref, g_ref = _reference(fn, x, w, world, world == 4)
    y = np.concatenate([r["c"][cid][0] for r in res])
    np.testing.assert_allclose(y, y_ref, rtol=RTOL, atol=RTOL * np.abs(
        y_ref).max())
    if "quantized" in cid:
        return
    g = np.concatenate([r["c"][cid][1] for r in res])
    np.testing.assert_allclose(g, g_ref, rtol=RTOL,
                               atol=RTOL * np.abs(g_ref).max())


@pytest.mark.parametrize("cid", list(CASES2))
def test_collective_matches_the_reference_forward_and_backward(cid, worlds):
    _check(cid, 2, CASES2, worlds)


@pytest.mark.parametrize("cid", list(CASES4))
def test_two_level_collectives_deliver_in_flat_composite_order(cid,
                                                               worlds):
    _check(cid, 4, CASES4, worlds)


def test_nothing_staged_through_the_host_on_the_cpu(worlds):
    for world in (2, 4):
        assert all(r["c"]["staged"] == {} for r in worlds[world][0])
        assert not any(r["_jax_loaded"] for r in worlds[world][0])


def test_quantized_psum_rejects_an_unknown_wire(worlds):
    from hetu_tpu_torch.parallel import collectives as C
    with pytest.raises(ValueError, match="wire"):
        C.quantized_psum(torch.ones(4), "dp", wire="fp4", mesh=object())


@pytest.mark.parametrize("size,block", [(1000, 128), (257, 256), (64, 16),
                                        (5, 256)])
def test_block_codec_is_bitwise_the_reference(size, block):
    x = _x(size, (size,)) * 3.0
    x[::7] = 0.0
    if size > 10:
        x[3], x[4], x[5] = np.nan, np.inf, -np.inf
    q, s = quantwire.block_encode(torch.tensor(x), block)
    jq, js = jnp_block_encode(jnp.asarray(x), block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        quantwire.block_decode(q, s, size, (size,)).numpy(),
        np.asarray(jnp_block_decode(jq, js, size, (size,))))


def test_block_wire_bytes_and_check_wire():
    from hetu_tpu.quantwire import block_wire_bytes as ref_bytes
    for n, wire, block in ((1000, "int8", 128), (17, "bf16", 256),
                           (3, "f32", 256), (0, "int8", 256)):
        assert quantwire.block_wire_bytes(n, wire, block) == \
            ref_bytes(n, wire, block)
    assert quantwire.check_wire("int8") == "int8"
    with pytest.raises(ValueError, match="wire"):
        quantwire.check_wire("fp4")
