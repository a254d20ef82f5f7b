"""The port's sequence parallelism (``hetu_tpu_torch/parallel/ring_attention.py``
and ``ulysses.py``) against hetu_tpu on the CPU.

A ``gloo`` world of 2 and one of 4 rank processes start once for the
module (``tests/torch_sharded_bodies.py``); each rank holds its sequence
block of one numpy q, k, v ``[2, 8, 32, 16]`` and of a cotangent ``w``.
The oracles are the reference's ``ring_attention`` and
``ulysses_attention`` on its virtual CPU mesh of the same sp, run in this
process: O (the ranks' blocks concatenated) at the reference tests'
``rtol=2e-4, atol=2e-5`` (``tests/test_seq_parallel.py``), and dQ, dK,
dV of ``sum(O * w)`` at the same tolerance, causal and not, for

* the kernel ring (the flash kernels' plain versions on the CPU, merged
  by LSE; the FlashAttention-2 ring backward),
* the plain ring (the reference's blockwise einsum, autograd),
* Ulysses (all-to-all to heads, flash attention, all-to-all back);

and Ulysses refuses heads that do not divide the axis.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hetu_tpu as ht
import torch_sharded_bodies as bodies
from hetu_tpu.parallel.ring_attention import ring_attention as jax_ring
from hetu_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from hetu_tpu_torch.parallel import ranks

SHAPE = (2, 8, 32, 16)
RTOL, ATOL = 2e-4, 2e-5


def inputs():
    g = np.random.default_rng(0)
    return {x: g.standard_normal(SHAPE).astype(np.float32)
            for x in ("q", "k", "v", "w")}


@pytest.fixture(scope="module")
def worlds():
    spec = inputs()
    return {n: ranks.run(bodies.run_cases, n, threads=1, timeout_s=300,
                         args=({"seq": ("seq_attention", spec)},))
            for n in (2, 4)}


def _reference(fn, n, causal):
    """O and (dQ, dK, dV) of ``sum(O * w)`` of the reference's function
    on an sp = n mesh."""
    x = inputs()
    mesh = ht.make_mesh(sp=n)
    f = partial(fn, mesh=mesh, causal=causal)

    def loss(q, k, v):
        return jnp.sum(f(q, k, v) * x["w"])
    o = np.asarray(jax.jit(f)(x["q"], x["k"], x["v"]))
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(x["q"], x["k"],
                                                       x["v"])
    return [o] + [np.asarray(g) for g in grads]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", ["ring", "plain", "ulysses"])
def test_matches_the_reference_forward_and_backward(name, causal, n, worlds):
    ref = _reference(jax_ulysses if name == "ulysses" else jax_ring, n,
                     causal)
    got = [np.concatenate([r["seq"][(name, causal)][i] for r in worlds[n]],
                          axis=2) for i in range(4)]
    for what, a, b in zip(("O", "dQ", "dK", "dV"), got, ref):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} {what}")


def test_ulysses_rejects_bad_heads_and_no_rank_loads_jax(worlds):
    for n in (2, 4):
        for r in worlds[n]:
            assert "not divisible" in r["seq"]["bad_heads"]
            assert not r["_jax_loaded"]
