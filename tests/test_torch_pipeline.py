"""The port's GPipe (``hetu_tpu_torch/parallel/pipeline.py``) against
hetu_tpu on the CPU.

A ``gloo`` world of 2 and one of 4 rank processes start once for the
module (``tests/torch_sharded_bodies.py``) and run ``GPipe`` on the tanh
block of ``tests/test_pipeline.py`` from numpy layers, inputs and
cotangents.  The oracle is the reference's ``GPipe`` on its virtual CPU
mesh of the same pp, run in this process, with the reference test's cases:
equal stages (``remat`` off and on), a batch of 8 microbatches with the
output scaled outside the pipeline, and unequal stages from a
``GPipeSearching`` plan with the layer mask.  Outputs are held at the
reference test's ``rtol=1e-5, atol=1e-6``; the gradients of ``sum(out *
w)`` for the layers (each rank's stage rows, assembled) and for the input
at its ``rtol=1e-4, atol=1e-5``.  ``pipedream_schedule`` is the
reference's list for several (stages, microbatches).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hetu_tpu as ht
import torch_sharded_bodies as bodies
from hetu_tpu.parallel.pipeline import GPipe as JaxGPipe
from hetu_tpu.parallel.pipeline import pipedream_schedule as jax_schedule
from hetu_tpu_torch.parallel import pipeline, ranks


def block_fn(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])


def searched_bounds():
    """Unequal cuts from the reference's searcher (its test's plan)."""
    from hetu_tpu.parallel.strategies.search import GPipeSearching
    from hetu_tpu.profiler.cost_model import CHIPS
    from hetu_tpu.profiler.simulator import LayerSpec, ShardOption, Simulator
    specs = [LayerSpec(f"l{i}", flops=1e12 * (1 + 3 * (i == 0)),
                       param_bytes=1e6, act_bytes=1e6,
                       options=[ShardOption("dp")]) for i in range(6)]
    plan = GPipeSearching(Simulator(CHIPS["v5e"]), n_stages=4,
                          n_microbatches=4).search(specs)
    return list(plan.stage_bounds)


def case(seed, L, D, B, M, remat=False, scale=1.0, bounds=None):
    g = np.random.default_rng(seed)
    return dict(layers={"w": (g.standard_normal((L, D, D)) * 0.3).astype(
        np.float32), "b": (g.standard_normal((L, D)) * 0.1).astype(
        np.float32)}, h=g.standard_normal((B, D)).astype(np.float32),
        w=g.standard_normal((B, D)).astype(np.float32), M=M, remat=remat,
        scale=scale, bounds=bounds)


def cases(n):
    if n == 2:
        return {"equal": case(0, 4, 16, 8, 4),
                "remat": case(1, 4, 8, 8, 2, remat=True)}
    bounds = searched_bounds()
    assert len({e - s for s, e in zip([0] + bounds[:-1], bounds)}) > 1
    return {"equal": case(0, 8, 16, 8, 4),
            "remat": case(2, 4, 8, 8, 4, remat=True),
            "dp_outside": case(5, 4, 8, 16, 8, scale=2.0),
            "unequal": case(7, 6, 8, 8, 4, bounds=bounds)}


@pytest.fixture(scope="module")
def worlds():
    return {n: (cases(n), ranks.run(
        bodies.run_cases, n, threads=1, timeout_s=300,
        args=({"pipe": ("gpipe", {"cases": cases(n)})},)))
        for n in (2, 4)}


def _reference(c, n):
    """Output and the gradients of sum(out * w) (layers [L, ...], h) of the
    reference's GPipe on a pp = n mesh."""
    pipe = JaxGPipe(block_fn, ht.make_mesh(pp=n), n_microbatches=c["M"],
                    remat=c["remat"])

    def out(layers, h):
        if c["bounds"]:
            st, mask = pipe.stack_params_unequal(layers, c["bounds"])
            return pipe(st, h, layer_mask=mask) * c["scale"]
        return pipe(pipe.stack_params(layers), h) * c["scale"]

    layers = {k: jnp.asarray(v) for k, v in c["layers"].items()}
    y = np.asarray(jax.jit(out)(layers, c["h"]))
    g_l, g_h = jax.jit(jax.grad(lambda ls, h: jnp.sum(out(ls, h) * c["w"]),
                                argnums=(0, 1)))(layers, c["h"])
    return y, {k: np.asarray(v) for k, v in g_l.items()}, np.asarray(g_h)


def _stage_rows(res, cid, key, c, n):
    """The layers' gradient ``[L, ...]`` from each stage's rows."""
    rows = [r["pipe"][cid][key] for r in res]
    if c["bounds"]:
        starts = [0] + c["bounds"][:-1]
        rows = [x[:e - s] for x, s, e in zip(rows, starts, c["bounds"])]
    return np.concatenate(rows)


@pytest.mark.parametrize("n,cid", [(2, "equal"), (2, "remat"), (4, "equal"),
                                   (4, "remat"), (4, "dp_outside"),
                                   (4, "unequal")])
def test_gpipe_matches_the_reference(n, cid, worlds):
    cs, res = worlds[n]
    c = cs[cid]
    y_ref, gl_ref, gh_ref = _reference(c, n)
    for r in res:
        np.testing.assert_allclose(r["pipe"][cid]["y"], y_ref, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r["pipe"][cid]["dh"], gh_ref, rtol=1e-4,
                                   atol=1e-5)
    for key, ref in (("dw", gl_ref["w"]), ("db", gl_ref["b"])):
        np.testing.assert_allclose(_stage_rows(res, cid, key, c, n), ref,
                                   rtol=1e-4, atol=1e-5, err_msg=key)
    if c["bounds"]:
        sizes = [e - s for s, e in zip([0] + c["bounds"][:-1], c["bounds"])]
        mask = res[0]["pipe"][cid]["mask"]
        assert mask.tolist() == [[1.0] * k + [0.0] * (max(sizes) - k)
                                 for k in sizes]


def test_no_rank_loads_jax(worlds):
    assert not any(r["_jax_loaded"] for n in worlds for r in worlds[n][1])


@pytest.mark.parametrize("stages,micro", [(4, 6), (2, 2), (3, 8), (4, 2),
                                          (1, 3)])
def test_pipedream_schedule_is_the_references(stages, micro):
    assert pipeline.pipedream_schedule(stages, micro) == \
        jax_schedule(stages, micro)


def test_stack_stage_params_refuses_uneven_layers():
    import torch
    with pytest.raises(ValueError, match="not divisible"):
        pipeline.stack_stage_params({"w": torch.zeros(6, 2)}, 4)
