"""Small parts of the reference's API in hetu_tpu_torch, each against
hetu_tpu on the CPU: ``train.gradients``, ``Executor.set_grad_scale``,
``models.gpt2_small`` and ``LayerNorm(dtype=)``.

Tolerances (f32): gradients and parameters after an SGD step rtol 1e-5
(atol 1e-7); the bf16 LayerNorm's output bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu import layers as jlayers
from hetu_tpu import models as jmodels
from hetu_tpu import ops as jops
from hetu_tpu import optim as joptim
from hetu_tpu.models.mlp import MLP as JMLP
from hetu_tpu.train.executor import Executor as JExecutor
from hetu_tpu.train.executor import gradients as jgradients
from hetu_tpu_torch import interop, layers, models, optim
from hetu_tpu_torch.models import classifier_loss_fn
from hetu_tpu_torch.train import Executor, gradients

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-7


def _t(x):
    return torch.tensor(np.asarray(x))


def test_gradients_is_jax_grad():
    g = np.random.default_rng(0)
    w, x = g.standard_normal((3, 4), np.float32), g.standard_normal(
        (5, 3), np.float32)

    def jloss(w, x):
        y = jnp.tanh(x @ w)
        return jnp.sum(y * y), {"max": jnp.max(y)}

    def tloss(w, x):
        y = torch.tanh(x @ w)
        return (y * y).sum(), {"max": y.max()}
    for argnums in (0, 1, (0, 1)):
        ref, raux = jgradients(jloss, argnums=argnums, has_aux=True)(w, x)
        got, aux = gradients(tloss, argnums=argnums, has_aux=True)(_t(w),
                                                                   _t(x))
        for r, a in zip(jax.tree_util.tree_leaves(ref),
                        jax.tree_util.tree_leaves(got)):
            np.testing.assert_allclose(a.numpy(), r, RTOL, ATOL)
        np.testing.assert_allclose(float(aux["max"]), float(raux["max"]),
                                   RTOL)
    np.testing.assert_allclose(
        gradients(lambda w: tloss(w, _t(x))[0])(_t(w)).numpy(),
        jgradients(lambda w: jloss(w, x)[0])(w), RTOL, ATOL)


@pytest.mark.parametrize("scale", [0.5, 1.0, 3.0])
def test_a_step_under_set_grad_scale_is_the_references(scale):
    """An MLP (Sequential) through one SGD(0.1) Executor step on each side
    with the same weights and batch, the scale set before the step."""
    jm = JMLP(6, (5,), 3)
    g = np.random.default_rng(1)

    def draw(s):
        return g.uniform(-0.5, 0.5, s.shape).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(draw, shapes["params"])
    empty = shapes["state"]  # a subtree a layer, no leaves
    tm = models.MLP(6, (5,), 3, device="cpu")
    tm.load_state_dict(interop.params_from_jax(p, tm))
    batch = (g.standard_normal((8, 6), np.float32),
             g.integers(0, 3, 8).astype(np.int32))

    def jfn(params, model_state, batch, rng, train):
        x, y = batch
        logits, _ = jm.apply({"params": params, "state": model_state}, x)
        return jnp.mean(jops.softmax_cross_entropy_sparse(logits, y)), (
            {}, model_state)
    jex = JExecutor(jfn, joptim.SGDOptimizer(0.1), seed=0)
    tex = Executor(classifier_loss_fn(tm), optim.SGDOptimizer(0.1), seed=0)
    jex.set_grad_scale(scale)
    tex.set_grad_scale(scale)
    assert tex.grad_scale == jex.grad_scale == scale
    jstate = jex.init_state({"params": p, "state": empty})
    tstate = tex.init_state(tm)
    before = {k: v.detach().clone() for k, v in tstate.params.items()}
    jstate, jmet = jex.run("train", jstate, batch)
    tstate, tmet = tex.run("train", tstate, batch)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               RTOL)
    got = interop.params_to_jax(tstate.params, tm)
    for path, r in jax.tree_util.tree_flatten_with_path(jstate.params)[0]:
        a = dict(jax.tree_util.tree_flatten_with_path(got)[0])[path]
        np.testing.assert_allclose(a, r, RTOL, ATOL)
    moved = max(float((tstate.params[k] - before[k]).abs().max())
                for k in before)
    assert moved > 0


def test_gpt2_small_config_is_the_references():
    """``gpt2_small``'s defaults are the reference's; an override passes
    through (one layer and a small vocabulary keep the CPU model
    small)."""
    kw = dict(num_layers=1, vocab_size=64, max_position=32)
    ref = jmodels.gpt2_small(**kw).c
    got = models.gpt2_small(device="cpu", **kw)
    assert isinstance(got, models.GPTModel)
    for f in dataclasses.fields(ref):
        if f.name != "dtype":
            assert getattr(got.c, f.name) == getattr(ref, f.name), f.name
    assert got.c.dtype == torch.float32 and ref.dtype == jnp.float32
    assert models.gpt2_small.__defaults__ is None  # keywords only
    assert sum(p.numel() for p in got.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(jax.eval_shape(
            jmodels.gpt2_small(**kw).init, jax.random.PRNGKey(0))[
                "params"]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_dtype_is_the_references(dtype):
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype]
    ref = jlayers.LayerNorm(8, dtype=jdt).init(jax.random.PRNGKey(0))[
        "params"]
    ln = layers.LayerNorm(8, dtype=dtype)
    assert ln.scale.dtype == ln.bias.dtype == dtype
    assert str(ref["scale"].dtype) == str(dtype).split(".")[1]
    g = np.random.default_rng(2)
    scale = (1 + 0.1 * g.standard_normal(8)).astype(np.float32)
    bias = (0.1 * g.standard_normal(8)).astype(np.float32)
    x = g.standard_normal((3, 8)).astype(np.float32)
    with torch.no_grad():
        ln.scale.copy_(_t(scale))
        ln.bias.copy_(_t(bias))
    want = jops.layer_norm(jnp.asarray(x, jdt), jnp.asarray(scale, jdt),
                           jnp.asarray(bias, jdt))
    got = ln(_t(x).to(dtype))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want, np.float32))
    assert layers.LayerNorm(8).scale.dtype == torch.float32
