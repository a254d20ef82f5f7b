"""The recurrent layers of hetu_tpu_torch against hetu_tpu, on the CPU: the
three cells (one step and the scan over T, outputs and the final carry),
``RNN``'s learning test (``tests/test_rnn_htir.py::
test_rnn_shapes_and_learning``), and the row-sequence MNIST classifier of
``examples/rnn_mnist.py`` through one ``Executor`` step each.

Weights are drawn with numpy into the reference's tree (from
``jax.eval_shape`` of its ``init``) and loaded into the port through
``interop.params_from_jax``; inputs are numpy from a seed.  The reference's
classifier is built here from ``hetu_tpu.layers.RNN`` and ``Linear``, as
the example builds it (importing the example would reconfigure JAX's
devices for the whole process).

Tolerances (f32):

* outputs and carries: 1e-5 · max|y|;
* gradients, and the first moments after one Adam step (``m = 0.1 g``):
  1e-4 · max|G|; the second moments (``v = 1e-3 g²``) 2e-4 · max|v|;
* the loss 1e-5 relative; the interop round trip bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu import layers as jlayers
from hetu_tpu import ops as jops
from hetu_tpu import optim as joptim
from hetu_tpu.train.executor import Executor as JExecutor
from hetu_tpu_torch import interop, layers, models, optim
from hetu_tpu_torch.train import Executor

torch.set_num_threads(2)

CELLS = ("rnn", "lstm", "gru")
TOL_Y, TOL_G, TOL_V, TOL_LOSS = 1e-5, 1e-4, 2e-4, 1e-5
LR = 1e-3


def _t(x):
    return torch.tensor(np.asarray(x))


def _draw(shapes, seed):
    """Glorot-uniform matrices, small random biases (so the bias path is
    tested), drawn with numpy into the tree of ``shapes``."""
    g = np.random.default_rng(seed)

    def draw(path, s):
        if len(s.shape) == 2:
            lim = np.sqrt(6.0 / sum(s.shape))
            return g.uniform(-lim, lim, s.shape).astype(np.float32)
        return 0.1 * g.standard_normal(s.shape, np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _within(got, ref, rel, what):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got, ref = np.asarray(got, np.float32), np.asarray(ref)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


def _tree_within(got, ref, rel, what):
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(flat_got) == len(flat_ref), what
    for path, r in flat_ref:
        _within(flat_got[path], r, rel, what + jax.tree_util.keystr(path))


def _pair(cell, d=8, h=16, seed=0):
    """The reference's ``RNN`` and its drawn params, and the port's ``RNN``
    loaded with them."""
    jm = jlayers.RNN(d, h, cell_type=cell)
    p = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0))["params"],
              seed)
    tm = layers.RNN(d, h, cell_type=cell,
                    generator=torch.Generator().manual_seed(0))
    tm.load_state_dict(interop.params_from_jax(p, tm))
    return jm, p, tm


def _carries(carry):
    return carry if isinstance(carry, tuple) else (carry,)


@pytest.mark.parametrize("cell", CELLS)
def test_scan_outputs_and_final_carry(cell):
    jm, p, tm = _pair(cell)
    x = np.random.default_rng(1).standard_normal((4, 10, 8), np.float32)
    carry = jm.cell.initial_carry(4)
    for t in range(10):
        carry, _ = jm.cell.step(p, carry, jnp.asarray(x[:, t]))
    ys, _ = jm.apply({"params": p, "state": {}}, jnp.asarray(x))
    got_ys, got_carry = tm.scan(_t(x))
    assert got_ys.shape == (4, 10, 16)
    _within(got_ys, ys, TOL_Y, f"{cell} outputs")
    _within(tm(_t(x)), ys, TOL_Y, f"{cell} forward")
    for g, r in zip(_carries(got_carry), _carries(carry)):
        _within(g, r, TOL_Y, f"{cell} carry")


def _step_f64(cell, w, b, x, carry):
    """One step of the reference's equations in float64 numpy."""
    def sig(z):
        return 1 / (1 + np.exp(-z))
    h = carry[0]
    H = h.shape[1]
    z = np.concatenate([x, h], -1) @ w + b
    if cell == "rnn":
        return (np.tanh(z),)
    if cell == "lstm":
        i, f, g, o = np.split(z, 4, -1)
        c2 = sig(f + 1.0) * carry[1] + sig(i) * np.tanh(g)
        return sig(o) * np.tanh(c2), c2
    r, u = np.split(sig(z[:, :2 * H]), 2, -1)
    n = np.tanh(np.concatenate([x, r * h], -1) @ w[:, 2 * H:] + b[2 * H:])
    return ((1 - u) * n + u * h,)


@pytest.mark.parametrize("cell", CELLS)
def test_one_step_is_the_references_equations(cell):
    """The forget gate's +1 (gates i, f, g, o), the GRU's ``r * h`` inside
    the candidate's product, ``[x, h]`` in that order: one step from a
    non-zero carry against float64 numpy."""
    _, p, tm = _pair(cell, seed=2)
    g = np.random.default_rng(3)
    x = g.standard_normal((3, 8))
    carry = tuple(g.standard_normal((3, 16)) for _ in
                  range(2 if cell == "lstm" else 1))
    ref = _step_f64(cell, np.float64(p["w"]), np.float64(p["b"]), x, carry)
    tc = tuple(_t(c.astype(np.float32)) for c in carry)
    got, y = tm.cell.step(tc if cell == "lstm" else tc[0],
                          _t(x.astype(np.float32)))
    got = got if isinstance(got, tuple) else (got,)
    for a, r in zip(got, ref):
        _within(a, r, TOL_Y, f"{cell} step")
    assert torch.equal(y, got[0])


def test_cells_are_the_references_layout():
    for cell, k in (("rnn", 1), ("lstm", 4), ("gru", 3)):
        m = layers.RNN(5, 7, cell_type=cell,
                       generator=torch.Generator().manual_seed(0))
        assert m.cell.n_gates == k
        assert dict(m.named_parameters()).keys() == {"cell.w", "cell.b"}
        assert m.cell.w.shape == (12, 7 * k) and m.cell.b.shape == (7 * k,)
        assert not m.cell.b.any()
        lim = np.sqrt(6.0 / (12 + 7 * k))
        assert float(m.cell.w.detach().abs().max()) <= lim
        carry = m.cell.initial_carry(2)
        for c in (carry if cell == "lstm" else (carry,)):
            assert c.shape == (2, 7) and c.dtype == torch.float32
            assert not c.any()
    bf = layers.GRUCell(3, 4, generator=torch.Generator().manual_seed(0),
                        dtype=torch.bfloat16)
    assert bf.w.dtype == bf.b.dtype == bf.initial_carry(1).dtype \
        == torch.bfloat16
    with pytest.raises(ValueError):
        layers.RNN(3, 4, cell_type="elman",
                   generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("cell", CELLS)
def test_rnn_shapes_and_learning(cell):
    """The reference test's task on the port: the last output fits a
    sequence-sum target with Adam(1e-2) in 30 steps; the first loss and
    its gradients are the reference's."""
    jm, p, tm = _pair(cell, seed=4)
    g = np.random.default_rng(0)
    xs = g.standard_normal((32, 6, 8)).astype(np.float32)
    tgt = xs.sum(axis=(1, 2)).astype(np.float32)

    def jloss(params):
        out, _ = jm.apply({"params": params, "state": {}}, xs)
        return jnp.mean((out[:, -1].sum(-1) - tgt) ** 2)

    params = dict(tm.named_parameters())

    def tloss():
        return ((tm(_t(xs))[:, -1].sum(-1) - _t(tgt)) ** 2).mean()
    l0 = tloss()
    grads = torch.autograd.grad(l0, list(params.values()))
    np.testing.assert_allclose(float(l0), float(jloss(p)), rtol=TOL_LOSS)
    _tree_within(interop.params_to_jax(dict(zip(params, grads)), tm),
                 jax.grad(jloss)(p), TOL_G, f"{cell} grads")

    opt = optim.AdamOptimizer(1e-2)
    st = opt.init_state(params)
    for _ in range(30):
        loss = tloss()
        g_ = dict(zip(params, torch.autograd.grad(loss, list(
            params.values()))))
        with torch.no_grad():
            params, st = opt.update(g_, st, params)
    assert float(tloss()) < float(l0), cell


# ---- the row-sequence MNIST classifier (examples/rnn_mnist.py) ----

class _JClassifier(jlayers.Module):
    """``examples/rnn_mnist.py``'s ``RNNClassifier``, rebuilt here."""

    def __init__(self, cell, hidden, classes=10):
        self.rnn = jlayers.RNN(28, hidden, cell_type=cell)
        self.head = jlayers.Linear(hidden, classes)

    def init(self, key):
        k1, k2 = jax.random.split(key)
        return {"params": {"rnn": self.rnn.init(k1)["params"],
                           "head": self.head.init(k2)["params"]},
                "state": {}}

    def loss_fn(self):
        def fn(params, model_state, batch, rng, train):
            x, y = batch
            seq = x.reshape(x.shape[0], 28, 28)
            hs, _ = self.rnn.apply({"params": params["rnn"], "state": {}},
                                   seq)
            logits, _ = self.head.apply(
                {"params": params["head"], "state": {}}, hs[:, -1])
            loss = jops.softmax_cross_entropy_sparse(logits, y).mean()
            acc = jnp.mean((jnp.argmax(logits, -1) == y).astype(
                jnp.float32))
            return loss, ({"loss": loss, "acc": acc}, model_state)
        return fn


@pytest.mark.parametrize("cell", CELLS)
def test_classifier_through_one_executor_step(cell):
    jm = _JClassifier(cell, 16)
    v = jm.init(jax.random.PRNGKey(0))
    p = _draw(jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), v["params"]), 5)
    tm = models.RNNClassifier(cell, 16, generator=torch.Generator()
                              .manual_seed(0), device="cpu")
    tm.load_state_dict(interop.params_from_jax(p, tm))
    tree = interop.params_to_jax(tm.state_dict(), tm)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(p)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(p)))

    g = np.random.default_rng(6)
    batch = (g.random((8, 784), np.float32), g.integers(0, 10, 8)
             .astype(np.int32))
    jex = JExecutor(jm.loss_fn(), joptim.AdamOptimizer(LR), seed=0)
    jstate = jex.init_state({"params": p, "state": {}})
    tex = Executor(tm.loss_fn(), optim.AdamOptimizer(LR), seed=0)
    tstate = tex.init_state(tm)
    jval = jex.run("validate", jstate, batch)
    tval = tex.run("validate", tstate, batch)
    np.testing.assert_allclose(float(tval["loss"]), float(jval["loss"]),
                               rtol=TOL_LOSS)
    assert float(tval["acc"]) == float(jval["acc"])
    jstate, jmet = jex.run("train", jstate, batch)
    tstate, tmet = tex.run("train", tstate, batch)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=TOL_LOSS)
    slots = interop.opt_state_to_jax(tstate.opt_state, tm)["slots"]
    _tree_within(slots["m"], jstate.opt_state["slots"]["m"], TOL_G,
                 f"{cell} m")
    _tree_within(slots["v"], jstate.opt_state["slots"]["v"], TOL_V,
                 f"{cell} v")
    assert tstate.step == int(jstate.step) == 1
