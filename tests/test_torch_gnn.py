"""GCN's ops and model in hetu_tpu_torch against hetu_tpu, on the CPU
(``tests/test_gnn.py``'s three tests, mirrored, with the reference as the
oracle): ``coo_spmm`` against a dense product and the reference,
``gcn_norm``'s edges and weights, the two-layer ``GCN``'s logits and
gradients, one ``Executor`` step, and the community-graph learning test.

Tolerances (f32): ``coo_spmm`` and the weights rtol 1e-5 (values and
gradients); logits 1e-5 · max|logit|; gradients 1e-2 · max|G| of each
leaf, since a ReLU input within rounding of 0 lands on either side in two
packages and keeps or drops that element's gradient; the loss 1e-5
relative.  Dropout draws other bits than ``jax.random``, so the parity
cases run at rate 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu import optim as joptim
from hetu_tpu.models.gcn import GCN as JGCN
from hetu_tpu.ops.graph_ops import coo_spmm as jcoo_spmm
from hetu_tpu.ops.graph_ops import gcn_norm as jgcn_norm
from hetu_tpu.train.executor import Executor as JExecutor
from hetu_tpu_torch import interop, models, ops, optim
from hetu_tpu_torch.ops import graph_ops
from hetu_tpu_torch.train import Executor

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
TOL_LOGITS, TOL_GRAD, TOL_LOSS = 1e-5, 1e-2, 1e-5


def _t(x):
    return torch.tensor(np.asarray(x))


def _within(got, ref, rel, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, ref = np.asarray(got, np.float32), np.asarray(ref)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


def test_coo_spmm_matches_dense_and_the_reference():
    g = np.random.default_rng(0)
    N, F, E = 10, 4, 30
    src, dst = g.integers(0, N, E), g.integers(0, N, E)
    w = g.standard_normal(E).astype(np.float32)
    h = g.standard_normal((N, F)).astype(np.float32)
    A = np.zeros((N, N), np.float32)
    np.add.at(A, (dst, src), w)
    th, tw = _t(h).requires_grad_(), _t(w).requires_grad_()
    out = ops.coo_spmm(_t(src), _t(dst), tw, th, N)
    np.testing.assert_allclose(out.detach().numpy(), A @ h, rtol=1e-4,
                               atol=1e-5)
    ref, vjp = jax.vjp(lambda ww, hh: jcoo_spmm(
        jnp.asarray(src), jnp.asarray(dst), ww, hh, N), jnp.asarray(w),
        jnp.asarray(h))
    np.testing.assert_allclose(out.detach().numpy(), ref, RTOL, ATOL)
    c = g.standard_normal((N, F)).astype(np.float32)
    gw, gh = torch.autograd.grad((out * _t(c)).sum(), (tw, th))
    rw, rh = vjp(jnp.asarray(c))
    np.testing.assert_allclose(gw.numpy(), rw, RTOL, ATOL)
    np.testing.assert_allclose(gh.numpy(), rh, RTOL, ATOL)
    # unweighted, and more nodes than rows of h (the empty ones stay 0)
    np.testing.assert_array_equal(
        ops.coo_spmm(_t(src), _t(dst), None, _t(h), N + 2).numpy(),
        np.asarray(jcoo_spmm(jnp.asarray(src), jnp.asarray(dst), None,
                             jnp.asarray(h), N + 2)))


def test_gcn_norm_symmetric_and_the_references():
    src, dst = np.array([0, 1, 1, 2]), np.array([1, 0, 2, 1])
    s, d, w = ops.gcn_norm(_t(src), _t(dst), 3)
    assert s.shape[0] == 4 + 3 and s.dtype == d.dtype == torch.int64
    A = np.zeros((3, 3), np.float32)
    np.add.at(A, (d.numpy(), s.numpy()), w.numpy())
    np.testing.assert_allclose(A, A.T, rtol=1e-5)
    assert A.sum(axis=1).max() <= 1.5
    g = np.random.default_rng(1)
    src, dst = g.integers(0, 50, 300), g.integers(0, 50, 300)
    for loops in (True, False):
        rs, rd, rw = jgcn_norm(jnp.asarray(src), jnp.asarray(dst), 60,
                               add_self_loops=loops)
        s, d, w = ops.gcn_norm(_t(src), _t(dst), 60, add_self_loops=loops)
        np.testing.assert_array_equal(s.numpy(), rs)
        np.testing.assert_array_equal(d.numpy(), rd)
        np.testing.assert_allclose(w.numpy(), rw, rtol=RTOL)
    deg = graph_ops.in_degree(_t(dst), 60)
    np.testing.assert_array_equal(deg.numpy(), np.bincount(dst, minlength=60))


@pytest.mark.parametrize("bad", ["src_high", "src_negative", "dst_high"])
def test_out_of_range_ids_raise(bad):
    """A departure: the reference clamps a source id and drops a
    destination id; the port raises for either."""
    src, dst = torch.tensor([0, 1, 2]), torch.tensor([1, 2, 0])
    if bad == "src_high":
        src[1] = 3
    elif bad == "src_negative":
        src[1] = -1
    else:
        dst[2] = 3
    h = torch.ones(3, 2)
    with pytest.raises(IndexError):
        ops.coo_spmm(src, dst, None, h, 3)
    with pytest.raises(IndexError):
        ops.gcn_norm(src, dst, 3)


def _community(g, n_per=20, comms=2, feat=8, intra=6, inter=6):
    """``tests/test_gnn.py``'s graph: dense communities, a few cross
    edges, both directions."""
    edges = []
    for c in range(comms):
        for _ in range(n_per * intra):
            a, b = g.integers(0, n_per, 2)
            edges.append((c * n_per + a, c * n_per + b))
    for _ in range(inter):
        edges.append((g.integers(0, n_per), n_per + g.integers(0, n_per)))
    src = np.array([e[0] for e in edges])
    dst = np.array([e[1] for e in edges])
    return np.concatenate([src, dst]), np.concatenate([dst, src])


def _models(f, hidden, classes, seed, dropout_rate=0.0):
    jm = JGCN(f, hidden, classes, dropout_rate=dropout_rate)
    g = np.random.default_rng(seed)

    def draw(s):
        lim = np.sqrt(6.0 / sum(s.shape))
        return g.uniform(-lim, lim, s.shape).astype(np.float32)
    p = jax.tree_util.tree_map(draw, jax.eval_shape(
        jm.init, jax.random.PRNGKey(0))["params"])
    tm = models.GCN(f, hidden, classes, dropout_rate=dropout_rate,
                    device="cpu")
    tm.load_state_dict(interop.params_from_jax(p, tm))
    return jm, p, tm


def test_gcn_layout_logits_gradients_and_one_executor_step():
    g = np.random.default_rng(2)
    src, dst = _community(g)
    N, F = 40, 8
    x = g.standard_normal((N, F)).astype(np.float32)
    labels = np.repeat([0, 1], 20).astype(np.int32)
    mask = (g.random(N) < 0.5).astype(np.float32)
    jm, p, tm = _models(F, 16, 2, 3)
    assert dict(tm.named_parameters()).keys() == {"w1", "w2"}
    assert tm.w1.shape == (F, 16) and tm.w2.shape == (16, 2)
    tree = interop.params_to_jax(tm.state_dict(), tm)
    assert tree.keys() == p.keys() and all(
        np.array_equal(tree[k], p[k]) for k in p)

    jes, jed, jew = jgcn_norm(jnp.asarray(src), jnp.asarray(dst), N)
    es, ed, ew = ops.gcn_norm(_t(src), _t(dst), N)
    logits = tm(_t(x), es, ed, ew)
    ref, _ = jm.apply({"params": p, "state": {}}, jnp.asarray(x), jes, jed,
                      jew)
    _within(logits, ref, TOL_LOGITS, "logits")

    batch = (x, labels, mask)
    jfn, tfn = jm.loss_fn(jes, jed, jew), tm.loss_fn(es, ed, ew)
    (jl, (jmet, _)), jg = jax.value_and_grad(jfn, has_aux=True)(
        p, {}, batch, None, False)
    params = dict(tm.named_parameters())
    tl, (tmet, _) = tfn(params, {}, tuple(map(_t, batch)), None, False)
    tg = dict(zip(params, torch.autograd.grad(tl, list(params.values()))))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=TOL_LOSS)
    assert float(tmet["acc"]) == float(jmet["acc"])
    for k in p:
        _within(tg[k], jg[k], TOL_GRAD, f"grad {k}")

    jex = JExecutor(jfn, joptim.AdamOptimizer(0.01), seed=0)
    jstate = jex.init_state({"params": p, "state": {}})
    tex = Executor(tfn, optim.AdamOptimizer(0.01), seed=0)
    tstate = tex.init_state(tm)
    jstate, jmet = jex.run("train", jstate, batch)
    tstate, tmet = tex.run("train", tstate, batch)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=TOL_LOSS)
    slots = interop.opt_state_to_jax(tstate.opt_state, tm)["slots"]
    for k in p:
        _within(slots["m"][k], jstate.opt_state["slots"]["m"][k], TOL_GRAD,
                f"m {k}")


def test_gcn_dropout_draws_from_the_generator():
    g = np.random.default_rng(4)
    src, dst = _community(g)
    x = _t(g.standard_normal((40, 8)).astype(np.float32))
    es, ed, ew = ops.gcn_norm(_t(src), _t(dst), 40)
    tm = models.GCN(8, 16, 2, device="cpu")
    assert tm.dropout_rate == 0.5
    a = tm(x, es, ed, ew, train=True,
           generator=torch.Generator().manual_seed(1))
    b = tm(x, es, ed, ew, train=True,
           generator=torch.Generator().manual_seed(1))
    c = tm(x, es, ed, ew, train=True,
           generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(tm(x, es, ed, ew), tm(x, es, ed, ew, train=False))


def test_gcn_learns_community_labels():
    """``tests/test_gnn.py``'s task through the port's Executor: 60 Adam
    steps on 20 % labelled nodes separate the two communities."""
    g = np.random.default_rng(1)
    src, dst = _community(g)
    N, F = 40, 8
    es, ed, ew = ops.gcn_norm(_t(src), _t(dst), N)
    x = g.standard_normal((N, F)).astype(np.float32)
    labels = np.repeat([0, 1], 20).astype(np.int32)
    mask = np.zeros(N, np.float32)
    mask[::5] = 1.0
    model = models.GCN(F, 16, 2, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    ex = Executor(model.loss_fn(es, ed, ew), optim.AdamOptimizer(0.01),
                  seed=0)
    state = ex.init_state(model)
    for _ in range(60):
        state, m = ex.run("train", state, (x, labels, mask))
    with torch.no_grad():
        logits = model(_t(x), es, ed, ew)
    acc = (logits.argmax(-1).numpy() == labels).mean()
    assert acc > 0.85, acc
