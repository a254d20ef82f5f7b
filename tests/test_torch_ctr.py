"""The CTR training slice of hetu_tpu_torch against hetu_tpu, on the CPU.

Every input is drawn with numpy from a seed and fed to both packages;
parameters go from the reference's tree to the port's ``state_dict``
through ``interop.params_from_jax``.  The reference runs as its own tests
run it: ``Embedding(impl="auto")`` through ``routed_gather`` on the CPU,
and the Pallas gather itself in interpret mode.  The port's wrappers take
their kernels' plain versions for CPU tensors.

Tolerances:

* copies (the gather, ``to_dense`` without duplicates, set, the bucketing
  utilities): bitwise;
* segment sums (the table's gradient, ``deduplicate``): bitwise where a
  row has at most two sources (a + b is the same in either order).  With
  more, both packages here sum each row's sources in the same order in f32
  (the reference's ``segment_sum`` after its stable sort, and its
  scatter-add, in the ids' order; the port's plain scatter-add in the order
  the ids come in, which for ``deduplicate`` is the sorted order), so
  these are held bitwise too, and also within the bound of a sequential
  f32 sum, n · 2^-24 of the sum of magnitudes, of an f64 oracle;
* a loss: 1e-6 relative;
* parameters, optimizer slots and rows after steps: 1e-5 relative plus
  1e-7 (XLA and PyTorch sum f32 products in different orders).

``tests/test_ctr.py::test_bucketed_epoch_compiles_bounded_programs`` has
no counterpart: it counts jit programs, and the port has no jit.  The
kernels run only on the card: the tests marked ``cuda`` hold them against
their plain versions at the CTR step's shapes and skip here.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu import layers as jlayers
from hetu_tpu import ops as jops
from hetu_tpu import optim as joptim
from hetu_tpu.data import bucketing as jbucketing
from hetu_tpu.models import ctr_zoo as jzoo
from hetu_tpu.models import wdl as jwdl
from hetu_tpu.ops.pallas_kernels import embedding as jemb
from hetu_tpu.utils import metrics as jmetrics
from hetu_tpu_torch import interop, layers, ops, optim
from hetu_tpu_torch.data import bucketing
from hetu_tpu_torch.models import (
    DCN, DeepCrossing, DeepFM, WideDeep, WideDeepDevice,
)
from hetu_tpu_torch.ops.embedding import IndexedSlices
from hetu_tpu_torch.utils import metrics

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-7
OPTIMIZERS = {
    "sgd": (lambda m, l2: m.SGDOptimizer(0.1, l2reg=l2)),
    "momentum": (lambda m, l2: m.MomentumOptimizer(0.1, 0.9, l2reg=l2)),
    "adagrad": (lambda m, l2: m.AdaGradOptimizer(
        0.1, initial_accumulator_value=0.1, l2reg=l2)),
    "adam": (lambda m, l2: m.AdamOptimizer(0.01, l2reg=l2)),
}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _bits(x):
    return np.asarray(_np(x), np.float32).view(np.int32)


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(ref), rtol=rtol, atol=atol)


def _sum_bound(ids, grads, num_rows):
    """Per row: n · 2^-24 · sum |g| over its n sources (the bound of a
    sequential f32 sum), and the f64 sum itself."""
    ids = np.asarray(ids).reshape(-1)
    valid = (ids >= 0) & (ids < num_rows)
    g = np.asarray(grads, np.float64).reshape(ids.shape[0], -1)
    exact = np.zeros((num_rows, g.shape[1]))
    mag = np.zeros_like(exact)
    np.add.at(exact, ids[valid], g[valid])
    np.add.at(mag, ids[valid], np.abs(g[valid]))
    n = np.bincount(ids[valid], minlength=num_rows)[:, None]
    return n * 2.0 ** -24 * mag, exact


def _port_of(model, jax_params):
    """``model`` (the port's, on the CPU) with the reference's parameters."""
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    model.load_state_dict(interop.params_from_jax(tree, model))
    return model


def _assert_params(model, jax_params, rtol=RTOL, atol=ATOL):
    """Every parameter of ``model`` against the reference's tree."""
    got = interop.params_to_jax(model.state_dict(), model)
    flat_ref = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_got) == len(flat_ref)
    for path, ref in flat_ref:
        np.testing.assert_allclose(flat_got[path], np.asarray(ref),
                                   rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def _ctr_batch(g, b, fields, dense, vocab, *, low=0):
    dx = g.standard_normal((b, dense)).astype(np.float32)
    ids = g.integers(low, vocab, (b, fields)).astype(np.int32)
    y = g.integers(0, 2, b).astype(np.float32)
    return dx, ids, y


# ---------------------------------------------------------------- ops

def test_losses_and_relu_match_the_reference():
    g = np.random.default_rng(0)
    x = np.concatenate([g.standard_normal(64) * 8,
                        [0.0, -0.0, 40.0, -40.0]]).astype(np.float32)
    y = g.integers(0, 2, x.shape[0]).astype(np.float32)
    p = 1 / (1 + np.exp(-x))
    _close(ops.binary_cross_entropy_with_logits(torch.tensor(x),
                                                torch.tensor(y)),
           jops.binary_cross_entropy_with_logits(x, y), 1e-6, 0)
    _close(ops.binary_cross_entropy(torch.tensor(p), torch.tensor(y)),
           jops.binary_cross_entropy(p, y), 1e-6, 1e-7)
    # relu and the BCE split the derivative at 0 as jnp.maximum does
    xt = torch.tensor(x, requires_grad=True)
    ops.relu(xt).sum().backward()
    np.testing.assert_array_equal(
        xt.grad.numpy(), np.asarray(jax.grad(
            lambda v: jops.relu(v).sum())(jnp.asarray(x))))
    xt.grad = None
    ops.binary_cross_entropy_with_logits(xt, torch.tensor(y)).sum().backward()
    _close(xt.grad, jax.grad(lambda v: jops.binary_cross_entropy_with_logits(
        v, y).sum())(jnp.asarray(x)), 1e-6, 1e-7)


def test_sequential_keeps_the_reference_child_names():
    gen = torch.Generator().manual_seed(0)
    seq = layers.Sequential(layers.Linear(3, 4, generator=gen),
                            layers.Relu(), layers.Linear(4, 2, generator=gen))
    assert list(seq.state_dict()) == ["0.weight", "0.bias", "2.weight",
                                      "2.bias"]
    jseq = jlayers.Sequential(jlayers.Linear(3, 4), jlayers.Relu(),
                              jlayers.Linear(4, 2))
    v = jseq.init(jax.random.PRNGKey(0))
    assert sorted(v["params"]) == ["0", "1", "2"]
    for i in ("0", "2"):
        lin = getattr(seq, i)
        lin.weight.data = torch.tensor(np.asarray(
            v["params"][i]["weight"]).T.copy())
        lin.bias.data = torch.tensor(np.asarray(v["params"][i]["bias"]))
    x = np.random.default_rng(1).standard_normal((5, 3)).astype(np.float32)
    _close(seq(torch.tensor(x)), jseq.apply(v, x)[0])


# ---------------------------------------------------------- the embedding

@pytest.mark.parametrize("impl", ["auto", "pallas", "xla"])
def test_embedding_rows_are_bitwise_the_reference(impl):
    """Ids in range, -1 and >= V: the gathered rows bitwise the reference's
    Embedding and the Pallas gather in interpret mode."""
    g = np.random.default_rng(2)
    vocab, d = 300, 16
    ids = g.integers(-1, vocab + 5, (40, 7)).astype(np.int32)
    jemb_layer = jlayers.Embedding(vocab, d, impl=impl)
    v = jemb_layer.init(jax.random.PRNGKey(3))
    table = np.asarray(v["params"]["weight"])
    emb = layers.Embedding(vocab, d, impl=impl,
                           generator=torch.Generator().manual_seed(0))
    assert emb.weight.dtype == torch.float32
    emb.weight.data = torch.tensor(table)
    rows = emb(torch.tensor(ids))
    assert rows.shape == (40, 7, d)
    ref = jemb_layer.apply(v, jnp.asarray(ids))[0]
    np.testing.assert_array_equal(_bits(rows), _bits(ref))
    pallas = jemb.embedding_gather(jnp.asarray(table),
                                   jnp.asarray(ids.reshape(-1)),
                                   interpret=True)
    np.testing.assert_array_equal(_bits(rows.reshape(-1, d)), _bits(pallas))


def test_embedding_defaults_are_the_reference():
    emb = layers.Embedding(2000, 8, generator=torch.Generator().manual_seed(0))
    assert emb.impl == "xla" and emb.weight.dtype == torch.float32
    assert abs(float(emb.weight.detach().std()) - 0.01) < 5e-4  # normal(0.01)
    with pytest.raises(ValueError, match="'auto', 'xla' or 'pallas'"):
        layers.Embedding(4, 2, impl="cuda", generator=torch.Generator())


@pytest.mark.parametrize("dups", ["pairs", "many"])
def test_embedding_table_gradient_matches_routed_gather_vjp(dups):
    """The scatter-add gradient of ``Embedding(impl="auto")`` against the
    reference's ``routed_gather`` VJP: bitwise with at most two sources a
    row; with up to ~40 (ids in [0, 30) over 600 slots) bitwise as well, and
    within the sequential-sum bound of the f64 sum."""
    g = np.random.default_rng(4)
    vocab, d = 200, 8
    if dups == "pairs":
        ids = np.concatenate([g.permutation(vocab), g.permutation(vocab)])
        ids = np.concatenate([ids[:300], [-1, vocab + 3]]).astype(np.int32)
    else:
        ids = g.integers(-2, 30, 600).astype(np.int32)
    table = g.standard_normal((vocab, d)).astype(np.float32)
    cot = g.standard_normal((ids.shape[0], d)).astype(np.float32)
    emb = layers.Embedding(vocab, d, impl="auto",
                           generator=torch.Generator().manual_seed(0))
    emb.weight.data = torch.tensor(table)
    (emb(torch.tensor(ids)) * torch.tensor(cot)).sum().backward()
    _, vjp = jax.vjp(lambda t: jemb.routed_gather(t, jnp.asarray(ids)),
                     jnp.asarray(table))
    (ref,) = vjp(jnp.asarray(cot))
    np.testing.assert_array_equal(_bits(emb.weight.grad), _bits(ref))
    bound, exact = _sum_bound(ids, cot, vocab)
    assert (np.abs(emb.weight.grad.numpy() - exact) <= bound).all()


# ------------------------------------------------------------ IndexedSlices

def _slices(g, n, d, vocab, *, low=-1):
    ids = g.integers(low, vocab, n).astype(np.int32)
    vals = g.standard_normal((n, d)).astype(np.float32)
    return ids, vals


def _both(ids, vals, shape):
    return (IndexedSlices(torch.tensor(ids), torch.tensor(vals), shape),
            jops.IndexedSlices(jnp.asarray(ids), jnp.asarray(vals), shape))


@pytest.mark.parametrize("vocab", [6, 40, 5000])
def test_deduplicate_matches_the_reference(vocab):
    """Many duplicates (vocab 6 over 300 ids: ~50 a row) and -1 ids:
    indices equal (the unique ids ascending, the empty slots -2^31), sums
    bitwise (both sum each segment in its stable-sorted order) and within
    the sequential-sum bound."""
    g = np.random.default_rng(5)
    ids, vals = _slices(g, 300, 12, vocab)
    mine, ref = _both(ids, vals, (vocab, 12))
    got, want = mine.deduplicate(), ref.deduplicate()
    assert got.indices.dtype == torch.int32
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(_bits(got.values), _bits(want.values))
    uniq = np.unique(ids)
    assert (got.indices.numpy()[:uniq.size] == uniq).all()
    bound, exact = _sum_bound(ids - ids.min(), vals, vocab + 1)
    sums = got.values.numpy()[:uniq.size]
    assert (np.abs(sums - exact[uniq - ids.min()])
            <= bound[uniq - ids.min()]).all()
    assert got.dense_shape == (vocab, 12)


def test_to_dense_sum_and_assign_match_the_reference():
    g = np.random.default_rng(6)
    vocab, d = 50, 4
    a_ids, a_vals = _slices(g, 80, d, vocab)
    b_ids, b_vals = _slices(g, 30, d, vocab)
    a, ja = _both(a_ids, a_vals, (vocab, d))
    b, jb = _both(b_ids, b_vals, (vocab, d))
    total = ops.sum_sparse_gradient(a, b)
    jtotal = jops.sum_sparse_gradient(ja, jb)
    np.testing.assert_array_equal(total.indices.numpy(),
                                  np.asarray(jtotal.indices))
    np.testing.assert_array_equal(total.values.numpy(),
                                  np.asarray(jtotal.values))
    dense = total.to_dense()
    np.testing.assert_array_equal(_bits(dense), _bits(jtotal.to_dense()))
    # take_grad_indexed and the lookup on the PS path
    table = g.standard_normal((vocab, d)).astype(np.float32)
    idx2 = g.integers(0, vocab, (6, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        ops.sparse_embedding_lookup(torch.tensor(table),
                                    torch.tensor(idx2)).numpy(),
        np.asarray(jops.sparse_embedding_lookup(table, idx2)))
    cot = g.standard_normal((6, 3, d)).astype(np.float32)
    tg = ops.take_grad_indexed(torch.tensor(idx2), torch.tensor(cot), vocab)
    jtg = jops.take_grad_indexed(jnp.asarray(idx2), jnp.asarray(cot), vocab)
    np.testing.assert_array_equal(tg.indices.numpy(), np.asarray(jtg.indices))
    np.testing.assert_array_equal(tg.values.numpy(), np.asarray(jtg.values))
    assert tg.dense_shape == jtg.dense_shape == (vocab, d)
    # set (unique valid ids, some -1 and >= V) and add, in place
    set_ids = np.concatenate([g.permutation(vocab)[:20], [-1, -1, vocab + 2]])
    set_ids = set_ids.astype(np.int32)
    set_vals = g.standard_normal((set_ids.size, d)).astype(np.float32)
    s, js = _both(set_ids, set_vals, (vocab, d))
    for add in (False, True):
        t = torch.tensor(table)
        out = ops.assign_with_indexed_slices(t, s, add=add)
        assert out is t
        np.testing.assert_array_equal(_bits(out), _bits(
            jops.assign_with_indexed_slices(jnp.asarray(table), js,
                                            add=add)))


# -------------------------------------------------------------- optimizers

def _table_and_slots(g, opt, vocab, d):
    table = g.standard_normal((vocab, d)).astype(np.float32)
    jstate = opt.init_state({"t": jnp.asarray(table)})
    # slots with history, so the update reads them
    slots = tuple(np.abs(g.standard_normal((vocab, d))).astype(np.float32)
                  * 0.1 for _ in opt.slot_names)
    return table, slots


@pytest.mark.parametrize("l2reg", [0.0, 0.01])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_apply_indexed_matches_the_reference(name, l2reg):
    """Duplicates and -1 ids; the rows updated in place, the untouched rows
    and slots bitwise unchanged."""
    g = np.random.default_rng(7)
    vocab, d = 64, 6
    jopt, opt = (OPTIMIZERS[name](m, l2reg) for m in (joptim, optim))
    table, slots = _table_and_slots(g, jopt, vocab, d)
    ids, vals = _slices(g, 90, d, 40)  # rows 40.. untouched
    mine, ref = _both(ids, vals, (vocab, d))
    p = torch.tensor(table)
    s = tuple(torch.tensor(x) for x in slots)
    step = 3
    opt.apply_indexed(p, mine, s, 0.1 if name != "adam" else 0.01, step)
    jp, js = jopt.apply_indexed(jnp.asarray(table), ref,
                                tuple(jnp.asarray(x) for x in slots),
                                0.1 if name != "adam" else 0.01,
                                jnp.int32(step))
    _close(p, jp)
    for a, b in zip(s, js):
        _close(a, b)
    np.testing.assert_array_equal(_bits(p[40:]), _bits(table[40:]))
    for a, b in zip(s, slots):
        np.testing.assert_array_equal(_bits(a[40:]), _bits(b[40:]))


def test_invalid_slots_leave_every_bit_of_row_zero():
    """Slots of index -1 (and >= V) read row 0 but add -0.0 to it, so even
    a -0.0 there keeps its sign; the reference adds +0.0."""
    table = torch.zeros(5, 3)
    table[0] = torch.tensor([-0.0, 1.5, -2.0])
    before = table.clone()
    slices = IndexedSlices(torch.tensor([-1, -1, 7], dtype=torch.int32),
                           torch.ones(3, 3), (5, 3))
    for opt in (optim.SGDOptimizer(0.1), optim.AdamOptimizer(0.01)):
        slots = tuple(torch.zeros(5, 3) for _ in opt.slot_names)
        opt.apply_indexed(table, slices, slots, 0.1, 1)
        np.testing.assert_array_equal(_bits(table), _bits(before))
        for s in slots:
            np.testing.assert_array_equal(_bits(s), _bits(torch.zeros(5, 3)))


def test_update_takes_dense_and_indexed_gradients_together():
    """``update`` with an IndexedSlices leaf and a dense leaf: the table
    through apply_indexed (no l2reg added twice), the dense leaf as
    before; the step counter advances once."""
    g = np.random.default_rng(8)
    jopt, opt = joptim.AdamOptimizer(0.01, l2reg=0.01), \
        optim.AdamOptimizer(0.01, l2reg=0.01)
    table = g.standard_normal((30, 4)).astype(np.float32)
    w = g.standard_normal((4, 3)).astype(np.float32)
    gw = g.standard_normal((4, 3)).astype(np.float32)
    ids, vals = _slices(g, 50, 4, 30)
    mine, ref = _both(ids, vals, (30, 4))
    params = {"emb": torch.tensor(table), "w": torch.tensor(w)}
    state = opt.init_state(params)
    _, state = opt.update({"emb": mine, "w": torch.tensor(gw)}, state, params)
    jparams = {"emb": jnp.asarray(table), "w": jnp.asarray(w)}
    jp, jstate = jopt.update({"emb": ref, "w": jnp.asarray(gw)},
                             jopt.init_state(jparams), jparams)
    assert state["step"] == int(jstate["step"]) == 1
    for k in params:
        _close(params[k], jp[k])
        for n in opt.slot_names:
            _close(state["slots"][n][k], jstate["slots"][n][k])


# -------------------------------------------------------------- the models

V, F, D, DENSE, HIDDEN = 1000, 5, 4, 8, (32, 16)


def _device_models(seed=0, emb_impl="auto"):
    jm = jwdl.WideDeepDevice(V, F, D, DENSE, hidden=HIDDEN,
                             emb_impl=emb_impl)
    v = jm.init(jax.random.PRNGKey(seed))
    pm = _port_of(WideDeepDevice(V, F, D, DENSE, hidden=HIDDEN,
                                 emb_impl=emb_impl, device="cpu"),
                  v["params"])
    return jm, v, pm


def test_widedeep_device_names_and_interop_round_trip():
    jm, v, pm = _device_models()
    assert set(pm.state_dict()) == {
        "emb.weight", "net.wide.weight", "net.wide.bias",
        *(f"net.deep.{i}.{n}" for i in (0, 2, 4) for n in ("weight",
                                                            "bias"))}
    assert tuple(pm.state_dict()["net.deep.0.weight"].shape) == (
        HIDDEN[0], F * D + DENSE)
    back = interop.params_to_jax(pm.state_dict(), pm)
    assert back["net"]["deep"]["1"] == {}  # the Relu's empty subtree
    _assert_params(pm, v["params"], rtol=0, atol=0)
    g = np.random.default_rng(9)
    dx, ids, _ = _ctr_batch(g, 16, F, DENSE, V)
    _close(pm(torch.tensor(dx), torch.tensor(ids)),
           jm.apply({"params": back, "state": v["state"]}, dx, ids)[0])


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_sparse_step_matches_the_reference(opt_name):
    """One step of WideDeepDevice.sparse_step_fn on a batch whose ids repeat
    (vocab 50 of 1000): the loss, the logits and every parameter."""
    jm, v, pm = _device_models()
    g = np.random.default_rng(10)
    dx, ids, y = _ctr_batch(g, 64, F, DENSE, 50)
    jopt, opt = (OPTIMIZERS[opt_name](m, 0.0) for m in (joptim, optim))
    p1, _, _, loss1, logit1 = jm.sparse_step_fn(jopt, jit=False)(
        v["params"], jopt.init_state(v["params"]), v["state"], dx, ids, y)
    step = pm.sparse_step_fn(opt)
    loss, logit = step(torch.tensor(dx), torch.tensor(ids), torch.tensor(y))
    _close(loss, loss1, 1e-6, 0)
    _close(logit, logit1)
    _assert_params(pm, p1)
    assert step.opt_state["step"] == 1


def test_masked_step_matches_the_reference():
    """One masked step on a batch of 37 padded into a bucket of 64."""
    jm, v, pm = _device_models()
    g = np.random.default_rng(11)
    dx, ids, y = _ctr_batch(g, 37, F, DENSE, 60)
    (pdx, pids, py), n_valid = bucketing.pad_batch(
        [dx, ids, y], bucketing.pow2_bucket(37, 128))
    jopt, opt = joptim.AdamOptimizer(0.01), optim.AdamOptimizer(0.01)
    p1, _, _, loss1, logit1 = jm.masked_step_fn(jopt, jit=False)(
        v["params"], jopt.init_state(v["params"]), v["state"], pdx, pids, py,
        n_valid)
    loss, logit = pm.masked_step_fn(opt)(pdx, pids, py, n_valid)
    _close(loss, loss1, 1e-6, 0)
    _close(logit, logit1)
    _assert_params(pm, p1)


def test_masked_step_equals_the_exact_step():
    """The port's own version of tests/test_ctr.py's test: a batch of 37
    padded to 64 steps as the unpadded batch does (the reference's
    tolerance, 1e-6 relative plus 1e-7), and the padding's -1 ids touch no
    row of the table."""
    g = np.random.default_rng(1)
    dx, ids, y = _ctr_batch(g, 37, 5, 8, 1000)
    gen = torch.Generator().manual_seed(0)
    exact_model = WideDeepDevice(1000, 5, 4, 8, emb_impl="auto",
                                 generator=gen, device="cpu")
    masked_model = WideDeepDevice(1000, 5, 4, 8, emb_impl="auto",
                                  generator=torch.Generator(), device="cpu")
    masked_model.load_state_dict(exact_model.state_dict())
    before = exact_model.emb.weight.detach().clone()
    loss1, _ = exact_model.sparse_step_fn(optim.SGDOptimizer(0.1))(dx, ids, y)
    bucket = bucketing.pow2_bucket(37, 128)
    assert bucket == 64
    (pdx, pids, py), n_valid = bucketing.pad_batch([dx, ids, y], bucket)
    assert n_valid == 37 and (pids[37:] == -1).all()
    loss2, _ = masked_model.masked_step_fn(optim.SGDOptimizer(0.1))(
        pdx, pids, py, n_valid)
    _close(loss2, loss1, 1e-6, 0)
    for (name, a), b in zip(exact_model.state_dict().items(),
                            masked_model.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    touched = np.unique(ids)
    rest = np.setdiff1d(np.arange(1000), touched)
    np.testing.assert_array_equal(
        _bits(masked_model.emb.weight[rest]), _bits(before[rest]))


def test_bucketed_epoch_trains_through_the_masked_step():
    """BucketedLoader over a stream of varying batch sizes drives the
    masked step: finite losses, the ids of each bucket's padding -1."""
    g = np.random.default_rng(0)
    model = WideDeepDevice(1000, 5, 4, 8, emb_impl="auto", device="cpu")
    step = model.masked_step_fn(optim.SGDOptimizer(0.1))
    sizes = [100, 64, 37, 128, 5, 99]
    loader = bucketing.BucketedLoader(
        (_ctr_batch(g, n, 5, 8, 1000) for n in sizes), max_batch=128)
    shapes = set()
    for (dx, ids, y, n_valid), n in zip(loader, sizes):
        assert n_valid == n and (ids[n:] == -1).all()
        shapes.add(dx.shape[0])
        loss, _ = step(dx, ids, y, n_valid)
        assert np.isfinite(float(loss))
    assert shapes == {128, 64, 8}
    assert step.opt_state["step"] == len(sizes)


def _zoo(kind, fields, d, dense):
    """(reference model, port model class and args) for a CTR zoo model."""
    if kind == "wdl":
        return jwdl.WideDeep(fields, d, dense, hidden=(16, 8)), \
            WideDeep(fields, d, dense, hidden=(16, 8), device="cpu")
    if kind == "deepfm":
        return jzoo.DeepFM(fields, d, dense, hidden=(16,)), \
            DeepFM(fields, d, dense, hidden=(16,), device="cpu")
    if kind == "dc":
        return jzoo.DeepCrossing(fields, d, dense, hidden=12, n_units=2), \
            DeepCrossing(fields, d, dense, hidden=12, n_units=2,
                         device="cpu")
    return jzoo.DCN(fields, d, dense, hidden=(16, 8), n_cross=2), \
        DCN(fields, d, dense, hidden=(16, 8), n_cross=2, device="cpu")


@pytest.mark.parametrize("kind", ["wdl", "deepfm", "dc", "dcn"])
def test_ctr_zoo_apply_and_hybrid_step_match_the_reference(kind):
    """Each model's forward, then two hybrid steps with Adam: loss, logits,
    the rows' gradients and every parameter."""
    fields, d, dense, b = 4, 6, 3, 32
    jm, pm = _zoo(kind, fields, d, dense)
    v = jm.init(jax.random.PRNGKey(1))
    _port_of(pm, v["params"])
    g = np.random.default_rng(12)
    dx = g.standard_normal((b, dense)).astype(np.float32)
    rows = [g.standard_normal((b, fields, d)).astype(np.float32)]
    if kind == "deepfm":
        rows.append(g.standard_normal((b, fields, 1)).astype(np.float32))
    y = g.integers(0, 2, b).astype(np.float32)
    _close(pm(torch.tensor(dx), *map(torch.tensor, rows)),
           jm.apply(v, dx, *rows)[0])
    jopt, opt = joptim.AdamOptimizer(5e-3), optim.AdamOptimizer(5e-3)
    jstep, step = jm.hybrid_step_fn(jopt), pm.hybrid_step_fn(opt)
    params, ostate, mstate = v["params"], jopt.init_state(v["params"]), \
        v["state"]
    for _ in range(2):
        params, ostate, mstate, jloss, jlogit, *jgrads = jstep(
            params, ostate, mstate, dx, *rows, y)
        loss, logit, *grads = step(dx, *map(torch.tensor, rows), y)
        _close(loss, jloss, 1e-6, 0)
        _close(logit, jlogit)
        assert len(grads) == len(jgrads) == len(rows)
        for a, b_ in zip(grads, jgrads):
            assert a.shape == b_.shape
            _close(a, b_)
    _assert_params(pm, params)


def test_deepfm_second_order_term_is_the_pairwise_sum():
    g = np.random.default_rng(0)
    rows = g.standard_normal((2, 5, 3)).astype(np.float32)
    m = DeepFM(5, 3, 2, hidden=(8,), device="cpu")
    with torch.no_grad():
        for p in m.parameters():
            p.zero_()
    logit = m(torch.zeros(2, 2), torch.tensor(rows), torch.zeros(2, 5, 1))
    naive = sum((rows[:, i] * rows[:, j]).sum(-1)
                for i in range(5) for j in range(i + 1, 5))
    np.testing.assert_allclose(_np(logit), naive, rtol=1e-5, atol=1e-6)


def test_crossnet_with_zero_weights_is_the_identity():
    from hetu_tpu_torch.models.ctr_zoo import CrossNet
    cn = CrossNet(4, 2, generator=torch.Generator().manual_seed(0))
    x0 = torch.tensor(np.random.default_rng(1).standard_normal(
        (3, 4)).astype(np.float32))
    assert cn(x0).shape == (3, 4)
    with torch.no_grad():
        cn.w.zero_()
        cn.b.zero_()
    np.testing.assert_array_equal(_np(cn(x0)), x0.numpy())


# ---------------------------------------------------- bucketing and metrics

def test_bucketing_matches_the_reference():
    for n, cap in ((1, 128), (65, 128), (128, 128), (65, 100), (37, 64)):
        assert bucketing.pow2_bucket(n, cap) == jbucketing.pow2_bucket(n, cap)
    for bad, msg in ((129, "exceeds"), (0, "positive")):
        with pytest.raises(ValueError, match=msg):
            bucketing.pow2_bucket(bad, 128)
    arrs = [np.zeros((3, 2), np.float32), np.ones((3,), np.int64)]
    (a, b), n = bucketing.pad_batch(arrs, 8)
    (ja, jb), jn = jbucketing.pad_batch(arrs, 8)
    assert n == jn == 3
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(b, jb)
    assert (b[3:] == -1).all() and (a[3:] == 0).all()
    for cap in (1024, 100):
        assert bucketing.BucketedLoader([], cap).max_distinct_shapes == \
            jbucketing.BucketedLoader([], cap).max_distinct_shapes
    g = np.random.default_rng(0)
    batches = [tuple(_ctr_batch(g, n, 2, 3, 10)) for n in (5, 16, 9)]
    for got, want in zip(bucketing.BucketedLoader(batches, 16),
                         jbucketing.BucketedLoader(batches, 16)):
        assert got[-1] == want[-1]
        for x, y in zip(got[:-1], want[:-1]):
            np.testing.assert_array_equal(x, y)


def test_metrics_match_the_reference():
    cases = [([0.9, 0.8, 0.2, 0.1], [1, 1, 0, 0]),
             ([0.1, 0.2, 0.8, 0.9], [1, 1, 0, 0]),
             ([0.5, 0.5, 0.5, 0.5], [1, 0, 1, 0]),
             ([0.9, 0.5, 0.5, 0.1], [1, 1, 0, 0]),
             ([0.3, 0.3], [1, 1])]
    for s, y in cases:
        assert metrics.auc(s, y) == jmetrics.auc(s, y)
    assert metrics.auc([0.9, 0.5, 0.5, 0.1], [1, 1, 0, 0]) == 0.875
    g = np.random.default_rng(0)
    s, y = g.random(500), g.integers(0, 2, 500)
    assert metrics.auc(s, y) == jmetrics.auc(s, y)
    assert metrics.accuracy(np.eye(3), [0, 1, 2]) == 1.0
    assert metrics.accuracy(s, y) == jmetrics.accuracy(s, y)
    pred = [0.9, 0.9, 0.1, 0.9]
    assert metrics.precision_recall_f1(pred, [1, 1, 0, 0]) == \
        jmetrics.precision_recall_f1(pred, [1, 1, 0, 0]) == \
        pytest.approx((2 / 3, 1.0, 0.8))
    cm = metrics.confusion_matrix(np.asarray([0, 1, 1]), np.asarray([0, 1, 0]),
                                  2)
    np.testing.assert_array_equal(cm, jmetrics.confusion_matrix(
        np.asarray([0, 1, 1]), np.asarray([0, 1, 0]), 2))
    assert cm[0, 0] == 1 and cm[0, 1] == 1 and cm[1, 1] == 1


# --------------------------------------------------------------- the slice

def test_ctr_slice_runs_without_jax():
    """In a fresh process: sparse and masked steps of WideDeepDevice and a
    hybrid step of WideDeep, with jax and hetu_tpu never imported."""
    code = (
        "import sys, numpy as np, torch\n"
        "import hetu_tpu_torch as htt\n"
        "g = np.random.default_rng(0)\n"
        "m = htt.models.WideDeepDevice(500, 3, 4, 5, hidden=(8,), "
        "device='cpu')\n"
        "ids = torch.tensor(g.integers(0, 500, (16, 3)), dtype=torch.int32)\n"
        "dx, y = torch.randn(16, 5), torch.ones(16)\n"
        "print(float(m.sparse_step_fn(htt.optim.SGDOptimizer(0.1))(dx, ids, "
        "y)[0]))\n"
        "print(float(m.masked_step_fn(htt.optim.AdamOptimizer())(dx, ids, y, "
        "9)[0]))\n"
        "w = htt.models.WideDeep(3, 4, 5, hidden=(8,), device='cpu')\n"
        "loss, logit, g_rows = w.hybrid_step_fn(htt.optim.AdamOptimizer())("
        "dx, torch.randn(16, 3, 4), y)\n"
        "assert g_rows.shape == (16, 3, 4)\n"
        "print(sorted(n for n in sys.modules "
        "if n.split('.')[0] in ('jax', 'jaxlib', 'hetu_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert all(np.isfinite(float(x)) for x in lines[:2])
    assert lines[-1] == "[]"


def test_int64_ids_past_int32_raise():
    table = torch.zeros(10, 4)
    from hetu_tpu_torch.ops.cuda_kernels import (
        embedding_gather, embedding_scatter_add,
    )
    big = torch.tensor([1, 2 ** 31 + 3], dtype=torch.int64)
    with pytest.raises(ValueError, match="int32"):
        embedding_gather(table, big)
    with pytest.raises(ValueError, match="int32"):
        embedding_scatter_add(torch.zeros(2, 4), big, 10)
    with pytest.raises(ValueError, match="int32"):
        IndexedSlices(big, torch.zeros(2, 4), (10, 4)).deduplicate()
    # in range, int64 ids work
    ok = torch.tensor([1, -1, 9], dtype=torch.int64)
    assert embedding_gather(table, ok).shape == (3, 4)


# -------------------------------------------------------- on the card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")


@pytest.mark.cuda
def test_ctr_kernels_equal_their_plain_versions_on_the_card(cuda):
    """At the CTR step's shapes: the gather of 53 248 ids from a [33 000 000,
    16] f32 table bitwise its plain version; deduplicate's segment sum (the
    scatter-add kernel, sorted route) bitwise the CPU's plain sum in the
    same order, on uniform and on Zipf-skewed ids."""
    from hetu_tpu_torch.ops.cuda_kernels import (
        embedding_gather, embedding_gather_plain,
    )
    gen = torch.Generator(device="cuda").manual_seed(0)
    vocab, n, d = 33_000_000, 2048 * 26, 16
    table = torch.empty(vocab, d, device="cuda").normal_(0, 0.01,
                                                         generator=gen)
    g = np.random.default_rng(0)
    uniform = g.integers(0, vocab, n)
    zipf = np.minimum(g.zipf(1.2, n), vocab) - 1
    for ids_np in (uniform, zipf):
        ids = torch.tensor(ids_np, dtype=torch.int32, device="cuda")
        assert torch.equal(embedding_gather(table, ids),
                           embedding_gather_plain(table, ids))
        vals = torch.randn(n, d, generator=gen, device="cuda")
        got = IndexedSlices(ids, vals, (vocab, d)).deduplicate()
        ref = IndexedSlices(ids.cpu(), vals.cpu(), (vocab, d)).deduplicate()
        assert torch.equal(got.indices.cpu(), ref.indices)
        assert torch.equal(got.values.cpu(), ref.values)


@pytest.mark.cuda
def test_widedeep_device_step_launches_each_kernel_once(cuda):
    from hetu_tpu_torch.ops.cuda_kernels import (
        embedding_gather, embedding_scatter_add,
    )
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = WideDeepDevice(100_000, 26, 16, 13, generator=gen)
    step = model.sparse_step_fn(optim.SGDOptimizer(0.01))
    g = np.random.default_rng(0)
    dx, ids, y = _ctr_batch(g, 256, 26, 13, 100_000)
    gathers, scatters = embedding_gather.launches, \
        embedding_scatter_add.launches
    loss, _ = step(dx, ids, y)
    torch.cuda.synchronize()
    assert np.isfinite(float(loss))
    assert embedding_gather.launches - gathers == 1
    assert embedding_scatter_add.launches - scatters == 1
