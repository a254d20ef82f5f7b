"""The embedding-compression zoo of hetu_tpu_torch against hetu_tpu's
(``embedding_compress/``), on the CPU, at the reference tests' size (N
1000, D 16).

Each method's variables come from the reference's ``init`` (its flat
leaves, with the degenerate starting values redrawn from a numpy seed so
that every code, mask and gate takes both sides) and are carried into the
port's module by ``interop.variables_from_jax``; ids hold duplicates and
-1.  Held, per method of ``tests/test_embedding_compress.py``'s
ALL_METHODS:

* the rows within 1e-6 of max|y|, their zero pattern (the pruning and
  OptEmbed masks, PEP's ReLU) bitwise, DPQ's and MGQE's codes bitwise;
* each parameter's gradient of ``sum(rows * c)`` (``c`` a seeded
  cotangent) within 1e-5 of its max|G|.  ALPT's ``log_scale`` gradient is
  zero in exact arithmetic (its straight-through form ``(w / s) · s``
  cancels) and rounding noise in both packages: it is held within 1e-5 of
  ``sum |c · y|``, the size of the terms that cancel;
* the interop round trip bitwise.

Bitwise: ``_hash`` (ids 0, -1, 2^31 - 1, -2^31 and around the
Criteo-Kaggle vocabulary's top), the quantile helper against
``jnp.quantile``, the serving forms (DPQ and MGQE codes and lookups,
``QuantizedEmbedding.from_table``, the ELL form as each row's set of
(col, value) pairs and its lookups), the four converters, the scheduler's
hooks and ``ServingRowCodec``'s bytes.  The flows (AutoDim's bi-level
trainer, OptEmbed's supernet) run 3 steps from the same variables with an
Adam whose eps (1e-3) damps the steps of gradients that are rounding
noise: the parameters are held within 1e-5 of each leaf's max|p|, the
selected dim and the evolutionary winner equal.  An id past a table
raises ``IndexError`` where the reference returns NaN rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu import embedding_compress as jec
from hetu_tpu import optim as joptim
from hetu_tpu.embedding_compress import layers as jlayers
from hetu_tpu.embedding_compress.scheduler import (
    CompressionScheduler as JScheduler, Stage as JStage,
    prune_rate_setter as j_rate, switch_to_quantized as j_switch,
)
from hetu_tpu_torch import embedding_compress as ec
from hetu_tpu_torch import interop, optim
from hetu_tpu_torch.embedding_compress import layers
from hetu_tpu_torch.embedding_compress.scheduler import (
    CompressionScheduler, Stage, prune_rate_setter, switch_to_quantized,
)

torch.set_num_threads(2)

N, D = 1000, 16
IDS = np.array([[1, 5, 999], [0, 500, 7], [-1, 5, 5]])
TOL_Y, TOL_G, TOL_P = 1e-6, 1e-5, 1e-5

# (name, class, positional args, keywords): tests/test_embedding_compress.py's
# ALL_METHODS
ALL_METHODS = [
    ("hash", "HashEmbedding", (0.1,), {}),
    ("compo", "CompositionalEmbedding", (), {}),
    ("dpq", "DPQEmbedding", (), dict(n_codebooks=4, codes=16)),
    ("mgqe", "MGQEEmbedding", (), dict(n_codebooks=4, codes=16)),
    ("tt", "TensorTrainEmbedding", (), dict(ranks=4)),
    ("dhe", "DHEEmbedding", (), dict(k_hashes=8, hidden=32)),
    ("robe", "ROBEEmbedding", (0.1,), {}),
    ("alpt", "ALPTEmbedding", (), {}),
    ("prune", "PrunedEmbedding", (), dict(rate=0.5)),
    ("pep", "PEPEmbedding", (), {}),
    ("optembed", "OptEmbedEmbedding", (), {}),
    ("autosrh", "AutoSRHEmbedding", (), {}),
    ("mde", "MixedDimEmbedding", (), {}),
    ("autodim", "AutoDimEmbedding", (), {}),
    ("dedup", "DedupEmbedding", (0.2,), {}),
    ("adapt", "AdaptiveEmbedding", (), {}),
]
BY_NAME = {m[0]: m for m in ALL_METHODS}
# the methods whose table reads past their tables in the reference give
# NaN rows (pruning: all rows zero, the threshold being NaN); (method, an
# id past a table): compo's quotient table has 32 rows of 32 ids, so 1000
# still lands in it and 1024 does not
OUT_OF_RANGE = [(n, N) for n in ("dpq", "mgqe", "alpt", "prune", "pep",
                                 "optembed", "autosrh", "autodim", "dedup")]
OUT_OF_RANGE += [("compo", 1024)]


def _redraw(name, leaf, value, g):
    """A numpy redraw of a leaf whose reference init is degenerate
    (constant), so each discrete choice and gate takes both sides."""
    shape = value.shape
    if name == "alpt" and leaf == "log_scale":
        return (-5.0 + 0.3 * g.standard_normal(shape)).astype(np.float32)
    if name == "pep" and leaf == "g":  # sigmoid(g) in (0, 0.02)
        s = g.uniform(1e-4, 0.02, shape)
        return np.log(s / (1 - s)).astype(np.float32)
    if name == "optembed" and leaf == "t":  # softplus(t) near a row's norm
        s = g.uniform(0.01, 0.06, shape)
        return np.log(np.expm1(s)).astype(np.float32)
    if name in ("dpq", "mgqe") and leaf == "logits":
        return g.standard_normal(shape).astype(np.float32)
    if np.ptp(value) == 0:  # alpha, arch, the DHE biases
        return (0.5 * g.standard_normal(shape)).astype(np.float32)
    return value


def reference(name, seed=0):
    """The reference module and its variables (numpy leaves)."""
    _, cls, args, kw = BY_NAME[name]
    m = getattr(jec, cls)(N, D, *args, **kw)
    v = jax.tree_util.tree_map(np.asarray, m.init(jax.random.PRNGKey(seed)))
    g = np.random.default_rng(seed + 100)
    v["params"] = {k: _redraw(name, k, a, g) for k, a in v["params"].items()}
    return m, v


def port(name, variables):
    _, cls, args, kw = BY_NAME[name]
    m = getattr(ec, cls)(N, D, *args, **kw,
                         generator=torch.Generator().manual_seed(0))
    m.load_state_dict(interop.variables_from_jax(variables, m))
    return m


def _jv(v):
    return jax.tree_util.tree_map(jnp.asarray, v)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _bitwise(got, ref):
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, \
        (got.shape, ref.shape, got.dtype, ref.dtype)
    assert got.tobytes() == ref.tobytes()


def _within(got, ref, rel, what, scale=None):
    got, ref = _np(got).astype(np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max() if scale is None else scale
    gap = np.abs(got - ref).max()
    assert gap <= rel * scale, f"{what}: {gap:.3e} > {rel:g} * {scale:.3e}"


@pytest.mark.parametrize("name", [m[0] for m in ALL_METHODS])
def test_rows_and_gradients_match_the_reference(name):
    jm, v = reference(name)
    pm = port(name, v)
    cot = np.random.default_rng(7).standard_normal((*IDS.shape, D)).astype(
        np.float32)

    def jloss(params):
        rows, _ = jm.apply({"params": params, "state": _jv(v["state"])},
                           jnp.asarray(IDS), train=True)
        return jnp.sum(rows * cot), rows
    (_, ref_rows), ref_g = jax.value_and_grad(jloss, has_aux=True)(
        _jv(v["params"]))
    rows = pm(torch.tensor(IDS), train=True)
    params = dict(pm.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(
        (rows * torch.tensor(cot)).sum(), list(params.values()))))

    _within(rows, ref_rows, TOL_Y, f"{name} rows")
    np.testing.assert_array_equal(_np(rows) == 0, np.asarray(ref_rows) == 0)
    assert grads.keys() == ref_g.keys()
    for leaf, g in grads.items():
        scale = None
        if name == "alpt" and leaf == "log_scale":  # see the module doc
            scale = float(np.abs(cot * np.asarray(ref_rows)).sum())
        _within(g, ref_g[leaf], TOL_G, f"{name} d{leaf}", scale)
    back = interop.variables_to_jax(pm)
    for part in ("params", "state"):
        assert back[part].keys() == v[part].keys()
        for k, a in v[part].items():
            _bitwise(back[part][k], a)


@pytest.mark.parametrize("name", ["dpq", "mgqe"])
def test_codes_and_serving_form_match_the_reference(name):
    jm, v = reference(name)
    pm = port(name, v)
    ids = IDS.reshape(-1)
    idx = np.where(ids < 0, ids + N, ids)
    lg = v["params"]["logits"][idx]
    if name == "mgqe":  # the reference's masking, as its apply does it
        lg = np.asarray(jm._serving_logits({"logits": jnp.asarray(
            v["params"]["logits"])}))[idx]
        lg = np.where(ids[:, None, None] < jm.hot_cut, v["params"]["logits"][
            idx], lg)
    _bitwise(layers.hard_codes(torch.tensor(lg)), np.argmax(lg, -1))
    ref_s = jm.to_serving(_jv(v))
    serving = pm.to_serving()
    _bitwise(serving["codes"], ref_s["state"]["codes"])
    got = pm.serving_lookup(serving, torch.tensor(IDS))
    _bitwise(got, jm.serving_lookup(ref_s, jnp.asarray(IDS)))
    hard = pm(torch.tensor(IDS))
    np.testing.assert_allclose(_np(got), _np(hard), rtol=1e-5, atol=1e-6)


def test_alpt_stochastic_rounding_by_its_properties():
    """Each value within one step of the deterministic rounding and inside
    the int8 bounds; over 2000 draws the mean within 0.05 of a step of
    the unrounded row (the mean of 2000 roundings has a standard
    deviation of 0.0065 step)."""
    _, v = reference("alpt")
    pm = port("alpt", v)
    ids = torch.tensor(IDS)
    step = torch.exp(pm.log_scale.detach()[layers.table_ids(ids, pm.w)])[
        ..., None]
    det = pm(ids).detach()
    gen = torch.Generator().manual_seed(3)
    draws = torch.stack([pm(ids, train=True, generator=gen).detach()
                         for _ in range(2000)])
    assert ((draws - det).abs() <= step * (1 + 1e-5)).all()
    assert ((draws / step).round().abs() <= 128).all()
    exact = pm.w.detach()[layers.table_ids(ids, pm.w)]
    assert ((draws.mean(0) - exact).abs() <= 0.05 * step).all()
    assert (draws != det).any()


@pytest.mark.parametrize("salt,mod", [(0, 100), (7, 200), (1, 52_799_992),
                                      (31, layers._P1), (3, 3_300_000)])
def test_hash_is_bitwise_the_reference(salt, mod):
    ids = np.array([0, -1, 1, 2, 2 ** 31 - 1, -2 ** 31, 32_999_999,
                    33_000_000, 123_456_789, -5], np.int32)
    ids = np.concatenate([ids, np.random.default_rng(salt).integers(
        -2 ** 31, 2 ** 31, 1000, dtype=np.int64).astype(np.int32)])
    _bitwise(layers._hash(torch.tensor(ids), salt, mod),
             jlayers._hash(jnp.asarray(ids), salt, mod))
    # int64 ids of the same values hash alike
    _bitwise(layers._hash(torch.tensor(ids.astype(np.int64)), salt, mod),
             jlayers._hash(jnp.asarray(ids), salt, mod))


@pytest.mark.parametrize("n", [1, 2, 7, 853, 16_000])
def test_quantile_helper_is_bitwise_jnp_quantile(n):
    x = np.abs(np.random.default_rng(n).standard_normal(n)).astype(
        np.float32)
    x[: n // 3] = x[0]  # ties
    for q in [*np.linspace(0, 1, 21, dtype=np.float32), 0.35, 0.9]:
        _bitwise(layers.linear_quantile(torch.tensor(x), torch.tensor(
            q, dtype=torch.float32)), jnp.quantile(jnp.asarray(x),
                                                   jnp.float32(q)))
        _bitwise(layers.linear_quantile(torch.tensor(x), 1.0 - float(q)),
                 jnp.quantile(jnp.asarray(x), 1.0 - float(q)))


@pytest.mark.parametrize("name,bad", OUT_OF_RANGE)
def test_an_id_past_a_table_raises(name, bad):
    jm, v = reference(name)
    rows, _ = jm.apply(_jv(v), jnp.asarray([[bad, 3]]))
    rows = np.asarray(rows)
    if name == "prune":  # the NaN row makes the threshold NaN: all zeros
        assert (rows == 0).all()
    else:
        assert np.isnan(rows[0, 0]).all()  # the reference's NaN row
    pm = port(name, v)
    with pytest.raises(IndexError):
        pm(torch.tensor([[bad, 3]]))
    if name != "compo":
        with pytest.raises(IndexError):
            pm(torch.tensor([[-N - 1, 3]]))


def test_quantized_embedding_matches_the_reference():
    jm = jec.QuantizedEmbedding(N, D)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    table = np.random.default_rng(1).standard_normal((N, D)).astype(
        np.float32)
    table[3] = 0.0  # a zero row takes the 1e-8 floor
    q, scale = ec.QuantizedEmbedding.from_table(torch.tensor(table))
    jq, jscale = jec.QuantizedEmbedding.from_table(jnp.asarray(table))
    _bitwise(q, jq)
    _bitwise(scale, jscale)
    pm = ec.QuantizedEmbedding(N, D, generator=torch.Generator())
    pm.load_state_dict(interop.variables_from_jax(v, pm))
    ref, _ = jm.apply(_jv(v), jnp.asarray(IDS))
    _bitwise(pm(torch.tensor(IDS)), ref)
    assert pm.q.dtype == torch.int8
    with pytest.raises(IndexError):
        pm(torch.tensor([N]))


def _pruned_table(seed=5, n=20):
    table = np.random.default_rng(seed).standard_normal((n, D)).astype(
        np.float32)
    table[np.abs(table) < 0.8] = 0.0
    table[4] = 0.0   # an empty row
    table[6, :] = 1.5  # a full row, all tied
    return table


def test_sparse_ell_form_matches_the_reference():
    table = _pruned_table()
    max_nnz = int((table != 0).sum(axis=1).max())
    pm = ec.SparseEmbedding.from_dense(torch.tensor(table), max_nnz)
    jv = jec.SparseEmbedding.from_dense(table, max_nnz)
    # each row's set of (col, value) pairs; tied columns may come in
    # another order
    for r in range(table.shape[0]):
        def pairs(vals, cols):
            return sorted((int(c), float(x)) for c, x in zip(cols, vals)
                          if c >= 0)
        assert pairs(_np(pm.values[r]), _np(pm.cols[r])) == pairs(
            np.asarray(jv["state"]["values"][r]),
            np.asarray(jv["state"]["cols"][r]))
    ids = np.array([0, 3, 19, 4, 6, -1, 6])
    jm = jec.SparseEmbedding(20, D, max_nnz=max_nnz)
    ref, _ = jm.apply(jv, jnp.asarray(ids))
    got = pm(torch.tensor(ids))
    _bitwise(got, ref)
    _bitwise(got, table[ids])
    assert pm.cols.dtype == torch.int32


def test_masked_embedding_and_the_retrain_conversions():
    # PEP -> frozen mask
    jm, v = reference("pep")
    pm = port("pep", v)
    r = ec.pep_to_retrain(pm)
    jr = jec.pep_to_retrain(jm, _jv(v))
    _bitwise(r.mask, jr["state"]["mask"])
    _bitwise(r.w, jr["params"]["w"])
    assert 0 < float(r.mask.mean()) < 1
    # AutoSRH -> gates pruned at the quantile
    jm, v = reference("autosrh")
    pm = port("autosrh", v)
    r = ec.autosrh_to_retrain(pm, keep_fraction=0.3)
    jr = jec.autosrh_to_retrain(jm, _jv(v), keep_fraction=0.3)
    _bitwise(r.mask, jr["state"]["mask"])
    _bitwise(r.w, jr["params"]["w"])
    assert 0.25 < float(r.mask.mean()) < 0.35
    # AutoDim -> the winner's table and projection
    jm, v = reference("autodim")
    pm = port("autodim", v)
    r = ec.autodim_to_retrain(pm)
    jr = jec.autodim_to_retrain(jm, _jv(v))
    assert int(r.dim) == jr["state"]["dim"] == pm.selected_dim() \
        == jm.selected_dim(_jv(v))
    _bitwise(r.t, jr["params"]["t"])
    _bitwise(r.p, jr["params"]["p"])
    assert interop.variables_to_jax(r)["state"]["dim"] == jr["state"]["dim"]
    # OptEmbed -> rows pruned
    jm, v = reference("optembed")
    pm = port("optembed", v)
    r = ec.optembed_row_pruned(pm)
    jr = jec.optembed_row_pruned(jm, _jv(v))
    _bitwise(r.row_mask, jr["state"]["row_mask"])
    _bitwise(r.w, jr["params"]["w"])
    assert 0 < float(r.row_mask.mean()) < 1

    # finetuning through MaskedEmbedding: rows and gradients as the
    # reference's, zero gradient where masked
    jr = jec.autosrh_to_retrain(*reference("autosrh"), keep_fraction=0.3)
    jme = jec.MaskedEmbedding(N, D)
    me = ec.MaskedEmbedding(N, D, generator=torch.Generator())
    me.load_state_dict(interop.variables_from_jax(jr, me))

    def jloss(params):
        rows, _ = jme.apply({"params": params, "state": jr["state"]},
                            jnp.asarray(IDS))
        return jnp.sum(rows ** 2)
    ref_g = jax.grad(jloss)({"w": jr["params"]["w"]})["w"]
    rows = me(torch.tensor(IDS))
    (g,) = torch.autograd.grad((rows ** 2).sum(), [me.w])
    _bitwise(rows, jme.apply(jr, jnp.asarray(IDS))[0])
    _within(g, ref_g, TOL_G, "masked dw")
    m = _np(me.mask)
    assert np.all(_np(g)[m == 0] == 0) and np.any(_np(g)[m == 1] != 0)


def test_scheduler_stages_and_hooks():
    jm, v = reference("prune")
    pm = port("prune", v)
    stages = [("warmup", 10, None), ("prune", 20, 0.95)]
    sched = CompressionScheduler([Stage(n, u, prune_rate_setter(r) if r
                                        else None) for n, u, r in stages])
    jsched = JScheduler([JStage(n, u, j_rate(r) if r else None)
                         for n, u, r in stages])
    jv = _jv(v)
    assert sched.current.name == "warmup"
    for step in (5, 15, 25):
        assert sched.maybe_transition(step, pm) is pm
        jv = jsched.maybe_transition(step, jv)
        assert sched.current.name == jsched.current.name
    _bitwise(pm.rate, jv["state"]["rate"])
    _bitwise(pm(torch.tensor(IDS)), jm.apply(jv, jnp.asarray(IDS))[0])
    with pytest.raises(ValueError):
        CompressionScheduler([Stage("a", 10), Stage("b", 10)])

    # switch to the int8 serving form: the dense PEP table quantized
    jm, v = reference("pep")
    pm = port("pep", v)
    sched = CompressionScheduler([Stage("train", 10), Stage(
        "serve", 20, on_enter=switch_to_quantized(pm))])
    jsched = JScheduler([JStage("train", 10), JStage(
        "serve", 20, on_enter=j_switch(jm))])
    q = sched.maybe_transition(12, pm)
    jq = jsched.maybe_transition(12, _jv(v))
    assert isinstance(q, ec.QuantizedEmbedding) and q.q.dtype == torch.int8
    _bitwise(q.q, jq["state"]["q"])
    _bitwise(q.scale, jq["state"]["scale"])


def test_multistage_flow():
    with pytest.raises(ValueError):
        ec.MultiStageFlow([])
    ms = ec.MultiStageFlow([("a", lambda c: c + 1), ("b", lambda c: c * 2)])
    assert ms.run(1) == 4 and ms.history == ["a", "b"]
    assert ms.run(1, start_stage=1) == 2 and ms.history == ["b"]


# ---- the training flows, as tests/test_embedding_compress.py's tiny CTR
# task: 64 ids, dim 8, 3 fields, a linear head from zeros

def _ctr_task(n=64, fields=3):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, n, (256, fields))
    w_true = rng.standard_normal((n,))
    y = (w_true[ids].sum(-1) > 0).astype(np.float32)
    return [(ids[i::4], y[i::4]) for i in range(4)]


def _bce(logit, y, lib):
    return lib.mean(lib.maximum(logit, lib.zeros_like(logit)) - logit * y
                    + lib.log1p(lib.exp(-lib.abs(logit))))


def _flow_problem(cls, **kw):
    """The reference's module, params tree and loss, and the port's
    module, params dict and loss, from the same variables (the
    reference's init with the head redrawn small, so every leaf's
    gradient is live from the first step)."""
    jm = getattr(jec, cls)(64, 8, **kw)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    if "arch" in v["params"]:
        v["params"]["arch"] = np.array([0.1, -0.2, 0.05], np.float32)
    head = (0.1 * np.random.default_rng(1).standard_normal(24)).astype(
        np.float32)

    def jloss(params, batch):
        emb, _ = jm.apply({"params": params["embed"], "state": {}},
                          jnp.asarray(batch[0]))
        logit = emb.reshape(emb.shape[0], -1) @ params["head"]
        return _bce(logit, jnp.asarray(batch[1]), jnp)
    jparams = {"embed": _jv(v["params"]), "head": jnp.asarray(head)}

    pm = getattr(ec, cls)(64, 8, **kw,
                          generator=torch.Generator().manual_seed(0))
    pm.load_state_dict(interop.variables_from_jax(v, pm))
    params = {f"embed.{k}": p for k, p in pm.named_parameters()}
    params["head"] = torch.nn.Parameter(torch.tensor(head))

    def loss(params, batch):
        emb = pm(torch.tensor(batch[0]))
        logit = emb.reshape(emb.shape[0], -1) @ params["head"]
        return _bce(logit, torch.tensor(batch[1]), torch)
    return jm, jparams, jloss, pm, params, loss


def _same_params(params, jparams):
    for k, p in params.items():
        ref = jparams["head"] if k == "head" else \
            jparams["embed"][k.split(".", 1)[1]]
        _within(p, ref, TOL_P, k)


def test_autodim_bilevel_trainer_matches_the_reference():
    jm, jparams, jloss, pm, params, loss = _flow_problem(
        "AutoDimEmbedding", candidate_dims=[8, 4, 2])
    batches = _ctr_task()
    jt = jec.AutoDimBiLevelTrainer(jm, jloss, alpha_lr=5e-2,
                                   weight_opt=joptim.AdamOptimizer(
                                       1e-3, eps=1e-3))
    t = ec.AutoDimBiLevelTrainer(pm, loss, alpha_lr=5e-2,
                                 weight_opt=optim.AdamOptimizer(1e-3,
                                                                eps=1e-3))
    arch0 = params["embed.arch"].detach().clone()
    jparams, jtl, jvl = jt.fit(jparams, batches[:3], batches[3:])
    params, tl, vl = t.fit(params, batches[:3], batches[3:])
    np.testing.assert_allclose(tl, jtl, rtol=1e-6)
    np.testing.assert_allclose(vl, jvl, rtol=1e-6)
    _same_params(params, jparams)
    assert not torch.equal(params["embed.arch"], arch0)
    r, jr = t.finalize(), jt.finalize({"params": jparams["embed"],
                                       "state": {}})
    assert int(r.dim) == jr["state"]["dim"]
    _within(r.t, jr["params"]["t"], TOL_P, "retrain t")


def test_optembed_flow_matches_the_reference():
    jm, jparams, jloss, pm, params, loss = _flow_problem(
        "OptEmbedEmbedding")
    batches = _ctr_task()
    kw = dict(thresh_lr=5e-2, alpha=1e-3)
    jf = jec.OptEmbedFlow(jm, jloss, **kw, weight_opt=joptim.AdamOptimizer(
        1e-3, eps=1e-3))
    f = ec.OptEmbedFlow(pm, loss, **kw,
                        weight_opt=optim.AdamOptimizer(1e-3, eps=1e-3))
    jparams, jlosses = jf.train_supernet(jparams, batches[:3])
    params, losses = f.train_supernet(params, batches[:3])
    np.testing.assert_allclose(losses, jlosses, rtol=1e-6)
    _same_params(params, jparams)

    def fitness(lib, run, head, cand):
        mask = (np.arange(8)[None, :] < np.asarray(cand)[:, None])
        emb = np.asarray(run(batches[0][0]), np.float32) * mask[None]
        logit = emb.reshape(emb.shape[0], -1) @ np.asarray(head)
        return float(_bce(logit, batches[0][1], np)) + 1e-3 * float(
            np.sum(cand))
    jrun = (lambda ids: jm.apply({"params": jparams["embed"],
                                 "state": {}}, jnp.asarray(ids))[0])
    run = (lambda ids: pm(torch.tensor(ids)).detach().numpy())
    kw = dict(n_fields=3, dim=8, population=6, generations=3, seed=1)
    jbest, jfit = jec.OptEmbedFlow.evolutionary_search(
        lambda c: fitness(np, jrun, jparams["head"], c), **kw)
    best, fit = ec.OptEmbedFlow.evolutionary_search(
        lambda c: fitness(np, run, params["head"].detach(), c), **kw)
    np.testing.assert_array_equal(best, jbest)
    assert abs(fit - jfit) <= 1e-6 * abs(jfit)
    # the same seed and fitness give the same search, bitwise
    assert np.array_equal(ec.OptEmbedFlow.evolutionary_search(
        np.sum, **kw)[0], jec.OptEmbedFlow.evolutionary_search(
        np.sum, **kw)[0])
    _bitwise(ec.OptEmbedFlow.field_mask(best, 8, device="cpu"),
             jec.OptEmbedFlow.field_mask(best, 8))

    rv = f.finalize(best)
    jrv = jf.finalize({"params": jparams["embed"], "state": {}}, jbest)
    _bitwise(rv.row_mask, jrv["state"]["row_mask"])
    np.testing.assert_array_equal(_np(rv.field_dims), jbest)
    ms = ec.MultiStageFlow([
        ("supernet", lambda c: f.train_supernet(c, batches[:1])[0]),
        ("evo+prune", lambda c: f.finalize(best))])
    out = ms.run(params)
    assert ms.history == ["supernet", "evo+prune"]
    assert "row_mask" in interop.variables_to_jax(out)["state"]


def test_serving_row_codec_is_bytewise_the_reference():
    rows = np.random.default_rng(2).standard_normal((33, D)).astype(
        np.float32)
    rows[5] = 0.0
    rows[7, 3] = -1e-30
    codec, ref = ec.ServingRowCodec(D), jec.ServingRowCodec(D)
    blob, ref_blob = codec.compress(rows), ref.compress(rows)
    for got, want in zip(blob, ref_blob):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert codec.decompress(blob).tobytes() == \
        ref.decompress(ref_blob).tobytes()
    assert codec.bytes_per_value == ref.bytes_per_value == 1


def test_exports_match_the_reference():
    import hetu_tpu.embedding_compress as ref_pkg
    import hetu_tpu_torch
    names = {n for n in dir(ref_pkg) if not n.startswith("_")
             and n not in ("layers", "scheduler", "recipes")}
    assert names <= set(dir(hetu_tpu_torch.embedding_compress))
    assert len([n for n in names if n.endswith("Embedding")]) == 19
