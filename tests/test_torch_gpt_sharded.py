"""The port's fully sharded GPT-MoE (``hetu_tpu_torch/models/gpt_sharded.py``)
and the expert-parallel ``MoELayer`` against hetu_tpu on the CPU.

Two ``gloo`` worlds start once for the module, of 4 and of 2 rank
processes (``tests/torch_sharded_bodies.py``), and run every case of this
file.  The oracle is the reference's single-device ``ShardedGPT``, run in
this process on the same numpy parameters (its ``init``, carried to each
rank's shards by ``interop.sharded_params_from_jax``) and the same batch,
as ``tests/test_sharded_gpt.py`` holds its sharded runs to it:

* every mesh of the list below reproduces the single device's three Adam
  steps' losses at the reference test's ``rtol=2e-4, atol=2e-5``, and each
  parameter's first-step gradient, assembled from the ranks' shards
  (``interop.sharded_params_to_jax``), lies within 1e-4 · max|g| of
  ``jax.grad`` of the reference's ``loss_fn()``: the gradients of the
  parameters replicated over pp, dp, sp, ep or tp are the single device's,
  not a multiple of it.  Under dp the reference's own sharded step draws
  its aux loss's statistics from global microbatches that interleave the
  dp shards, so there the oracle's batch has its rows in that order
  (:func:`microbatch_rows`; its CE does not depend on the order);
* ``remat=True`` matches the default at rtol 1e-5 and
  ``vocab_parallel=False`` at 2e-4 (the reference test's), and the loss
  falls over 6 steps;
* no route is dropped (``capacity_factor=4.0``, E = 4, k = 2);
* the ep MoE layer at ep = 2 and 4 matches the reference's unsharded
  ``MoELayer`` (``tests/test_moe.py``: out at rtol 1e-4, aux at 1e-5), its
  gradients the port's unsharded layer's at 1e-5 relative to max|g|.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hetu_tpu as ht
import torch_sharded_bodies as bodies
from hetu_tpu import optim
from hetu_tpu.layers.moe import Expert as JaxExpert
from hetu_tpu.layers.moe import MoELayer as JaxMoELayer
from hetu_tpu.layers.moe import TopKGate as JaxTopKGate
from hetu_tpu.models.gpt_sharded import ShardedGPT as JaxShardedGPT
from hetu_tpu.models.gpt_sharded import ShardedGPTConfig as JaxConfig
from hetu_tpu_torch import interop
from hetu_tpu_torch.parallel import ranks

CFG = dict(vocab_size=128, hidden_size=32, num_layers=4, num_heads=4,
           ffn_size=64, num_experts=4, top_k=2, capacity_factor=4.0,
           max_position=64, n_microbatches=2)
B, S, LR = 8, 16, 1e-3
MESHES4 = {"pp2_tp2": {"pp": 2, "tp": 2}, "dp2_ep2": {"dp": 2, "ep": 2},
           "sp2_tp2": {"sp": 2, "tp": 2}, "pp2_sp2": {"pp": 2, "sp": 2},
           "ep2_tp2": {"ep": 2, "tp": 2}}
MESHES2 = {"sp2": {"sp": 2}, "pp2": {"pp": 2}}
MOE = dict(D=16, F=32, E=8, cf=2.0)


def data():
    g = np.random.default_rng(0)
    ids = g.integers(0, CFG["vocab_size"], (B, S)).astype(np.int32)
    labels = np.concatenate([ids[:, 1:], np.full((B, 1), -1, np.int32)],
                            axis=1)
    return ids, labels


def microbatch_rows(dp):
    """The batch's rows in the order of a dp run's global microbatches:
    microbatch m holds the m-th slice of every dp shard.  The single
    device's CE is the same in any row order, its aux loss (statistics a
    microbatch) is the dp run's in this one."""
    b_loc = B // dp
    mb = b_loc // CFG["n_microbatches"]
    return [r * b_loc + m * mb + j for m in range(CFG["n_microbatches"])
            for r in range(dp) for j in range(mb)]


def reference_model():
    model = JaxShardedGPT(JaxConfig(**CFG), ht.make_mesh())
    return model, model.place(model.init(jax.random.PRNGKey(0)))


def reference(model, params, steps=3):
    """The single-device reference's losses and its first step's
    gradients, by dp (the batch's rows in that dp's microbatch order,
    :func:`microbatch_rows`)."""
    ids, labels = data()
    loss = model.loss_fn()
    grad = jax.jit(jax.grad(lambda p, i, l: loss(p, i, l)[0]))
    g = {dp: jax.tree_util.tree_map(np.asarray, grad(
        params, ids[microbatch_rows(dp)], labels[microbatch_rows(dp)]))
         for dp in (1, 2)}
    opt = optim.AdamOptimizer(LR)
    state = opt.init_state(params)
    step = model.make_train_step(opt)
    losses = []
    for _ in range(steps):
        params, state, m = step(params, state, ids, labels)
        losses.append(float(m["loss"]))
    return losses, g


def moe_reference():
    D, Fz, E, cf = MOE["D"], MOE["F"], MOE["E"], MOE["cf"]
    layer = JaxMoELayer(JaxTopKGate(D, E, 2), JaxExpert(E, D, Fz),
                        capacity_factor=cf)
    v = layer.init(jax.random.PRNGKey(0))
    g = np.random.default_rng(1)
    x = g.standard_normal((4, 8, D)).astype(np.float32)
    w = g.standard_normal((4, 8, D)).astype(np.float32)
    (y, aux), _ = layer.apply(v, jnp.asarray(x))
    return (jax.tree_util.tree_map(np.asarray, v["params"]), x, w,
            np.asarray(y), float(aux))


def _spec(tree, mesh, steps=3, **over):
    ids, labels = data()
    return ("sharded_gpt", dict(cfg={**CFG, **over}, params=tree, mesh=mesh,
                                ids=ids, labels=labels, lr=LR, steps=steps))


@pytest.fixture(scope="module")
def worlds():
    model, params = reference_model()
    tree = jax.tree_util.tree_map(np.asarray, params)
    moe_tree, x, w, y_ref, aux_ref = moe_reference()
    moe = dict(MOE, params=moe_tree, x=x, w=w)
    cases4 = {cid: _spec(tree, m, steps=6 if cid == "pp2_sp2" else 3)
              for cid, m in MESHES4.items()}
    cases4["pp2_tp2_remat"] = _spec(tree, MESHES4["pp2_tp2"], remat=True)
    cases4["pp2_tp2_novp"] = _spec(tree, MESHES4["pp2_tp2"],
                                   vocab_parallel=False)
    cases4["moe_ep4"] = ("moe_ep", moe)
    cases2 = {cid: _spec(tree, m) for cid, m in MESHES2.items()}
    cases2["single"] = _spec(tree, None)
    cases2["moe_ep1"] = ("moe_ep", dict(moe, unsharded=True))
    cases2["moe_ep2"] = ("moe_ep", moe)
    # the two worlds run while this process computes the reference
    with ThreadPoolExecutor(2) as pool:
        r4 = pool.submit(ranks.run, bodies.run_cases, 4, threads=1,
                         timeout_s=600, args=(cases4,))
        r2 = pool.submit(ranks.run, bodies.run_cases, 2, threads=1,
                         timeout_s=600, args=(cases2,))
        losses, grads = reference(model, params)
        r4, r2 = r4.result(), r2.result()
    return dict(r4=r4, r2=r2, tree=tree, losses=losses, grads=grads,
                y_ref=y_ref, aux_ref=aux_ref)


def _results(worlds, cid):
    for key in ("r4", "r2"):
        if cid in worlds[key][0]:
            return [r[cid] for r in worlds[key]]
    raise KeyError(cid)


@pytest.mark.parametrize("cid", list(MESHES4) + list(MESHES2) + ["single"])
def test_losses_match_the_single_device(cid, worlds):
    for r in _results(worlds, cid):
        np.testing.assert_allclose(r["losses"][:3], worlds["losses"],
                                   rtol=2e-4, atol=2e-5)
        assert r["dropped"] == [0.0] * len(r["dropped"])


@pytest.mark.parametrize("cid", list(MESHES4) + list(MESHES2) + ["single"])
def test_gradients_match_jax_grad_per_parameter(cid, worlds):
    res = _results(worlds, cid)
    got = interop.sharded_params_to_jax(
        [(r["coords"], r["grads"]) for r in res], res[0]["specs"],
        res[0]["sizes"])
    flat_got = interop._flat_tree(got)
    flat_ref = interop._flat_tree(worlds["grads"][res[0]["sizes"]["dp"]])
    assert set(flat_got) == set(flat_ref)
    for name, ref in flat_ref.items():
        scale = np.abs(ref).max()
        np.testing.assert_allclose(flat_got[name], ref, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


def test_remat_and_vocab_replicated_match_default(worlds):
    ref = _results(worlds, "pp2_tp2")[0]["losses"]
    remat = _results(worlds, "pp2_tp2_remat")[0]["losses"]
    novp = _results(worlds, "pp2_tp2_novp")[0]["losses"]
    np.testing.assert_allclose(remat, ref, rtol=1e-5)
    np.testing.assert_allclose(novp, ref, rtol=2e-4)


def test_loss_decreases_under_sharding(worlds):
    for r in _results(worlds, "pp2_sp2"):
        assert len(r["losses"]) == 6 and r["losses"][-1] < r["losses"][0]


def test_every_rank_agrees_and_no_rank_loads_jax(worlds):
    for key in ("r4", "r2"):
        assert not any(r["_jax_loaded"] for r in worlds[key])
    for cid in list(MESHES4) + list(MESHES2):
        losses = [r["losses"] for r in _results(worlds, cid)]
        assert all(x == losses[0] for x in losses), cid


@pytest.mark.parametrize("cid", ["moe_ep2", "moe_ep4"])
def test_ep_moe_layer_matches_the_unsharded_reference(cid, worlds):
    res = _results(worlds, cid)
    n = len(res)
    for r in res:
        np.testing.assert_allclose(r["y"], worlds["y_ref"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(r["aux"], worlds["aux_ref"], rtol=1e-5)
        assert r["dropped"] == 0.0
        assert "Shard(dim=0)" in r["placement"]
        assert r["local"] == [MOE["E"] // n, MOE["D"], MOE["F"]]
    # gradients: the unsharded layer's (every rank the same x, gate)
    whole = _results(worlds, "moe_ep1")[0]
    for r in res:
        for name in ("dx", "dgate"):
            np.testing.assert_allclose(
                r[name], whole[name], rtol=0,
                atol=1e-5 * np.abs(whole[name]).max(), err_msg=name)
    for name in ("dw1", "db1", "dw2", "db2"):
        got = np.concatenate([r[name] for r in res])
        np.testing.assert_allclose(got, whole[name], rtol=0,
                                   atol=1e-5 * np.abs(whole[name]).max(),
                                   err_msg=name)


def test_sharded_interop_round_trip_is_the_identity(worlds):
    """The reference's tree → each rank's shards (in the ranks) → the tree
    again, bitwise."""
    tree = worlds["tree"]
    for cid in ("pp2_tp2", "dp2_ep2", "sp2_tp2", "pp2_tp2_novp"):
        res = _results(worlds, cid)
        back = interop.sharded_params_to_jax(
            [(r["coords"], r["params0"]) for r in res], res[0]["specs"],
            res[0]["sizes"])
        flat, got = interop._flat_tree(tree), interop._flat_tree(back)
        assert set(got) == set(flat)
        for k, v in flat.items():
            assert np.array_equal(got[k], v), (cid, k)
        # a rank holds its piece only: pp and tp split the blocks
        if cid == "pp2_tp2":
            assert res[0]["params0"]["blocks.qkv_w"].shape == (2, 32, 48)
