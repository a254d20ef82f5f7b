"""The port's partial-reduce step (``hetu_tpu_torch/parallel/preduce.py``)
and distributed GCN aggregation (``hetu_tpu_torch/ops/distgcn.py``)
against hetu_tpu on the CPU.

A ``gloo`` world of 2 and one of 4 rank processes start once for the
module (``tests/torch_dppipe_bodies.py``).  The oracles run in this
process on the same numpy inputs, with the cases and tolerances of the
reference's ``tests/test_preduce_distgcn.py``:

* ``preduce_step_fn`` at dp = 4 against the reference's on its dp = 4
  mesh: every worker a member (the all-reduce step, rtol 1e-4, atol
  1e-6), a partial group whose stragglers' gradients must not reach the
  update, an empty group that changes nothing, and an empty round under
  ``MomentumOptimizer`` that leaves the parameter and its velocity frozen
  (each step's parameter, velocity and group loss);
* ``dist_gcn_aggregate`` at dp = 2 and 4 against the reference's, both
  routes (gather, ring): each rank's output rows and dL/dh of ``sum(out *
  cot)`` at rtol 1e-4, atol 1e-5; ``shard_edges_by_dst`` equals the
  reference's layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hetu_tpu as ht
import torch_dppipe_bodies as bodies
from hetu_tpu import optim
from hetu_tpu.ops.distgcn import dist_gcn_aggregate as jax_aggregate
from hetu_tpu.ops.distgcn import shard_edges_by_dst as jax_shard_edges
from hetu_tpu.parallel.preduce import preduce_step_fn as jax_preduce
from hetu_tpu_torch.ops.distgcn import shard_edges_by_dst
from hetu_tpu_torch.parallel import ranks

N, F, E = 32, 8, 120


def preduce_spec(world):
    g = np.random.default_rng(0)
    x = g.standard_normal((32, 4)).astype(np.float32)
    # shard s sees the constant s: its gradient of mean(w * batch) is s
    return dict(x=x, y=x.sum(-1).astype(np.float32),
                const_batch=np.repeat(np.arange(world, dtype=np.float32), 4),
                mask=np.asarray([1] * (world // 2)
                                + [0] * (world - world // 2), np.float32))


def gcn_spec():
    g = np.random.default_rng(0)
    return dict(src=g.integers(0, N, E), dst=g.integers(0, N, E),
                w=g.standard_normal(E).astype(np.float32),
                h=g.standard_normal((N, F)).astype(np.float32),
                cot=g.standard_normal((N, F)).astype(np.float32))


@pytest.fixture(scope="module")
def worlds():
    out = {}
    for n in (2, 4):
        cases = {"gcn": ("distgcn", gcn_spec())}
        if n == 4:
            cases["preduce"] = ("preduce", preduce_spec(n))
        out[n] = ranks.run(bodies.run_cases, n, threads=1, timeout_s=300,
                           args=(cases,))
    return out


def test_ranks_load_no_jax(worlds):
    for res in worlds.values():
        assert not any(r["_jax_loaded"] for r in res)


# ---------------------------------------------------------------- preduce

def _ref_preduce(loss_fn, opt, params, steps):
    """The reference's step on its dp = 4 mesh: (params, opt state, loss)
    after each ``(batch, mask)`` of ``steps``."""
    step, n = jax_preduce(loss_fn, opt, ht.make_mesh(dp=4))
    state = opt.init_state(params)
    out = []
    for batch, mask in steps:
        params, state, loss = step(params, state, batch, mask)
        out.append((jax.tree_util.tree_map(np.asarray, params),
                    jax.tree_util.tree_map(np.asarray, state), float(loss)))
    return out, n


def test_preduce_full_mask_equals_allreduce_dp(worlds):
    spec = preduce_spec(4)
    x, y = spec["x"], spec["y"]

    def loss_fn(params, batch):
        bx, by = batch
        return jnp.mean(((bx @ params["w"])[:, 0] - by) ** 2)
    ref, n = _ref_preduce(loss_fn, optim.SGDOptimizer(0.1),
                          {"w": jnp.zeros((4, 1))}, [((x, y), np.ones(4))])
    for r in worlds[4]:
        got = r["preduce"]["full"]
        assert got["n"] == n == 4
        np.testing.assert_allclose(got["w"], ref[0][0]["w"], rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(got["loss"], ref[0][2], rtol=1e-4)


@pytest.mark.parametrize("name", ["partial", "empty"])
def test_preduce_group_excludes_stragglers(worlds, name):
    """Group {0, 1}: the gradients of shards 2 and 3 do not reach the
    update (w = -mean(0, 1) = -0.5); an empty group changes nothing."""
    spec = preduce_spec(4)
    mask = spec["mask"] if name == "partial" else np.zeros(4, np.float32)

    def loss_fn(params, batch):
        return jnp.mean(params["w"] * batch)
    ref, _ = _ref_preduce(loss_fn, optim.SGDOptimizer(1.0),
                          {"w": jnp.zeros(())},
                          [(spec["const_batch"], mask)])
    want = -0.5 if name == "partial" else 0.0
    np.testing.assert_allclose(float(ref[0][0]["w"]), want, rtol=1e-6)
    for r in worlds[4]:
        got = r["preduce"][name]
        np.testing.assert_allclose(got["w"], ref[0][0]["w"], rtol=1e-6)
        np.testing.assert_allclose(got["loss"], ref[0][2], atol=1e-6)


def test_preduce_empty_group_freezes_momentum(worlds):
    """A real step builds velocity; the empty round leaves the parameter,
    the velocity and the optimizer's step bitwise; training resumes."""
    def loss_fn(params, batch):
        return jnp.mean(params["w"] * batch)
    ones = np.ones(4, np.float32)
    ref, _ = _ref_preduce(loss_fn, optim.MomentumOptimizer(1.0, 0.9),
                          {"w": jnp.zeros(())},
                          [(ones, np.ones(4)), (ones, np.zeros(4)),
                           (ones, np.ones(4))])
    for r in worlds[4]:
        seq = r["preduce"]["momentum"]
        assert seq[1]["w"] == seq[0]["w"] and seq[1]["v"] == seq[0]["v"]
        assert seq[1]["step"] == seq[0]["step"] == 1
        assert seq[2]["w"] != seq[0]["w"]
        for got, (p, st, loss) in zip(seq, ref):
            np.testing.assert_allclose(got["w"], p["w"], rtol=1e-6)
            np.testing.assert_allclose(
                got["v"], jax.tree_util.tree_leaves(st["slots"])[0],
                rtol=1e-6)
            np.testing.assert_allclose(got["loss"], loss, atol=1e-6)


# ---------------------------------------------------------------- distgcn

@pytest.mark.parametrize("ring", [False, True], ids=["gather", "ring"])
@pytest.mark.parametrize("p", [2, 4])
def test_dist_gcn_matches_the_reference(worlds, p, ring):
    spec = gcn_spec()
    ss, dd, ww = jax_shard_edges(spec["src"], spec["dst"], spec["w"], N, p)
    mesh = ht.make_mesh(dp=p)

    def f(h):
        return jax_aggregate(h, jnp.asarray(ss), jnp.asarray(dd),
                             jnp.asarray(ww), mesh, ring=ring)
    out, vjp = jax.vjp(f, jnp.asarray(spec["h"]))
    (dh,) = vjp(jnp.asarray(spec["cot"]))
    out, dh = np.asarray(out), np.asarray(dh)
    n_loc = N // p
    for rank, r in enumerate(worlds[p]):
        got = r["gcn"][ring]
        rows = slice(rank * n_loc, (rank + 1) * n_loc)
        np.testing.assert_allclose(got["y"], out[rows], rtol=1e-4,
                                   atol=1e-5, err_msg=f"rank {rank}")
        np.testing.assert_allclose(got["dh"], dh[rows], rtol=1e-4,
                                   atol=1e-5, err_msg=f"rank {rank} dh")


@pytest.mark.parametrize("p", [2, 4])
def test_shard_edges_by_dst_is_the_references_layout(worlds, p):
    spec = gcn_spec()
    want = jax_shard_edges(spec["src"], spec["dst"], spec["w"], N, p)
    got = shard_edges_by_dst(spec["src"], spec["dst"], spec["w"], N, p)
    for a, b, c in zip(got, want, worlds[p][0]["gcn"]["layout"]):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(c, np.asarray(b))
    # unweighted: real edges weigh 1, padding 0
    got = shard_edges_by_dst(spec["src"], spec["dst"], None, N, p)
    want = jax_shard_edges(spec["src"], spec["dst"], None, N, p)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match="not divisible"):
        shard_edges_by_dst(spec["src"], spec["dst"], None, N + 1, p)
