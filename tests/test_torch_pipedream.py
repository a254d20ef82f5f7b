"""The port's 1F1B pipeline (``hetu_tpu_torch/parallel/pipedream.py``) and
HetPipe's PS-synced virtual workers (``hetu_tpu_torch/parallel/hetpipe.py``)
against hetu_tpu on the CPU.

A ``gloo`` world of 2 and one of 4 rank processes start once for the
module (``tests/torch_dppipe_bodies.py``), after a van server started in
this process (the port's, ``ps.van.serve``) for the weight tables and the
SSP clocks.  The oracle is the one the reference's slow tests use
themselves: ``jax.grad`` of the reference's SEQUENTIAL block stack
(``tests/test_pipedream_runtime.py``), in this process, on the same numpy
layers and inputs; one case also runs the reference's ``PipeDream1F1B``.

* 1F1B at pp = 2 and 4: the loss and every stage's parameter gradients
  with more microbatches than ``2 · n_stages`` (the stash wraps), outputs
  and gradients under a direct cotangent, and the losses of 10 Adam steps
  (the reference optimizer's replay of the sequential stack; the loss
  falls below 0.9 of the first); the reference test's tolerances (rtol
  1e-5 loss and outputs, rtol 1e-4 / atol 1e-5 gradients);
* ``interop.stage_params_from_jax`` gives each rank the stage of the
  reference's stacked tree, and ``stage_params_to_jax`` stacks it back;
* HetPipe (``tests/test_hetpipe.py``'s cases): ``flatten_params`` equals
  the reference's on the same tree; one virtual worker at pp = 2 syncing
  every wave equals flush SGD wave for wave; with ``sync_every`` 2 the
  odd waves move only the local weights (the server untouched) and the
  even waves install the server's, which saw only the pushed sum; two
  virtual workers (dp = 2 × pp = 2) sharing one van table and a
  ``RemoteSSP`` converge with their clocks within the bound; a worker
  whose peer never clocks trips the staleness bound on both its ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hetu_tpu as ht
import torch_dppipe_bodies as bodies
from hetu_tpu.parallel.hetpipe import flatten_params as jax_flatten
from hetu_tpu.parallel.hetpipe import unflatten_params as jax_unflatten
from hetu_tpu.parallel.pipedream import PipeDream1F1B as JaxPipeDream
from hetu_tpu_torch.parallel import hetpipe, ranks
from hetu_tpu_torch.ps import van


def block_fn(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])


def sequential(layers, h):
    for i in range(layers["w"].shape[0]):
        h = block_fn({"w": layers["w"][i], "b": layers["b"][i]}, h)
    return h


def make_layers(seed, L, D):
    g = np.random.default_rng(seed)
    return {"w": (g.standard_normal((L, D, D)) * 0.3).astype(np.float32),
            "b": (g.standard_normal((L, D)) * 0.1).astype(np.float32)}


def normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def pipe_cases(n):
    """The reference test's cases at pp = n: M > 2n in the loss case."""
    L = 2 * n
    return {
        "loss": dict(kind="loss", layers=make_layers(0, L, 8), M=2 * n + 2,
                     h=normal(1, 4 * (n + 1), 8), y=normal(2, 4 * (n + 1), 8)),
        "direct": dict(kind="direct", layers=make_layers(3, n, 4), M=4,
                       h=normal(4, 8, 4), cot=normal(5, 8, 4)),
        "train": dict(kind="train", layers=make_layers(6, n, 8), M=4,
                      h=normal(7, 16, 8), y=normal(8, 16, 8, scale=0.1),
                      lr=1e-2, steps=10),
    }


def het_cases():
    return {
        "flush": dict(layers=make_layers(10, 4, 6), M=4, h=normal(11, 16, 6),
                      y=normal(12, 16, 6, scale=0.1), lr=0.05, sync_every=1,
                      local_lr=0.05, waves=5, table_id=0x5E7_0001),
        "lookahead": dict(layers=make_layers(13, 2, 4), M=2,
                          h=normal(14, 8, 4), y=np.zeros((8, 4), np.float32),
                          lr=0.05, sync_every=2, local_lr=0.05, waves=2,
                          table_id=0x5E7_0002),
        "stale": dict(layers=make_layers(15, 2, 4), M=2, h=normal(16, 8, 4),
                      y=np.zeros((8, 4), np.float32), lr=0.01, sync_every=1,
                      waves=2, table_id=0x5E7_0003, ssp_id=0x5E7_0004,
                      staleness=1),
    }


def two_worker_spec(port):
    return dict(port=port, layers=make_layers(20, 2, 6), M=2,
                h=[normal(21, 8, 6), normal(22, 8, 6)],
                y=[np.zeros((8, 6), np.float32)] * 2, lr=0.1, waves=12,
                staleness=2, table_id=0x5E7_0005, ssp_id=0x5E7_0006)


@pytest.fixture(scope="module")
def van_port():
    port = van.serve(0)
    yield port
    van.stop()


@pytest.fixture(scope="module")
def worlds(van_port):
    out = {}
    for n in (2, 4):
        cases = {"pipe": ("pipedream", {"cases": pipe_cases(n)})}
        if n == 2:
            cases["het"] = ("hetpipe", {"port": van_port,
                                        "cases": het_cases()})
        else:
            cases["two"] = ("hetpipe_two_workers", two_worker_spec(van_port))
        out[n] = ranks.run(bodies.run_cases, n, threads=1, timeout_s=300,
                           args=(cases,))
    return out


def test_ranks_load_no_jax(worlds):
    for res in worlds.values():
        assert not any(r["_jax_loaded"] for r in res)


def _stage_rows(layers, n, s):
    L = layers["w"].shape[0]
    return {k: v[s * L // n:(s + 1) * L // n] for k, v in layers.items()}


def _check_stage_grads(res, g_ref, n):
    for s, r in enumerate(res):
        want = _stage_rows({k: np.asarray(v) for k, v in g_ref.items()}, n, s)
        for k in ("w", "b"):
            got = r[k]
            assert got.shape == (1,) + want[k].shape
            np.testing.assert_allclose(got[0], want[k], rtol=1e-4,
                                       atol=1e-5, err_msg=f"stage {s} {k}")


@pytest.mark.parametrize("n", [2, 4])
def test_1f1b_loss_and_grads_match_the_sequential_oracle(worlds, n):
    c = pipe_cases(n)["loss"]
    assert c["M"] > 2 * n  # the stash slots wrap

    def loss_fn(ls):
        return jnp.mean((sequential(ls, c["h"]) - c["y"]) ** 2)
    ref_loss, g_ref = jax.value_and_grad(loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, c["layers"]))
    got = [r["pipe"]["loss"] for r in worlds[n]]
    for r in got:
        np.testing.assert_allclose(r["loss"], float(ref_loss), rtol=1e-5)
    _check_stage_grads([r["grads"] for r in got], g_ref, n)


@pytest.mark.parametrize("n", [2, 4])
def test_1f1b_forward_and_grad_direct_cotangent(worlds, n):
    c = pipe_cases(n)["direct"]
    layers = jax.tree_util.tree_map(jnp.asarray, c["layers"])
    out, vjp = jax.vjp(lambda ls: sequential(ls, c["h"]), layers)
    (g_ref,) = vjp(jnp.asarray(c["cot"]))
    got = [r["pipe"]["direct"] for r in worlds[n]]
    for r in got:
        np.testing.assert_allclose(r["y"], np.asarray(out), rtol=1e-5,
                                   atol=1e-6)
    _check_stage_grads([r["grads"] for r in got], g_ref, n)


def test_1f1b_matches_the_references_pipeline(worlds):
    """One call of the reference's own ``PipeDream1F1B`` (pp = 2, the
    direct-cotangent case): the port's outputs and each rank's stage
    gradients equal its outputs and its ``[S, L/S, ...]`` gradients' rows
    (outputs at rtol 1e-5, gradients at rtol 1e-4 / atol 1e-5)."""
    c = pipe_cases(2)["direct"]
    pipe = JaxPipeDream(block_fn, ht.make_mesh(pp=2), n_microbatches=c["M"])
    stacked = pipe.stack_params(jax.tree_util.tree_map(jnp.asarray,
                                                       c["layers"]))
    out, grads = pipe.forward_and_grad(stacked, jnp.asarray(c["h"]),
                                       jnp.asarray(c["cot"]))
    for s, r in enumerate(worlds[2]):
        got = r["pipe"]["direct"]
        np.testing.assert_allclose(got["y"], np.asarray(out), rtol=1e-5,
                                   atol=1e-6)
        for k in ("w", "b"):
            np.testing.assert_allclose(got["grads"][k][0],
                                       np.asarray(grads[k])[s], rtol=1e-4,
                                       atol=1e-5, err_msg=f"stage {s} {k}")


@pytest.mark.parametrize("n", [2, 4])
def test_1f1b_trains_end_to_end(worlds, n):
    """10 Adam steps on each rank's stage: the losses equal the
    reference Adam's replay on the sequential stack, and fall."""
    from hetu_tpu import optim
    c = pipe_cases(n)["train"]
    opt = optim.AdamOptimizer(c["lr"])
    layers = jax.tree_util.tree_map(jnp.asarray, c["layers"])
    st = opt.init_state(layers)
    want = []

    def loss_fn(ls):
        return jnp.mean((sequential(ls, c["h"]) - c["y"]) ** 2)
    for _ in range(c["steps"]):
        loss, g = jax.value_and_grad(loss_fn)(layers)
        layers, st = opt.update(g, st, layers)
        want.append(float(loss))
    for s, r in enumerate(worlds[n]):
        got = r["pipe"]["train"]
        np.testing.assert_allclose(got["losses"], want, rtol=1e-4)
        assert got["losses"][-1] < got["losses"][0] * 0.9
        rows = _stage_rows({k: np.asarray(v) for k, v in layers.items()},
                           n, s)
        for k in ("w", "b"):
            np.testing.assert_allclose(got["params"][k][0], rows[k],
                                       rtol=1e-4, atol=1e-5)


def test_stage_params_cross_between_the_packages():
    """``interop.stage_params_from_jax`` gives each rank the stage of the
    reference's stacked tree that ``PipeDream1F1B.local_stage`` takes,
    and ``stage_params_to_jax`` stacks the stages back bitwise."""
    import torch

    from hetu_tpu_torch import interop
    layers = make_layers(40, 4, 3)
    ref = JaxPipeDream(block_fn, ht.make_mesh(pp=2), n_microbatches=2)
    stacked = jax.tree_util.tree_map(np.asarray, ref.stack_params(
        jax.tree_util.tree_map(jnp.asarray, layers)))
    stages = [interop.stage_params_from_jax(stacked, s) for s in range(2)]
    for s, st in enumerate(stages):
        for k in ("w", "b"):
            assert st[k].shape == (1, 2) + layers[k].shape[1:]
            np.testing.assert_array_equal(st[k].numpy(),
                                          layers[k][2 * s:2 * s + 2][None])
    back = interop.stage_params_to_jax(stages)
    for k in ("w", "b"):
        np.testing.assert_array_equal(back[k], stacked[k])
    assert isinstance(stages[0]["w"], torch.Tensor)


# ---------------------------------------------------------------- hetpipe

def test_flatten_params_is_the_references_order():
    import torch
    g = np.random.default_rng(30)
    tree = {"z": g.standard_normal((2, 3)).astype(np.float32),
            "a": {"y": g.standard_normal(4).astype(np.float32),
                  "b": g.standard_normal((2, 2, 2)).astype(np.float32)}}
    want = np.asarray(jax_flatten(jax.tree_util.tree_map(jnp.asarray, tree)))
    as_torch = jax.tree_util.tree_map(torch.tensor, tree)
    np.testing.assert_array_equal(hetpipe.flatten_params(as_torch), want)
    np.testing.assert_array_equal(hetpipe.flatten_params(tree), want)
    back = hetpipe.unflatten_params(want, as_torch)
    ref_back = jax_unflatten(want, jax.tree_util.tree_map(jnp.asarray, tree))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(ref_back)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        hetpipe.unflatten_params(want[:-1], as_torch)


def _whole_flat(res, n_stages):
    """Each wave's whole flat vector, from the ranks' stage rows."""
    n = len(res[0]["params"])
    total = sum(r["rows"].size for r in res)
    out = []
    for i in range(n):
        v = np.zeros(total, np.float32)
        for r in res:
            v[r["rows"]] = r["params"][i]
        out.append(v)
    return out


def test_single_worker_sync_every_wave_matches_flush_sgd(worlds):
    c = het_cases()["flush"]
    res = [r["het"]["flush"] for r in worlds[2]]
    layers = jax.tree_util.tree_map(jnp.asarray, c["layers"])

    def loss_fn(ls):
        return jnp.mean((sequential(ls, c["h"]) - c["y"]) ** 2)
    stages = _whole_flat(res, 2)
    for wave in range(c["waves"]):
        loss, g = jax.value_and_grad(loss_fn)(layers)
        layers = jax.tree_util.tree_map(lambda w, gg: w - c["lr"] * gg,
                                        layers, g)
        for r in res:
            assert r["error"] is None
            np.testing.assert_allclose(r["losses"][wave], float(loss),
                                       rtol=1e-5)
        want = np.asarray(jax_flatten(
            {k: v.reshape(2, -1, *v.shape[1:]) for k, v in layers.items()}))
        np.testing.assert_allclose(stages[wave], want, rtol=1e-4, atol=1e-5)


def test_local_lookahead_between_syncs(worlds):
    """Wave 1 moves only the local weights by local SGD (the server's rows
    stay the published ones); wave 2 pushes the SUM of both waves'
    gradients, and the local weights become the server's."""
    c = het_cases()["lookahead"]
    res = [r["het"]["lookahead"] for r in worlds[2]]
    layers = jax.tree_util.tree_map(jnp.asarray, c["layers"])

    def loss_fn(ls):
        return jnp.mean((sequential(ls, c["h"]) - c["y"]) ** 2)

    def flat(ls):
        return np.asarray(jax_flatten(
            {k: v.reshape(2, -1, *v.shape[1:]) for k, v in ls.items()}))
    w0 = flat(layers)
    _, g1 = jax.value_and_grad(loss_fn)(layers)
    w1 = jax.tree_util.tree_map(lambda w, g: w - c["local_lr"] * g, layers,
                                g1)
    _, g2 = jax.value_and_grad(loss_fn)(w1)
    server = jax.tree_util.tree_map(lambda w, a, b: w - c["lr"] * (a + b),
                                    layers, g1, g2)
    local = _whole_flat(res, 2)
    srv = [np.zeros_like(w0), np.zeros_like(w0)]
    for r in res:
        for i in range(2):
            srv[i][r["rows"]] = r["server"][i]
    np.testing.assert_allclose(local[0], flat(w1), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(srv[0], w0)          # server untouched
    assert np.abs(local[0] - w0).max() > 0            # moved locally
    np.testing.assert_array_equal(local[1], srv[1])    # local == global
    np.testing.assert_allclose(srv[1], flat(server), rtol=1e-5, atol=1e-6)
    assert np.abs(srv[1] - w0).max() > 0


def test_two_virtual_workers_converge_with_ssp(worlds):
    res = [r["two"] for r in worlds[4]]
    by_worker = {}
    for r in res:
        by_worker.setdefault(r["worker"], r["losses"])
        # the ranks of one worker see the same wave losses
        np.testing.assert_array_equal(by_worker[r["worker"]], r["losses"])
    first = by_worker[0][0] + by_worker[1][0]
    last = by_worker[0][-1] + by_worker[1][-1]
    assert last < first * 0.8, (first, last)
    for r in res:
        c0, c1 = r["clocks"]
        assert c0 == c1 == 12  # each worker clocked once a wave
        assert abs(c0 - c1) <= 2


def test_ssp_staleness_bound_trips_on_every_rank(worlds):
    """The peer never clocks: wave 1 is within staleness 1, wave 2 trips
    the bound after the timeout, on both ranks of the worker."""
    for r in worlds[2]:
        got = r["het"]["stale"]
        assert len(got["losses"]) == 1
        assert got["error"] is not None and "staleness" in got["error"]
