"""The rest of the MoE gates of hetu_tpu_torch (hash, k-top-1, balanced
assignment, SAM) against hetu_tpu on the CPU.

Mirrored here: ``tests/test_moe.py``'s gate shapes and validity, the
balanced assignment's balance, the gather dispatch against the einsum
dispatch and the dropped-routes metric, for the four gates, across the
packages.  Weights are drawn with numpy from a seed in the JAX package's
tree and fed to the port through ``interop.params_from_jax``; the inputs
are numpy arrays.  On the CPU the port's kernel wrappers take their plain
versions; the reference takes its XLA paths.

Tolerances, f32: routes (expert indices) equal, and ``dropped_frac``
equal exactly; gates, outputs and losses 1e-5 relative plus 1e-6 times
the larger of 1 and the tensor's largest element (sums in another order);
every gradient, the input's included, within 1e-5 of its largest element
(``GRAD_TOL``).  The balanced assignment's routes may differ only at a
near tie of its Sinkhorn iterate, by the rule of ``chip_smoke.py``
(``balance_near_ties``: the top two entries of a row within 16 x iters
f32 ulps of the row's largest magnitude), fixed before these tests ran;
the count of such rows is printed.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from hetu_tpu.layers import moe as jmoe
from hetu_tpu.ops import moe_ops as jops
from hetu_tpu.ops import reduce as jreduce
from hetu_tpu_torch import interop, ops
from hetu_tpu_torch.layers import (
    BalanceAssignmentGate, Expert, HashGate, KTop1Gate, MoELayer, SAMGate,
    TopKGate,
)

torch.set_num_threads(2)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

T, D, E, F = 64, 16, 4, 32
RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-5
GATES = ("hash", "ktop1", "balance", "sam")


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    atol = ATOL * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _gates(kind, k=2):
    """The reference's gate and the port's of the same widths."""
    gen = torch.Generator().manual_seed(0)
    return {"hash": (jmoe.HashGate(E), HashGate(E)),
            "ktop1": (jmoe.KTop1Gate(D, E, k),
                      KTop1Gate(D, E, k, generator=gen)),
            "balance": (jmoe.BalanceAssignmentGate(D, E),
                        BalanceAssignmentGate(D, E, generator=gen)),
            "sam": (jmoe.SAMGate(D, E), SAMGate(D, E, generator=gen)),
            "topk": (jmoe.TopKGate(D, E, k, impl="xla"),
                     TopKGate(D, E, k, generator=gen, impl="xla"))}[kind]


def _load_gate(jgate, gate, seed):
    """The reference's initial gate parameters, loaded into the port's."""
    if isinstance(jgate, jmoe.HashGate):
        return {}
    p = jgate.init(jax.random.PRNGKey(seed))["params"]
    for name, w in p.items():
        getattr(gate, name).data.copy_(torch.from_numpy(np.array(w)))
    return p


def _tokens(seed, n=T):
    g = np.random.default_rng(seed)
    return g.standard_normal((n, D)).astype(np.float32)


def _ids(seed, n=T, lo=-40, hi=300):
    return np.random.default_rng(seed).integers(lo, hi, n)


def _gate_inputs(kind, seed):
    if kind == "hash":
        ids = _ids(seed)
        return jnp.asarray(ids, jnp.int32), torch.from_numpy(ids)
    x = _tokens(seed)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("kind,k", [("hash", 1), ("ktop1", 2), ("ktop1", 4),
                                    ("balance", 1), ("sam", 1)])
def test_gate_matches_the_reference(kind, k):
    """(gates, idx, aux) of each gate against the reference's; the
    shapes and validity of ``tests/test_moe.py``'s gate test."""
    jgate, gate = _gates(kind, k)
    p = _load_gate(jgate, gate, seed=3)
    jin, tin = _gate_inputs(kind, seed=4)
    (jg, ji, jaux), _ = jgate.apply({"params": p, "state": {}}, jin)
    g, i, aux = gate(tin)
    assert g.shape == (T, k) and i.shape == (T, k)
    assert g.dtype == torch.float32 and i.dtype == torch.int32
    assert 0 <= int(i.min()) and int(i.max()) < E
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    _close(g.detach().numpy(), jg)
    assert float(aux) == float(jaux) == 0.0


def test_hash_mod_of_negative_ids_floors():
    """A negative id maps into [0, E) as jnp's ``%`` does (torch.fmod
    would not)."""
    ids = np.array([-9, -5, -4, -1, 0, 3, 4, 7, 2 ** 31 - 1, -(2 ** 31)])
    (_, ji, _), _ = jmoe.HashGate(E).apply(
        {}, jnp.asarray(ids, jnp.int32))
    _, i, _ = HashGate(E)(torch.from_numpy(ids))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(i.numpy()[:, 0], np.mod(ids, E))
    assert np.asarray(ji).min() >= 0


def test_ktop1_takes_the_first_maximum_of_a_group_on_ties():
    """Columns 0 and 1 (the first group) and 2 and 3 (the second) are
    equal, so every token ties in both groups: both packages pick the
    group's first expert."""
    jgate, gate = _gates("ktop1", 2)
    p = _load_gate(jgate, gate, seed=5)
    w = np.asarray(p["gate_w"]).copy()
    w[:, 1], w[:, 3] = w[:, 0], w[:, 2]
    gate.gate_w.data.copy_(torch.from_numpy(w))
    x = _tokens(6)
    (jg, ji, _), _ = jgate.apply({"params": {"gate_w": jnp.asarray(w)},
                                  "state": {}}, jnp.asarray(x))
    g, i, _ = gate(torch.from_numpy(x))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(i.numpy(), np.tile([0, 2], (T, 1)))
    _close(g.detach().numpy(), jg)


def _jax_log_plan(scores, iters):
    logp = scores - jnp.max(scores, axis=-1, keepdims=True)

    def body(_, lp):
        lp = lp - jax.nn.logsumexp(lp, axis=0, keepdims=True)
        return lp - jax.nn.logsumexp(lp, axis=1, keepdims=True)

    return lax.fori_loop(0, iters, body, logp)


@pytest.mark.parametrize("t,e,iters", [(64, 4, 20), (512, 8, 20),
                                       (2048, 8, 50)])
def test_balance_assignment_matches_the_reference_but_at_near_ties(
        t, e, iters):
    """The Sinkhorn routes against the reference's: equal except where the
    reference's iterate has a near tie (the rule fixed beforehand); the
    iterates themselves within that rule's bound of each other."""
    g = np.random.default_rng(t + e)
    scores = (2 * g.standard_normal((t, e))).astype(np.float32)
    want = np.asarray(jops.balance_assignment(jnp.asarray(scores),
                                              iters=iters))
    lp_ref = torch.from_numpy(np.asarray(
        _jax_log_plan(jnp.asarray(scores), iters)))
    got = ops.balance_assignment(torch.from_numpy(scores), iters=iters)
    lp = ops.balance_log_plan(torch.from_numpy(scores), iters=iters)
    eps = np.finfo(np.float32).eps
    bound = chip_smoke.BALANCE_TIE_ULPS * iters * eps \
        * lp_ref.abs().amax(-1, keepdim=True)
    assert bool(((lp - lp_ref).abs() <= bound / 2).all())
    near = chip_smoke.balance_near_ties(lp_ref, iters)
    flips = (got.numpy() != want)
    print(f"[{t}x{e}, {iters} rounds] routes otherwise: {int(flips.sum())}, "
          f"rows at a near tie: {int(near.sum())}")
    assert not (flips & ~near.numpy()).any()
    assert got.dtype == torch.int64 and got.shape == (t,)


def test_balance_assignment_is_balanced():
    """``tests/test_moe.py``'s balance check, on the port."""
    g = np.random.default_rng(2)
    scores = torch.from_numpy(g.standard_normal((32, 4)).astype(np.float32))
    counts = np.bincount(ops.balance_assignment(scores, iters=50).numpy(),
                         minlength=4)
    assert counts.max() <= 2 * counts.min() + 4, counts


def test_near_tie_rule_flags_only_rows_within_its_bound():
    iters = chip_smoke.GATES_ITERS
    unit = chip_smoke.BALANCE_TIE_ULPS * iters * np.finfo(np.float32).eps
    lp = torch.tensor([[-0.5, -0.5 - 0.9 * unit * 4.0, -4.0],
                       [-0.5, -0.5 - 1.1 * unit * 4.0, -4.0],
                       [-0.1, -3.0, -4.0]], dtype=torch.float32)
    assert chip_smoke.balance_near_ties(lp, iters).tolist() == \
        [True, False, False]
    with pytest.raises(chip_smoke.SmokeFailure, match="away from a near"):
        chip_smoke.route_flips("balance", torch.tensor([[0], [0], [0]]),
                               torch.tensor([[1], [1], [0]]), lp)
    assert chip_smoke.route_flips("balance", torch.tensor([[0], [0], [0]]),
                                  torch.tensor([[1], [0], [0]]), lp) == (1, 1)
    with pytest.raises(chip_smoke.SmokeFailure, match="away from a near"):
        chip_smoke.route_flips("sam", torch.tensor([[0]]), torch.tensor([[1]]))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_sam_group_sum_and_max_match_the_reference(dtype):
    """Segment sum and max, with an empty segment (id 3 never occurs) and
    an id out of range (dropped by both): the sum's empty segment is 0,
    the max's -inf for a float and the type's minimum for an integer."""
    g = np.random.default_rng(7)
    x = g.standard_normal((40, 5)).astype(np.float32) * 10
    x = x.astype(dtype)
    idx = g.choice([0, 1, 2, 4, 5], size=40)
    idx[7] = 6  # out of range of the 6 segments: dropped
    for jfn, fn in ((jreduce.sam_group_sum, ops.sam_group_sum),
                    (jreduce.sam_max, ops.sam_max)):
        want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(idx), 6))
        got = fn(torch.from_numpy(x), torch.from_numpy(idx), 6).numpy()
        assert got.dtype == want.dtype
        if dtype == np.float32:
            _close(got, want)
        else:
            np.testing.assert_array_equal(got, want)
    empty_max = ops.sam_max(torch.from_numpy(x), torch.from_numpy(idx), 6)[3]
    lowest = -np.inf if dtype == np.float32 else np.iinfo(dtype).min
    assert (empty_max.numpy() == lowest).all()
    assert not ops.sam_group_sum(torch.from_numpy(x), torch.from_numpy(idx),
                                 6)[3].any()


def test_sam_group_sum_is_differentiable():
    x = torch.from_numpy(_tokens(8)).requires_grad_()
    idx = torch.from_numpy(np.random.default_rng(8).integers(0, E, T))
    w = torch.randn(E, D, generator=torch.Generator().manual_seed(0))
    (ops.sam_group_sum(x, idx, E) * w).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), w[idx].numpy())


def _layers(kind, cf, dispatch_impl="gather"):
    """The reference's MoELayer with gate ``kind`` and the port's, with the
    reference's initial weights loaded through interop."""
    jgate, gate = _gates(kind)
    jlayer = jmoe.MoELayer(jgate, jmoe.Expert(E, D, F), capacity_factor=cf,
                           dispatch_impl=dispatch_impl)
    layer = MoELayer(gate, Expert(E, D, F,
                                  generator=torch.Generator().manual_seed(0)),
                     capacity_factor=cf, dispatch_impl=dispatch_impl)
    params = jlayer.init(jax.random.PRNGKey(11))["params"]
    layer.load_state_dict(interop.params_from_jax(params, layer))
    return jlayer, layer, params


def _layer_run(kind, cf, dispatch_impl="gather"):
    """Output, loss, metrics and every gradient (and the input's) of both
    packages' layers on the same tokens (hash: routed by ids)."""
    jlayer, layer, params = _layers(kind, cf, dispatch_impl)
    x = _tokens(12)
    ids = _ids(13)
    jgi = jnp.asarray(ids, jnp.int32) if kind == "hash" else None
    gi = torch.from_numpy(ids) if kind == "hash" else None

    def jloss(p, xx):
        (y, aux, m), _ = jlayer.apply({"params": p, "state": {}}, xx,
                                      gate_input=jgi, return_metrics=True)
        return jnp.sum(y * y) + aux, (y, m)

    (jl, (jy, jm)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y, aux, m = layer(xt, gate_input=gi, return_metrics=True)
    loss = (y * y).sum() + aux
    grads = torch.autograd.grad(loss, [*layer.parameters(), xt])
    names = [n for n, _ in layer.named_parameters()]
    tree = interop.params_to_jax(dict(zip(names, grads[:-1])), layer)
    return dict(jl=jl, jy=jy, jm=jm, jgp=jgp, jgx=jgx, loss=loss, y=y, m=m,
                tree=tree, gx=grads[-1])


def _grads_close(r):
    leaves = jax.tree_util.tree_flatten_with_path(r["jgp"])[0]
    assert leaves
    for path, want in leaves:
        got = r["tree"]
        for key in path:
            got = got[key.key]
        want = np.asarray(want)
        np.testing.assert_allclose(
            got, want, rtol=0,
            atol=GRAD_TOL * max(1e-30, float(np.abs(want).max())))
    want = np.asarray(r["jgx"])
    np.testing.assert_allclose(r["gx"].numpy(), want, rtol=0,
                               atol=GRAD_TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("kind", GATES)
@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_moe_layer_matches_jax_grad(kind, cf):
    """MoELayer with each gate (the hash gate by ``gate_input``): output,
    loss and every gradient against ``jax.grad`` of the reference; with
    capacity factor 0.5 routes overflow, and ``dropped_frac`` is equal."""
    r = _layer_run(kind, cf)
    assert float(r["m"]["dropped_frac"]) == float(r["jm"]["dropped_frac"])
    if cf == 0.5:
        assert float(r["m"]["dropped_frac"]) > 0
    _close(r["y"].detach().numpy(), r["jy"])
    _close(float(r["loss"].detach()), float(r["jl"]))
    _grads_close(r)


@pytest.mark.parametrize("kind", GATES)
def test_gather_dispatch_matches_einsum(kind):
    """``tests/test_moe.py``'s gather-against-einsum check, under overflow,
    for each gate: the two dispatches give the same loss and gradients in
    the port, and the einsum dispatch equals the reference's."""
    g = _layer_run(kind, 0.5, "gather")
    e = _layer_run(kind, 0.5, "einsum")
    _close(float(e["loss"].detach()), float(g["loss"].detach()))
    _close(e["gx"].numpy(), g["gx"].numpy(), rtol=1e-4)
    assert float(e["m"]["dropped_frac"]) == float(g["jm"]["dropped_frac"])
    _grads_close(e)


def test_capacity_counts_k_of_one_for_a_gate_without_k():
    """capacity = int(cf * T * k / E) with k = getattr(gate, "k", 1): a
    hash layer of cf 1.0 holds T / E routes an expert, so ids all on one
    expert keep exactly that many."""
    _, layer, _ = _layers("hash", 1.0)
    ids = torch.full((T,), 3)
    _, _, m = layer(torch.from_numpy(_tokens(1)), gate_input=ids,
                    return_metrics=True)
    assert float(m["dropped_frac"]) == 1 - (T // E) / T


@pytest.mark.parametrize("kind", ["topk", *GATES])
def test_interop_round_trip(kind):
    """A bare MoELayer's parameters, both ways: the reference's tree →
    state_dict → the same tree, bit for bit (the hash gate's subtree is
    empty)."""
    _, layer, params = _layers(kind, 1.25)
    back = interop.params_to_jax(layer.state_dict(), layer)
    want = jax.tree_util.tree_map(np.asarray, params)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    if kind == "hash":
        assert back["gate"] == {}
    names = {"sam": "gate.centroids", "hash": None}.get(kind, "gate.gate_w")
    if names:
        assert names in layer.state_dict()


def test_gates_phase_weights_are_the_references_tree():
    """chip_smoke.py's seeded weights for the gates phase have the
    reference's tree, shapes and initialisers' scales."""
    d, e = chip_smoke.MOE_H, chip_smoke.MOE_E
    jgates = {"hash": jmoe.HashGate(e), "ktop1": jmoe.KTop1Gate(d, e, 2),
              "balance": jmoe.BalanceAssignmentGate(d, e),
              "sam": jmoe.SAMGate(d, e)}
    for kind in GATES:
        tree = chip_smoke.gates_jax_layout_weights(kind, 0)
        ref = jax.eval_shape(jmoe.MoELayer(jgates[kind], jmoe.Expert(
            e, d, chip_smoke.GATES_FFN)).init, jax.random.PRNGKey(0))
        shapes = jax.tree_util.tree_map(lambda a: a.shape, ref["params"])
        assert jax.tree_util.tree_map(np.shape, tree) == shapes
        for name, w in tree["gate"].items():  # Xavier-uniform's limit
            assert np.abs(w).max() <= np.sqrt(6.0 / sum(w.shape))
