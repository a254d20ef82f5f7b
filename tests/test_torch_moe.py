"""The MoE training slice of hetu_tpu_torch against hetu_tpu on the CPU.

Weights and inputs are drawn with numpy from a seed in the JAX package's
layout and fed to both packages (into the port through
``interop.params_from_jax`` or ``load_state_dict``).  On the CPU the port's
kernel wrappers take their plain versions; the reference takes its XLA
paths (``routed_gather`` and ``lax.top_k``).

Tolerances, f32: routing tables, dispatched rows and expert indices equal;
outputs, losses and gradients 1e-5 relative plus 1e-6 times the larger of
1 and the tensor's largest element (sums in another order: the expert
products, the combine's and the gate's softmax); the model's gradients
within 1e-5 of each parameter's largest element (``GRAD_TOL``); after 5
AdamW steps, parameters and slots 1e-4 relative plus the gap that AdamW can
make of gradients that far apart (below).  bf16: the model's forward is
bitwise the reference's up to the gate (the same routes), but gradients
rounded to bf16 in sums with cancellation land a few percent of their
largest element from the f32 gradients in both packages, so the port's
bf16 loss and gradients are held to the reference's own bf16 error
against its f32 run (see the test).  The executor runs AdamW with eps
1e-3, as the GPT parity test does: the key bias's gradient is rounding
noise that Adam would scale to full steps.

AdamW's bound.  An element's update is u = mhat / (s + eps) + wd * p with
s = sqrt(vhat).  After the bias corrections, mhat is a weighted mean and s
a weighted root-mean-square of the gradients so far (weights summing to
1), so gradients that differ by at most delta move each by at most delta,
and since |mhat| <= s (to 1 % over 5 steps at betas 0.9 and 0.999), u moves
by at most delta * (2 s + eps) / (s + eps)^2 <= delta / eps.  The bound is
reached where the gradient is of the size of eps or below: there Adam
turns a rounding gap into a step (a relative error of the gradient does
not pass through unchanged).  So after T steps of lr a parameter lies
within lr / eps * sum_t delta_t of the reference's, with delta_t the
gradient bound at step t: GRAD_TOL times the leaf's largest gradient G_t
(the weight decay's lr * wd share of a gap is inside the relative term).
The slots: m = sum_t (1 - b1) b1^(T-t) g_t moves by at most max_t delta_t,
v = sum_t (1 - b2) b2^(T-t) g_t^2 by at most (1 - b2) sum_t (2 G_t +
delta_t) delta_t.  The test checks the premise at every step: at the
reference's parameters the port's gradient lies within delta_t of the
reference's.  Along the two runs the parameters drift apart within those
bounds, which moves later gradients further apart than delta_t; measured
here, the drift leaves the final gaps at most 0.035 (parameters), 0.18
(m) and 0.16 (v) of their bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adamw_bound import adamw_atol, flat, get
from hetu_tpu import rng as jax_rng
from hetu_tpu.layers import moe as jmoe_layers
from hetu_tpu.models.moe_transformer import MoEConfig as JaxMoEConfig
from hetu_tpu.models.moe_transformer import MoETransformer as JaxMoE
from hetu_tpu.ops import moe_ops as jmoe
from hetu_tpu.optim import AdamWOptimizer as JaxAdamW
from hetu_tpu.train import Executor as JaxExecutor
from hetu_tpu.train import checkpoint as jax_checkpoint
from hetu_tpu_torch import interop, ops
from hetu_tpu_torch import rng as torch_rng
from hetu_tpu_torch.layers import Expert, MoELayer, TopKGate
from hetu_tpu_torch.models import MoEConfig, MoETransformer
from hetu_tpu_torch.ops.cuda_kernels import (
    embedding_gather, embedding_scatter_add, topk_gating,
)
from hetu_tpu_torch.optim import AdamWOptimizer
from hetu_tpu_torch.train import Executor, checkpoint

torch.set_num_threads(2)

V, H, L, NH, FFN, E, K, P, B, S = 97, 32, 2, 4, 64, 4, 2, 32, 2, 16
RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-5  # the model's gradients, relative to each leaf's largest
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(autouse=True)
def _keep_global_rng_status():
    saved = jax_rng.get_seed_status(), torch_rng.get_seed_status()
    yield
    jax_rng.set_seed_status(*saved[0])
    torch_rng.set_seed_status(*saved[1])


def _r(g, *shape, scale=0.1, loc=0.0):
    return (loc + scale * g.standard_normal(shape)).astype(np.float32)


def gate_expert_params(g, h=H, e=E, f=FFN):
    """A MoE layer's parameters in the reference's layout; biases random
    too, so a swapped or untransposed tensor cannot go unnoticed."""
    return {"gate": {"gate_w": _r(g, h, e, scale=1.0)},
            "experts": {"w1": _r(g, e, h, f, scale=0.3), "b1": _r(g, e, f),
                        "w2": _r(g, e, f, h, scale=0.2), "b2": _r(g, e, h)}}


def model_params(seed=0):
    g = np.random.default_rng(seed)
    p = {"tok_emb": _r(g, V, H, scale=0.1), "pos_emb": _r(g, P, H, scale=0.1)}
    for layer in range(L):
        p[f"layer{layer}"] = {
            "attn": {"qkv_weight": _r(g, H, 3 * H, scale=0.2),
                     "qkv_bias": _r(g, 3 * H),
                     "out_weight": _r(g, H, H, scale=0.2),
                     "out_bias": _r(g, H)},
            "ln1": {"scale": _r(g, H, loc=1.0), "bias": _r(g, H)},
            "ln2": {"scale": _r(g, H, loc=1.0), "bias": _r(g, H)},
            "moe": gate_expert_params(g)}
    return p


def _ids(seed=1):
    return np.random.default_rng(seed).integers(0, V, (B, S)).astype(
        np.int32)


def _tree(fn, t):
    return {k: _tree(fn, v) for k, v in t.items()} \
        if isinstance(t, dict) else fn(t)


def _assert_tree_close(got, want, rtol, atol, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_close(got[k], want[k], rtol, atol, f"{path}/{k}")
    else:
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(want, np.float32), rtol=rtol,
                                   atol=atol, err_msg=path)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rtol=RTOL, err_msg=""):
    """Within ``rtol`` relative plus ``ATOL`` times the larger of 1 and the
    largest element of ``want`` (sums of many terms round in proportion
    to the values summed)."""
    got, want = _np(got), _np(want)
    atol = ATOL * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=err_msg)


# ------------------------------------------------------------ routing ops

def _routing_inputs(t=64, seed=2):
    """Gates [T, K] and distinct expert choices [T, K] per token."""
    g = np.random.default_rng(seed)
    idx = np.stack([g.permutation(E)[:K] for _ in range(t)]).astype(np.int32)
    gates = g.random((t, K)).astype(np.float32)
    return gates, idx


@pytest.mark.parametrize("capacity", [4, 16, 40])  # heavy, some, no drops
def test_slot_routing_matches_jax(capacity):
    gates, idx = _routing_inputs()
    want = jmoe.make_slot_routing(jnp.asarray(gates), jnp.asarray(idx), E,
                                  capacity)
    got = ops.make_slot_routing(torch.from_numpy(gates),
                                torch.from_numpy(idx), E, capacity)
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got[2]) == int(want[2])


def test_gather_dispatch_and_combine_match_jax():
    capacity = 16
    g = np.random.default_rng(3)
    gates, idx = _routing_inputs()
    tokens = _r(g, 64, H, scale=1.0)
    y = _r(g, E, capacity, H, scale=1.0)
    w = _r(g, 64, H, scale=1.0)
    slot_token, token_slot, _ = jmoe.make_slot_routing(
        jnp.asarray(gates), jnp.asarray(idx), E, capacity)

    def jfn(x, ye, gt):
        xe = jmoe.gather_dispatch(x, slot_token, E, capacity)
        out = jmoe.gather_combine(ye, token_slot, gt)
        return jnp.sum(xe * xe) + jnp.sum(out * w), (xe, out)

    (_, (j_xe, j_out)), j_grads = jax.value_and_grad(
        jfn, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(tokens), jnp.asarray(y), jnp.asarray(gates))
    t_args = [torch.from_numpy(a).requires_grad_() for a in (tokens, y,
                                                             gates)]
    st = torch.from_numpy(np.array(slot_token))
    ts = torch.from_numpy(np.array(token_slot))
    xe = ops.gather_dispatch(t_args[0], st, E, capacity)
    out = ops.gather_combine(t_args[1], ts, t_args[2])
    loss = (xe * xe).sum() + (out * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(loss, t_args)
    np.testing.assert_array_equal(_np(xe), _np(j_xe))
    _close(out, j_out)
    for a, b in zip(grads, j_grads):
        _close(a, b)


def test_dense_masks_and_layout_transforms_match_jax():
    capacity = 16
    g = np.random.default_rng(4)
    gates, idx = _routing_inputs()
    tokens = _r(g, 64, H, scale=1.0)
    y = _r(g, E, capacity, H, scale=1.0)
    jd, jc = jmoe.make_dispatch_combine(jnp.asarray(gates), jnp.asarray(idx),
                                        E, capacity)
    td, tc = ops.make_dispatch_combine(torch.from_numpy(gates),
                                       torch.from_numpy(idx), E, capacity)
    np.testing.assert_array_equal(_np(td), _np(jd))
    np.testing.assert_array_equal(_np(tc), _np(jc))
    _close(ops.layout_transform(torch.from_numpy(tokens), td),
           jmoe.layout_transform(jnp.asarray(tokens), jd))
    _close(ops.reverse_layout_transform(torch.from_numpy(y), tc),
           jmoe.reverse_layout_transform(jnp.asarray(y), jc))


# ------------------------------------------------------------------ layers

def _torch_gate(params, impl="auto", k=K):
    gate = TopKGate(H, E, k, generator=torch.Generator(), impl=impl)
    gate.load_state_dict({"gate_w": torch.from_numpy(params["gate_w"])})
    return gate


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("impl", ["auto", "xla", "pallas"])
def test_topk_gate_matches_jax(impl, dtype):
    g = np.random.default_rng(5)
    params = gate_expert_params(g)["gate"]
    tokens = torch.from_numpy(_r(g, 64, H, scale=1.0)).to(dtype)
    jgate = jmoe_layers.TopKGate(H, E, K, impl=impl)
    (jg, ji, jaux), _ = jgate.apply(
        {"params": _tree(jnp.asarray, params), "state": {}},
        jnp.asarray(tokens.float().numpy(), JDT[dtype]))
    gate = _torch_gate(params, impl)
    assert gate.uses_kernel == (impl != "xla")
    before = topk_gating.launches
    with torch.no_grad():
        tg, ti, taux = gate(tokens)
    assert topk_gating.launches == before  # CPU: the plain version
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tg, jg)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=RTOL)


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_topk_gate_on_an_untileable_token_count(impl):
    """T = 12 divides by no power-of-two block >= 8.  The reference's tiled
    kernel cannot take it ("auto" takes lax.top_k there, "pallas" raises);
    the port's kernel takes any T, so both names choose it, and the gate
    agrees with the reference's "auto"."""
    g = np.random.default_rng(6)
    params = gate_expert_params(g)["gate"]
    tokens = _r(g, 12, H, scale=1.0)
    gate = _torch_gate(params, impl)
    assert gate.uses_kernel
    with torch.no_grad():
        tg, ti, taux = gate(torch.from_numpy(tokens))
    (jg, ji, jaux), _ = jmoe_layers.TopKGate(H, E, K, impl="auto").apply(
        {"params": _tree(jnp.asarray, params), "state": {}},
        jnp.asarray(tokens))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tg, jg)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=RTOL)
    with pytest.raises(ValueError, match="impl"):
        TopKGate(H, E, K, generator=torch.Generator(), impl="triton")


@pytest.mark.cuda
@pytest.mark.parametrize("t", [12, 64])
def test_topk_gate_launches_its_kernel_at_any_token_count_on_the_card(t):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    params = gate_expert_params(np.random.default_rng(6))["gate"]
    gate = _torch_gate(params).to("cuda")
    plain = _torch_gate(params, "xla").to("cuda")
    tokens = torch.randn(t, H, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(0))
    before = topk_gating.launches
    with torch.no_grad():
        gates, idx, _ = gate(tokens)
        p_gates, p_idx, _ = plain(tokens)
    assert topk_gating.launches == before + 1
    assert torch.equal(idx, p_idx)
    torch.testing.assert_close(gates, p_gates, rtol=0, atol=1e-6)


def _torch_expert(params, dtype):
    ex = Expert(E, H, FFN, generator=torch.Generator(), dtype=dtype)
    ex.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return ex


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_matches_jax(dtype):
    """f32 products of the compute type's operands, forward and backward:
    the operands and their gradients round at the same points in both
    packages."""
    g = np.random.default_rng(7)
    params = gate_expert_params(g)["experts"]
    xe = _r(g, E, 8, H, scale=1.0)
    w = _r(g, E, 8, H, scale=1.0)
    jex = jmoe_layers.Expert(E, H, FFN, dtype=JDT[dtype])

    def jloss(p, x):
        y, _ = jex.apply({"params": p, "state": {}}, x)
        return jnp.sum(y * w), y

    (_, jy), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        _tree(jnp.asarray, params), jnp.asarray(xe))
    # bf16: the operands' gradients are rounded to bf16, where a sum taken
    # in another order may land one ulp (2^-7 of the value, at most) away
    rtol = RTOL if dtype == torch.float32 else 2 ** -7
    ex = _torch_expert(params, dtype)
    x = torch.from_numpy(xe).requires_grad_()
    y = ex(x)
    assert y.dtype == torch.float32
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum(),
                                [x, *ex.parameters()])
    _close(y, jy, rtol)
    _close(grads[0], jgx, rtol)
    for (name, _), gr in zip(ex.named_parameters(), grads[1:]):
        _close(gr, jgp[name], rtol, err_msg=name)


@pytest.mark.parametrize("cf", [0.5, 1.25])
@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
def test_moe_layer_matches_jax(dispatch, cf):
    g = np.random.default_rng(8)
    params = gate_expert_params(g)
    x = _r(g, 4, 16, H, scale=1.0)
    w = _r(g, 4, 16, H, scale=1.0)
    jlayer = jmoe_layers.MoELayer(jmoe_layers.TopKGate(H, E, K),
                                  jmoe_layers.Expert(E, H, FFN),
                                  capacity_factor=cf, dispatch_impl=dispatch)

    def jloss(p, xx):
        (y, aux, met), _ = jlayer.apply({"params": p, "state": {}}, xx,
                                        return_metrics=True)
        return jnp.sum(y * w) + aux, (y, aux, met)

    (_, (jy, jaux, jmet)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(_tree(jnp.asarray, params),
                                             jnp.asarray(x))
    layer = MoELayer(_torch_gate(params["gate"]),
                     _torch_expert(params["experts"], torch.float32),
                     capacity_factor=cf, dispatch_impl=dispatch)
    xt = torch.from_numpy(x).requires_grad_()
    y, aux, met = layer(xt, return_metrics=True)
    assert y.shape == xt.shape
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum() + aux,
                                [xt, *layer.parameters()])
    _close(y, jy)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL)
    assert float(met["dropped_frac"]) == float(jmet["dropped_frac"])
    assert (float(met["dropped_frac"]) > 0) == (cf < 1)
    _close(grads[0], jgx)
    want = {f"{mod}.{n}": v for mod, d in jgp.items() for n, v in d.items()}
    for (name, _), gr in zip(layer.named_parameters(), grads[1:]):
        _close(gr, want[name], err_msg=name)


def test_moe_layer_refuses_a_mesh_and_unknown_dispatch():
    params = gate_expert_params(np.random.default_rng(9))
    gate = _torch_gate(params["gate"])
    ex = _torch_expert(params["experts"], torch.float32)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        MoELayer(gate, ex, mesh=object())
    with pytest.raises(ValueError, match="dispatch_impl"):
        MoELayer(gate, ex, dispatch_impl="alltoall")


# ------------------------------------------------------------------- model

def _cfg_kw(dtype):
    return dict(vocab_size=V, hidden_size=H, num_layers=L, num_heads=NH,
                ffn_size=FFN, num_experts=E, top_k=K, max_position=P,
                dtype=dtype)


def _torch_model(dtype=torch.float32, seed=0, params=None):
    """The port's model with ``params`` (the reference's layout), or
    :func:`model_params` of ``seed``."""
    cfg = MoEConfig(**_cfg_kw(dtype))
    m = MoETransformer(cfg, device="cpu")
    m.load_state_dict(interop.params_from_jax(
        model_params(seed) if params is None else params, cfg))
    return m


_JAX_FN, _JAX_REF = {}, {}


def _jax_value_and_grad_fn(dtype):
    """The reference's jitted value and gradient of the LM loss on
    :func:`_ids`, at any parameters; compiled once per type."""
    if dtype not in _JAX_FN:
        model = JaxMoE(JaxMoEConfig(**_cfg_kw(JDT[dtype])))
        fn = model.lm_loss_fn()
        ids = jnp.asarray(_ids())
        _JAX_FN[dtype] = jax.jit(jax.value_and_grad(
            lambda p: fn(p, {}, (ids,), None, False), has_aux=True))
    return _JAX_FN[dtype]


def _jax_value_and_grad(dtype):
    if dtype not in _JAX_REF:
        (loss, (metrics, _)), grads = _jax_value_and_grad_fn(dtype)(
            _tree(jnp.asarray, model_params()))
        _JAX_REF[dtype] = (float(loss), _tree(float, metrics),
                           _tree(np.asarray, grads))
    return _JAX_REF[dtype]


def _port_value_and_grad(dtype, params=None):
    model = _torch_model(dtype, params=params)
    params = dict(model.named_parameters())
    loss, (metrics, _) = model.lm_loss_fn()(
        params, {}, (torch.from_numpy(_ids()),), None, True)
    grads = torch.autograd.grad(loss, list(params.values()))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            interop.params_to_jax(dict(zip(params, grads)), model.c))


def test_loss_and_every_gradient_match_jax_f32():
    want_loss, want_metrics, want_grads = _jax_value_and_grad(torch.float32)
    counts = [c.launches for c in (topk_gating, embedding_gather,
                                   embedding_scatter_add)]
    loss, metrics, grads = _port_value_and_grad(torch.float32)
    assert counts == [c.launches for c in (topk_gating, embedding_gather,
                                           embedding_scatter_add)]
    np.testing.assert_allclose(loss, want_loss, rtol=RTOL)
    for k in ("lm_loss", "aux_loss"):
        np.testing.assert_allclose(metrics[k], want_metrics[k], rtol=RTOL)
    for path, g in flat(grads):
        w = get(want_grads, path)
        assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max(), path


def test_loss_and_every_gradient_in_bf16_as_close_as_jax():
    """bf16 against the reference's f32 gradients: the port's error is at
    most 1.5x the reference's own bf16 error, plus 1e-3 of the largest
    element, for the loss and every parameter; and the two bf16 losses
    agree within 1e-3 relative."""
    ref_loss, _, ref_grads = _jax_value_and_grad(torch.float32)
    jax_loss, _, jax_grads = _jax_value_and_grad(torch.bfloat16)
    loss, _, grads = _port_value_and_grad(torch.bfloat16)
    np.testing.assert_allclose(loss, jax_loss, rtol=1e-3)
    assert abs(loss - ref_loss) <= 1.5 * abs(jax_loss - ref_loss) + 1e-4
    for path, g in flat(grads):
        ref = get(ref_grads, path)
        scale = np.abs(ref).max()
        jax_err = np.abs(get(jax_grads, path) - ref).max()
        assert np.abs(g - ref).max() <= 1.5 * jax_err + 1e-3 * scale, path


def test_lm_loss_fn_refuses_foreign_parameters():
    model = _torch_model()
    params = {n: p.detach().clone().requires_grad_()
              for n, p in model.named_parameters()}
    with pytest.raises(ValueError, match="own"):
        model.lm_loss_fn()(params, {}, torch.from_numpy(_ids()), None, True)


def test_interop_round_trip():
    tree = model_params(3)
    cfg = MoEConfig(**_cfg_kw(torch.float32))
    sd = interop.params_from_jax({"params": tree}, cfg)
    assert set(sd) == set(dict(_torch_model().named_parameters()))
    _assert_tree_close(interop.params_to_jax(sd, cfg), tree, 0, 0)
    # the attention weights flip to nn.Linear's [out, in]; the gate and the
    # stacked experts keep the reference's layout
    np.testing.assert_array_equal(sd["layers.1.attn.qkv.weight"].numpy(),
                                  tree["layer1"]["attn"]["qkv_weight"].T)
    np.testing.assert_array_equal(sd["layers.0.moe.gate.gate_w"].numpy(),
                                  tree["layer0"]["moe"]["gate"]["gate_w"])


# ---------------------------------------------------------------- executor

EPS = 1e-3  # see the module docstring
# at lr 1e-2 the gates move so far in 5 steps that a near-tie between two
# experts amplifies the packages' 1e-7 differences to 5e-5 in the loss by
# step 5; at 3e-3 they stay at 2e-7
LR = 3e-3


def _jax_executor(lr=LR):
    model = JaxMoE(JaxMoEConfig(**_cfg_kw(jnp.float32)))
    ex = JaxExecutor(model.lm_loss_fn(), JaxAdamW(lr, eps=EPS), seed=0)
    state = ex.init_state({"params": _tree(jnp.asarray, model_params()),
                           "state": {}})
    return ex, state


def _torch_executor(lr=LR):
    model = _torch_model()
    ex = Executor(model.lm_loss_fn(), AdamWOptimizer(lr, eps=EPS), seed=0)
    return model, ex, ex.init_state(model)


def test_five_adamw_steps_match_the_jax_executor():
    """The loss, lm_loss and aux_loss of every step; at the reference's
    parameters before each step, the port's gradient within GRAD_TOL of
    the reference's; after 5 steps, parameters and slots within AdamW's
    bound of those gradient gaps (module docstring)."""
    ids = _ids()
    jex, js = _jax_executor()
    model, tex, ts = _torch_executor()
    deltas, g_max = [], []  # per step: {leaf: bound}, {leaf: max |G|}
    for step in range(5):
        ref = _tree(np.asarray, js.params)
        want = _tree(np.asarray, _jax_value_and_grad_fn(torch.float32)(
            js.params)[1])
        got = _port_value_and_grad(torch.float32, ref)[2]
        g_max.append({p: np.abs(w).max() for p, w in flat(want)})
        deltas.append({p: GRAD_TOL * g for p, g in g_max[-1].items()})
        for path, g in flat(got):
            assert np.abs(g - get(want, path)).max() <= deltas[-1][path], \
                (step, path)
        js, jm = jex.run("train", js, (jnp.asarray(ids),))
        ts, tm = tex.run("train", ts, (ids,))
        for k in ("loss", "lm_loss", "aux_loss"):
            # the aux loss (about 0.03) is held in the loss's own units
            np.testing.assert_allclose(
                float(tm[k]), float(jm[k]), rtol=RTOL,
                atol=RTOL * float(jm["loss"]) if k == "aux_loss" else 0,
                err_msg=f"step {step} {k}")
    assert ts.step == int(js.step) == 5
    assert float(tm["loss"]) < float(_jax_value_and_grad(torch.float32)[0])
    got = {"params": interop.params_to_jax(ts.params, model.c),
           **interop.opt_state_to_jax(ts.opt_state, model.c)["slots"]}
    want = {"params": _tree(np.asarray, js.params),
            **_tree(np.asarray, js.opt_state["slots"])}
    assert set(got) == set(want) == {"params", "m", "v"}
    for path in deltas[0]:
        atol = adamw_atol([d[path] for d in deltas],
                          [g[path] for g in g_max], LR, EPS)
        for kind in want:
            np.testing.assert_allclose(
                get(got[kind], path), get(want[kind], path), rtol=1e-4,
                atol=atol[kind], err_msg=f"{kind} {'/'.join(path)}")
    assert sorted(p for p, _ in flat(got["params"])) == sorted(deltas[0])


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    ids = _ids()
    jex, js = _jax_executor()
    for _ in range(2):
        js, _ = jex.run("train", js, (jnp.asarray(ids),))
    jax_checkpoint.save(tmp_path / "jax.npz", js)
    model, tex, ts = _torch_executor()
    ts = checkpoint.load(tmp_path / "jax.npz", ts, model.c)
    assert ts.step == 2 and ts.opt_state["step"] == 2
    np.testing.assert_array_equal(ts.rng, np.asarray(js.rng))
    _assert_tree_close(interop.params_to_jax(ts.params, model.c),
                       _tree(np.asarray, js.params), 0, 0)
    js, jm = jex.run("train", js, (jnp.asarray(ids),))
    ts, tm = tex.run("train", ts, (ids,))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=RTOL)


def test_port_checkpoint_loads_into_jax(tmp_path):
    ids = _ids()
    model, tex, ts = _torch_executor()
    for _ in range(2):
        ts, _ = tex.run("train", ts, (ids,))
    checkpoint.save(tmp_path / "port.npz", ts, model.c)
    _, template = _jax_executor()
    js = jax_checkpoint.load(tmp_path / "port.npz", template)
    assert int(js.step) == 2 and int(js.opt_state["step"]) == 2
    _assert_tree_close(_tree(np.asarray, js.params),
                       interop.params_to_jax(ts.params, model.c), 0, 0)
    _assert_tree_close(
        _tree(np.asarray, js.opt_state["slots"]),
        interop.opt_state_to_jax(ts.opt_state, model.c)["slots"], 0, 0)
