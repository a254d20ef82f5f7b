"""The GPT training slice of hetu_tpu_torch against hetu_tpu on the CPU.

One set of GPT parameters, drawn with numpy from a seed in the JAX
package's layout, goes into both packages (into the port through
``interop.params_from_jax``).  Then, in float32 with dropout 0 (dropout
cannot match ``jax.random`` bit for bit):

* the loss of ``lm_loss_fn`` and every gradient, mapped back through
  ``interop.params_to_jax``, match ``jax.value_and_grad`` of the
  reference's ``lm_loss_fn`` for both attention paths ("flash": the Pallas
  kernels in interpret mode against the plain versions of the CUDA
  kernels), fused and unfused CE, and every recomputation setting;
* 5 AdamW steps of the port's ``Executor("train")`` track 5 steps of
  ``hetu_tpu.train.Executor``: the loss of every step, the final
  parameters and both moment slots;
* checkpoints cross between the packages in both directions.

Tolerances: loss 1e-5 relative; gradients 1e-4 relative plus 1e-6
absolute (two layers of f32 sums in another order, and the Pallas
kernels' blocked sums); after 5 AdamW steps, parameters and slots 1e-4
relative plus the gap that AdamW can make of gradients that far apart
(``tests/adamw_bound.py``), as ``tests/test_torch_moe.py`` derives it:
with delta_t the gradient bound of an element at step t and G_t the size
of its gradient, the parameter within lr / eps * sum_t delta_t, m within
max_t delta_t and v within (1 - b2) sum_t (2 G_t + delta_t) delta_t (an
update moves by at most delta / eps, most where the gradient is of the
size of eps).  The test
checks the premise at every step, at the reference's parameters.  The
executor runs AdamW with eps 1e-3: the key bias's gradient is zero but for
rounding (softmax ignores a constant added to a row's scores), about 1e-8
here and different in each package, and with the default eps 1e-7 Adam
scales that noise up to a full step of lr.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adamw_bound import adamw_atol, flat, get
from hetu_tpu import rng as jax_rng
from hetu_tpu.models.gpt import GPTConfig as JaxGPTConfig
from hetu_tpu.models.gpt import GPTModel as JaxGPTModel
from hetu_tpu.optim import AdamWOptimizer as JaxAdamW
from hetu_tpu.train import Executor as JaxExecutor
from hetu_tpu.train import checkpoint as jax_checkpoint
from hetu_tpu_torch import interop
from hetu_tpu_torch import rng as torch_rng
from hetu_tpu_torch.models import GPTConfig, GPTModel
from hetu_tpu_torch.optim import AdamWOptimizer
from hetu_tpu_torch.ops.cuda_kernels import (
    flash_attention, flash_attention_bwd_dkdv, flash_attention_bwd_dq,
)
from hetu_tpu_torch.train import Executor, checkpoint
from hetu_tpu_torch.train.checkpoint import (
    CheckpointCorruptError, CheckpointError,
)

torch.set_num_threads(2)

V, H, L, NH, FFN, P, B, S = 97, 32, 2, 4, 64, 64, 2, 24
CHUNK = 16  # 2 x 23 = 46 loss rows: three chunks, the last one padded
TOL_LOSS, TOL_G, ATOL_G = 1e-5, 1e-4, 1e-6


@pytest.fixture(autouse=True)
def _keep_global_rng_status():
    """Executors and checkpoint loads set both packages' global (seed,
    seqnum); put them back so no other test sees this file's."""
    saved = jax_rng.get_seed_status(), torch_rng.get_seed_status()
    yield
    jax_rng.set_seed_status(*saved[0])
    torch_rng.set_seed_status(*saved[1])


def jax_params(seed=0):
    """Parameters in hetu_tpu's layout; biases and LayerNorm parameters
    random too, so a swapped or untransposed tensor cannot go unnoticed."""
    g = np.random.default_rng(seed)

    def r(*shape, scale=0.1, loc=0.0):
        return (loc + scale * g.standard_normal(shape)).astype(np.float32)

    return {
        "tok_emb": r(V, H, scale=0.5), "pos_emb": r(P, H, scale=0.5),
        "blocks": {
            "attn": {"qkv_weight": r(L, H, 3 * H, scale=0.2),
                     "qkv_bias": r(L, 3 * H),
                     "out_weight": r(L, H, H, scale=0.2),
                     "out_bias": r(L, H)},
            "ln1": {"scale": r(L, H, loc=1.0), "bias": r(L, H)},
            "ffn_in": {"weight": r(L, H, FFN, scale=0.2), "bias": r(L, FFN)},
            "ffn_out": {"weight": r(L, FFN, H, scale=0.15), "bias": r(L, H)},
            "ln2": {"scale": r(L, H, loc=1.0), "bias": r(L, H)},
        },
        "ln_f_scale": r(H, loc=1.0), "ln_f_bias": r(H),
    }


def _ids(seed=1):
    return np.random.default_rng(seed).integers(0, V, (B, S)).astype(
        np.int32)


def _cfg_kw(impl, fused):
    return dict(vocab_size=V, hidden_size=H, num_layers=L, num_heads=NH,
                ffn_size=FFN, max_position=P, dropout_rate=0.0,
                attention_impl=impl, fused_ce=fused, ce_row_chunk=CHUNK)


def _jax_model(impl, fused):
    return JaxGPTModel(JaxGPTConfig(**_cfg_kw(impl, fused)))


def _torch_model(impl, fused, remat="off", seed=0, params=None):
    """The port's model with ``params`` (the reference's layout), or
    :func:`jax_params` of ``seed``."""
    cfg = GPTConfig(**_cfg_kw(impl, fused), remat=remat != "off",
                    remat_policy="full" if remat == "off" else remat)
    m = GPTModel(cfg, device="cpu")
    m.load_state_dict(interop.params_from_jax(
        jax_params(seed) if params is None else params, cfg))
    return m


def _tree(fn, t):
    return {k: _tree(fn, v) for k, v in t.items()} \
        if isinstance(t, dict) else fn(t)


def _assert_tree_close(got, want, rtol, atol, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_close(got[k], want[k], rtol, atol, f"{path}/{k}")
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=rtol, atol=atol, err_msg=path)


_JAX_FN, _JAX_REF = {}, {}


def _jax_value_and_grad_fn(impl, fused):
    """The reference's jitted loss and gradient on :func:`_ids`, at any
    parameters; compiled once per (impl, fused)."""
    key = (impl, fused)
    if key not in _JAX_FN:
        fn = _jax_model(impl, fused).lm_loss_fn()
        ids = jnp.asarray(_ids())
        _JAX_FN[key] = jax.jit(jax.value_and_grad(
            lambda p: fn(p, {}, (ids,), None, False)[0]))
    return _JAX_FN[key]


def _jax_value_and_grad(impl, fused):
    """The reference's loss and gradients, computed once per (impl,
    fused): recomputation does not change the function, so every remat
    setting of the port is held against the same reference."""
    key = (impl, fused)
    if key not in _JAX_REF:
        loss, grads = _jax_value_and_grad_fn(impl, fused)(
            _tree(jnp.asarray, jax_params()))
        _JAX_REF[key] = (float(loss), _tree(np.asarray, grads))
    return _JAX_REF[key]


def _port_grads(model, ids):
    """The port's gradients of ``model``'s LM loss on ``ids``, in the
    reference's layout."""
    params = dict(model.named_parameters())
    loss, _ = model.lm_loss_fn()(params, {}, (torch.from_numpy(ids),), None,
                                 True)
    grads = torch.autograd.grad(loss, list(params.values()))
    return interop.params_to_jax(dict(zip(params, grads)), model.c)


@pytest.mark.parametrize("remat", ["off", "full", "dots"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_loss_and_every_gradient_match_jax(impl, fused, remat):
    want_loss, want_grads = _jax_value_and_grad(impl, fused)
    model = _torch_model(impl, fused, remat)
    params = dict(model.named_parameters())
    loss, (metrics, _) = model.lm_loss_fn()(
        params, {}, (torch.from_numpy(_ids()),), None, True)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert metrics == {}
    np.testing.assert_allclose(float(loss.detach()), want_loss,
                               rtol=TOL_LOSS)
    got = interop.params_to_jax(dict(zip(params, grads)), model.c)
    _assert_tree_close(got, want_grads, TOL_G, ATOL_G)


def test_lm_loss_fn_refuses_foreign_parameters():
    model = _torch_model("xla", True)
    params = {n: p.detach().clone().requires_grad_()
              for n, p in model.named_parameters()}
    with pytest.raises(ValueError, match="own"):
        model.lm_loss_fn()(params, {}, torch.from_numpy(_ids()), None, True)


def test_remat_recomputes_the_flash_forward(monkeypatch):
    """Under ``remat`` each block's forward runs again in the backward
    pass, so its flash forward is called 2·L times a step; on CPU tensors
    every call is the plain version and no kernel launch is counted."""
    model = _torch_model("flash", True, "full")
    calls = []
    fa = importlib.import_module(
        "hetu_tpu_torch.ops.cuda_kernels.flash_attention")
    orig = fa.flash_attention_plain

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(fa, "flash_attention_plain", counting)
    params = dict(model.named_parameters())
    loss, _ = model.lm_loss_fn()(params, {}, torch.from_numpy(_ids()),
                                 None, True)
    assert len(calls) == L
    torch.autograd.grad(loss, list(params.values()))
    assert len(calls) == 2 * L
    assert flash_attention.launches == flash_attention_bwd_dkdv.launches \
        == flash_attention_bwd_dq.launches == 0


def test_dots_policy_saves_the_gemms():
    """``remat_policy="dots"`` saves the weight GEMMs' outputs, so its
    backward pass runs exactly the matrix products of a backward without
    recomputation, while "full" recomputes some; all give the same
    gradients."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in (torch.ops.aten.mm.default,
                               torch.ops.aten.addmm.default)
            return func(*args, **(kwargs or {}))

    counts, grads = {}, {}
    for remat in ("off", "full", "dots"):
        model = _torch_model("flash", True, remat)
        params = dict(model.named_parameters())
        loss, _ = model.lm_loss_fn()(params, {}, torch.from_numpy(_ids()),
                                     None, True)
        with CountMM() as mode:
            grads[remat] = torch.autograd.grad(loss, list(params.values()))
        counts[remat] = mode.n
    assert counts["dots"] == counts["off"] < counts["full"], counts
    for remat in ("full", "dots"):
        for a, b in zip(grads["off"], grads[remat]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_dropout_when_training_only():
    """With dropout on, a training loss depends on the generator's seed
    and is reproducible for one seed; validation ignores the generator."""
    cfg = GPTConfig(**dict(_cfg_kw("flash", True), dropout_rate=0.2),
                    remat=True)
    model = GPTModel(cfg, device="cpu")
    params = dict(model.named_parameters())
    fn = model.lm_loss_fn()
    ids = torch.from_numpy(_ids())

    def loss(seed, train):
        g = torch.Generator().manual_seed(seed) if seed is not None else None
        return float(fn(params, {}, ids, g, train)[0].detach())

    assert loss(1, True) == loss(1, True) != loss(2, True)
    assert loss(None, False) == loss(3, False)
    # recomputation redraws the same masks: gradients are those of the
    # same function, so a second backward of a fresh graph agrees
    g1 = torch.autograd.grad(fn(params, {}, ids, torch.Generator()
                                .manual_seed(4), True)[0], params["tok_emb"])
    g2 = torch.autograd.grad(fn(params, {}, ids, torch.Generator()
                                .manual_seed(4), True)[0], params["tok_emb"])
    assert torch.equal(g1[0], g2[0])


# ---------------------------------------------------------------- executor

EPS, LR = 1e-3, 1e-2  # see the module docstring


def _jax_executor(impl="flash", lr=LR):
    model = _jax_model(impl, True)
    ex = JaxExecutor(model.lm_loss_fn(), JaxAdamW(lr, eps=EPS), seed=0)
    state = ex.init_state({"params": _tree(jnp.asarray, jax_params()),
                           "state": {}})
    return ex, state


def _torch_executor(impl="flash", lr=LR):
    model = _torch_model(impl, True, "full")
    ex = Executor(model.lm_loss_fn(), AdamWOptimizer(lr, eps=EPS), seed=0)
    return model, ex, ex.init_state(model)


def test_five_adamw_steps_match_the_jax_executor():
    """The loss of every step; at the reference's parameters before each
    step, the port's gradient within the gradient tolerance of the
    reference's; after 5 steps, parameters and slots within AdamW's bound
    of those gradient gaps (module docstring)."""
    ids = _ids()
    jex, js = _jax_executor()
    model, tex, ts = _torch_executor()
    deltas, g_abs = [], []  # per step: {leaf: bound}, {leaf: |G|}
    for step in range(5):
        ref = _tree(np.asarray, js.params)
        want = _jax_value_and_grad_fn("flash", True)(js.params)[1]
        got = _port_grads(_torch_model("flash", True, "full", params=ref),
                          ids)
        _assert_tree_close(got, _tree(np.asarray, want), TOL_G, ATOL_G)
        g_abs.append({p: np.abs(w) for p, w in flat(want)})
        deltas.append({p: TOL_G * g + ATOL_G for p, g in g_abs[-1].items()})
        js, jm = jex.run("train", js, (jnp.asarray(ids),))
        ts, tm = tex.run("train", ts, (ids,))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=TOL_LOSS, err_msg=f"step {step}")
    assert ts.step == int(js.step) == 5
    assert ts.opt_state["step"] == int(js.opt_state["step"]) == 5
    assert ts.params["tok_emb"] is model.tok_emb  # updated in place
    got = {"params": interop.params_to_jax(ts.params, model.c),
           **interop.opt_state_to_jax(ts.opt_state, model.c)["slots"]}
    want = {"params": _tree(np.asarray, js.params),
            **_tree(np.asarray, js.opt_state["slots"])}
    assert set(got) == set(want) == {"params", "m", "v"}
    for path in deltas[0]:
        atol = adamw_atol([d[path] for d in deltas],
                          [g[path] for g in g_abs], LR, EPS)
        for kind in want:
            w = get(want[kind], path)
            share = np.abs(get(got[kind], path) - w) / (
                TOL_G * np.abs(w) + atol[kind])
            assert share.max() <= 1, (kind, path, share.max())
    assert sorted(p for p, _ in flat(got["params"])) == sorted(deltas[0])
    # the loss fell, and validate reports the new loss without a step
    metrics = tex.run("validate", ts, (ids,))
    assert float(metrics["loss"]) < float(jm["loss"]) + 1e-6
    assert ts.step == 5


def test_train_guarded_skips_a_poisoned_batch():
    """A batch that makes the loss NaN leaves parameters, slots and the
    optimizer's step as they were; the state's step still advances."""
    model = _torch_model("xla", True)
    base = model.lm_loss_fn()

    def poisonable(params, model_state, batch, generator, train):
        loss, aux = base(params, model_state, batch[0], generator, train)
        return loss * batch[1], aux

    ex = Executor(poisonable, AdamWOptimizer(1e-2))
    state = ex.init_state(model)
    ids = _ids()
    state, m = ex.run("train_guarded", state, (ids, np.float32(1.0)))
    assert int(m["nonfinite"]) == 0
    before = {n: p.detach().clone() for n, p in state.params.items()}
    slots = {n: t.clone() for n, t in state.opt_state["slots"]["m"].items()}
    state, m = ex.run("train_guarded", state, (ids, np.float32(np.nan)))
    assert int(m["nonfinite"]) == 1 and state.step == 2
    assert state.opt_state["step"] == 1
    for n, p in state.params.items():
        assert torch.equal(p, before[n]), n
        assert torch.equal(state.opt_state["slots"]["m"][n], slots[n]), n
    state, m = ex.run("train_guarded", state, (ids, np.float32(1.0)))
    assert int(m["nonfinite"]) == 0 and state.opt_state["step"] == 2
    assert not torch.equal(state.params["tok_emb"], before["tok_emb"])


def test_executor_refuses_what_this_slice_lacks():
    model = _torch_model("xla", True)
    fn = model.lm_loss_fn()
    ex = Executor(fn)
    state = ex.init_state(model)
    with pytest.raises(ValueError, match="optimizer"):
        ex.run("train", state, _ids())
    with pytest.raises(KeyError):
        ex.run("eval_all", state, _ids())
    for kw in (dict(mesh=object()), dict(grad_sync="int8"),
               dict(dist_strategy=object())):
        with pytest.raises(NotImplementedError, match="multi-GPU"):
            Executor(fn, AdamWOptimizer(), **kw)
    with pytest.raises(NotImplementedError, match="profiler"):
        ex.profile(state, _ids())


def test_executor_spans_name_each_subexecutor():
    from hetu_tpu_torch.telemetry import trace
    model, ex, state = _torch_executor("xla")
    tracer = trace.enable()
    try:
        state, _ = ex.run("train", state, (_ids(),))
        ex.run("validate", state, (_ids(),))
    finally:
        trace.disable()
    names = [e["name"] for e in tracer.events]
    assert names == ["train.host_to_device", "train.step.train",
                     "train.host_to_device", "train.step.validate"]


# -------------------------------------------------------------- checkpoint

def test_jax_checkpoint_loads_into_the_port(tmp_path):
    """A JAX TrainState after 2 steps, saved by hetu_tpu, loads into a
    fresh port state: same parameters, slots, steps and rng words, and the
    same next loss."""
    ids = _ids()
    jex, js = _jax_executor()
    for _ in range(2):
        js, _ = jex.run("train", js, (jnp.asarray(ids),))
    path = tmp_path / "jax.npz"
    jax_checkpoint.save(path, js)
    model, tex, ts = _torch_executor(lr=1e-2)
    ts = checkpoint.load(path, ts, model.c)
    assert ts.step == 2 and ts.opt_state["step"] == 2
    np.testing.assert_array_equal(ts.rng, np.asarray(js.rng))
    _assert_tree_close(interop.params_to_jax(ts.params, model.c),
                       _tree(np.asarray, js.params), 0, 0)
    js, jm = jex.run("train", js, (jnp.asarray(ids),))
    ts, tm = tex.run("train", ts, (ids,))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=TOL_LOSS)


def test_port_checkpoint_loads_into_jax(tmp_path):
    ids = _ids()
    model, tex, ts = _torch_executor()
    for _ in range(2):
        ts, _ = tex.run("train", ts, (ids,))
    path = tmp_path / "port.npz"
    checkpoint.save(path, ts, model.c, extra={"note": "port"})
    jex, template = _jax_executor()
    js = jax_checkpoint.load(path, template)
    assert int(js.step) == 2 and int(js.opt_state["step"]) == 2
    np.testing.assert_array_equal(np.asarray(js.rng), ts.rng)
    _assert_tree_close(_tree(np.asarray, js.params),
                       interop.params_to_jax(ts.params, model.c), 0, 0)
    _assert_tree_close(
        _tree(np.asarray, js.opt_state["slots"]),
        interop.opt_state_to_jax(ts.opt_state, model.c)["slots"], 0, 0)
    assert jax_checkpoint.read_header(path)["extra"] == {"note": "port"}


def test_checkpoint_round_trip_restores_the_rng_status(tmp_path):
    rng = torch_rng
    model, tex, ts = _torch_executor()
    ts, _ = tex.run("train", ts, (_ids(),))
    rng.set_seed_status(5, 9)
    checkpoint.save(tmp_path / "c.npz", ts, model.c)
    rng.set_seed_status(0, 0)
    model2, _, fresh = _torch_executor()
    fresh = checkpoint.load(tmp_path / "c.npz", fresh, model2.c)
    assert rng.get_seed_status() == (5, 9) and fresh.step == 1
    for n, p in fresh.params.items():
        assert torch.equal(p, ts.params[n]), n


@pytest.mark.parametrize("damage", ["truncated", "garbage"])
def test_corrupt_checkpoints_raise(tmp_path, damage):
    model, tex, ts = _torch_executor()
    path = tmp_path / "c.npz"
    checkpoint.save(path, ts, model.c)
    data = path.read_bytes()
    path.write_bytes(data[:len(data) // 2] if damage == "truncated"
                     else np.random.default_rng(0).bytes(256))
    with pytest.raises(CheckpointCorruptError):
        checkpoint.load(path, ts, model.c)


def test_checkpoint_of_another_architecture_raises(tmp_path):
    model, tex, ts = _torch_executor()
    checkpoint.save(tmp_path / "c.npz", ts, model.c)
    cfg = GPTConfig(**dict(_cfg_kw("flash", True), hidden_size=16))
    other = GPTModel(cfg, device="cpu")
    ex = Executor(other.lm_loss_fn(), AdamWOptimizer())
    with pytest.raises(CheckpointError, match="shape"):
        checkpoint.load(tmp_path / "c.npz", ex.init_state(other), cfg)
