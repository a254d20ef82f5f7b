"""The CNN slice of hetu_tpu_torch against hetu_tpu, on the CPU: the ops
(convolution, pools, batch and instance norm, activations, losses), the
layers (Conv2d, BatchNorm with its state, Sequential, DropOut), ResNet-18
at full width, VGG, LeNet and MLP, the Executor's BatchNorm state and the
checkpoints across the packages.

Every input is drawn with numpy from a seed and fed to both packages;
weights are drawn with numpy into the reference's tree (from
``jax.eval_shape`` of its ``init``) and loaded into the port through
``interop.params_from_jax`` and ``interop.state_from_jax``.  No Pallas
kernel lies on this path.

Tolerances (f32; XLA and PyTorch sum in different orders):

* ops: rtol 1e-5, atol 1e-6 (values and gradients);
* ResNet-18 logits: 1e-4 · max|logit|; every gradient 1e-2 · max|G| of its
  leaf; the BatchNorm statistics 1e-5 · max|s| of their leaf.  The
  gradients' bound is set by ReLU, not by the sums: a pre-activation
  within f32 rounding of 0 lands on the two sides of it in the two
  packages (one at 2.8e-7 against -2.5e-7 in f64 in ``layer0_1.bn1``'s
  output with these seeds), which drops or keeps that element's gradient
  and moves the first stage's parameter gradients by up to 1.4e-3 ·
  max|G|.  Away from such flips each package's f32 gradients are within
  1e-5 · max|G| of an f64 run;
* after an Executor step (Momentum, lr 0.01) from the same state: the
  velocity slots 1e-2 · max|v| (the gradients' bound, as the first
  velocity is ``-lr · g``), the parameters 1e-6 · max|p| plus that bound
  of their velocity, the state as above, the losses 1e-5 relative;
* VGG, LeNet and MLP: the same as ResNet-18;
* copies (checkpoints, the interop round trip, the guard's rollback):
  bitwise.

DropOut draws other bits than ``jax.random``, so parity cases run VGG's at
rate 0 and the layer's own test checks the kept share and the scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu import layers as jlayers
from hetu_tpu import models as jmodels
from hetu_tpu import ops as jops
from hetu_tpu import optim as joptim
from hetu_tpu.train import checkpoint as jckpt
from hetu_tpu.train.executor import Executor as JExecutor
from hetu_tpu_torch import init, interop, layers, models, ops, optim
from hetu_tpu_torch import rng as trng
from hetu_tpu_torch.layers import state_buffers
from hetu_tpu_torch.train import Executor, checkpoint

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
TOL_LOGITS, TOL_GRAD, TOL_STATS = 1e-4, 1e-2, 1e-5
TOL_SLOTS, TOL_LOSS = 1e-2, 1e-5
LR = 0.01


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _tree_close(got, ref, rel, what):
    """Every leaf of the reference tree ``ref`` within ``rel`` of its own
    largest magnitude; ``got`` has the same leaves."""
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_got) == len(flat_ref), what
    for path, r in flat_ref:
        r = np.asarray(r)
        err = np.abs(np.asarray(flat_got[path], np.float32) - r).max()
        scale = np.abs(r).max()
        assert err <= rel * scale or err == 0, \
            f"{what}{jax.tree_util.keystr(path)}: {err} > {rel} * {scale}"


def _variables(module, seed):
    """The reference's variables of ``module`` drawn with numpy: He-normal
    convolutions, Glorot-uniform matmuls, batch norms away from their
    initial values (so evaluation and the state updates are tested)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0))
    g = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "weight" and len(s.shape) == 4:
            fan_in = s.shape[1] * s.shape[2] * s.shape[3]
            return g.standard_normal(s.shape, np.float32) \
                * np.float32(np.sqrt(2.0 / fan_in))
        if name == "weight":
            lim = np.sqrt(6.0 / sum(s.shape))
            return g.uniform(-lim, lim, s.shape).astype(np.float32)
        if name == "scale":
            return 1 + 0.1 * g.standard_normal(s.shape, np.float32)
        if name in ("bias", "mean"):
            return 0.1 * g.standard_normal(s.shape, np.float32)
        assert name == "var", name
        return g.uniform(0.5, 1.5, s.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port(model, variables):
    """``model`` (the port's, on the CPU) with the reference's variables."""
    model.load_state_dict({
        **interop.params_from_jax(variables["params"], model),
        **interop.state_from_jax(variables["state"], model)})
    return model


def _images(g, b, c=3, hw=32):
    return (g.standard_normal((b, c, hw, hw), np.float32),
            g.integers(0, 10, b).astype(np.int32))


def _jax_loss_fn(module):
    """``ResNet.loss_fn``'s body for any reference module (the reference's
    Sequential models have none)."""
    def fn(params, model_state, batch, rng, train):
        x, y = batch
        logits, new_state = module.apply(
            {"params": params, "state": model_state}, x, train=train,
            rng=rng)
        loss = jnp.mean(jops.softmax_cross_entropy_sparse(logits, y))
        acc = jnp.mean((jnp.argmax(logits, -1) == y).astype(jnp.float32))
        return loss, ({"acc": acc}, new_state)
    return fn


def _grads_port(model, x, y, train=True):
    params = dict(model.named_parameters())
    logits = model(_t(x), train=train,
                   generator=torch.Generator().manual_seed(0))
    loss = ops.softmax_cross_entropy_sparse(logits, _t(y)).mean()
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss, logits, interop.params_to_jax(dict(zip(params, grads)),
                                               model)


# ------------------------------------------------------------------- ops

def _vjp_both(jfn, tfn, args, seed=1):
    """Values and the gradients of ``sum(out * c)`` for a seeded
    cotangent ``c``, through ``jax.vjp`` and autograd."""
    out_j, vjp = jax.vjp(jfn, *args)
    c = np.random.default_rng(seed).standard_normal(
        out_j.shape).astype(np.float32)
    grads_j = vjp(jnp.asarray(c))
    targs = [_t(a).requires_grad_() for a in args]
    out_t = tfn(*targs)
    grads_t = torch.autograd.grad((out_t * _t(c)).sum(), targs)
    return out_j, out_t, grads_j, grads_t


def _check_vjp(jfn, tfn, args, rtol=RTOL, atol=ATOL):
    out_j, out_t, grads_j, grads_t = _vjp_both(jfn, tfn, args)
    _close(out_t, out_j, rtol, atol)
    for gj, gt in zip(grads_j, grads_t):
        _close(gt, gj, rtol, atol)


@pytest.mark.parametrize("stride,padding,bias", [
    (1, 0, False), (2, 1, True), ((2, 1), (1, 2), True)])
def test_conv2d(stride, padding, bias):
    g = np.random.default_rng(0)
    x = g.standard_normal((2, 3, 9, 8), np.float32)
    w = g.standard_normal((5, 3, 3, 3), np.float32)
    b = g.standard_normal(5, np.float32)
    if bias:
        _check_vjp(lambda x, w, b: jops.conv2d_add_bias(x, w, b, stride,
                                                        padding),
                   lambda x, w, b: ops.conv2d_add_bias(x, w, b, stride,
                                                       padding), (x, w, b))
    else:
        _check_vjp(lambda x, w: jops.conv2d(x, w, stride, padding),
                   lambda x, w: ops.conv2d(x, w, stride, padding), (x, w))


def test_conv2d_bf16_accumulates_and_returns_f32():
    g = np.random.default_rng(1)
    x = g.standard_normal((2, 16, 8, 8), np.float32)
    w = g.standard_normal((8, 16, 3, 3), np.float32)
    ref = jops.conv2d(jnp.asarray(x, jnp.bfloat16),
                      jnp.asarray(w, jnp.bfloat16), 1, 1)
    got = ops.conv2d(_t(x).bfloat16(), _t(w).bfloat16(), 1, 1)
    assert ref.dtype == jnp.float32 and got.dtype == torch.float32
    _close(got, ref)
    # a bf16 result would be off by up to half a bf16 ulp
    assert np.abs(_np(got) - np.asarray(ref)).max() \
        < 2 ** -9 * np.abs(np.asarray(ref)).max()


@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("kernel,stride,padding", [
    (2, None, 0), (3, 2, 1), ((3, 2), (2, 1), (1, 0)), (3, 1, 2)])
def test_pools(kind, kernel, stride, padding):
    """``stride=None`` is the window; padding of 2 in a 3-wide window is
    wider than the pools' own padding allows."""
    x = np.random.default_rng(2).standard_normal((2, 3, 9, 8), np.float32)
    jfn = getattr(jops, f"{kind}_pool2d")
    tfn = getattr(ops, f"{kind}_pool2d")
    _check_vjp(lambda x: jfn(x, kernel, stride, padding),
               lambda x: tfn(x, kernel, stride, padding), (x,))


def test_max_pool_routes_a_tied_windows_gradient_as_the_reference():
    """Values from {0, 1, 2}: most windows hold a tie for their max; both
    packages route its gradient to the first maximum.  Behind ReLU, the
    all-zero windows of a negative input get no gradient either way."""
    g = np.random.default_rng(3)
    x = g.integers(0, 3, (2, 3, 8, 8)).astype(np.float32)
    _check_vjp(lambda x: jops.max_pool2d(x, 2, 2),
               lambda x: ops.max_pool2d(x, 2, 2), (x,), 0, 0)
    z = g.standard_normal((2, 3, 8, 8), np.float32)
    _check_vjp(lambda z: jops.max_pool2d(jops.relu(z), 2, 2),
               lambda z: ops.max_pool2d(ops.relu(z), 2, 2), (z,), 0, 0)


@pytest.mark.parametrize("ndim", [4, 2])
@pytest.mark.parametrize("train", [True, False])
def test_batch_norm(ndim, train):
    """The running variance moves by the biased batch variance."""
    g = np.random.default_rng(4)
    shape = (4, 6, 5, 5) if ndim == 4 else (8, 6)
    x = (3 + 2 * g.standard_normal(shape)).astype(np.float32)
    scale, bias, rm = (g.standard_normal(6).astype(np.float32)
                       for _ in range(3))
    rv = g.uniform(0.5, 2, 6).astype(np.float32)
    yj, mj, vj = jops.batch_norm(x, scale, bias, rm, rv, momentum=0.2,
                                 train=train)
    yt, mt, vt = ops.batch_norm(_t(x), _t(scale), _t(bias), _t(rm), _t(rv),
                                momentum=0.2, train=train)
    _close(mt, mj)
    _close(vt, vj)
    if train:
        axes = (0, 2, 3) if ndim == 4 else (0,)
        np.testing.assert_allclose(
            _np(vt), 0.8 * rv + 0.2 * x.astype(np.float64).var(axis=axes),
            rtol=1e-5)
    _check_vjp(
        lambda x, s, b: jops.batch_norm(x, s, b, rm, rv, momentum=0.2,
                                        train=train)[0],
        lambda x, s, b: ops.batch_norm(x, s, b, _t(rm), _t(rv), momentum=0.2,
                                       train=train)[0],
        (x, scale, bias))
    _close(yt, yj)


def test_instance_norm2d():
    x = np.random.default_rng(5).standard_normal((2, 3, 6, 5), np.float32)
    _check_vjp(jops.instance_norm2d, ops.instance_norm2d, (x,))


@pytest.mark.parametrize("name", ["relu", "leaky_relu", "sigmoid", "tanh",
                                  "softmax", "log_softmax"])
def test_activations(name):
    x = np.random.default_rng(6).standard_normal((4, 7), np.float32) * 3
    x[0, :3] = 0.0  # the derivatives at 0 (relu 1/2, leaky_relu 1)
    _check_vjp(getattr(jops, name), getattr(ops, name), (x,))


@pytest.mark.parametrize("name", ["cross_entropy", "cross_entropy_sparse",
                                  "softmax_cross_entropy",
                                  "softmax_cross_entropy_sparse",
                                  "nll_loss"])
def test_losses(name):
    g = np.random.default_rng(7)
    logits = g.standard_normal((6, 5), np.float32) * 2
    sparse = g.integers(0, 5, 6).astype(np.int32)
    if name in ("cross_entropy", "softmax_cross_entropy"):
        label = np.eye(5, dtype=np.float32)[sparse]
    else:
        label = sparse
        if name != "nll_loss":
            label[1] = -1  # the ignored index gives 0
    if name in ("cross_entropy", "cross_entropy_sparse"):
        pred = np.asarray(jax.nn.softmax(logits))
    elif name == "nll_loss":
        pred = np.asarray(jax.nn.log_softmax(logits))
    else:
        pred = logits
    _check_vjp(lambda p: getattr(jops, name)(p, label),
               lambda p: getattr(ops, name)(p, _t(label)), (pred,))


# ---------------------------------------------------------------- layers

def test_he_normal_draws_by_the_convolutions_fan_in():
    w = init.he_normal()(torch.Generator().manual_seed(0), (64, 32, 3, 3))
    assert abs(float(w.std()) / np.sqrt(2 / (32 * 9)) - 1) < 0.02
    assert init._fans((64, 32, 3, 3)) == (32 * 9, 64 * 9)


def test_conv2d_layer_with_bias_and_activation():
    jl = jlayers.Conv2d(3, 4, 3, stride=2, padding=1, activation=jops.tanh)
    v = _variables(jl, 0)
    tl = layers.Conv2d(3, 4, 3, stride=2, padding=1, activation=ops.tanh,
                       generator=torch.Generator())
    tl.load_state_dict({k: _t(v["params"][k]) for k in ("weight", "bias")})
    x = np.random.default_rng(1).standard_normal((2, 3, 8, 8), np.float32)
    _close(tl(_t(x)), jl.apply(v, x)[0])
    assert tl.weight.shape == (4, 3, 3, 3)  # OIHW, as the reference


def test_batch_norm_layer_keeps_its_state_in_its_buffers():
    jl = jlayers.BatchNorm(6, momentum=0.3)
    v = _variables(jl, 1)
    tl = layers.BatchNorm(6, momentum=0.3)
    tl.load_state_dict({k: _t(v[part][k]) for part, keys in (
        ("params", ("scale", "bias")), ("state", ("mean", "var")))
        for k in keys})
    assert state_buffers(tl) == {"mean": tl.mean, "var": tl.var}
    x = np.random.default_rng(2).standard_normal((4, 6, 3, 3), np.float32)
    y, s = jl.apply(v, x, train=True)
    _close(tl(_t(x), train=True), y)
    _close(tl.mean, s["mean"])
    _close(tl.var, s["var"])
    y, _ = jl.apply({"params": v["params"], "state": s}, x, train=False)
    before = tl.mean.clone()
    _close(tl(_t(x)), y)  # evaluation reads the buffers, writes nothing
    assert torch.equal(tl.mean, before)


def test_sequential_passes_train_and_each_childs_generator():
    """Conv2d, BatchNorm (takes train), Relu, Lambda, DropOut (train and
    a generator), Flatten, Linear: against the reference's Sequential at
    dropout rate 0, and DropOut's mask drawn from ``child_generator(g,
    4)``."""
    def chain(mod, rate):
        return mod.Sequential(
            mod.Conv2d(2, 3, 3, padding=1, **kw(mod)), mod.BatchNorm(3),
            mod.Relu(), mod.Lambda(lambda x: 2 * x), mod.DropOut(rate),
            mod.Flatten(), mod.Linear(3 * 4 * 4, 5, **kw(mod)))

    def kw(mod):
        return {"generator": torch.Generator()} if mod is layers else {}
    jm = chain(jlayers, 0.0)
    v = _variables(jm, 3)
    tm = _port(chain(layers, 0.0), v)
    x = np.random.default_rng(4).standard_normal((2, 2, 4, 4), np.float32)
    y, s = jm.apply(v, x, train=True, rng=jax.random.PRNGKey(0))
    _close(tm(_t(x), train=True, generator=torch.Generator()), y)
    _tree_close(interop.state_to_jax(state_buffers(tm), tm), s, TOL_STATS,
                "state")
    y, _ = jm.apply({"params": v["params"], "state": s}, x)
    _close(tm(_t(x)), y)

    dropout = tm.get_submodule("4")
    dropout.rate = 0.5
    got = tm(_t(x), train=True, generator=torch.Generator().manual_seed(9))
    h = _t(x)
    for i in range(4):
        kw = {"train": True} if i == 1 else {}
        h = tm.get_submodule(str(i))(h, **kw)
    h = dropout(h, train=True, generator=layers.child_generator(
        torch.Generator().manual_seed(9), 4))
    want = tm.get_submodule("6")(tm.get_submodule("5")(h))
    assert torch.equal(got, want)


def test_dropout_layer():
    d = layers.DropOut(0.25)
    x = torch.ones(200, 200)
    assert d(x) is x  # evaluation: the identity
    with pytest.raises(ValueError, match="generator"):
        d(x, train=True)
    y = d(x, train=True, generator=torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.75))


# ------------------------------------------------------- ResNet-18, full

@pytest.fixture(scope="module")
def resnet():
    """ResNet-18 at full width, batch 4 of 32x32: the reference's loss,
    logits, new state and gradients (train), its logits (evaluation), and
    the port's model with the same variables."""
    jm = jmodels.ResNet18(num_classes=10)
    v = _variables(jm, 10)
    x, y = _images(np.random.default_rng(11), 4)

    def f(params):
        logits, ns = jm.apply({"params": params, "state": v["state"]}, x,
                              train=True)
        return jnp.mean(jops.softmax_cross_entropy_sparse(logits, y)), (
            logits, ns)
    (loss, (logits, ns)), grads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(v["params"])
    eval_logits, _ = jax.jit(lambda p, s: jm.apply(
        {"params": p, "state": s}, x))(v["params"], v["state"])
    return dict(jm=jm, v=v, x=x, y=y, loss=loss, logits=logits, state=ns,
                grads=grads, eval_logits=eval_logits,
                tm=_port(models.ResNet18(device="cpu"), v))


def test_resnet18_tree_is_the_references(resnet):
    tm, v = resnet["tm"], resnet["v"]
    assert jax.tree_util.tree_structure(interop.params_to_jax(
        dict(tm.named_parameters()), tm)) == \
        jax.tree_util.tree_structure(v["params"])
    assert jax.tree_util.tree_structure(interop.state_to_jax(
        state_buffers(tm), tm)) == jax.tree_util.tree_structure(v["state"])
    assert [n for n in state_buffers(tm)][:4] == [
        "bn1.mean", "bn1.var", "layer0_0.bn1.mean", "layer0_0.bn1.var"]


def test_resnet18_forward_state_and_gradients(resnet):
    tm = resnet["tm"]
    loss, logits, grads = _grads_port(tm, resnet["x"], resnet["y"])
    ref = np.asarray(resnet["logits"])
    _close(logits, ref, 0, TOL_LOGITS * np.abs(ref).max())
    _close(loss, resnet["loss"], TOL_LOSS, 0)
    _tree_close(interop.state_to_jax(state_buffers(tm), tm),
                resnet["state"], TOL_STATS, "state")
    _tree_close(grads, resnet["grads"], TOL_GRAD, "grad")
    # evaluation from the reference's pre-step state
    _port(tm, resnet["v"])
    with torch.no_grad():
        got = tm(_t(resnet["x"]))
    ref = np.asarray(resnet["eval_logits"])
    _close(got, ref, 0, TOL_LOGITS * np.abs(ref).max())


def test_bf16_basic_block():
    """Each convolution returns f32, the batch norms run in f32 with f32
    statistics, the downsample path too."""
    jb = jmodels.BasicBlock(16, 32, stride=2, dtype=jnp.bfloat16)
    v = _variables(jb, 12)
    tb = _port(models.BasicBlock(16, 32, stride=2, dtype=torch.bfloat16,
                                 generator=torch.Generator()), v)
    x = np.random.default_rng(13).standard_normal((2, 16, 8, 8), np.float32)
    y, s = jb.apply(v, jnp.asarray(x), train=True)
    got = tb(_t(x), train=True)
    assert y.dtype == jnp.float32 and got.dtype == torch.float32
    _close(got, y, 0, TOL_LOGITS * np.abs(np.asarray(y)).max())
    _tree_close(interop.state_to_jax(state_buffers(tb), tb), s, TOL_STATS,
                "state")


# ---------------------------------------------- Executor, 3 steps a side

def _port_state_tree(state, model):
    """Copies: interop's arrays are views of the live tensors."""
    return jax.tree_util.tree_map(np.array, (
        interop.params_to_jax(state.params, model),
        interop.opt_state_to_jax(state.opt_state, model)["slots"],
        interop.state_to_jax(state.model_state, model)))


def _jax_state_tree(state):
    """Copies: a later step donates the state's buffers."""
    return jax.tree_util.tree_map(np.array, (
        state.params, state.opt_state["slots"], state.model_state))


def _load_reference(tstate, model, trees, step):
    """Put the reference's ``(params, slots, state)`` trees into the
    port's state, in place, at ``step``."""
    params, slots, buffers = trees
    loaded = interop.params_from_jax(params, model)
    opt = interop.opt_state_from_jax({"step": step, "slots": slots}, model)
    state = interop.state_from_jax(buffers, model)
    with torch.no_grad():
        for name, p in tstate.params.items():
            p.copy_(loaded[name])
        for slot, d in tstate.opt_state["slots"].items():
            for name, t in d.items():
                t.copy_(opt["slots"][slot][name])
        for name, t in tstate.model_state.items():
            t.copy_(state[name])
    tstate.opt_state["step"] = tstate.step = step


@pytest.fixture(scope="module")
def executors(tmp_path_factory):
    """ResNet-18 from the same variables on each side (Momentum(0.01,
    0.9), seeded batches of 4): three ``Executor.run("train")`` steps, each
    side's trees after each; ``validate``; a ``train_guarded`` step on a
    NaN batch, with the port's tensors before and after it; the
    reference's state saved after it, and the loss of its next step.

    Each port step starts from the reference's state before that step
    (loaded in place): at batch 4 a few steps are chaotic, a relative
    change of 1e-7 in the weights moves the third step's velocities by
    8 % of their largest value in an f64 run of the port alone, so two f32
    trajectories part after a ReLU flip (see the module's docstring)."""
    jm = jmodels.ResNet18()
    v = _variables(jm, 20)
    g = np.random.default_rng(21)
    batches = [_images(g, 4) for _ in range(4)]
    jex = JExecutor(jm.loss_fn(), joptim.MomentumOptimizer(LR, 0.9), seed=0)
    jstate = jex.init_state(v)
    tm = _port(models.ResNet18(device="cpu"), v)
    tex = Executor(tm.loss_fn(), optim.MomentumOptimizer(LR, 0.9), seed=0)
    tstate = tex.init_state(tm)
    steps = []
    for i, b in enumerate(batches[:3]):
        if i:
            _load_reference(tstate, tm, steps[-1]["ref"], i)
        jstate, jmet = jex.run("train", jstate, b)
        tstate, tmet = tex.run("train", tstate, b)
        steps.append(dict(ref=_jax_state_tree(jstate),
                          got=_port_state_tree(tstate, tm),
                          loss=(float(jmet["loss"]), float(tmet["loss"])),
                          acc=(float(jmet["acc"]), float(tmet["acc"])),
                          step=(int(jstate.step), tstate.step)))
    valid = (jex.run("validate", jstate, batches[0]),
             tex.run("validate", tstate, batches[0]))
    bad = (np.full_like(batches[0][0], np.nan), batches[0][1])
    before = checkpoint.state_dict(tstate, tm)
    jstate, jmet = jex.run("train_guarded", jstate, bad)
    tstate, tmet = tex.run("train_guarded", tstate, bad)
    guard = dict(before=before, after=checkpoint.state_dict(tstate, tm),
                 ref=_jax_state_tree(jstate), got=_port_state_tree(tstate, tm),
                 nonfinite=(int(jmet["nonfinite"]), int(tmet["nonfinite"])),
                 loss=float(tmet["loss"]),
                 step=(int(jstate.step), tstate.step))
    path = tmp_path_factory.mktemp("ckpt") / "jax.npz"
    jckpt.save(path, jstate)
    template = jax.tree_util.tree_map(np.array, jstate)
    jstate, jmet = jex.run("train", jstate, batches[3])  # donates jstate
    return dict(steps=steps, valid=valid, guard=guard, jax_ckpt=path,
                next_batch=batches[3], next_loss=float(jmet["loss"]),
                template=template, tm=tm, tex=tex, tstate=tstate)


def _check_step(ref, got, what):
    """Slots and state to their bounds; parameters to 1e-6 · max|p| plus
    the velocity's bound (a step adds the velocity to the same
    parameters)."""
    (pr, sr, br), (pg, sg, bg) = ref, got
    _tree_close(sg, sr, TOL_SLOTS, f"{what} slots")
    _tree_close(bg, br, TOL_STATS, f"{what} state")
    flat_v = dict(jax.tree_util.tree_flatten_with_path(sr["velocity"])[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(pg)[0])
    for path, r in jax.tree_util.tree_flatten_with_path(pr)[0]:
        bound = 1e-6 * np.abs(r).max() + TOL_SLOTS * np.abs(
            flat_v[path]).max()
        err = np.abs(flat_g[path] - r).max()
        assert err <= bound, f"{what} params{jax.tree_util.keystr(path)}"


def test_executor_three_steps(executors):
    for i, s in enumerate(executors["steps"]):
        _close(s["loss"][1], s["loss"][0], TOL_LOSS, 0)
        assert s["acc"][1] == s["acc"][0], i
        assert s["step"] == (i + 1, i + 1)
        _check_step(s["ref"], s["got"], f"step {i}")


def test_executor_keeps_the_buffers_as_its_model_state(executors):
    tm, tstate = executors["tm"], executors["tstate"]
    own = state_buffers(tm)
    assert tstate.model_state.keys() == own.keys()
    assert all(tstate.model_state[k] is t for k, t in own.items())


def test_validate_matches(executors):
    ref, got = executors["valid"]
    _close(got["loss"], ref["loss"], TOL_LOSS, 0)
    assert float(got["acc"]) == float(ref["acc"])


def test_guarded_step_on_a_nan_batch_keeps_parameters_slots_and_state(
        executors):
    """Both packages skip the step and count it; the reference keeps its
    pre-step trees (``jnp.where``), the port restores, bitwise, its
    snapshot of the tensors that the forward (the batch norms' buffers)
    and the update wrote in place."""
    gd = executors["guard"]
    assert gd["nonfinite"] == (1, 1) and not np.isfinite(gd["loss"])
    assert gd["step"] == (4, 4)
    for k, a in gd["before"].items():
        if k != "[<flat index 4>]":  # the step counter advances
            assert np.array_equal(gd["after"][k], a), k
    _check_step(gd["ref"], gd["got"], "kept")


def test_checkpoints_cross_the_packages_both_ways(executors, tmp_path):
    """The reference's checkpoint loads into a fresh port state and gives
    the reference's next loss; the port's checkpoint loads into the
    reference's template as the same tree, key for key and bit for bit
    (``state_dict`` of both packages)."""
    tm = models.ResNet18(device="cpu",
                         generator=torch.Generator().manual_seed(5))
    tex = Executor(tm.loss_fn(), optim.MomentumOptimizer(LR, 0.9))
    tstate = checkpoint.load(executors["jax_ckpt"], tex.init_state(tm), tm)
    assert tstate.step == 4 and tstate.opt_state["step"] == 3
    ref = jckpt.state_dict(jckpt.load(executors["jax_ckpt"],
                                      executors["template"]))
    got = checkpoint.state_dict(tstate, tm)
    assert list(got) == list(ref)
    for k, r in ref.items():
        assert np.array_equal(got[k], r), k
    _, met = tex.run("train", tstate, executors["next_batch"])
    _close(float(met["loss"]), executors["next_loss"], TOL_LOSS, 0)

    path = tmp_path / "port.npz"
    src, tsrc = executors["tm"], executors["tstate"]
    executors["tex"].save(path, tsrc, src, extra={"epoch": 1})
    assert checkpoint.read_header(path) == jckpt.read_header(path)
    assert checkpoint.read_header(path)["extra"] == {"epoch": 1}
    loaded = jckpt.state_dict(jckpt.load(path, executors["template"]))
    want = checkpoint.state_dict(tsrc, src)
    assert list(loaded) == list(want)
    for k, w in want.items():
        assert np.array_equal(loaded[k], w), k
    # and back through the port's Executor.load
    fresh = tex.init_state(tm)
    tex.load(path, fresh, tm)
    for k, w in checkpoint.state_dict(fresh, tm).items():
        assert np.array_equal(w, want[k]), k


# ------------------------------------------------------ VGG, LeNet, MLP

@pytest.mark.parametrize("name", ["vgg11", "lenet", "mlp"])
def test_zoo_forward_and_one_step(name):
    """The evaluation forward, then one Executor step (Momentum) on each
    side: loss, parameters and the batch norms' state.  VGG's DropOut runs
    at rate 0 on both sides."""
    g = np.random.default_rng(30)
    if name == "vgg11":
        jm, tm = jmodels.VGG(11), models.VGG(11, device="cpu")
        jm.modules[-2].rate = 0.0
        tm.get_submodule(str(len(jm.modules) - 2)).rate = 0.0
        x, y = _images(g, 4)
    elif name == "lenet":
        jm, tm = jmodels.LeNet(), models.LeNet(device="cpu")
        x, y = _images(g, 4, c=1)
    else:
        jm, tm = jmodels.MLP(), models.MLP(device="cpu")
        x, y = g.standard_normal((8, 784), np.float32), \
            g.integers(0, 10, 8).astype(np.int32)
    v = _variables(jm, 31)
    _port(tm, v)
    ref = np.asarray(jm.apply(v, x)[0])
    with torch.no_grad():
        _close(tm(_t(x)), ref, 0, TOL_LOGITS * np.abs(ref).max())
    jex = JExecutor(_jax_loss_fn(jm), joptim.MomentumOptimizer(0.1, 0.9),
                    seed=0)
    jstate, jmet = jex.run("train", jex.init_state(v), (x, y))
    tex = Executor(models.classifier_loss_fn(tm),
                   optim.MomentumOptimizer(0.1, 0.9), seed=0)
    tstate, tmet = tex.run("train", tex.init_state(tm), (x, y))
    _close(float(tmet["loss"]), float(jmet["loss"]), TOL_LOSS, 0)
    _check_step(_jax_state_tree(jstate), _port_state_tree(tstate, tm), name)


def test_vgg_dropout_draws_from_the_steps_generator():
    """VGG-11 trains with DropOut(0.5) from the Executor's step generator:
    two runs from the same seed give the same loss; a training forward
    without a generator raises."""
    losses = []
    for _ in range(2):
        trng.set_random_seed(0)
        tm = models.VGG(11, device="cpu")
        tex = Executor(models.classifier_loss_fn(tm),
                       optim.MomentumOptimizer(0.1, 0.9), seed=0)
        x, y = _images(np.random.default_rng(32), 4)
        state, met = tex.run("train", tex.init_state(tm), (x, y))
        losses.append(float(met["loss"]))
    assert losses[0] == losses[1]
    with pytest.raises(ValueError, match="generator"):
        tm(_t(x), train=True)


def test_interop_round_trip_of_a_tree_model_with_state():
    tm = models.VGG(11, device="cpu")
    for t in state_buffers(tm).values():
        t.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
    params = interop.params_to_jax(dict(tm.named_parameters()), tm)
    state = interop.state_to_jax(state_buffers(tm), tm)
    assert set(state) == {name for name, _ in tm.named_children()}
    assert state["0"] == {} and set(state["1"]) == {"mean", "var"}
    back = {**interop.params_from_jax(params, tm),
            **interop.state_from_jax({"state": state}, tm)}
    for k, t in tm.state_dict().items():
        assert torch.equal(back[k], t), k
