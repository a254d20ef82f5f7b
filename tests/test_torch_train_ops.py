"""The training slice's ops of hetu_tpu_torch against hetu_tpu on the CPU:
losses, optimizers, learning-rate schedules, dropout and the (seed, seqnum)
RNG.

Every input is a numpy array from a seed, fed to both packages and
compared in float32.  Tolerances: 1e-6 relative for the losses (the same
f32 reduction in another order); 1e-6 relative and 1e-7 absolute for
optimizer updates over 3 steps (the same f32 formulas in the same order;
an f32 ``pow`` or a division may round differently by one ulp); 1e-6
relative for schedules (f32 in both).  Dropout cannot match
``jax.random.bernoulli`` bit for bit, so it is held to its own contract.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu import lr as jlr
from hetu_tpu import ops as jops
from hetu_tpu import optim as joptim
from hetu_tpu_torch import lr as tlr
from hetu_tpu_torch import ops as tops
from hetu_tpu_torch import optim as toptim
from hetu_tpu_torch import rng as trng
from hetu_tpu_torch.layers.base import child_generator

torch.set_num_threads(2)


# ------------------------------------------------------------------ losses

def _ce_inputs():
    g = np.random.default_rng(2)
    n, h, v = 37, 16, 53  # N not a multiple of the row chunk
    hs = g.standard_normal((n, h)).astype(np.float32)
    w = (g.standard_normal((v, h)) * 0.2).astype(np.float32)
    y = g.integers(0, v, n).astype(np.int32)
    y[5] = y[20] = -1  # ignored rows
    return hs, w, y


def test_softmax_cross_entropy_sparse_matches_jax():
    hs, w, y = _ce_inputs()
    logits = hs @ w.T
    want = np.asarray(jops.softmax_cross_entropy_sparse(
        jnp.asarray(logits), jnp.asarray(y)))
    got = tops.softmax_cross_entropy_sparse(torch.from_numpy(logits),
                                            torch.from_numpy(y))
    assert got.dtype == torch.float32 and got[5] == 0 and got[20] == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # bf16 logits reduce in f32
    got16 = tops.softmax_cross_entropy_sparse(
        torch.from_numpy(logits).bfloat16(), torch.from_numpy(y))
    assert got16.dtype == torch.float32


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_lm_head_cross_entropy_value_and_grads_match_jax(fused):
    """The fused chunked loss (chunk 8 over 37 rows: padded) and the
    unfused head + CE, values and gradients in h and w, against JAX's
    ``lm_head_cross_entropy``."""
    hs, w, y = _ce_inputs()

    def jloss(h, w):
        return jops.lm_head_cross_entropy(h, w, jnp.asarray(y), row_chunk=8)

    lj, (ghj, gwj) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(hs), jnp.asarray(w))
    h_t = torch.from_numpy(hs).requires_grad_()
    w_t = torch.from_numpy(w).requires_grad_()
    y_t = torch.from_numpy(y)
    if fused:
        loss = tops.lm_head_cross_entropy(h_t, w_t, y_t, row_chunk=8)
    else:
        per = tops.softmax_cross_entropy_sparse(h_t @ w_t.t(), y_t)
        loss = per.sum() / (y_t != -1).sum()
    gh, gw = torch.autograd.grad(loss, (h_t, w_t))
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-6)
    np.testing.assert_allclose(gh.numpy(), np.asarray(ghj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(gw.numpy(), np.asarray(gwj), rtol=1e-5,
                               atol=1e-6)


def test_lm_head_cross_entropy_all_ignored_is_zero():
    h = torch.randn(5, 4)
    w = torch.randn(7, 4)
    y = torch.full((5,), -1)
    assert float(tops.lm_head_cross_entropy(h, w, y, row_chunk=4)) == 0.0


# -------------------------------------------------------------- optimizers

def _params():
    g = np.random.default_rng(0)
    return {"w": g.standard_normal((4, 3)).astype(np.float32),
            "b": g.standard_normal((3,)).astype(np.float32)}


def _grads(seed):
    g = np.random.default_rng(seed)
    return {k: g.standard_normal(v.shape).astype(np.float32)
            for k, v in _params().items()}


OPTIMIZERS = [
    ("SGDOptimizer", dict(learning_rate=0.1)),
    ("SGDOptimizer", dict(learning_rate=0.1, l2reg=0.01)),
    ("MomentumOptimizer", dict(learning_rate=0.1, momentum=0.9)),
    ("NesterovOptimizer", dict(learning_rate=0.1, momentum=0.9)),
    ("AdaGradOptimizer", dict(learning_rate=0.1,
                              initial_accumulator_value=0.1)),
    ("AdamOptimizer", dict(learning_rate=0.01)),
    ("AMSGradOptimizer", dict(learning_rate=0.01)),
    ("AdamWOptimizer", dict(learning_rate=0.01, weight_decay=0.1)),
    ("LambOptimizer", dict(learning_rate=0.01)),
]


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=[f"{n}{'_l2' if 'l2reg' in k else ''}"
                              for n, k in OPTIMIZERS])
def test_optimizer_matches_jax_over_three_steps(name, kw):
    """The same params, a different gradient each step, and (for the
    schedule case) the same learning rate: params and every slot agree."""
    jopt = getattr(joptim, name)(**kw)
    topt = getattr(toptim, name)(**kw)
    jp = {k: jnp.asarray(v) for k, v in _params().items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in _params().items()}
    js, ts = jopt.init_state(jp), topt.init_state(tp)
    for step in range(3):
        g = _grads(step + 1)
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                             js, jp)
        tp, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp)
    assert ts["step"] == int(js["step"]) == 3
    for k in tp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    assert set(ts["slots"]) == set(js["slots"])
    for slot in ts["slots"]:
        for k in tp:
            t = ts["slots"][slot][k]
            assert t.dtype == torch.float32
            np.testing.assert_allclose(
                t.numpy(), np.asarray(js["slots"][slot][k]), rtol=1e-6,
                atol=1e-7, err_msg=f"{slot}/{k}")


def test_optimizer_updates_in_place_with_a_schedule():
    """The tensors given are the tensors updated; a schedule is read at the
    new step (1, 2, ...), as in the reference."""
    seen = []

    def sched(step):
        seen.append(step)
        return 0.1

    p = {"w": torch.ones(3)}
    opt = toptim.SGDOptimizer(sched)
    st = opt.init_state(p)
    w = p["w"]
    for _ in range(2):
        p, st = opt.update({"w": torch.ones(3)}, st, p)
    assert p["w"] is w and seen == [1, 2]
    torch.testing.assert_close(w, torch.full((3,), 0.8))


# --------------------------------------------------------------- schedules

SCHEDULES = [
    ("ConstantScheduler", (0.1,), {}),
    ("StepScheduler", (0.1, 3), dict(gamma=0.5)),
    ("MultiStepScheduler", (0.1, [2, 5, 7]), dict(gamma=0.3)),
    ("ExponentialScheduler", (0.1,), dict(gamma=0.9)),
    ("CosineScheduler", (0.1, 10), dict(min_lr=0.01, warmup=3)),
    ("LambdaScheduler", (0.1, lambda s: 1.0 / (1.0 + s)), {}),
]


@pytest.mark.parametrize("name,args,kw", SCHEDULES,
                         ids=[s[0] for s in SCHEDULES])
def test_schedule_matches_jax(name, args, kw):
    js = getattr(jlr, name)(*args, **kw)
    ts = getattr(tlr, name)(*args, **kw)
    for step in range(13):
        want = float(js(jnp.asarray(step, jnp.int32)))
        got = ts(step)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str(step))


# ----------------------------------------------------------------- dropout

def test_dropout_contract():
    """Deterministic for one generator state, different for another; kept
    share within 4 standard deviations of 1 - rate; kept values scaled by
    1/keep in x's type; the identity when not training or at rate 0."""
    rate, n = 0.25, 1 << 16
    x = torch.rand(n, generator=torch.Generator().manual_seed(0)) + 1.0
    a = tops.dropout(x, rate, torch.Generator().manual_seed(1))
    b = tops.dropout(x, rate, torch.Generator().manual_seed(1))
    c = tops.dropout(x, rate, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    share = kept.float().mean().item()
    sd = (rate * (1 - rate) / n) ** 0.5
    assert abs(share - (1 - rate)) < 4 * sd
    torch.testing.assert_close(a[kept], x[kept] / (1 - rate))
    y = tops.dropout(x.bfloat16(), rate, torch.Generator().manual_seed(1))
    assert y.dtype == torch.bfloat16
    assert tops.dropout(x, rate, None, train=False) is x
    assert tops.dropout(x, 0.0, None) is x
    with pytest.raises(ValueError, match="generator"):
        tops.dropout(x, rate, None)


def test_child_generators_are_stateless_in_the_parent():
    """A child depends on the parent's seed and its index only, so a
    recomputed block draws the same mask; different indices differ."""
    parent = torch.Generator().manual_seed(7)
    x = torch.ones(4096)
    m0 = tops.dropout(x, 0.5, child_generator(parent, 0))
    torch.rand(10, generator=parent)  # the parent draws in between
    assert torch.equal(m0, tops.dropout(x, 0.5, child_generator(parent, 0)))
    assert not torch.equal(m0, tops.dropout(x, 0.5,
                                            child_generator(parent, 1)))
    assert child_generator(None, 0) is None


def test_rng_seed_status_round_trip():
    """(seed, seqnum) semantics: a restored status gives the same streams,
    and every draw advances seqnum."""
    saved = trng.get_seed_status()
    try:
        _round_trip()
    finally:
        trng.set_seed_status(*saved)


def _round_trip():
    trng.set_random_seed(11)
    assert trng.get_seed_status() == (11, 0)
    a = torch.rand(4, generator=trng.next_generator("cpu"))
    n = trng.np_rng().integers(0, 1 << 30, 3)
    assert trng.get_seed_status() == (11, 2)
    assert trng.step_seqnum(3) == 5
    trng.set_seed_status(11, 0)
    assert torch.equal(a, torch.rand(4, generator=trng.next_generator("cpu")))
    assert np.array_equal(n, trng.np_rng().integers(0, 1 << 30, 3))
    b = torch.rand(4, generator=trng.next_generator("cpu"))
    assert not torch.equal(a, b)
