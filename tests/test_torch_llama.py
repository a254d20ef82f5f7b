"""The Llama slice of hetu_tpu_torch against hetu_tpu on the CPU.

Inputs and parameters are numpy arrays drawn from a seed, in the JAX
package's layout, fed to both packages (to the port through
``interop.params_from_jax``).  Two small configurations: "mha", H 256
with 2 heads, so head dim 128 (Llama-2-7B's) is covered; and "gqa", 4
query heads sharing 2 kv heads.  Both attention paths run: "flash" (the
Pallas kernels in interpret mode against the plain versions of the port's
CUDA kernels, which CPU tensors take) and "xla".

Tolerances, all stated beside their tests:

* float32 ops (rms_norm, silu, the RoPE tables and rotations): 1e-6
  relative and absolute, a few ulps of values of size ~1;
* bfloat16 ops: one bf16 ulp of the value (2^-8 relative) plus 2^-8 of
  the largest element: the two packages may keep an intermediate of a
  fused bf16 expression in f32 where the other rounds it;
* float32 logits, K and V through two layers: 1e-4 (only the order of
  f32 sums differs, and the Pallas kernels sum in blocks);
* the loss 1e-5 relative; every gradient 1e-4 relative plus 1e-4 of its
  parameter's largest gradient (f32 sums over 48 rows and widths up to
  256, in another order; a wrong term moves elements by their own size);
* after AdamW steps: parameters and slots within AdamW's bound of the
  gradient gaps (``tests/adamw_bound.py``; the derivation is in
  ``tests/test_torch_gpt_train.py``), with eps 1e-3 so that a gradient of
  rounding noise cannot be scaled up to a full step;
* greedy decode through the engines: token-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from adamw_bound import adamw_atol, flat, get
from hetu_tpu import ops as jops
from hetu_tpu import rng as jax_rng
from hetu_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from hetu_tpu.models.llama import LlamaModel as JaxLlamaModel
from hetu_tpu.optim import AdamWOptimizer as JaxAdamW
from hetu_tpu.serve import ContinuousBatchingScheduler as JaxScheduler
from hetu_tpu.serve import Request as JaxRequest
from hetu_tpu.serve import ServeEngine as JaxServeEngine
from hetu_tpu.train import Executor as JaxExecutor
from hetu_tpu_torch import interop, ops
from hetu_tpu_torch import rng as torch_rng
from hetu_tpu_torch.models import LlamaConfig, LlamaModel, llama2_7b
from hetu_tpu_torch.optim import AdamWOptimizer
from hetu_tpu_torch.ops.cuda_kernels import flash_attention
from hetu_tpu_torch.serve import (
    ContinuousBatchingScheduler, Request, ServeEngine,
)
from hetu_tpu_torch.train import Executor

torch.set_num_threads(2)

TOL = 1e-4
TOL_OP = 1e-6
TOL_LOSS, TOL_G, TOL_G_MAX = 1e-5, 1e-4, 1e-4
V, L, P, FFN, B, S = 97, 2, 64, 96, 2, 24
CONFIGS = {"mha": dict(hidden_size=256, num_heads=2, num_kv_heads=None),
           "gqa": dict(hidden_size=64, num_heads=4, num_kv_heads=2)}
IMPLS = ["xla", "flash"]
CHUNK = 16  # 2 x 23 = 46 loss rows: three chunks, the last one padded


@pytest.fixture(autouse=True)
def _keep_global_rng_status():
    saved = jax_rng.get_seed_status(), torch_rng.get_seed_status()
    yield
    jax_rng.set_seed_status(*saved[0])
    torch_rng.set_seed_status(*saved[1])


def _cfg_kw(name, impl, **kw):
    return dict(vocab_size=V, num_layers=L, ffn_size=FFN, max_position=P,
                rope_theta=500.0, attention_impl=impl, ce_row_chunk=CHUNK,
                **CONFIGS[name], **kw)


def jax_params(name, seed=0):
    """Llama parameters in hetu_tpu's layout ([in, out], blocks stacked
    [L, ...]); the RMS scales random too, so a swapped tensor shows."""
    c = JaxLlamaConfig(**_cfg_kw(name, "xla"))
    g = np.random.default_rng(seed)
    h, hd = c.hidden_size, c.hidden_size // c.num_heads
    n_qkv = (c.num_heads + 2 * c.num_kv_heads) * hd

    def r(*shape, scale=0.1, loc=0.0):
        return (loc + scale * g.standard_normal(shape)).astype(np.float32)

    w = lambda *shape: r(*shape, scale=1.5 / np.sqrt(shape[-2]))
    return {
        "tok_emb": r(V, h, scale=0.5), "lm_head": r(V, h, scale=0.3),
        "rms_f_scale": r(h, loc=1.0),
        "blocks": {
            "attn": {"qkv_weight": w(L, h, n_qkv), "out_weight": w(L, h, h)},
            "rms1_scale": r(L, h, loc=1.0), "rms2_scale": r(L, h, loc=1.0),
            "ffn_gate": w(L, h, FFN), "ffn_up": w(L, h, FFN),
            "ffn_down": w(L, FFN, h),
        },
    }


def _tree(fn, t):
    return {k: _tree(fn, v) for k, v in t.items()} \
        if isinstance(t, dict) else fn(t)


def _jax_model(name, impl, **kw):
    return JaxLlamaModel(JaxLlamaConfig(**_cfg_kw(name, impl, **kw)))


def _jax_vars(name):
    return {"params": _tree(jnp.asarray, jax_params(name)), "state": {}}


def _torch_model(name, impl, dtype=torch.float32, params=None, **kw):
    cfg = LlamaConfig(**_cfg_kw(name, impl, **kw), dtype=dtype)
    m = LlamaModel(cfg, device="cpu")
    m.load_state_dict(interop.params_from_jax(
        jax_params(name) if params is None else params, cfg))
    return m


def _ids(b=B, s=S, seed=1):
    return np.random.default_rng(seed).integers(0, V, (b, s)).astype(
        np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _close_bf16(got, want):
    """Within one bf16 ulp of each value plus 2^-8 of the largest."""
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    tol = 2 ** -8 * (np.abs(want) + np.abs(want).max())
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


def _grad_bound(want):
    """Each element's gradient tolerance (module docstring)."""
    w = np.abs(np.asarray(want, np.float32))
    return TOL_G * w + TOL_G_MAX * w.max()


def _assert_grads_close(got, want):
    got, want = dict(flat(got)), dict(flat(want))
    assert set(got) == set(want)
    for path, w in want.items():
        err = np.abs(got[path] - w)
        assert np.all(err <= _grad_bound(w)), (path, err.max())


# ------------------------------------------------------------------- ops

def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches(dtype):
    x, scale = _x((3, 5, 128), 0, 3.0), _x((128,), 1) + 1.0
    want = jops.rms_norm(jnp.asarray(x).astype(dtype), jnp.asarray(scale),
                         eps=1e-6)
    got = ops.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                       torch.from_numpy(scale), eps=1e-6)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close(got, want, TOL_OP)
    else:  # statistics in f32 and one rounding at the end: bitwise
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_matches_in_the_input_type(dtype):
    x = _x((4, 300), 2, 4.0)
    want = jops.silu(jnp.asarray(x).astype(dtype))
    got = ops.silu(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close(got, want, TOL_OP)
    else:
        _close_bf16(got, want)


@pytest.mark.parametrize("seq,head_dim,theta", [(16, 128, 1e4),
                                                (4096, 128, 1e4),
                                                (33, 16, 500.0)])
def test_rope_tables_match(seq, head_dim, theta):
    wc, ws = jops.rope_tables(seq, head_dim, theta=theta)
    gc, gs = ops.rope_tables(seq, head_dim, theta=theta, device="cpu")
    assert gc.shape == (seq, head_dim // 2) and gc.dtype == torch.float32
    # angles up to seq radians: cos/sin of f32 arguments that large agree
    # to an f32 ulp of the argument's size
    tol = 4 * seq * 2 ** -24 + TOL_OP
    _close(gc, wc, tol)
    _close(gs, ws, tol)


def test_rope_refuses_an_odd_head_dim():
    with pytest.raises(ValueError, match="even"):
        ops.rope_tables(8, 7, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_the_half_rotation(dtype):
    """The [x1 | x2] layout, tables cast to x's type: bf16 q/k rotate in
    bf16 and come out bf16."""
    x = _x((2, 3, 10, 32), 3)
    cos, sin = jops.rope_tables(10, 32)
    want = jops.apply_rope(jnp.asarray(x).astype(dtype), cos, sin)
    tc, ts = ops.rope_tables(10, 32, device="cpu")
    got = ops.apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                         tc, ts)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close(got, want, TOL_OP)
        # not the interleaved-pairs layout
        xi = torch.from_numpy(x)
        pairs = torch.stack([xi[..., 0::2] * tc - xi[..., 1::2] * ts,
                             xi[..., 1::2] * tc + xi[..., 0::2] * ts],
                            -1).flatten(-2)
        assert (pairs - got).abs().max() > 0.1
    else:
        _close_bf16(got, want)


def test_apply_rope_at_matches_and_clamps():
    """Per-sequence positions, one past the table's end: the reference
    clamps the gather to the last row, and so does the port."""
    x = _x((3, 2, 4, 16), 4)
    cos, sin = jops.rope_tables(12, 16)
    positions = np.array([0, 5, 10], np.int32)  # 10 + 3 > 11: clamped
    want = jops.apply_rope_at(jnp.asarray(x), cos, sin,
                              jnp.asarray(positions))
    tc, ts = ops.rope_tables(12, 16, device="cpu")
    got = ops.apply_rope_at(torch.from_numpy(x), tc, ts,
                            torch.from_numpy(positions))
    _close(got, want, TOL_OP)
    assert torch.isfinite(got).all()
    # the clamped rows rotate by the last row of the tables
    last = ops.apply_rope(torch.from_numpy(x[2:, :, 2:]), tc[11:12],
                          ts[11:12])
    torch.testing.assert_close(got[2:, :, 2:], last, rtol=0, atol=0)
    # positions 0.. is apply_rope
    zero = ops.apply_rope_at(torch.from_numpy(x), tc, ts,
                             torch.zeros(3, dtype=torch.int32))
    torch.testing.assert_close(zero, ops.apply_rope(torch.from_numpy(x),
                                                    tc[:4], ts[:4]),
                               rtol=0, atol=0)


# ---------------------------------------------------------------- config

def test_config_checks_the_gqa_grouping():
    with pytest.raises(ValueError, match="multiple of num_kv_heads"):
        LlamaConfig(hidden_size=64, num_heads=4, num_kv_heads=3)
    with pytest.raises(ValueError, match="divide hidden_size"):
        LlamaConfig(hidden_size=66, num_heads=4)
    assert LlamaConfig(num_heads=8).num_kv_heads == 8
    c = LlamaConfig()
    assert (c.vocab_size, c.hidden_size, c.num_layers, c.num_heads,
            c.ffn_size, c.max_position, c.rope_theta, c.rms_eps) == (
        32000, 4096, 32, 32, 11008, 4096, 1e4, 1e-6)


def test_llama2_7b_keeps_the_config_defaults():
    m = llama2_7b(device="cpu", vocab_size=V, hidden_size=64, num_layers=1,
                  num_heads=4, ffn_size=32)
    assert (m.c.max_position, m.c.rope_theta, m.c.rms_eps,
            m.c.num_kv_heads) == (4096, 1e4, 1e-6, 4)
    assert m.lm_head.shape == m.tok_emb.shape == (V, 64)
    assert m.lm_head is not m.tok_emb


# ---------------------------------------------------------------- interop

def test_interop_round_trips_both_configs():
    for name in CONFIGS:
        tree = jax_params(name)
        cfg = _torch_model(name, "xla").c
        sd = interop.params_from_jax(tree, cfg)
        assert "lm_head" in sd                     # untied: its own key
        w = tree["blocks"]["attn"]["qkv_weight"][1]          # [in, out]
        np.testing.assert_array_equal(sd["blocks.1.attn.qkv_weight"].numpy(),
                                      w.T)
        back = interop.params_to_jax(sd, cfg)
        for (ka, a), (kb, b) in zip(flat(tree), flat(back)):
            assert ka == kb
            np.testing.assert_array_equal(a, b)
        again = interop.params_to_jax(_torch_model(name, "flash")
                                      .state_dict(), cfg)
        for (_, a), (_, b) in zip(flat(tree), flat(again)):
            np.testing.assert_array_equal(a, b)


def test_interop_opt_state_round_trips():
    cfg = _torch_model("gqa", "xla").c
    tree = {"step": np.int32(3), "slots": {"m": jax_params("gqa", 1),
                                           "v": jax_params("gqa", 2)}}
    back = interop.opt_state_to_jax(interop.opt_state_from_jax(tree, cfg),
                                    cfg)
    assert int(back["step"]) == 3
    for (ka, a), (kb, b) in zip(flat(tree["slots"]), flat(back["slots"])):
        assert ka == kb
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------ forward, loss, gradients

@pytest.fixture(scope="module", params=[(n, i) for n in CONFIGS
                                        for i in IMPLS],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    name, impl = request.param
    return (name, impl, _jax_model(name, impl), _jax_vars(name),
            _torch_model(name, impl))


def test_forward_logits_match(pair):
    _, _, jm, jv, tm = pair
    ids = _ids(seed=2)
    want, _ = jm.apply(jv, jnp.asarray(ids))
    with torch.inference_mode():
        got = tm(torch.from_numpy(ids))
    assert got.shape == (B, S, V)
    _close(got, want)


_JAX_FN = {}


def _jax_value_and_grad_fn(name, impl):
    """The reference's jitted loss and gradients on :func:`_ids`, compiled
    once per configuration and path."""
    key = (name, impl)
    if key not in _JAX_FN:
        fn = _jax_model(name, impl).lm_loss_fn()
        ids = jnp.asarray(_ids())
        _JAX_FN[key] = jax.jit(jax.value_and_grad(
            lambda p: fn(p, {}, (ids,), None, True)[0]))
    return _JAX_FN[key]


def _port_loss_and_grads(model, ids):
    params = dict(model.named_parameters())
    loss, (metrics, _) = model.lm_loss_fn()(
        params, {}, (torch.from_numpy(ids),), None, True)
    assert metrics == {}
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), interop.params_to_jax(
        dict(zip(params, grads)), model.c)


@pytest.mark.parametrize("remat", [False, True], ids=["noremat", "remat"])
def test_loss_and_every_gradient_match_jax(pair, remat):
    name, impl, _, jv, _ = pair
    want_loss, want = _jax_value_and_grad_fn(name, impl)(jv["params"])
    loss, got = _port_loss_and_grads(_torch_model(name, impl, remat=remat),
                                     _ids())
    np.testing.assert_allclose(loss, float(want_loss), rtol=TOL_LOSS)
    _assert_grads_close(got, want)


def test_unfused_loss_equals_the_fused_loss():
    """The unfused head + CE is the same function as the fused one."""
    ids = torch.from_numpy(_ids())
    losses = []
    for fused in (True, False):
        m = _torch_model("gqa", "flash", fused_ce=fused)
        with torch.no_grad():
            losses.append(float(m.lm_loss_fn()(dict(m.named_parameters()),
                                               {}, ids, None, False)[0]))
    np.testing.assert_allclose(losses[0], losses[1], rtol=TOL_LOSS)


def test_gqa_repeats_each_kv_head_in_place():
    """Query heads 0 and 1 read kv head 0, heads 2 and 3 kv head 1 (the
    reference's ``jnp.repeat``); tiling the kv heads (``Tensor.repeat``)
    computes another function."""
    m = _torch_model("gqa", "xla")
    attn = m.blocks[0].attn
    ids = torch.from_numpy(_ids(1, 8, seed=5))
    with torch.inference_mode():
        x = m._embed(ids)
        cos, sin = m._tables(8)
        y, k, v = attn(x, cos, sin)
        q = ops.apply_rope(attn.qkv(x)[0].transpose(1, 2), cos, sin)
        kt, vt = (t.transpose(1, 2).repeat(1, 2, 1, 1) for t in (k, v))
        tiled = attn.out(ops.causal_attention(q, kt, vt))
    assert not torch.allclose(y, tiled, atol=1e-3)


# ------------------------------------------------------ prefill and decode

@pytest.mark.parametrize("last_index", [None, 5])
def test_prefill_logits_and_kv_match(pair, last_index):
    name, _, jm, jv, tm = pair
    ids = _ids(2, 16, seed=3)
    wl, wk, wv = jm.prefill_with_cache(jv, jnp.asarray(ids),
                                       last_index=last_index)
    with torch.inference_mode():
        gl, gk, gv = tm.prefill_with_cache(torch.from_numpy(ids),
                                           last_index=last_index)
    c = tm.c
    assert gk.shape == (L, 2, 16, c.num_kv_heads,
                        c.hidden_size // c.num_heads) == wk.shape
    for got, want in ((gl, wl), (gk, wk), (gv, wv)):
        _close(got, want)


def test_decode_logits_and_cache_match(pair):
    name, _, jm, jv, tm = pair
    c = tm.c
    s, t = 8, 24
    ids = _ids(2, s, seed=4)
    _, k, v = jm.prefill_with_cache(jv, jnp.asarray(ids))
    kc = np.zeros((L, 2, t, c.num_kv_heads, c.hidden_size // c.num_heads),
                  np.float32)
    vc = np.zeros_like(kc)
    kc[:, :, :s], vc[:, :, :s] = np.asarray(k), np.asarray(v)
    lengths = np.array([s, s - 3], np.int32)
    tokens = np.array([5, 11], np.int32)
    wl, wk, wv = jm.decode_with_cache(jv, jnp.asarray(tokens),
                                      jnp.asarray(kc), jnp.asarray(vc),
                                      jnp.asarray(lengths))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    with torch.inference_mode():
        gl, gk, gv = tm.decode_with_cache(torch.from_numpy(tokens), tk, tv,
                                          torch.from_numpy(lengths))
    assert gk is tk and gv is tv              # the port writes in place
    for got, want in ((gl, wl), (gk, wk), (gv, wv)):
        _close(got, want)


def _greedy(engine, prompt, n):
    slot = engine.alloc_slot()
    toks = [engine.prefill(slot, prompt)]
    for _ in range(n - 1):
        toks.append(engine.decode()[slot])
    engine.release(slot)
    return toks


@pytest.fixture(scope="module")
def engines(pair):
    _, _, jm, jv, tm = pair
    return (JaxServeEngine(jm, jv, num_slots=2, max_len=40, min_bucket=8),
            ServeEngine(tm, num_slots=2, max_len=40, min_bucket=8,
                        device="cpu"))


@pytest.mark.parametrize("prompt_len", [1, 9, 17])
def test_engine_greedy_tokens_equal_jax(engines, prompt_len):
    je, te = engines
    g = np.random.default_rng(prompt_len)
    prompt = [int(t) for t in g.integers(0, V, prompt_len)]
    assert _greedy(te, prompt, 10) == _greedy(je, prompt, 10)


def _requests(cls):
    g = np.random.default_rng(6)
    return [cls(prompt=[int(t) for t in g.integers(0, V, n)], max_tokens=m)
            for n, m in ((3, 7), (12, 4), (1, 9), (20, 5), (7, 12))]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_scheduler_run_tokens_equal_jax(name):
    want, got = _requests(JaxRequest), _requests(Request)
    JaxScheduler(JaxServeEngine(_jax_model(name, "flash"), _jax_vars(name),
                                num_slots=3, max_len=40,
                                min_bucket=8)).run(want)
    te = ServeEngine(_torch_model(name, "flash"), num_slots=3, max_len=40,
                     min_bucket=8, device="cpu")
    ContinuousBatchingScheduler(te).run(got)
    assert [r.status for r in got] == ["ok"] * len(got)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert te.cache.k.shape[3] == te.model.c.num_kv_heads
    assert flash_attention.launches == 0     # CPU tensors launch nothing


# ------------------------------------------------------------ serving copy

class _CopiedBytes(TorchDispatchMode):
    """Bytes written by the copies and casts dispatched inside it."""

    _OPS = (torch.ops.aten.clone.default, torch.ops.aten._to_copy.default,
            torch.ops.aten.copy_.default)

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self._OPS:
            self.n += out.numel() * out.element_size()
        return out


def test_inference_copy_casts_each_weight_once_without_a_float32_copy():
    """bf16 matmul weights and head, f32 tok_emb and RMS scales (as the
    reference keeps them); the copy writes exactly those bytes (no deep
    copy of the f32 model first: at 7B that is 27 GB more), leaves the
    training model f32, and gives bitwise the logits of casting at each
    use."""
    tm = _torch_model("mha", "flash", dtype=torch.bfloat16)
    with _CopiedBytes() as copied:
        served = tm.inference_copy()
    kept = {"tok_emb", "rms_f_scale"} | {
        n for n, _ in served.named_parameters() if "rms" in n}
    for n, p in served.named_parameters():
        assert p.dtype == (torch.float32 if n in kept else torch.bfloat16), n
        assert not p.requires_grad
    assert copied.n == sum(p.numel() * p.element_size()
                           for p in served.parameters())
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    ids = torch.from_numpy(_ids(1, 16, seed=4))
    with torch.inference_mode():
        a = served.prefill_with_cache(ids, last_index=9)
        b = tm.prefill_with_cache(ids, last_index=9)
    for x, y in zip(a, b):
        assert x.dtype == torch.bfloat16
        assert torch.equal(x, y)


def test_float32_inference_copy_owns_its_storage():
    """An f32 model's copy shares no storage with it, so an update of the
    training model (an in-place optimizer step here) leaves a running
    server's weights as they were."""
    tm = _torch_model("gqa", "flash")
    served = tm.inference_copy()
    src = dict(tm.named_parameters())
    before = {n: p.clone() for n, p in served.named_parameters()}
    for n, p in served.named_parameters():
        assert p.dtype == torch.float32, n
        assert p.data_ptr() != src[n].data_ptr(), n
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(1.0)
    for n, p in served.named_parameters():
        assert torch.equal(p, before[n]), n


def test_rope_tables_are_made_once_and_match_fresh_ones(monkeypatch):
    """Prefill and every decode step slice one set of tables, bitwise
    those ``rope_tables`` makes for the length asked."""
    from hetu_tpu_torch.models import llama as llama_mod

    tm = _torch_model("mha", "flash").inference_copy()
    made = []
    orig = llama_mod.ops.rope_tables
    monkeypatch.setattr(llama_mod.ops, "rope_tables",
                        lambda *a, **k: made.append(a) or orig(*a, **k))
    ids = torch.from_numpy(_ids(2, 8, seed=5))
    with torch.inference_mode():
        _, k, v = tm.prefill_with_cache(ids)
        L, b, s, nkv, hd = k.shape
        kc = torch.zeros(L, b, 16, nkv, hd)
        vc = torch.zeros_like(kc)
        kc[:, :, :s], vc[:, :, :s] = k, v
        lengths = torch.full((b,), s)
        for _ in range(3):
            tm.decode_with_cache(ids[:, 0], kc, vc, lengths)
            lengths += 1
    assert len(made) == 1
    c = tm.c
    for n in (1, 8, c.max_position):
        for got, want in zip(tm._tables(n), orig(
                n, c.hidden_size // c.num_heads, theta=c.rope_theta,
                device="cpu")):
            assert torch.equal(got, want)


# --------------------------------------------------------------- executor

EPS, LR, STEPS = 1e-3, 1e-2, 3


def test_adamw_steps_match_the_jax_executor():
    """GQA with flash and recomputation: the loss of every step; the
    port's gradient at the reference's parameters before each step within
    the gradient tolerance; after the steps, parameters and slots within
    AdamW's bound of those gaps."""
    name, ids = "gqa", _ids()
    jex = JaxExecutor(_jax_model(name, "flash").lm_loss_fn(),
                      JaxAdamW(LR, eps=EPS), seed=0)
    js = jex.init_state(_jax_vars(name))
    model = _torch_model(name, "flash", remat=True)
    tex = Executor(model.lm_loss_fn(), AdamWOptimizer(LR, eps=EPS), seed=0)
    ts = tex.init_state(model)
    deltas, g_abs = [], []
    for step in range(STEPS):
        want = _jax_value_and_grad_fn(name, "flash")(js.params)[1]
        _, got = _port_loss_and_grads(
            _torch_model(name, "flash", params=_tree(np.asarray, js.params)),
            ids)
        _assert_grads_close(got, want)
        g_abs.append({p: np.abs(w) for p, w in flat(want)})
        deltas.append({p: _grad_bound(g) for p, g in g_abs[-1].items()})
        js, jm = jex.run("train", js, (jnp.asarray(ids),))
        ts, tm = tex.run("train", ts, (ids,))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=TOL_LOSS, err_msg=f"step {step}")
    got = {"params": interop.params_to_jax(ts.params, model.c),
           **interop.opt_state_to_jax(ts.opt_state, model.c)["slots"]}
    want = {"params": _tree(np.asarray, js.params),
            **_tree(np.asarray, js.opt_state["slots"])}
    for path in deltas[0]:
        atol = adamw_atol([d[path] for d in deltas],
                          [g[path] for g in g_abs], LR, EPS)
        for kind in want:
            w = get(want[kind], path)
            share = np.abs(get(got[kind], path) - w) / (
                TOL_G * np.abs(w) + atol[kind])
            assert share.max() <= 1, (kind, path, share.max())
