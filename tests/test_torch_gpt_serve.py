"""The serving slice of hetu_tpu_torch against hetu_tpu on the CPU.

One set of GPT parameters, drawn with numpy from a seed in the JAX
package's layout, goes into both packages (into the port through
``interop.params_from_jax``).  Then: the port's forward, prefill and decode
logits, K and V match JAX within 1e-4 in float32 for both attention paths
("xla" and "flash"; JAX's flash runs the Pallas kernel in interpret mode,
the port's the plain version of its CUDA kernel), and the greedy tokens of
the port's ServeEngine and ContinuousBatchingScheduler equal hetu_tpu's
exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu.models.gpt import GPTConfig as JaxGPTConfig
from hetu_tpu.models.gpt import GPTModel as JaxGPTModel
from hetu_tpu.serve import ContinuousBatchingScheduler as JaxScheduler
from hetu_tpu.serve import Request as JaxRequest
from hetu_tpu.serve import ServeEngine as JaxServeEngine
from hetu_tpu_torch import interop
from hetu_tpu_torch.layers import Linear
from hetu_tpu_torch.models import GPTConfig, GPTModel
from hetu_tpu_torch.ops.cuda_kernels import flash_attention
from hetu_tpu_torch.serve import (
    ContinuousBatchingScheduler, Request, ServeEngine,
)

torch.set_num_threads(2)

TOL = 1e-4  # f32 logits/K/V through two layers: only sum order differs
V, H, L, NH, FFN, P = 97, 64, 2, 4, 128, 64
IMPLS = ["xla", "flash"]


def jax_params(seed=0):
    """GPT parameters in hetu_tpu's layout: Linear/MHA weights [in, out],
    blocks stacked [L, ...].  Biases and LayerNorm parameters are random
    too, so a swapped or untransposed tensor cannot go unnoticed."""
    g = np.random.default_rng(seed)

    def r(*shape, scale=0.1, loc=0.0):
        return (loc + scale * g.standard_normal(shape)).astype(np.float32)

    return {
        "tok_emb": r(V, H, scale=0.5), "pos_emb": r(P, H, scale=0.5),
        "blocks": {
            "attn": {"qkv_weight": r(L, H, 3 * H, scale=0.15),
                     "qkv_bias": r(L, 3 * H),
                     "out_weight": r(L, H, H, scale=0.15),
                     "out_bias": r(L, H)},
            "ln1": {"scale": r(L, H, loc=1.0), "bias": r(L, H)},
            "ffn_in": {"weight": r(L, H, FFN, scale=0.15),
                       "bias": r(L, FFN)},
            "ffn_out": {"weight": r(L, FFN, H, scale=0.1), "bias": r(L, H)},
            "ln2": {"scale": r(L, H, loc=1.0), "bias": r(L, H)},
        },
        "ln_f_scale": r(H, loc=1.0), "ln_f_bias": r(H),
    }


def _jax_model(impl):
    m = JaxGPTModel(JaxGPTConfig(
        vocab_size=V, hidden_size=H, num_layers=L, num_heads=NH,
        ffn_size=FFN, max_position=P, dropout_rate=0.0,
        attention_impl=impl))
    tree = jax_params()
    variables = {"params": _tree_map(jnp.asarray, tree), "state": {}}
    return m, variables


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _torch_model(impl, dtype=torch.float32):
    cfg = GPTConfig(vocab_size=V, hidden_size=H, num_layers=L, num_heads=NH,
                    ffn_size=FFN, max_position=P, dtype=dtype,
                    attention_impl=impl)
    m = GPTModel(cfg, device="cpu")
    m.load_state_dict(interop.params_from_jax(jax_params(), cfg))
    return m


@pytest.fixture(scope="module", params=IMPLS)
def pair(request):
    return _jax_model(request.param), _torch_model(request.param)


def _ids(b, s, seed):
    return np.random.default_rng(seed).integers(0, V, (b, s)).astype(
        np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


# ---- interop ----

def test_interop_round_trips():
    tree = jax_params()
    cfg = _torch_model("xla").c
    back = interop.params_to_jax(interop.params_from_jax(tree, cfg), cfg)
    assert _tree_map(np.shape, back) == _tree_map(np.shape, tree)
    flat = lambda t: [(k, v) for k, v in _flatten(t)]
    for (ka, a), (kb, b) in zip(flat(tree), flat(back)):
        assert ka == kb
        np.testing.assert_array_equal(a, b)
    # and through a real model's state_dict
    again = interop.params_to_jax(_torch_model("flash").state_dict(), cfg)
    for (_, a), (_, b) in zip(flat(tree), flat(again)):
        np.testing.assert_array_equal(a, b)


def _flatten(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_interop_transposes_linear_weights():
    tree = jax_params()
    sd = interop.params_from_jax(tree, _torch_model("xla").c)
    w = tree["blocks"]["attn"]["qkv_weight"][1]                 # [in, out]
    np.testing.assert_array_equal(sd["blocks.1.attn.qkv.weight"].numpy(),
                                  w.T)
    assert "head_weight" not in sd       # tied to tok_emb, no key of its own


def test_interop_refuses_a_wrong_layer_count():
    cfg = _torch_model("xla").c
    cfg.num_layers = 3
    with pytest.raises(ValueError, match="3"):
        interop.params_from_jax(jax_params(), cfg)


# ---- forward, prefill and decode logits against JAX ----

def test_forward_logits_match(pair):
    (jm, jv), tm = pair
    ids = _ids(2, 16, seed=1)
    want, _ = jm.apply(jv, jnp.asarray(ids))
    with torch.inference_mode():
        got = tm(torch.from_numpy(ids))
    assert got.shape == (2, 16, V)
    _close(got, want)


@pytest.mark.parametrize("last_index", [None, 5])
def test_prefill_logits_and_kv_match(pair, last_index):
    (jm, jv), tm = pair
    ids = _ids(2, 16, seed=2)
    wl, wk, wv = jm.prefill_with_cache(jv, jnp.asarray(ids),
                                       last_index=last_index)
    with torch.inference_mode():
        gl, gk, gv = tm.prefill_with_cache(torch.from_numpy(ids),
                                           last_index=last_index)
    assert gk.shape == (L, 2, 16, NH, H // NH) == wk.shape
    for got, want in ((gl, wl), (gk, wk), (gv, wv)):
        _close(got, want)


def test_decode_logits_and_cache_match(pair):
    (jm, jv), tm = pair
    s, t = 8, 24
    ids = _ids(2, s, seed=3)
    _, k, v = jm.prefill_with_cache(jv, jnp.asarray(ids))
    kc = np.zeros((L, 2, t, NH, H // NH), np.float32)
    vc = np.zeros_like(kc)
    kc[:, :, :s], vc[:, :, :s] = np.asarray(k), np.asarray(v)
    lengths = np.array([s, s - 3], np.int32)  # the second prompt is shorter
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


# ---- the engine and the scheduler: greedy tokens equal ----

def _greedy(engine, prompt, n):
    slot = engine.alloc_slot()
    toks = [engine.prefill(slot, prompt)]
    for _ in range(n - 1):
        toks.append(engine.decode()[slot])
    engine.release(slot)
    return toks


@pytest.fixture(scope="module")
def engines(pair):
    (jm, jv), tm = pair
    return (JaxServeEngine(jm, jv, num_slots=2, max_len=40, min_bucket=8),
            ServeEngine(tm, num_slots=2, max_len=40, min_bucket=8,
                        device="cpu"))


@pytest.mark.parametrize("prompt_len", [1, 5, 9, 17])
def test_engine_greedy_tokens_equal_jax(engines, prompt_len):
    je, te = engines
    g = np.random.default_rng(prompt_len)
    prompt = [int(t) for t in g.integers(0, V, prompt_len)]
    assert _greedy(te, prompt, 10) == _greedy(je, prompt, 10)


def _requests(cls):
    g = np.random.default_rng(6)
    return [cls(prompt=[int(t) for t in g.integers(0, V, n)], max_tokens=m)
            for n, m in ((3, 7), (12, 4), (1, 9), (20, 5), (7, 12), (9, 3))]


def test_scheduler_run_tokens_equal_jax(pair):
    (jm, jv), tm = pair
    want = _requests(JaxRequest)
    got = _requests(Request)
    JaxScheduler(JaxServeEngine(jm, jv, num_slots=3, max_len=40,
                                min_bucket=8)).run(want)
    te = ServeEngine(tm, num_slots=3, max_len=40, min_bucket=8,
                     device="cpu")
    ContinuousBatchingScheduler(te).run(got)
    assert [r.status for r in got] == ["ok"] * 6
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert te.metrics.snapshot()["decode_steps"] > 0


@pytest.mark.parametrize("impl", IMPLS)
def test_parity_independent_of_bucket_padding(impl):
    """One prompt through two buckets (forced by min_bucket) gives the same
    tokens: pad K/V never leaks into real positions."""
    tm = _torch_model(impl)
    prompt = [3, 14, 15, 9, 2]
    small = ServeEngine(tm, num_slots=1, max_len=40, min_bucket=8,
                        device="cpu")
    big = ServeEngine(tm, num_slots=1, max_len=40, min_bucket=32,
                      device="cpu")
    assert _greedy(small, prompt, 8) == _greedy(big, prompt, 8)
    assert small.metrics.snapshot()["prefill_compiles"] == 1


def test_engine_casts_weights_once_to_the_compute_type():
    """A bf16 engine stores its matmul weights (and the tied head) in bf16
    once; embeddings and LayerNorm stay f32 as in the reference.  Its
    logits are bitwise those of the model that casts at every use."""
    tm = _torch_model("flash", dtype=torch.bfloat16)
    engine = ServeEngine(tm, num_slots=1, max_len=32, min_bucket=8,
                         device="cpu")
    served = engine.model
    lin = [m for m in served.modules() if isinstance(m, Linear)]
    assert lin and all(m.weight.dtype == torch.bfloat16 for m in lin)
    assert served.tok_emb.dtype == torch.float32
    assert served.ln_f.scale.dtype == torch.float32
    assert served.head_weight.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    ids = torch.from_numpy(_ids(1, 16, seed=4))
    with torch.inference_mode():
        a = served.prefill_with_cache(ids, last_index=9)
        b = tm.prefill_with_cache(ids, last_index=9)
    for x, y in zip(a, b):
        assert x.dtype == torch.bfloat16
        assert torch.equal(x, y)


def test_engine_counts_buckets_and_decode_steps():
    engine = ServeEngine(_torch_model("flash"), num_slots=2, max_len=40,
                         min_bucket=8, device="cpu")
    assert engine.buckets == (8, 16, 32, 40)
    for n in (3, 5, 12):
        _greedy(engine, list(range(1, n + 1)), 3)
    snap = engine.metrics.snapshot()
    assert snap["prefill_compiles"] == 2 and snap["decode_steps"] == 6
    assert flash_attention.launches == 0     # CPU tensors launch nothing


@pytest.mark.parametrize("impl", IMPLS)
def test_eos_stops_at_its_token_and_frees_the_slot(impl):
    """The scheduler's EOS stop against the reference's stream: the eos is
    a token whose FIRST appearance in the greedy stream is at its own
    index (a token seen earlier would stop the stream there), so both
    packages' schedulers must emit the stream up to and including it, and
    the slot is free again."""
    jm, jv = _jax_model(impl)
    tm = _torch_model(impl)
    prompt = [3, 14, 15]
    ref = _greedy(JaxServeEngine(jm, jv, num_slots=1, max_len=32,
                                 min_bucket=8), prompt, 10)
    firsts = [i for i in range(1, 9) if ref.index(ref[i]) == i]
    assert firsts, f"no token first appears after index 0 in {ref}"
    stop = firsts[-1]
    eos = ref[stop]
    want = JaxRequest(prompt=prompt, max_tokens=10, eos_id=eos)
    JaxScheduler(JaxServeEngine(jm, jv, num_slots=1, max_len=32,
                                min_bucket=8)).run([want])
    engine = ServeEngine(tm, num_slots=1, max_len=32, min_bucket=8,
                         device="cpu")
    got = Request(prompt=prompt, max_tokens=10, eos_id=eos)
    out = ContinuousBatchingScheduler(engine).run([got])
    assert out[got.rid] == got.tokens == ref[:stop + 1] == want.tokens
    assert got.status == want.status == "ok"
    assert engine.cache.num_free == 1
