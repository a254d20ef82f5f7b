"""The BERT slice of hetu_tpu_torch against hetu_tpu on the CPU.

Parameters and batches are numpy arrays drawn from a seed, in the JAX
package's layout, fed to both packages (to the port through
``interop.params_from_jax``).  Dropout is 0 in every comparison (the two
frameworks draw different bits).  Both attention paths run: "flash" (the
non-causal Pallas kernels in interpret mode against the plain versions of
the port's CUDA kernels) and "xla"; with an attention mask both take the
plain path, and flash warns, as the reference does.

Tolerances: float32 block outputs, sequence outputs and pooled outputs
1e-4 (sums in another order through two post-LN layers); the loss and its
two parts 1e-5 relative; every gradient 1e-4 relative plus 1e-4 of its
parameter's largest gradient; the truncated normal's moments within 4.5
standard errors of a 10^6-sample mean and deviation.
"""

import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adamw_bound import flat
from hetu_tpu import rng as jax_rng
from hetu_tpu.layers.transformer import TransformerBlock as JaxBlock
from hetu_tpu.models.bert import BertConfig as JaxBertConfig
from hetu_tpu.models.bert import BertModel as JaxBertModel
from hetu_tpu.optim import AdamWOptimizer as JaxAdamW
from hetu_tpu.train import Executor as JaxExecutor
from hetu_tpu_torch import init, interop, ops
from hetu_tpu_torch import rng as torch_rng
from hetu_tpu_torch.layers import MultiHeadAttention, TransformerBlock
from hetu_tpu_torch.models import BertConfig, BertModel, bert_base, bert_large
from hetu_tpu_torch.ops.cuda_kernels import flash_attention as fa_wrapper
from hetu_tpu_torch.optim import AdamWOptimizer
from hetu_tpu_torch.train import Executor

torch.set_num_threads(2)

TOL = 1e-4
TOL_LOSS, TOL_G, TOL_G_MAX = 1e-5, 1e-4, 1e-4
V, H, L, NH, FFN, P, B, S = 97, 64, 2, 4, 128, 32, 3, 16
IMPLS = ["xla", "flash"]
fa = importlib.import_module("hetu_tpu_torch.ops.cuda_kernels.flash_attention")


@pytest.fixture(autouse=True)
def _keep_global_rng_status():
    saved = jax_rng.get_seed_status(), torch_rng.get_seed_status()
    yield
    jax_rng.set_seed_status(*saved[0])
    torch_rng.set_seed_status(*saved[1])


def _r(g, *shape, scale=0.1, loc=0.0):
    return (loc + scale * g.standard_normal(shape)).astype(np.float32)


def block_params(g, *lead):
    """A TransformerBlock's parameters in hetu_tpu's layout (stacked over
    ``lead``), every one random."""
    w = lambda i, o: _r(g, *lead, i, o, scale=1.2 / np.sqrt(i))
    return {
        "attn": {"qkv_weight": w(H, 3 * H), "qkv_bias": _r(g, *lead, 3 * H),
                 "out_weight": w(H, H), "out_bias": _r(g, *lead, H)},
        "ln1": {"scale": _r(g, *lead, H, loc=1.0), "bias": _r(g, *lead, H)},
        "ffn_in": {"weight": w(H, FFN), "bias": _r(g, *lead, FFN)},
        "ffn_out": {"weight": w(FFN, H), "bias": _r(g, *lead, H)},
        "ln2": {"scale": _r(g, *lead, H, loc=1.0), "bias": _r(g, *lead, H)},
    }


def jax_params(seed=0):
    g = np.random.default_rng(seed)
    return {
        "tok_emb": _r(g, V, H, scale=0.5), "pos_emb": _r(g, P, H, scale=0.5),
        "seg_emb": _r(g, 2, H, scale=0.5),
        "emb_ln_scale": _r(g, H, loc=1.0), "emb_ln_bias": _r(g, H),
        "blocks": block_params(g, L),
        "pooler_w": _r(g, H, H, scale=0.2), "pooler_b": _r(g, H),
        "mlm_dense_w": _r(g, H, H, scale=0.2), "mlm_dense_b": _r(g, H),
        "mlm_ln_scale": _r(g, H, loc=1.0), "mlm_ln_bias": _r(g, H),
        "mlm_bias": _r(g, V), "nsp_w": _r(g, H, 2, scale=0.3),
        "nsp_b": _r(g, 2),
    }


def _tree(fn, t):
    return {k: _tree(fn, v) for k, v in t.items()} \
        if isinstance(t, dict) else fn(t)


def _cfg_kw(impl):
    return dict(vocab_size=V, hidden_size=H, num_layers=L, num_heads=NH,
                ffn_size=FFN, max_position=P, dropout_rate=0.0,
                attention_impl=impl)


def _jax_model(impl):
    return JaxBertModel(JaxBertConfig(**_cfg_kw(impl)))


def _torch_model(impl, params=None, **kw):
    cfg = BertConfig(**{**_cfg_kw(impl), **kw})
    m = BertModel(cfg, device="cpu")
    m.load_state_dict(interop.params_from_jax(
        jax_params() if params is None else params, cfg))
    return m


def batch(seed=1, masked=True):
    """(ids, token types, attention mask or None, MLM labels, NSP labels);
    the mask hides the last 5 keys of row 1 and the last 2 of row 2."""
    g = np.random.default_rng(seed)
    ids = g.integers(0, V, (B, S)).astype(np.int32)
    tok = (np.arange(S)[None] >= S // 2).astype(np.int32).repeat(B, 0)
    mask = np.ones((B, S), np.int32)
    mask[1, -5:], mask[2, -2:] = 0, 0
    mlm = np.where(g.random((B, S)) < 0.3, ids, -1).astype(np.int32)
    nsp = g.integers(0, 2, (B,)).astype(np.int32)
    return ids, tok, mask if masked else None, mlm, nsp


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _assert_grads_close(got, want):
    got, want = dict(flat(got)), dict(flat(want))
    assert set(got) == set(want)
    for path, w in want.items():
        err = np.abs(got[path] - w)
        bound = TOL_G * np.abs(w) + TOL_G_MAX * np.abs(w).max()
        assert np.all(err <= bound), (path, err.max())


class _CountPlainFlash:
    """Counts calls of the flash kernels' plain version (what a CPU
    tensor runs where a CUDA tensor launches the kernel)."""

    def __init__(self, monkeypatch):
        self.n = 0
        orig = fa.flash_attention_plain

        def counting(*a, **k):
            self.n += 1
            return orig(*a, **k)

        monkeypatch.setattr(fa, "flash_attention_plain", counting)


# ------------------------------------------------------------ ops, init

def test_truncated_normal_bounds_and_moments():
    """Within mean ± 2σ, and the moments of a normal truncated at 2σ: the
    same mean, a deviation of 0.8796σ (what jax.random.truncated_normal
    gives, which the reference scales without correcting)."""
    mean, std, n = 0.5, 0.02, 10 ** 6
    t = init.truncated_normal(mean, std)(torch.Generator().manual_seed(0),
                                         (1000, 1000))
    assert t.dtype == torch.float32 and t.shape == (1000, 1000)
    lo, hi = torch.tensor([mean - 2 * std, mean + 2 * std])  # as f32
    assert bool(t.min() >= lo) and bool(t.max() <= hi)
    sd = 0.879626 * std
    assert abs(float(t.mean()) - mean) <= 4.5 * sd / n ** 0.5
    assert abs(float(t.std()) - sd) <= 4.5 * 0.47 * sd / n ** 0.5 + 1e-7
    ref = np.asarray(jax.random.truncated_normal(
        jax.random.PRNGKey(0), -2.0, 2.0, (n,))) * std + mean
    assert abs(float(t.std()) - ref.std()) <= 9 * 0.47 * sd / n ** 0.5
    # the same stream from the same seed
    again = init.truncated_normal(mean, std)(
        torch.Generator().manual_seed(0), (1000, 1000))
    assert torch.equal(t, again)


# ------------------------------------------------- attention and the block

def _port_block(params, impl, causal, pre_norm):
    blk = TransformerBlock(H, NH, FFN, generator=torch.Generator(),
                           causal=causal, pre_norm=pre_norm,
                           attention_impl=impl)
    sd = {}
    for mod, d in params.items():
        for name, w in d.items():
            port = {"qkv_weight": "qkv.weight", "qkv_bias": "qkv.bias",
                    "out_weight": "out.weight", "out_bias": "out.bias"}.get(
                name, name)
            sd[f"{mod}.{port}"] = torch.from_numpy(
                w.T.copy() if w.ndim == 2 else w)
    blk.load_state_dict(sd)
    return blk


@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("pre_norm", [False, True], ids=["postln", "preln"])
@pytest.mark.parametrize("impl", IMPLS)
def test_block_matches_jax(impl, pre_norm, masked, causal):
    """Both block layouts, both cores, with and without a mask, causal or
    not: a causal mask is ANDed with an explicit one."""
    params = block_params(np.random.default_rng(3))
    x = np.random.default_rng(4).standard_normal((B, S, H)).astype(
        np.float32)
    mask = batch()[2][:, None, None, :] if masked else None
    jb = JaxBlock(H, NH, FFN, causal=causal, pre_norm=pre_norm,
                  attention_impl=impl)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want, _ = jb.apply({"params": _tree(jnp.asarray, params),
                            "state": {}}, jnp.asarray(x),
                           mask=None if mask is None else jnp.asarray(mask))
        got = _port_block(params, impl, causal, pre_norm)(
            torch.from_numpy(x),
            mask=None if mask is None else torch.from_numpy(mask))
    _close(got, want)


def test_masked_flash_warns_and_takes_the_plain_path(monkeypatch):
    """With a mask, attention_impl="flash" warns and runs the plain
    composition (no flash call); without one it runs flash and does not
    warn.  Both agree with the "xla" layer."""
    g = torch.Generator().manual_seed(0)
    flash = MultiHeadAttention(H, NH, generator=g, attention_impl="flash")
    plain = MultiHeadAttention(H, NH, generator=g, attention_impl="xla")
    plain.load_state_dict(flash.state_dict())
    x = torch.randn(B, S, H, generator=g)
    mask = torch.from_numpy(batch()[2])[:, None, None, :]
    calls = _CountPlainFlash(monkeypatch)
    with pytest.warns(UserWarning, match="ignores explicit masks"):
        y = flash(x, mask=mask)
    assert calls.n == 0
    torch.testing.assert_close(y, plain(x, mask=mask), rtol=0, atol=0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        y = flash(x)
        plain(x, mask=mask)  # the xla layer does not warn
    assert calls.n == 1
    torch.testing.assert_close(y, plain(x), rtol=1e-5, atol=1e-5)
    assert fa_wrapper.launches == 0   # CPU tensors launch nothing


def test_post_ln_block_refuses_to_serve():
    blk = TransformerBlock(H, NH, FFN, generator=torch.Generator(),
                           causal=True, pre_norm=False)
    with pytest.raises(NotImplementedError, match="pre-LN"):
        blk.prefill_step(torch.zeros(1, 4, H))
    bidir = TransformerBlock(H, NH, FFN, generator=torch.Generator(),
                             pre_norm=True)
    with pytest.raises(NotImplementedError, match="causal"):
        bidir.prefill_step(torch.zeros(1, 4, H))


# ------------------------------------------------------------------ model

def test_configs_and_constructors():
    c = BertConfig()
    assert (c.vocab_size, c.hidden_size, c.num_layers, c.num_heads,
            c.ffn_size, c.max_position, c.type_vocab_size,
            c.dropout_rate) == (30522, 768, 12, 12, 3072, 512, 2, 0.1)
    small = dict(vocab_size=V, hidden_size=H, ffn_size=FFN, max_position=P)
    assert bert_base(device="cpu", num_layers=1, num_heads=NH,
                     **small).c.num_layers == 1
    large = bert_large(device="cpu", num_layers=1, **{**small,
                                                      "hidden_size": 32})
    assert (large.c.hidden_size, large.c.num_heads, large.c.ffn_size) == (
        32, 16, FFN)
    assert BertConfig(**small).num_heads == 12


def test_interop_round_trips():
    tree = jax_params()
    cfg = _torch_model("xla").c
    sd = interop.params_from_jax(tree, cfg)
    np.testing.assert_array_equal(sd["pooler.weight"].numpy(),
                                  tree["pooler_w"].T)
    np.testing.assert_array_equal(sd["nsp.weight"].numpy(), tree["nsp_w"].T)
    np.testing.assert_array_equal(sd["emb_ln.scale"].numpy(),
                                  tree["emb_ln_scale"])
    back = interop.params_to_jax(sd, cfg)
    again = interop.params_to_jax(_torch_model("flash").state_dict(), cfg)
    opt = interop.opt_state_to_jax(interop.opt_state_from_jax(
        {"step": np.int32(2), "slots": {"m": tree, "v": jax_params(1)}},
        cfg), cfg)
    assert int(opt["step"]) == 2
    want = dict(flat(tree))
    for other in (back, again, opt["slots"]["m"]):
        other = dict(flat(other))
        assert set(other) == set(want)
        for k, a in want.items():
            np.testing.assert_array_equal(a, other[k], err_msg=str(k))


@pytest.fixture(scope="module", params=IMPLS)
def pair(request):
    impl = request.param
    return impl, _jax_model(impl), _torch_model(impl)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_encode_and_pooled_match(pair, masked, monkeypatch):
    impl, jm, tm = pair
    ids, tok, mask, _, _ = batch(masked=masked)
    jv = {"params": _tree(jnp.asarray, jax_params()), "state": {}}
    calls = _CountPlainFlash(monkeypatch)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        (wseq, wpool), _ = jm.apply(
            jv, jnp.asarray(ids), jnp.asarray(tok),
            None if mask is None else jnp.asarray(mask))
        n_jax = len(caught)
        with torch.inference_mode():
            seq, pool = tm(torch.from_numpy(ids), torch.from_numpy(tok),
                           None if mask is None else torch.from_numpy(mask))
        n_port = len(caught) - n_jax
    assert seq.dtype == torch.float32 and seq.shape == (B, S, H)
    _close(seq, wseq)
    _close(pool, wpool)
    flash_masked = impl == "flash" and masked
    assert n_port == (L if flash_masked else 0) and (n_jax > 0) == \
        flash_masked
    assert calls.n == (L if impl == "flash" and not masked else 0)


_JAX_FN = {}


def _jax_loss_and_grads(impl, masked, params):
    key = (impl, masked)
    if key not in _JAX_FN:
        fn = _jax_model(impl).pretrain_loss_fn()
        b = tuple(None if t is None else jnp.asarray(t)
                  for t in batch(masked=masked))
        _JAX_FN[key] = jax.jit(jax.value_and_grad(
            lambda p: fn(p, {}, b, None, True), has_aux=True))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        (loss, (aux, _)), grads = _JAX_FN[key](params)
    return float(loss), {k: float(v) for k, v in aux.items()}, grads


def _port_loss_and_grads(model, masked):
    params = dict(model.named_parameters())
    b = tuple(None if t is None else torch.from_numpy(t)
              for t in batch(masked=masked))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        loss, (aux, _) = model.pretrain_loss_fn()(params, {}, b, None, True)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), {k: float(v) for k, v in aux.items()}, \
        interop.params_to_jax(dict(zip(params, grads)), model.c)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_pretrain_loss_aux_and_every_gradient_match_jax(pair, masked):
    impl, _, tm = pair
    want_loss, want_aux, want = _jax_loss_and_grads(
        impl, masked, _tree(jnp.asarray, jax_params()))
    loss, aux, got = _port_loss_and_grads(tm, masked)
    assert set(aux) == set(want_aux) == {"mlm_loss", "nsp_loss"}
    np.testing.assert_allclose(loss, want_loss, rtol=TOL_LOSS)
    for k in aux:
        np.testing.assert_allclose(aux[k], want_aux[k], rtol=TOL_LOSS)
    np.testing.assert_allclose(aux["mlm_loss"] + aux["nsp_loss"], loss,
                               rtol=1e-6)
    _assert_grads_close(got, _tree(np.asarray, want))


def test_dropout_when_training_only():
    """With dropout on, a training loss depends on the generator's seed
    and is reproducible for one seed; validation ignores the generator."""
    model = _torch_model("flash", dropout_rate=0.2)
    params = dict(model.named_parameters())
    fn = model.pretrain_loss_fn()
    b = tuple(torch.from_numpy(t) for t in batch(masked=False)
              if t is not None)
    b = b[:2] + (None,) + b[2:]

    def loss(seed, train):
        g = torch.Generator().manual_seed(seed) if seed is not None else None
        with torch.no_grad():
            return float(fn(params, {}, b, g, train)[0])

    assert loss(1, True) == loss(1, True) != loss(2, True)
    assert loss(None, False) == loss(3, False)


def test_executor_reports_the_aux_metrics_as_the_reference():
    """Two AdamW steps of both executors on one batch without a mask: the
    loss, ``mlm_loss`` and ``nsp_loss`` of each step agree (the gradients
    agree within the tolerance above; AdamW with eps 1e-3 keeps a gap
    that small from growing to a full step, as tests/adamw_bound.py
    derives)."""
    b = batch(masked=False)
    jex = JaxExecutor(_jax_model("flash").pretrain_loss_fn(),
                      JaxAdamW(1e-3, eps=1e-3), seed=0)
    js = jex.init_state({"params": _tree(jnp.asarray, jax_params()),
                         "state": {}})
    model = _torch_model("flash")
    tex = Executor(model.pretrain_loss_fn(), AdamWOptimizer(1e-3, eps=1e-3),
                   seed=0)
    ts = tex.init_state(model)
    for step in range(2):
        js, jm = jex.run("train", js, tuple(
            None if t is None else jnp.asarray(t) for t in b))
        ts, tm = tex.run("train", ts, b)
        assert set(tm) == set(jm) == {"loss", "mlm_loss", "nsp_loss"}
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=f"{k} {step}")
    metrics = tex.run("validate", ts, b)
    assert set(metrics) == {"loss", "mlm_loss", "nsp_loss"}
