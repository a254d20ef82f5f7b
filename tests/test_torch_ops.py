"""hetu_tpu_torch.ops against hetu_tpu.ops on the CPU.

The same numpy inputs (from a seed) go through the JAX op and its PyTorch
counterpart; outputs are compared in float32 within 1e-5 absolute (and
1e-5 relative): both frameworks compute the same expression, and only the
order of float32 sums differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu import init as jinit
from hetu_tpu import ops as jops
from hetu_tpu_torch import init as tinit
from hetu_tpu_torch import ops as tops

torch.set_num_threads(2)

TOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _randn(g, *shape):
    return g.standard_normal(shape).astype(np.float32)


def _pair(*arrays):
    """The same arrays as JAX and as torch inputs."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def _close(jax_out, torch_out):
    np.testing.assert_allclose(np.asarray(torch_out), np.asarray(jax_out),
                               rtol=TOL, atol=TOL)


# ---- one case per op (or op variant): a function of the ops module and
# the inputs, and the numpy inputs ----

def _gelu(g):
    (x,) = [_randn(g, 4, 33) * 3]
    return lambda o, a: o.gelu(*a), [x]


def _layer_norm(g):
    x = _randn(g, 3, 5, 64) * 2 + 1
    return (lambda o, a: o.layer_norm(*a),
            [x, _randn(g, 64), _randn(g, 64)])


def _linear(g):
    return (lambda o, a: o.linear(*a),
            [_randn(g, 2, 7, 32), _randn(g, 32, 48), _randn(g, 48)])


def _linear_no_bias(g):
    return lambda o, a: o.linear(*a), [_randn(g, 5, 32), _randn(g, 32, 8)]


def _embedding(g):
    # ids below 0 and at or past the vocabulary give zero rows
    ids = np.array([[0, 3, 49, -1], [50, 7, 70, -5]], np.int32)
    return lambda o, a: o.embedding_lookup(*a), [_randn(g, 50, 16), ids]


def _attention(g):
    return (lambda o, a: o.attention(*a),
            [_randn(g, 2, 4, 9, 16) for _ in range(3)])


def _attention_masked(g):
    mask = g.random((2, 1, 9, 9)) > 0.4
    mask[0, 0, 3] = False  # a row that keeps no key averages uniformly
    qkv = [_randn(g, 2, 4, 9, 16) for _ in range(3)]
    return lambda o, a: o.attention(*a[:3], mask=a[3]), qkv + [mask]


def _causal(g):
    return (lambda o, a: o.causal_attention(*a),
            [_randn(g, 2, 4, 12, 16) for _ in range(3)])


def _causal_cross(g):
    # S_q < S_k: bottom-right aligned
    return (lambda o, a: o.causal_attention(*a),
            [_randn(g, 1, 2, 5, 16), _randn(g, 1, 2, 13, 16),
             _randn(g, 1, 2, 13, 16)])


def _cache_update(g):
    kc, vc = _randn(g, 3, 10, 4, 8), _randn(g, 3, 10, 4, 8)
    kn, vn = _randn(g, 3, 1, 4, 8), _randn(g, 3, 1, 4, 8)
    lengths = np.array([0, 4, 9], np.int32)

    def run(o, a):
        k, v = o.cache_update(*a)
        return (np.concatenate([np.asarray(k), np.asarray(v)])
                if o is jops else torch.cat([k, v]))
    return run, [kc, vc, kn, vn, lengths]


def _decode(g):
    return (lambda o, a: o.decode_attention(*a),
            [_randn(g, 3, 4, 1, 8), _randn(g, 3, 10, 4, 8),
             _randn(g, 3, 10, 4, 8), np.array([0, 5, 9], np.int32)])


def _decode_gqa(g):
    # 4 query heads over 2 cached kv heads
    return (lambda o, a: o.decode_attention(*a),
            [_randn(g, 2, 4, 1, 8), _randn(g, 2, 7, 2, 8),
             _randn(g, 2, 7, 2, 8), np.array([2, 6], np.int32)])


CASES = {
    "gelu": _gelu, "layer_norm": _layer_norm, "linear": _linear,
    "linear_no_bias": _linear_no_bias, "embedding_lookup": _embedding,
    "attention": _attention, "attention_masked": _attention_masked,
    "causal_attention": _causal, "causal_attention_cross": _causal_cross,
    "cache_update": _cache_update, "decode_attention": _decode,
    "decode_attention_gqa": _decode_gqa,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    fn, arrays = CASES[name](_rng(sorted(CASES).index(name)))
    j_in, t_in = _pair(*arrays)
    _close(fn(jops, j_in), fn(tops, t_in))


def test_gelu_is_the_tanh_form():
    """F.gelu's default is the erf form; the reference's is tanh."""
    x = torch.linspace(-4, 4, 101)
    want = 0.5 * x * (1 + torch.tanh((2 / torch.pi) ** 0.5
                                     * (x + 0.044715 * x ** 3)))
    torch.testing.assert_close(tops.gelu(x), want, rtol=0, atol=1e-6)
    assert (tops.gelu(x) - torch.nn.functional.gelu(x)).abs().max() > 1e-4


def test_layer_norm_keeps_bf16_and_uses_population_variance():
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0]], dtype=torch.bfloat16)
    y = tops.layer_norm(x, torch.ones(4), torch.zeros(4), eps=0.0)
    assert y.dtype == torch.bfloat16
    # population std of 1..4 is sqrt(1.25); the sample std would be larger
    want = (torch.tensor([1.0, 2.0, 3.0, 4.0]) - 2.5) / 1.25 ** 0.5
    torch.testing.assert_close(y[0].float(), want, rtol=0, atol=1e-2)


def test_cache_update_writes_in_place():
    kc = torch.zeros(2, 6, 1, 2)
    vc = torch.zeros(2, 6, 1, 2)
    k, v = tops.cache_update(kc, vc, torch.ones(2, 1, 1, 2),
                             torch.full((2, 1, 1, 2), 2.0),
                             torch.tensor([1, 5]))
    assert k is kc and v is vc
    assert kc[0, 1].eq(1).all() and kc[1, 5].eq(1).all()
    assert vc[0, 1].eq(2).all() and kc.sum() == 4


@pytest.mark.parametrize("shape", [(48, 16), (16, 48)])
def test_initializers_follow_the_reference(shape):
    """Same distributions as hetu_tpu.init (the numbers differ: torch and
    JAX draw differently from one seed); the same generator state gives
    the same tensor."""
    g = torch.Generator().manual_seed(0)
    w = tinit.xavier_uniform()(g, shape)
    jw = np.asarray(jinit.xavier_uniform()(jax.random.PRNGKey(0), shape))
    limit = (6.0 / sum(shape)) ** 0.5
    assert w.abs().max() <= limit and np.abs(jw).max() <= limit
    assert w.abs().max() > 0.95 * limit
    n = tinit.normal(stddev=0.02)(torch.Generator().manual_seed(1),
                                  (256, 64))
    assert abs(float(n.std()) - 0.02) < 1e-3 and abs(float(n.mean())) < 1e-3
    assert torch.equal(n, tinit.normal(stddev=0.02)(
        torch.Generator().manual_seed(1), (256, 64)))
    assert tinit.zeros()(g, shape).eq(0).all()
    assert tinit.ones()(g, shape).eq(1).all()
