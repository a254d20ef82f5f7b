"""The elementwise, shape, reduce and matmul op families of hetu_tpu_torch
against hetu_tpu's, on the CPU (``tests/test_ops.py``'s elementwise,
matmul, shape, scatter/gather, reduction/top-k/unique and interpolate
parts, with the reference as the oracle).

Each case feeds the same numpy inputs (drawn from a seed) to the op of
each package under the same name.  Index and shape ops must agree
exactly; arithmetic within rtol 1e-6 (plus 1e-6 of the output's largest
magnitude, for sums whose order differs).  ``topk``, ``argsort`` and
``unique`` run on inputs with ties.  Ids out of range raise in the port
(the reference fills, clamps or drops), each such case pinned below.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu import ops as jops
from hetu_tpu_torch import ops

torch.set_num_threads(2)

RTOL = 1e-6


def rnd(*shape, seed=0, pos=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    return np.abs(x) + 0.1 if pos else x


def ints(*shape, hi=5, seed=0, lo=0):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(
        np.int32)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().numpy()
    return np.asarray(a)


def _compare(got, ref, exact, what):
    if isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), what
        for i, (g, r) in enumerate(zip(got, ref)):
            _compare(g, r, exact, f"{what}[{i}]")
        return
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if exact or not np.issubdtype(ref.dtype, np.floating):
        np.testing.assert_array_equal(got, ref, err_msg=what)
    else:
        scale = np.abs(ref).max() if ref.size else 0.0
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * scale,
                                   err_msg=what)


def _run(name, args, kw=None, exact=False, tkw=None):
    """The op ``name`` of each package on the same inputs: numpy arrays
    (also in a list) become a jax array and a torch tensor, everything
    else passes as it is; ``tkw`` goes to the port's op alone."""
    kw = kw or {}

    def each(a, conv):
        if isinstance(a, list):
            return [each(b, conv) for b in a]
        return conv(a) if isinstance(a, np.ndarray) else a
    jargs = [each(a, jnp.asarray) for a in args]
    targs = [each(a, torch.tensor) for a in args]
    ref = getattr(jops, name)(*jargs, **kw)
    got = getattr(ops, name)(*targs, **kw, **(tkw or {}))
    _compare(got, ref, exact, name)
    return got, ref


X, Y = rnd(4, 5), rnd(4, 5, seed=1)
POS = rnd(4, 5, seed=2, pos=True)

ELEMENTWISE = [
    ("abs_", (X,)), ("add", (X, Y)), ("add_const", (X, 2.5)),
    ("minus", (X, Y)), ("minus_const", (X, 1.5)),
    ("const_minus", (1.5, X)), ("multiply", (X, Y)),
    ("mul_const", (X, -3.0)), ("divide", (X, POS)),
    ("div_const", (X, 7.0)), ("const_div", (2.0, POS)),
    ("opposite", (X,)), ("exp", (X,)), ("log", (POS,)),
    ("pow_", (POS, Y)), ("const_pow", (2.0, X)), ("power", (POS, 3.0)),
    ("sqrt", (POS,)), ("rsqrt", (POS,)), ("sin", (X,)), ("cos", (X,)),
    ("floor", (X * 3,)), ("ceil", (X * 3,)), ("clamp", (X, -0.5, 0.5)),
    ("sign", (np.concatenate([X, np.zeros((1, 5), np.float32)]),)),
    ("bool_", (np.round(X),)), ("where", (X > 0, X, Y)),
    ("masked_fill", (X, X > 0, -1.0)), ("mask", (X, X > 0)),
    ("add", (X, Y[:1])),  # broadcasting
    ("divide", (ints(3, 4, lo=1), ints(3, 4, lo=1, seed=1))),  # true div
]


@pytest.mark.parametrize("name,args", ELEMENTWISE,
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(ELEMENTWISE)])
def test_elementwise(name, args):
    _run(name, args)


def test_clamp_with_open_bounds():
    _run("clamp", (X,), {"min": -0.2})
    _run("clamp", (X,), {"max": 0.3})
    _run("clamp", (X,), exact=True)


A, B = rnd(4, 6), rnd(6, 3, seed=1)
BA, BB = rnd(2, 4, 6, seed=3), rnd(2, 6, 3, seed=4)

MATMUL = [
    ("matmul", (A, B), {}), ("matmul", (A.T.copy(), B), {"trans_a": True}),
    ("matmul", (A, B.T.copy()), {"trans_b": True}),
    ("linear", (A, B, rnd(3, seed=2)), {}),
    ("linear", (A, B.T.copy()), {"trans_w": True}),
    ("batch_matmul", (BA, BB), {}),
    ("batch_matmul", (np.swapaxes(BA, 1, 2).copy(),
                      np.swapaxes(BB, 1, 2).copy()),
     {"trans_a": True, "trans_b": True}),
    ("addmm", (rnd(4, 3, seed=5), A, B), {"alpha": 2.0, "beta": 0.5}),
    ("baddbmm", (rnd(2, 4, 3, seed=6), BA, BB), {"alpha": -1.0,
                                                   "beta": 3.0}),
    ("matrix_dot", (A, rnd(4, 6, seed=7)), {}),
]


@pytest.mark.parametrize("name,args,kw", MATMUL,
                         ids=[f"{n}{i}" for i, (n, _, _) in
                              enumerate(MATMUL)])
def test_matmul_family(name, args, kw):
    _run(name, args, kw)


def test_bf16_matmul_keeps_the_promoted_type():
    a, b = (torch.tensor(v).to(torch.bfloat16) for v in (A, B))
    assert ops.matmul(a, b).dtype == torch.bfloat16
    assert ops.matmul(a, b.float()).dtype == torch.float32
    assert ops.batch_matmul(a[None], b[None]).dtype == torch.bfloat16


S = rnd(4, 6)
S3 = rnd(2, 3, 4, seed=9)
IDX = np.array([2, 0, 1, 2])

SHAPE = [
    ("reshape", (S, (2, 12)), {}), ("reshape", (S, -1), {}),
    ("transpose", (S3,), {}), ("transpose", (S3, (1, 0, 2)), {}),
    ("concat", (S, S), {"axis": 1}),
    ("concatenate", ([S, S, S],), {"axis": 0}),
    ("split", (S, 2), {"axis": 0}), ("split", (S, [1, 4]), {"axis": 1}),
    ("slice_", (S, (1, 2), (2, 3)), {}),
    ("slice_assign", (S, rnd(2, 3, seed=1), (1, 2)), {}),
    ("slice_assign", (S, rnd(2, 3, seed=1), (3, 5)), {}),  # clamped
    ("slice_by_matrix", (S, np.array([0, 3, -1]), np.array([5, 0, 2])), {}),
    ("pad", (S, ((1, 1), (0, 2))), {}),
    ("pad", (S, 2), {"constant_values": 3.0}),
    ("pad", (S, ((2, 1), (3, 7))), {"mode": "edge"}),
    ("pad", (S, ((2, 1), (3, 7))), {"mode": "reflect"}),
    ("pad", (S, ((5, 1), (3, 7))), {"mode": "symmetric"}),
    ("pad", (S, ((2, 9), (3, 1))), {"mode": "wrap"}),
    ("tile", (S, (2, 1)), {}), ("tile", (S3, (2,)), {}),
    ("repeat", (S, 2), {}), ("repeat", (S, 3), {"axis": 1}),
    ("repeat", (S, np.array([1, 0, 2, 3])), {"axis": 0}),
    ("roll", (S, 2), {"axis": 0}), ("roll", (S, -3), {}),
    ("broadcast_shape", (S[:, :1], (4, 6)), {}),
    ("broadcast_to", (S[:1], (3, 4, 6)), {}),
    ("gather", (S, IDX), {"axis": 1}),
    ("gather", (S3, np.array([[0, 2], [-1, 1]])), {"axis": 1}),
    ("gather_elements", (S, ints(4, 3, hi=6)), {"axis": 1}),
    ("gather_elements", (S, ints(2, 6, hi=4)), {"axis": 0}),
    ("indexing", (S, np.array([3, 0, -2])), {}),
    ("one_hot", (np.array([2, 0, 3, 7, -1]), 4), {}),
    ("arange", (5,), {}), ("arange", (2, 11, 3), {}),
    ("arange", (0.5, 3.0), {}),
    ("full", ((2, 3), 1.5), {}), ("full", (4, 7), {}),
    ("full_like", (S, -2.0), {}), ("ones_like", (S,), {}),
    ("zeros_like", (S,), {}),
    ("cumsum", (S,), {"axis": 1}), ("cumsum", (ints(3, 4),), {"axis": 0}),
    ("flip", (S3, 1), {}), ("flip", (S3, (0, 2)), {}),
    ("flip", (S3, None), {}),
    ("tril", (S,), {}), ("tril", (S3, -1), {}), ("triu", (S, 1), {}),
    ("tril_lookup", (np.arange(9, dtype=np.float32).reshape(3, 3),), {}),
    ("tril_lookup", (S3,), {"offset": 1}),
]
# arithmetic among them: compared within RTOL, the rest exactly
_ARITH = {"cumsum"}
# the factories make their tensor on the card unless asked for the CPU
_FACTORIES = {"arange", "full"}


@pytest.mark.parametrize("name,args,kw", SHAPE,
                         ids=[f"{n}{i}" for i, (n, _, _) in
                              enumerate(SHAPE)])
def test_shape_ops(name, args, kw):
    _run(name, args, kw, exact=name not in _ARITH,
         tkw={"device": "cpu"} if name in _FACTORIES else None)


def test_tril_lookup_packs_rows_in_order():
    got = ops.tril_lookup(torch.arange(9.0).reshape(3, 3))
    np.testing.assert_array_equal(got.numpy(), [0, 3, 4, 6, 7, 8])


def test_split_refuses_an_unequal_division():
    with pytest.raises(ValueError):
        ops.split(torch.tensor(S), 4, axis=1)


def test_scatter_writes_where_the_reference_does():
    """``scatter`` (the inverse of ``gather_elements``) and ``scatter1d``:
    exact wherever an index is written once, as ``tests/test_ops.py``
    compares; every element not written keeps ``x``."""
    x = rnd(3, 5)
    g = np.random.default_rng(1)
    for axis, idx in ((1, g.integers(0, 5, size=(3, 5))),
                      (0, g.integers(0, 3, size=(2, 5))),
                      (1, np.stack([g.permutation(5) for _ in range(3)]))):
        upd = rnd(*idx.shape, seed=2)
        ref = np.asarray(jops.scatter(jnp.asarray(x), jnp.asarray(idx),
                                      jnp.asarray(upd), axis=axis))
        got = ops.scatter(torch.tensor(x), torch.tensor(idx),
                          torch.tensor(upd), axis=axis).numpy()
        written = np.zeros(x.shape, int)
        pos = np.indices(idx.shape)
        pos[axis] = idx
        np.add.at(written, tuple(pos), 1)
        once = written <= 1
        np.testing.assert_array_equal(got[once], ref[once])
    rows = np.array([4, 0, 2])
    upd = rnd(3, 6, seed=3)
    x = rnd(5, 6, seed=4)
    _compare(ops.scatter1d(torch.tensor(x), torch.tensor(rows),
                           torch.tensor(upd)),
             jops.scatter1d(jnp.asarray(x), jnp.asarray(rows),
                            jnp.asarray(upd)), True, "scatter1d")


@pytest.mark.parametrize("name,args", [
    ("gather", (S, np.array([0, 6]))), ("indexing", (S, np.array([4]))),
    ("gather_elements", (S, np.array([[6]]))),
    ("slice_by_matrix", (S, np.array([0]), np.array([-7]))),
    ("scatter1d", (S, np.array([4]), np.ones((1, 6), np.float32))),
])
def test_out_of_range_ids_raise(name, args):
    """A departure: the reference fills with NaN, clamps or drops an id
    out of range; the port raises."""
    with pytest.raises(IndexError):
        getattr(ops, name)(*[torch.tensor(a) if isinstance(a, np.ndarray)
                             else a for a in args])


R = rnd(4, 6)
TIES = np.array([[3, 1, 3, 2, 1, 3], [0, 0, 5, 5, 0, 1],
                 [2, 2, 2, 2, 2, 2], [1, 9, 4, 9, 9, 0]], np.float32)

REDUCE = [
    ("reduce_sum", (R, 1), {}), ("reduce_sum", (R,), {}),
    ("reduce_sum", (R, (0, 1)), {"keepdims": True}),
    ("reduce_sum", (ints(3, 4),), {}),
    ("reduce_mean", (R, (0, 1)), {}), ("reduce_mean", (R, 0), {}),
    ("reduce_mean", (ints(3, 4), 1), {}),
    ("reduce_min", (R, 1), {}), ("reduce_max", (R, 0), {}),
    ("reduce_max", (R,), {"keepdims": True}),
    ("reduce_mul", (rnd(3, 4, pos=True), 1), {}),
    ("reduce_mul", (rnd(2, 3, 4, pos=True), (0, 2)), {}),
    ("reduce_mul", (ints(2, 3, lo=1),), {}),
    ("reduce_norm1", (R, 1), {}), ("reduce_norm2", (R, 1), {}),
    ("reduce_norm2", (R,), {"keepdims": True}),
    ("reduce_sum_axis_zero", (R,), {}),
    ("norm", (R,), {}), ("norm", (R, 1), {}), ("norm", (R, 3), {}),
    ("max_", (R,), {}), ("max_", (R, 1), {"keepdims": True}),
    ("min_", (R, 0), {}),
    ("argmax", (R, 1), {}), ("argmax", (TIES, 1), {}),
    ("argmax", (TIES, 0), {}),
    ("argsort", (TIES, 1), {}), ("argsort", (TIES, 1), {"descending": True}),
    ("argsort", (TIES, 0), {"descending": True}),
    ("topk", (R, 3), {}), ("topk", (TIES, 4), {}),
    ("topk", (TIES, 2), {"axis": 0}),
    ("topk_idx", (TIES, 3), {}), ("topk_val", (TIES, 3), {}),
    ("unique", (np.array([3, 1, 3, 2, 1, 9]), 6), {"fill_value": 0}),
    ("unique", (np.array([[3, 1], [3, 9]]), 6), {}),
    ("unique", (np.array([5, 4, 3, 2, 1]), 3), {}),  # cut to size
    ("unique", (TIES, 8), {"fill_value": -1.0}),
]
_EXACT = {"reduce_min", "reduce_max", "max_", "min_", "argmax", "argsort",
          "topk", "topk_idx", "topk_val", "unique"}


@pytest.mark.parametrize("name,args,kw", REDUCE,
                         ids=[f"{n}{i}" for i, (n, _, _) in
                              enumerate(REDUCE)])
def test_reductions_topk_unique(name, args, kw):
    _run(name, args, kw, exact=name in _EXACT)


def test_ties_come_out_in_the_references_order():
    """argsort's descending order is the flip of the stable ascending
    sort (ties in reverse index order); top-k puts the lowest index
    first among ties."""
    row = torch.tensor([[2.0, 5.0, 2.0, 5.0, 1.0]])
    assert ops.argsort(row, descending=True).tolist() == [[3, 1, 2, 0, 4]]
    v, i = ops.topk(row, 3)
    assert i.tolist() == [[1, 3, 0]] and v.tolist() == [[5.0, 5.0, 2.0]]
    u, inv = ops.unique(torch.tensor([7, 3, 7]), size=4, fill_value=-1)
    assert u.tolist() == [3, 7, -1, -1] and inv.tolist() == [1, 0, 1]


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("size", [(8, 8), (3, 5), (6, 2), (4, 4)])
def test_interpolate(mode, size):
    """``jax.image.resize``: up, down (a bilinear shrink antialiased),
    mixed, and the identity; ``align_corners`` is ignored."""
    x = rnd(2, 3, 4, 4, seed=5)
    _run("interpolate", (x,), {"size": size, "mode": mode},
         exact=mode == "nearest")
    _run("interpolate", (x,), {"size": size, "mode": mode,
                               "align_corners": True},
         exact=mode == "nearest")


def test_interpolate_by_scale_factor():
    x = rnd(1, 2, 6, 5, seed=6)
    for sf in (2, 0.5, 1.5):
        _run("interpolate", (x,), {"scale_factor": sf})
        _run("interpolate", (x,), {"scale_factor": sf, "mode": "nearest"},
             exact=True)
