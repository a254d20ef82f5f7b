"""The gather, scatter-add and top-k gate of hetu_tpu_torch against the
Pallas kernels of hetu_tpu, on the CPU.

The port's wrappers take their plain PyTorch versions for CPU tensors;
the reference's Pallas bodies run in interpret mode (``interpret=True``
for the gather and the scatter-add, ``interpret="kernel"`` for the gate).
Inputs are drawn with numpy from a seed and fed to both.

Tolerances:

* the gather copies rows: bitwise;
* the scatter-add (both routes: sorted ids, and the MoE routing's
  inverse map) with at most two rows on a destination: bitwise in f32
  and bf16 (the port sums in f32 and rounds once; the reference sums in
  the gradient's type; two bf16 values add exactly in f32, and a + b is
  the same in either order); with many duplicates (n rows on a
  destination) in f32 both add in the ids' order, each within the bound
  of a sequential sum, n · 2^-24 of the sum of magnitudes, of an f64
  oracle; in bf16 the port rounds once (within 2^-8 of the sum of
  magnitudes) and the reference after every add (n · 2^-8); the inverse
  route sums in ascending position, the sorted route's order, so the two
  are bitwise equal whatever the duplicates;
* the gate: indices equal; gates within 1e-6 in f32 (exp and the division
  rounded by XLA and PyTorch), one bf16 ulp (2^-8) in bf16; its gradient
  within 1e-5 relative plus 1e-7.

The kernels themselves run only on the card: the tests marked ``cuda``
hold them against their plain versions there and skip here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu import ops as jops
from hetu_tpu.ops.pallas_kernels import embedding as jemb
from hetu_tpu_torch.ops import make_slot_routes
from hetu_tpu_torch.ops.cuda_kernels import (
    embedding_gather, embedding_gather_plain, embedding_scatter_add,
    embedding_scatter_add_inverse_plain, embedding_scatter_add_plain,
    routed_gather, topk_gating, topk_gating_plain,
)
from hetu_tpu_torch.ops.cuda_kernels.embedding import scatter_segments

torch.set_num_threads(2)

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _pair(a, dtype):
    """The same values as a torch tensor and a jax array of ``dtype``."""
    tt, jt = DTYPES[dtype]
    t = torch.from_numpy(np.asarray(a, np.float32)).to(tt)
    return t, jnp.asarray(t.float().numpy(), jt)


def _np(x):
    """A torch tensor or jax array as f32 numpy (bf16 values are exact)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _bits(x):
    """Raw bits of a torch tensor or jax array, for bitwise equality."""
    if isinstance(x, torch.Tensor):
        ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
        return x.contiguous().view(ints[x.dtype]).numpy()
    return np.asarray(x).view(np.int32 if x.dtype == jnp.float32
                              else np.int16)


# ------------------------------------------------------------------ gather

@pytest.mark.parametrize("d", [128, 100])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gather_is_bitwise_the_pallas_gather(dtype, d):
    g = np.random.default_rng(0)
    v = 40
    t_table, j_table = _pair(g.standard_normal((v, d)), dtype)
    ids = np.concatenate([g.integers(0, v, 50), [-1, v, v + 5, 0, v - 1]])
    ids = g.permutation(ids).astype(np.int32)
    want = jemb.embedding_gather(j_table, jnp.asarray(ids), interpret=True)
    got = embedding_gather(t_table, torch.from_numpy(ids))
    assert got.dtype == t_table.dtype and got.shape == (ids.size, d)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    invalid = (ids < 0) | (ids >= v)
    assert not got[torch.from_numpy(invalid)].any()


def test_gather_takes_any_integer_ids_and_counts_no_cpu_launch():
    table = torch.arange(12.0).reshape(4, 3)
    before = embedding_gather.launches
    for ids in (torch.tensor([3, -1, 0]), torch.tensor([3, -1, 0],
                                                       dtype=torch.int32)):
        got = embedding_gather(table, ids)
        assert torch.equal(got, torch.stack([table[3], torch.zeros(3),
                                             table[0]]))
    assert embedding_gather.launches == before


def test_gather_refuses_what_the_kernel_does_not_take():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        embedding_gather(torch.zeros(4, 3, dtype=torch.float16),
                         torch.tensor([0]))
    with pytest.raises(TypeError, match="integer ids"):
        embedding_gather(torch.zeros(4, 3), torch.tensor([0.0]))
    with pytest.raises(ValueError, match=r"\[N, D\]"):
        embedding_gather(torch.zeros(4, 3), torch.tensor([[0]]))


# ------------------------------------------------------------- scatter-add

def _twice_ids(g, rows):
    """Ids in [-2, rows + 2) with every id at most twice: at most two
    gradient rows meet on a destination, and some ids are invalid."""
    ids = np.concatenate([g.permutation(np.arange(-2, rows + 2))[:rows],
                          g.permutation(np.arange(-2, rows + 2))[:rows]])
    return g.permutation(ids).astype(np.int32)


@pytest.mark.parametrize("d", [128, 100])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_scatter_add_with_pairs_is_bitwise_the_pallas_scatter(dtype, d):
    g = np.random.default_rng(1)
    rows = 30
    ids = _twice_ids(g, rows)
    t_g, j_g = _pair(g.standard_normal((ids.size, d)), dtype)
    want = jemb.embedding_scatter_add(j_g, jnp.asarray(ids), rows,
                                      interpret=True)
    got = embedding_scatter_add(t_g, torch.from_numpy(ids), rows)
    assert got.dtype == t_g.dtype and got.shape == (rows, d)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    hit = np.zeros(rows, bool)
    hit[ids[(ids >= 0) & (ids < rows)]] = True
    assert not got[torch.from_numpy(~hit)].any()  # zero rows where no id


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_scatter_add_with_many_duplicates(dtype):
    g = np.random.default_rng(2)
    rows, n = 8, 600
    ids = g.integers(-1, rows + 1, n).astype(np.int32)
    ids[:300] = 3  # one destination takes 300 rows or more
    t_g, j_g = _pair(g.standard_normal((n, 64)), dtype)
    valid = (ids >= 0) & (ids < rows)
    exact = np.zeros((rows, 64))
    np.add.at(exact, ids[valid], _np(t_g)[valid].astype(np.float64))
    mags = np.zeros((rows, 64))
    np.add.at(mags, ids[valid], np.abs(_np(t_g)[valid]).astype(np.float64))
    count = np.bincount(ids[valid], minlength=rows)[:, None]
    got = _np(embedding_scatter_add(t_g, torch.from_numpy(ids), rows))
    want = _np(jemb.embedding_scatter_add(j_g, jnp.asarray(ids), rows,
                                          interpret=True))
    if dtype == "f32":  # both add in the ids' order, rounding each add
        bound = count * 2 ** -24 * mags
        assert np.all(np.abs(got - exact) <= bound)
        assert np.all(np.abs(got - want) <= 2 * bound)
    else:  # the port rounds once, the reference after every add
        assert np.all(np.abs(got - exact) <= 2 ** -8 * mags)
        assert np.all(np.abs(want - exact) <= count * 2 ** -8 * mags)


def test_scatter_segments_give_each_row_its_sorted_gradients():
    """The kernel's inputs: row r sums ``grads[perm[offsets[r]:
    offsets[r + 1]]]`` in that order; invalid ids fall in no segment."""
    g = np.random.default_rng(3)
    ids = torch.from_numpy(g.integers(-3, 12, 200).astype(np.int32))
    grads = torch.from_numpy(g.standard_normal((200, 16)).astype(np.float32))
    perm, offsets = scatter_segments(ids, 10)
    assert perm.dtype == offsets.dtype == torch.int32
    assert offsets.shape == (11,)
    rows = []
    for r in range(10):
        seg = perm[offsets[r]:offsets[r + 1]].long()
        assert (ids[seg] == r).all()
        assert torch.equal(seg, torch.sort(seg).values)  # stable: id order
        acc = torch.zeros(16)
        for i in seg:
            acc = acc + grads[i]
        rows.append(acc)
    np.testing.assert_array_equal(
        torch.stack(rows).numpy(),
        embedding_scatter_add_plain(grads, ids, 10).numpy())
    assert int(offsets[-1] - offsets[0]) == int(((ids >= 0) & (ids < 10))
                                                .sum())


def test_scatter_add_refuses_mismatched_rows():
    with pytest.raises(ValueError, match="gradient rows"):
        embedding_scatter_add(torch.zeros(3, 4), torch.tensor([0, 1]), 5)


# ------------------------------------------- the routing's inverse maps

def _moe_routes(g, t, e, k, capacity):
    """The MoE routing of seeded logits, as ``MoELayer`` builds it:
    ``(slot_token [E·C], token_slot [T, k], slot_route [E·C])``."""
    logits = torch.from_numpy(g.standard_normal((t, e)).astype(np.float32))
    gates, idx = topk_gating_plain(logits, k)
    slot_route, token_slot, _ = make_slot_routes(gates, idx, e, capacity)
    return slot_route // k, token_slot, slot_route


def _directions(slot_token, token_slot, slot_route):
    """Both gradients of the MoE gathers as (grads rows, ids, num_rows,
    inverse): the dispatch's (slots onto tokens, inverse ``token_slot``)
    and the combine's (routes onto slots, inverse ``slot_route[:, None]``)."""
    t = token_slot.shape[0]
    return [(slot_token.numel(), slot_token, t, token_slot),
            (token_slot.numel(), token_slot.reshape(-1), slot_token.numel(),
             slot_route[:, None])]


@pytest.mark.parametrize("cf", [0.5, 1.0, 4.0])  # heavy, some, no drops
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_inverse_route_is_the_sorted_route_and_the_pallas_scatter(dtype, k,
                                                                   cf):
    g = np.random.default_rng(9 + k)
    t, e, d = 64, 8, 24
    routes = _moe_routes(g, t, e, k, max(1, int(cf * t * k / e)))
    for n, ids, num_rows, inverse in _directions(*routes):
        t_g, j_g = _pair(g.standard_normal((n, d)), dtype)
        got = embedding_scatter_add(t_g, ids, num_rows, inverse=inverse)
        np.testing.assert_array_equal(
            _bits(got), _bits(embedding_scatter_add_inverse_plain(t_g,
                                                                  inverse)))
        np.testing.assert_array_equal(
            _bits(got), _bits(embedding_scatter_add_plain(t_g, ids,
                                                          num_rows)))
        want = jemb.embedding_scatter_add(j_g, jnp.asarray(ids.numpy()),
                                          num_rows, interpret=True)
        if inverse.shape[1] <= 2:  # at most two rows on a destination
            np.testing.assert_array_equal(_bits(got), _bits(want))
            continue
        ids_np = ids.numpy()
        valid = (ids_np >= 0) & (ids_np < num_rows)
        mags = np.zeros((num_rows, d))
        np.add.at(mags, ids_np[valid], np.abs(_np(t_g)[valid]))
        count = np.bincount(ids_np[valid], minlength=num_rows)[:, None]
        bound = (2 * count * 2 ** -24 if dtype == "f32"
                 else (1 + count) * 2 ** -8) * mags
        assert np.all(np.abs(_np(got) - _np(want)) <= bound)


def test_inverse_route_skips_padding_and_invalid_positions():
    """Row r of the inverse lists its positions in any order, padded with
    -1; positions outside the gradient's rows are skipped as padding, and a
    row with no position is zero."""
    g = np.random.default_rng(10)
    grads = torch.from_numpy(g.standard_normal((6, 8)).astype(np.float32))
    inverse = torch.tensor([[4, -1, 1], [-1, -1, -1], [5, 6, 0],
                            [2, 3, -7]], dtype=torch.int32)
    got = embedding_scatter_add(grads, torch.zeros(6, dtype=torch.int32), 4,
                                inverse=inverse)
    want = torch.stack([grads[1] + grads[4], torch.zeros(8),
                        grads[0] + grads[5], grads[2] + grads[3]])
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_inverse_route_of_any_ids_is_the_sorted_route():
    """Ids with up to a few dozen rows on a destination, their inverse map
    listing each row's positions in descending order: the inverse route
    sorts them and is bitwise the sorted route."""
    g = np.random.default_rng(14)
    ids = g.integers(-3, 40, 700).astype(np.int32)
    rows = [np.flatnonzero(ids == r)[::-1] for r in range(37)]
    m = max(len(r) for r in rows)
    assert 16 < m <= 32
    inverse = np.full((37, m), -1, np.int32)
    for r, pos in enumerate(rows):
        inverse[r, :len(pos)] = pos
    for dtype in ("f32", "bf16"):
        grads = _pair(g.standard_normal((ids.size, 12)), dtype)[0]
        got = embedding_scatter_add(grads, torch.from_numpy(ids), 37,
                                    inverse=torch.from_numpy(inverse))
        np.testing.assert_array_equal(
            _bits(got), _bits(embedding_scatter_add_plain(
                grads, torch.from_numpy(ids), 37)))


def test_inverse_route_refuses_a_map_it_cannot_read():
    grads = torch.zeros(4, 3)
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"inverse map \[5, m\]"):
        embedding_scatter_add(grads, ids, 5, inverse=torch.zeros(
            4, 2, dtype=torch.int32))
    with pytest.raises(TypeError, match="integer inverse"):
        embedding_scatter_add(grads, ids, 5, inverse=torch.zeros(5, 2))
    with pytest.raises(ValueError, match="at most 32"):
        embedding_scatter_add(grads, ids, 5, inverse=torch.zeros(
            5, 33, dtype=torch.int32))


# ----------------------------------------------------------- routed gather

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_routed_gather_and_its_gradient_match_jax(dtype):
    g = np.random.default_rng(4)
    v, d = 16, 24
    ids = _twice_ids(g, v)[:25]
    t_table, j_table = _pair(g.standard_normal((v, d)), dtype)
    t_w, j_w = _pair(g.standard_normal((ids.size, d)), dtype)

    def jloss(t):
        out = jemb.routed_gather(t, jnp.asarray(ids), interpret=True)
        return jnp.sum((out * j_w).astype(jnp.float32)), out

    (_, j_out), j_grad = jax.value_and_grad(jloss, has_aux=True)(j_table)
    table = t_table.clone().requires_grad_()
    out = routed_gather(table, torch.from_numpy(ids))
    (grad,) = torch.autograd.grad((out * t_w).float().sum(), table)
    np.testing.assert_array_equal(_bits(out.detach()), _bits(j_out))
    assert grad.dtype == table.dtype
    np.testing.assert_array_equal(_bits(grad), _bits(j_grad))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_routed_gather_through_the_inverse_maps_matches_jax(dtype):
    """The MoE gathers with their ids' inverse maps: the forward is the
    gather, the gradient the reference's ``routed_gather`` vjp, bitwise
    (top-2: at most two rows on a destination)."""
    g = np.random.default_rng(11)
    t, e, k, d = 48, 8, 2, 16
    slot_token, token_slot, slot_route = _moe_routes(g, t, e, k, 10)
    for n_out, ids, rows, inverse in _directions(slot_token, token_slot,
                                                 slot_route):
        t_table, j_table = _pair(g.standard_normal((rows, d)), dtype)
        t_w, j_w = _pair(g.standard_normal((n_out, d)), dtype)
        j_ids = jnp.asarray(ids.numpy())

        def jloss(tab):
            out = jemb.routed_gather(tab, j_ids, interpret=True)
            return jnp.sum((out * j_w).astype(jnp.float32)), out

        (_, j_out), j_grad = jax.value_and_grad(jloss, has_aux=True)(
            j_table)
        table = t_table.clone().requires_grad_()
        out = routed_gather(table, ids, inverse=inverse)
        (grad,) = torch.autograd.grad((out * t_w).float().sum(), table)
        np.testing.assert_array_equal(_bits(out.detach()), _bits(j_out))
        np.testing.assert_array_equal(_bits(grad), _bits(j_grad))


# -------------------------------------------------------------------- gate

@pytest.mark.parametrize("e,k", [(7, 1), (7, 2), (7, 7), (8, 1), (8, 2),
                                 (8, 8), (64, 1), (64, 2), (64, 64),
                                 (300, 2), (300, 4), (1024, 2)])
def test_topk_gating_matches_the_pallas_gate(e, k):
    g = np.random.default_rng(5 + e + k)
    logits = g.standard_normal((256, e)).astype(np.float32)
    logits[:8] = 0.5  # all-equal rows: ties to the lowest index
    logits[8:16, 1::2] = logits[8:16, 0:e - 1:2]  # pairs of equal values
    j_g, j_i = jemb.topk_gating(jnp.asarray(logits), k, interpret="kernel")
    t_g, t_i = topk_gating(torch.from_numpy(logits), k)
    assert t_i.dtype == torch.int32 and t_g.dtype == torch.float32
    np.testing.assert_array_equal(t_i.numpy(), np.asarray(j_i))
    assert t_i[:8].tolist() == [list(range(k))] * 8
    np.testing.assert_allclose(t_g.numpy(), np.asarray(j_g), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("e", [8, 300])
def test_topk_gating_on_rows_of_minus_inf(e):
    """A row of -inf picks index 0 first, and once every value left is
    -inf a pass picks the lowest index again, masked or not, as the Pallas
    gate does; its gates are NaN in both."""
    g = np.random.default_rng(12)
    logits = g.standard_normal((32, e)).astype(np.float32)
    logits[0::4] = -np.inf
    lone = np.full_like(logits, -np.inf)
    keep = g.integers(0, e, 32)
    lone[np.arange(32), keep] = logits[np.arange(32), keep]
    logits[1::2] = lone[1::2]
    j_g, j_i = jemb.topk_gating(jnp.asarray(logits), 3, block_tokens=32,
                                interpret="kernel")
    t_g, t_i = topk_gating(torch.from_numpy(logits), 3)
    np.testing.assert_array_equal(t_i.numpy(), np.asarray(j_i))
    assert t_i[0].tolist() == [0, 0, 0]
    np.testing.assert_allclose(t_g.numpy(), np.asarray(j_g), rtol=0,
                               atol=1e-6)  # NaN where the reference has NaN


def test_topk_gating_in_bf16():
    g = np.random.default_rng(6)
    t_l, j_l = _pair(g.standard_normal((64, 8)), "bf16")
    j_g, j_i = jemb.topk_gating(j_l, 2, interpret="kernel")
    t_g, t_i = topk_gating(t_l, 2)
    assert t_g.dtype == torch.bfloat16
    np.testing.assert_array_equal(t_i.numpy(), np.asarray(j_i))
    np.testing.assert_allclose(_np(t_g), _np(j_g), rtol=0, atol=2 ** -8)


@pytest.mark.parametrize("k", [1, 2, 8])
def test_topk_gating_gradient_matches_jax(k):
    g = np.random.default_rng(7)
    logits = g.standard_normal((64, 8)).astype(np.float32)
    w = g.standard_normal((64, k)).astype(np.float32)

    def jloss(x):
        gates, _ = jemb.topk_gating(x, k, interpret="kernel")
        return jnp.sum(gates * w)

    want = jax.grad(jloss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    gates, idx = topk_gating(x, k)
    assert not idx.requires_grad
    (got,) = torch.autograd.grad((gates * torch.from_numpy(w)).sum(), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


def test_plain_gate_matches_lax_top_k():
    """``ops.top_k_idx_gate`` (the plain gate) against the reference's."""
    from hetu_tpu_torch.ops import top_k_idx_gate
    g = np.random.default_rng(8)
    logits = g.standard_normal((128, 8)).astype(np.float32)
    logits[:4] = 1.0
    j_g, j_i = jops.top_k_idx_gate(jnp.asarray(logits), 2)
    t_g, t_i = top_k_idx_gate(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(t_i.numpy(), np.asarray(j_i))
    np.testing.assert_allclose(t_g.numpy(), np.asarray(j_g), rtol=0,
                               atol=1e-6)


def test_topk_gating_refuses_k_above_e():
    with pytest.raises(ValueError, match="top-9 of only 8"):
        topk_gating(torch.zeros(16, 8), 9)
    with pytest.raises(ValueError, match="top-9 of only 8"):
        jemb.topk_gating(jnp.zeros((16, 8)), 9, interpret="kernel")
    with pytest.raises(ValueError, match=r"\[T, E\]"):
        topk_gating(torch.zeros(16), 1)


# -------------------------------------------------------- on the card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_equal_their_plain_versions_on_the_card(cuda, dtype):
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = torch.randn(300, 100, generator=gen, device="cuda").to(dtype)
    ids = torch.randint(-2, 310, (500,), generator=gen, device="cuda")
    assert torch.equal(embedding_gather(table, ids),
                       embedding_gather_plain(table, ids))
    pairs = torch.cat([torch.randperm(310, generator=gen, device="cuda") - 2
                       for _ in range(2)])
    grads = torch.randn(pairs.numel(), 100, generator=gen,
                        device="cuda").to(dtype)
    assert torch.equal(embedding_scatter_add(grads, pairs, 300),
                       embedding_scatter_add_plain(grads, pairs, 300))
    # the inverse route on an MoE routing with four choices a token
    g = np.random.default_rng(13)
    for n, ids, num_rows, inverse in _directions(
            *_moe_routes(g, 256, 8, 4, 100)):
        grads = torch.randn(n, 100, generator=gen, device="cuda").to(dtype)
        ids, inverse = ids.cuda(), inverse.cuda()
        got = embedding_scatter_add(grads, ids, num_rows, inverse=inverse)
        assert torch.equal(got, embedding_scatter_add_inverse_plain(
            grads, inverse))
        assert torch.equal(got, embedding_scatter_add(grads, ids, num_rows))
    for e in (8, 300):
        logits = torch.randn(256, e, generator=gen, device="cuda").to(dtype)
        gates, idx = topk_gating(logits, 2)
        p_gates, p_idx = topk_gating_plain(logits, 2)
        assert torch.equal(idx, p_idx)
        torch.testing.assert_close(gates, p_gates, rtol=0,
                                   atol=1e-6 if dtype == torch.float32
                                   else 2 ** -8)
