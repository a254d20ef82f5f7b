"""The flash attention wrappers of hetu_tpu_torch against the Pallas
kernels.

On the CPU the wrappers compute their plain PyTorch versions, which must be
the same functions as the TPU kernels: O and the f32 LSE, bottom-right
causal alignment, and O = 0 and dQ = 0 for a query row that sees no key.
The oracles are the Pallas ``_flash_fwd`` and ``_flash_bwd`` in interpret
mode (as hetu_tpu's own tests run them), and ``jax.grad`` through the
Pallas ``flash_attention``; not the XLA composition, which averages such
rows uniformly.  Inputs are numpy arrays from a seed, compared in float32
within 1e-5.  The CUDA kernels themselves are held against the same plain
versions on the card by ``chip_smoke.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu.ops.pallas_kernels import flash_attention as jax_flash
from hetu_tpu.ops.pallas_kernels.flash_attention import (
    _flash_bwd, _flash_fwd,
)
from hetu_tpu_torch.ops.cuda_kernels import (
    build, flash_attention, flash_attention_bwd, flash_attention_bwd_dkdv,
    flash_attention_bwd_dq, flash_attention_bwd_plain, flash_attention_plain,
)

torch.set_num_threads(2)

# the module (the package exports its function of the same name)
fa = importlib.import_module(
    "hetu_tpu_torch.ops.cuda_kernels.flash_attention")

TOL = 1e-5


def _qkv(b, h, s_q, s_k, d, seed):
    g = np.random.default_rng(seed)
    return (g.standard_normal((b, h, s_q, d)).astype(np.float32),
            g.standard_normal((b, h, s_k, d)).astype(np.float32),
            g.standard_normal((b, h, s_k, d)).astype(np.float32))


def _attention64(q, k, v, causal):
    """O in float64 numpy: the oracle that tells which side of a mismatch
    moved (bottom-right causal; a row that sees no key gives 0)."""
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) * q.shape[-1] ** -0.5
    if causal:
        s_q, s_k = s.shape[-2:]
        s = np.where(np.tril(np.ones((s_q, s_k), bool), k=s_k - s_q), s,
                     -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.where(np.isfinite(m), np.exp(s - np.where(np.isfinite(m), m, 0)),
                 0.0)
    l = np.maximum(p.sum(-1, keepdims=True), 1e-300)
    return np.einsum("bhqk,bhkd->bhqd", p, v.astype(np.float64)) / l


def _torch_state():
    """The process-wide torch settings that change a CPU f32 matmul."""
    return (f"threads={torch.get_num_threads()}, mkldnn matmul "
            f"fp32_precision={torch.backends.mkldnn.matmul.fp32_precision}, "
            f"fp32_precision={torch.backends.fp32_precision}")


def _pallas(q, k, v, causal, block=16):
    out, lse = _flash_fwd(*(jnp.asarray(a) for a in (q, k, v)),
                          scale=q.shape[-1] ** -0.5, causal=causal,
                          block_q=block, block_k=block, interpret=True)
    return np.array(out), np.array(lse)


# (b, h, s_q, s_k, d, causal): square, cross-length both ways, full
SHAPES = [
    (2, 2, 64, 64, 16, True),
    (2, 2, 64, 64, 16, False),
    (1, 3, 16, 64, 32, True),    # S_q < S_k (prefix in the cache)
    (1, 3, 16, 64, 32, False),
    (1, 2, 64, 32, 16, True),    # S_q > S_k: the first 32 rows see no key
    (1, 2, 32, 48, 16, True),
]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "b{}h{}q{}k{}d{}{}"
                         .format(*s[:5], "c" if s[5] else "f"))
def test_plain_matches_pallas(shape):
    b, h, s_q, s_k, d, causal = shape
    q, k, v = _qkv(b, h, s_q, s_k, d, seed=sum(shape))
    want_o, want_lse = _pallas(q, k, v, causal)
    o, lse = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=causal, return_lse=True)
    assert o.shape == (b, h, s_q, d) and lse.shape == (b * h, s_q, 1)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    # each side against float64 first, so that a mismatch names the side
    # that moved
    exact = _attention64(q, k, v, causal)
    np.testing.assert_allclose(want_o, exact, rtol=TOL, atol=TOL,
                               err_msg="Pallas against float64")
    np.testing.assert_allclose(o.numpy(), exact, rtol=TOL, atol=TOL,
                               err_msg=f"port against float64 "
                                       f"({_torch_state()})")
    np.testing.assert_allclose(o.numpy(), want_o, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=TOL, atol=TOL)
    if causal and s_q > s_k:
        dead = s_q - s_k
        assert not o[:, :, :dead].any()        # exactly zero, as Pallas
        assert not np.any(want_o[:, :, :dead])
        assert o[:, :, dead:].abs().sum(-1).gt(0).all()


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_length_matches_pallas_autofit(causal):
    """S = 48 is no power of two: Pallas fits its block to 48 (or 16), the
    port needs no fitting at all.  Both give the same O."""
    q, k, v = _qkv(1, 2, 48, 48, 16, seed=48)
    want = np.asarray(jax_flash(*(jnp.asarray(a) for a in (q, k, v)),
                                causal=causal, interpret=True))
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    for block in (16, 48):
        np.testing.assert_allclose(
            got.numpy(), _pallas(q, k, v, causal, block)[0], rtol=TOL,
            atol=TOL)


def test_explicit_scale():
    q, k, v = _qkv(1, 2, 32, 32, 16, seed=7)
    want, want_lse = _flash_fwd(*(jnp.asarray(a) for a in (q, k, v)),
                                scale=0.3, causal=True, block_q=16,
                                block_k=16, interpret=True)
    o, lse = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=True, scale=0.3, return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=TOL,
                               atol=TOL)


def test_cpu_tensors_never_count_a_launch():
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(1, 1, 8, 8, 8, seed=1))
    flash_attention(q, k, v, causal=True).sum().backward()
    flash_attention_plain(q, k, v, causal=True)
    assert flash_attention.launches == 0
    assert flash_attention_bwd_dkdv.launches == 0
    assert flash_attention_bwd_dq.launches == 0


def test_gradients_flow_and_match_the_pallas_backward():
    """q, k and v that require grad get gradients through the wrapper's
    autograd.Function: those of ``jax.vjp`` through the Pallas kernel."""
    q, k, v = _qkv(1, 1, 8, 8, 8, seed=2)
    g = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    want = _jax_vjp(q, k, v, g, causal=True)
    got = _torch_vjp(q, k, v, g, causal=True)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "rank", "shape",
                                 "device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 8, 8, 16, seed=3))
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "head_dim":
        q, k, v = (torch.zeros(1, 1, 4, 160) for _ in range(3))
    elif bad == "rank":
        q = q[0]
    elif bad == "device":
        q, k, v = q.to("meta"), k.to("meta"), v.to("meta")
    else:
        v = v[:, :, :4]
    with pytest.raises((TypeError, ValueError)):
        flash_attention(q, k, v, causal=True)


def test_bf16_plain_rounds_probabilities_like_the_kernel():
    """In bf16, O comes back in bf16 and the LSE in f32; the plain
    version stays within a bf16 ulp of its own f32 result."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 32, 32, 16, seed=4))
    o16, lse16 = flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                 causal=True, return_lse=True)
    o32 = flash_attention(q.bfloat16().float(), k.bfloat16().float(),
                          v.bfloat16().float(), causal=True)
    assert o16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    assert (o16.float() - o32).abs().max() < 2e-2


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A missing compiler is an error the caller sees, not a silent
    fallback: a CUDA tensor has no other path to take."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("flash_attention")
    assert not (tmp_path / "_build").exists()


# ------------------------------------------------------------- backward

def _jax_vjp(q, k, v, g, causal, block=16):
    """dq, dk, dv of ``sum(O * g)`` through the Pallas flash_attention."""
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(
        q, k, v, causal=causal, block_q=block, block_k=block,
        interpret=True), *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


def _torch_vjp(q, k, v, g, causal):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*ts, causal=causal)
    return [t.numpy() for t in torch.autograd.grad(
        out, ts, grad_outputs=torch.from_numpy(g))]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "b{}h{}q{}k{}d{}{}"
                         .format(*s[:5], "c" if s[5] else "f"))
def test_backward_plain_matches_pallas(shape):
    """Given the same q, k, v, O, LSE and dO, the plain backward gives the
    Pallas ``_flash_bwd``'s dQ, dK and dV; rows that see no key give a dQ
    of exactly zero in both."""
    b, h, s_q, s_k, d, causal = shape
    q, k, v = _qkv(b, h, s_q, s_k, d, seed=sum(shape) + 1)
    do = np.random.default_rng(sum(shape)).standard_normal(
        q.shape).astype(np.float32)
    o, lse = _pallas(q, k, v, causal)
    want = _flash_bwd(*(jnp.asarray(a) for a in (q, k, v, o, lse, do)),
                      scale=d ** -0.5, causal=causal, block_q=16,
                      block_k=16, interpret=True)
    got = flash_attention_bwd(*(torch.from_numpy(a)
                                for a in (q, k, v, o, lse, do)),
                              causal=causal)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=name)
    if causal and s_q > s_k:
        dead = s_q - s_k
        assert not got[0][:, :, :dead].any()
        assert not np.any(np.asarray(want[0])[:, :, :dead])
        assert got[0][:, :, dead:].abs().sum(-1).gt(0).all()


@pytest.mark.parametrize("shape", [(1, 2, 32, 32, 16, True),
                                   (1, 2, 32, 32, 16, False),
                                   (1, 2, 48, 16, 16, True)],
                         ids=["causal", "full", "cross_zero_rows"])
def test_autograd_matches_jax_grad(shape):
    """``torch.autograd.grad`` through the port's ``flash_attention``
    against ``jax.grad`` of the Pallas ``flash_attention`` (interpret)."""
    b, h, s_q, s_k, d, causal = shape
    q, k, v = _qkv(b, h, s_q, s_k, d, seed=s_q + s_k)
    w = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal=causal, block_q=16,
                                 block_k=16, interpret=True) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    loss = (flash_attention(*ts, causal=causal) * torch.from_numpy(w)).sum()
    got = torch.autograd.grad(loss, ts)
    for name, a, b_ in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=TOL,
                                   atol=TOL, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_length_backward_matches_pallas_autofit(causal):
    """S = 48: the Pallas backward fits its blocks (16, or 48 whole), the
    port's kernels mask the ragged tile; all give the same gradients."""
    q, k, v = _qkv(1, 2, 48, 48, 16, seed=49)
    g = np.random.default_rng(48).standard_normal(q.shape).astype(np.float32)
    got = _torch_vjp(q, k, v, g, causal)
    for block in (16, 48):
        for name, a, b in zip("qkv", got, _jax_vjp(q, k, v, g, causal,
                                                   block)):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL,
                                       err_msg=f"d{name} block {block}")


def test_backward_wrappers_are_the_plain_version_on_cpu():
    """Each kernel's wrapper returns its part of the plain backward, in the
    input's type (bf16 here), with f32 LSE and delta."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(1, 2, 24, 40, 16, seed=6))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(6)
                     ).bfloat16()
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    delta = (do.float() * out.float()).sum(-1).reshape(2, 24, 1)
    dq, dk, dv = flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                           causal=True)
    dk2, dv2 = flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal=True)
    dq2 = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=True)
    for a, b in ((dq, dq2), (dk, dk2), (dv, dv2)):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a, b)
    assert dk.shape == dv.shape == k.shape and dq.shape == q.shape


@pytest.mark.parametrize("bad", ["do_shape", "do_dtype", "lse_dtype",
                                 "delta_shape"])
def test_backward_wrappers_refuse_what_the_kernels_do_not_take(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 8, 8, 16, seed=8))
    do = torch.zeros_like(q)
    lse = delta = torch.zeros(2, 8, 1)
    if bad == "do_shape":
        do = do[:, :, :4]
    elif bad == "do_dtype":
        do = do.bfloat16()
    elif bad == "lse_dtype":
        lse = lse.double()
    else:
        delta = delta[:, :4]
    for fn in (flash_attention_bwd_dkdv, flash_attention_bwd_dq):
        with pytest.raises(ValueError):
            fn(q, k, v, do, lse, delta, causal=True)


# ------------------------------------------- the wrappers' routes and operands

def _layer_views(b, h, s, d, dtype, seed):
    """q, k, v and dO as the attention layer hands them to the backward:
    transposed views of ``[B, S, 3, H, D]`` and ``[B, S, H, D]``."""
    g = np.random.default_rng(seed)
    qkv = torch.from_numpy(g.standard_normal((b, s, 3, h, d)).astype(
        np.float32)).to(dtype)
    do = torch.from_numpy(g.standard_normal((b, s, h, d)).astype(
        np.float32)).to(dtype).transpose(1, 2)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    return q, k, v, do


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_backward_on_layer_views_equals_contiguous_copies(dtype):
    """``flash_attention_bwd`` on the transposed views the attention layer
    passes gives the same bits as on contiguous copies of them."""
    q, k, v, do = _layer_views(2, 3, 40, 16, dtype, seed=11)
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    want = flash_attention_bwd(*(t.contiguous() for t in (q, k, v, out)),
                               lse, do.contiguous(), causal=True)
    assert not q.is_contiguous() and not do.is_contiguous()
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 20, ("wgmma", 24)),
    (torch.bfloat16, 32, ("wgmma", 32)),
    (torch.bfloat16, 40, ("wgmma", 40)),
    (torch.bfloat16, 64, ("wgmma", 64)),
    (torch.bfloat16, 128, ("wgmma", 128)),
    (torch.float32, 20, ("scalar", 20)),
    (torch.float32, 32, ("scalar", 32)),
    (torch.float32, 40, ("scalar", 40)),
    (torch.float32, 64, ("scalar", 64)),
    (torch.float32, 128, ("scalar", 128)),
], ids=["bf16-20-padded", "bf16-32", "bf16-40", "bf16-64", "bf16-128",
        "f32-20", "f32-32", "f32-40", "f32-64", "f32-128"])
def test_routes_are_the_documented_ones(dtype, d, want):
    """Forward and backward alike: bf16 runs the tensor-core kernels at a
    head dim padded to a multiple of 8 (TMA strides); f32 runs the scalar
    kernels at its own head dim."""
    assert fa.route(dtype, d) == want


@pytest.mark.parametrize("dtype,d,unaligned,copied", [
    (torch.bfloat16, 16, False, False),
    (torch.bfloat16, 20, False, True),
    (torch.bfloat16, 16, True, True),
    (torch.float32, 16, False, True),
], ids=["bf16-in-place", "bf16-d20-padded", "bf16-unaligned",
        "f32-contiguous"])
def test_forward_prepares_inputs_once(monkeypatch, dtype, d, unaligned,
                                      copied):
    """The CUDA path hands the layer's bf16 views to the kernel as they are
    (TMA reads them in place); a bf16 head dim that is no multiple of 8 as
    one zero-padded copy, a view off a 16-byte boundary as one aligned
    copy, f32 as one contiguous copy; with the layout (heads, then the
    batch, head and row strides of q, k, v and O).  O comes back without
    its padding columns and the launch counts once.  The launch is
    recorded, not run."""
    calls = []

    def call(lib, fn_name, what, dims, ref, pointers, causal, scale):
        calls.append((fn_name, dims, pointers, causal, scale))

    monkeypatch.setattr(fa, "_call", call)
    monkeypatch.setattr(fa, "_fwd_library", lambda: None)
    monkeypatch.setattr(fa.flash_attention, "launches", 0)
    q, k, v, _ = _layer_views(1, 2, 24, d, dtype, seed=13)
    if unaligned:  # 2 bytes past the allocation's start
        q, k, v = (torch.empty(t.numel() + 1, dtype=dtype)[1:]
                   .view(t.shape).copy_(t) for t in (q, k, v))
    out, lse = fa._launch_fwd(q, k, v, causal=True, scale=0.25)
    (fn_name, dims, pointers, causal, scale), = calls
    d_run = fa.route(dtype, d)[1]
    assert fn_name == "hetu_flash_attention_fwd" and causal and scale == 0.25
    assert dims == (2, 24, 24, d_run)
    ops, o, lse_arg, layout = pointers[:3], pointers[3], pointers[4], \
        pointers[5]
    assert all((a is not b) == copied for a, b in zip(ops, (q, k, v)))
    assert all(t.data_ptr() % 16 == 0 and t.shape[-1] == d_run
               for t in ops)
    assert list(layout) == [2] + [s for t in (*ops, o)
                                  for s in fa._outer_strides(t)]
    assert o.shape == (1, 2, 24, d_run) and o.dtype == dtype
    assert out.shape == q.shape and out.data_ptr() == o.data_ptr()
    assert lse is lse_arg and lse.shape == (2, 24, 1)
    assert fa.flash_attention.launches == 1


@pytest.mark.parametrize("dtype,d,unaligned,copied", [
    (torch.bfloat16, 16, False, False),
    (torch.bfloat16, 20, False, True),
    (torch.bfloat16, 16, True, True),
    (torch.float32, 16, False, True),
], ids=["bf16-in-place", "bf16-d20-padded", "bf16-unaligned",
        "f32-contiguous"])
def test_backward_prepares_inputs_once_for_both_kernels(monkeypatch, dtype,
                                                        d, unaligned,
                                                        copied):
    """The CUDA path hands the same operands to both launches: bf16 layer
    views as they are (TMA reads them in place), a bf16 head dim that is
    no multiple of 8 as one zero-padded copy, a bf16 view that starts off
    a 16-byte boundary as one aligned copy, f32 as one contiguous copy;
    with the layout (heads, then each operand's batch, head and row
    strides).  Each launch counts once.  The launches are recorded, not
    run."""
    calls = []

    def call(lib, fn_name, what, dims, ref, pointers, causal, scale):
        calls.append((fn_name, dims, pointers, scale))

    monkeypatch.setattr(fa, "_call", call)
    monkeypatch.setattr(fa, "_bwd_library", lambda: None)
    monkeypatch.setattr(fa.flash_attention_bwd_dkdv, "launches", 0)
    monkeypatch.setattr(fa.flash_attention_bwd_dq, "launches", 0)
    q, k, v, do = _layer_views(1, 2, 24, d, dtype, seed=12)
    if unaligned:  # 2 bytes past the allocation's start
        q, k, v, do = (torch.empty(t.numel() + 1, dtype=dtype)[1:]
                       .view(t.shape).copy_(t) for t in (q, k, v, do))
    lse = delta = torch.zeros(2, 24, 1)
    dq, dk, dv = fa._launch_bwd(q, k, v, do, lse, delta, causal=True,
                                scale=0.25)
    assert [c[0] for c in calls] == ["hetu_flash_attention_bwd_dkdv",
                                     "hetu_flash_attention_bwd_dq"]
    d_run = fa.route(dtype, d)[1]
    assert all(c[1] == (2, 24, 24, d_run) and c[3] == 0.25 for c in calls)
    ops = calls[0][2][:4]
    assert all(a is b for a, b in zip(ops, calls[1][2][:4]))
    assert all((a is not b) == copied for a, b in zip(ops, (q, k, v, do)))
    assert all(t.data_ptr() % 16 == 0 for t in ops)
    layout = list(calls[0][2][-1])
    assert layout[0] == 2 and layout == list(calls[1][2][-1])
    assert layout[1:] == [s for t in ops for s in fa._outer_strides(t)]
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert fa.flash_attention_bwd_dkdv.launches == 1
    assert fa.flash_attention_bwd_dq.launches == 1


def test_a_changed_header_makes_libraries_stale(monkeypatch, tmp_path):
    """A library is rebuilt when its source or any ``csrc/*.cuh`` header is
    newer than it (no nvcc needed to decide)."""
    import os
    csrc, out = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    out.mkdir()
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("\n")
    assert build._stale("k")                      # no library yet
    build.library_path("k").write_bytes(b"")
    for p, t in ((csrc / "k.cu", 100), (csrc / "h.cuh", 100),
                 (build.library_path("k"), 200)):
        os.utime(p, (t, t))
    assert not build._stale("k")
    os.utime(csrc / "h.cuh", (300, 300))          # the header changed
    assert build._stale("k")
    os.utime(csrc / "h.cuh", (100, 100))
    os.utime(csrc / "k.cu", (300, 300))           # the source changed
    assert build._stale("k")


# -------------------------------------------------------- on the card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")


@pytest.mark.cuda
def test_tensor_core_forward_is_deterministic_on_the_card(cuda):
    """No atomics: two bf16 launches of the forward on the attention
    layer's transposed views give the same bits, and agree with the plain
    forward within one bf16 ulp of O (2e-2, as chip_smoke.py's TOL_O)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(2, 130, 3, 2, 64, generator=gen,
                      device="cuda").bfloat16()
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    a = flash_attention(q, k, v, causal=True, return_lse=True)
    b = flash_attention(q, k, v, causal=True, return_lse=True)
    want, want_lse = flash_attention_plain(q, k, v, causal=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert ((a[0].float() - want.float()).abs()
            <= 2e-2 + 1e-2 * want.float().abs()).all()
    assert (a[1] - want_lse).abs().max() <= 1e-4


@pytest.mark.cuda
def test_tensor_core_backward_is_deterministic_on_the_card(cuda):
    """No atomics: two bf16 launches of each backward kernel give the same
    bits, and agree with the plain backward within a bf16 ulp of each
    row's size.  The first query's dQ row is zero in exact arithmetic: it
    sees only the first key, so p_00 = 1, O_0 = v_0 and dS_00 = dO_0.v_0 -
    dO_0.O_0 = 0.  So it is held to that zero within the rounding of the
    two f32 sums of D products (each within D * 2^-24 * sum|dO_0 v_0| of
    the exact one), times scale * |k_0| and two bf16 roundings."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(1, 2, 130, 64, generator=gen, device="cuda")
                   .bfloat16() for _ in range(4))
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    a = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    b = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    delta = (do.float() * out.float()).sum(-1).reshape(2, 130, 1)
    want = flash_attention_bwd_plain(q, k, v, do, lse, delta, causal=True)
    first = (2 * 64 * 2 ** -24 * 64 ** -0.5 * (1 + 2 ** -7)
             * (do[..., :1, :].float() * v[..., :1, :].float()).abs()
             .sum(-1, keepdim=True) * k[..., :1, :].float().abs())
    assert (a[0][..., :1, :].float().abs() <= first).all()
    for i, (x, y, w) in enumerate(zip(a, b, want)):
        assert torch.equal(x, y)
        if i == 0:  # dQ: the first row is held above
            x, w = x[..., 1:, :], w[..., 1:, :]
        row = w.float().abs().amax(-1, keepdim=True)
        assert ((x.float() - w.float()).abs()
                <= 2 ** -8 * row + 2 ** -7 * w.float().abs()).all()
