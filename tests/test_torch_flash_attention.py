"""The flash attention wrapper of hetu_tpu_torch against the Pallas kernel.

On the CPU the wrapper computes its plain PyTorch version, which must be
the same function as the TPU kernel: O and the f32 LSE, bottom-right causal
alignment, and O = 0 for a query row that sees no key.  The oracle is the
Pallas ``_flash_fwd`` in interpret mode (as hetu_tpu's own tests run it),
not the XLA composition, which averages such rows uniformly.  Inputs are
numpy arrays from a seed, compared in float32 within 1e-5.  The CUDA
kernel itself is held against the same plain version on the card by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu.ops.pallas_kernels import flash_attention as jax_flash
from hetu_tpu.ops.pallas_kernels.flash_attention import _flash_fwd
from hetu_tpu_torch.ops.cuda_kernels import build, flash_attention
from hetu_tpu_torch.ops.cuda_kernels.flash_attention import (
    flash_attention_plain,
)

torch.set_num_threads(2)

TOL = 1e-5


def _qkv(b, h, s_q, s_k, d, seed):
    g = np.random.default_rng(seed)
    return (g.standard_normal((b, h, s_q, d)).astype(np.float32),
            g.standard_normal((b, h, s_k, d)).astype(np.float32),
            g.standard_normal((b, h, s_k, d)).astype(np.float32))


def _pallas(q, k, v, causal, block=16):
    out, lse = _flash_fwd(*(jnp.asarray(a) for a in (q, k, v)),
                          scale=q.shape[-1] ** -0.5, causal=causal,
                          block_q=block, block_k=block, interpret=True)
    return np.asarray(out), np.asarray(lse)


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
    before = flash_attention.launches
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 8, 8, 8, seed=1))
    flash_attention(q, k, v, causal=True)
    flash_attention_plain(q, k, v, causal=True)
    assert flash_attention.launches == before == 0


def test_requires_grad_raises_naming_the_training_slice():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 8, 8, 8, seed=2))
    with pytest.raises(NotImplementedError, match="training slice"):
        flash_attention(q.requires_grad_(), k, v, causal=True)


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
