"""The gate that ``chip_smoke.py`` holds the flash backward kernels to on the
card (``grad_tolerance_share`` with ``TOL_D``), tried here on the CPU at the
training step's sequence length (S 1024, D 64, bf16, causal).

It must pass the plain backward itself and the plain backward moved by one
bf16 ulp in every element, and refuse a backward whose walk misses a part
near the end of the sequence, where the gradients are smallest: one
64-wide tile (the key tile before the diagonal misses the last query tile
in dK and dV; the last query tile misses that key tile in dQ), or one row
(every key misses the last query; every query misses its diagonal key).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from hetu_tpu_torch.ops.cuda_kernels import (
    flash_attention_bwd_plain, flash_attention_plain,
)

torch.set_num_threads(2)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

S, D, T = 1024, 64, 64
LAST = slice(S - T, S)          # the last query tile
PREV = slice(S - 2 * T, S - T)  # the key tile before the diagonal one
NAMES = ("dq", "dk", "dv")


@pytest.fixture(scope="module")
def grads():
    """The plain backward's (dQ, dK, dV) and the same with one tile of the
    walk missing, from seeded bf16 inputs of shape (1, 2, S, D)."""
    g = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(
        g.standard_normal((1, 2, S, D), dtype=np.float32)).to(torch.bfloat16)
        for _ in range(4))
    o, lse = flash_attention_plain(q, k, v, causal=True)
    delta = (do.float() * o.float()).sum(-1).reshape(2, S, 1)
    want = dict(zip(NAMES, flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                                     causal=True)))
    # p and dS at the plain backward's rounding points
    scale = D ** -0.5
    s = q.float() @ k.float().transpose(-1, -2) * scale
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    p = torch.exp(s - lse.reshape(1, 2, S, 1)).masked_fill(~keep, 0.0)
    dp = do.float() @ v.float().transpose(-1, -2)
    ds = (p * (dp - delta.reshape(1, 2, S, 1)) * scale).to(
        torch.bfloat16).float()
    p = p.to(torch.bfloat16).float()
    q, k, do = q.float(), k.float(), do.float()
    every = slice(None)
    missing = {  # (fault, name): (rows of the output, the missing part)
        ("tile", "dq"): (LAST, ds[..., LAST, PREV] @ k[..., PREV, :]),
        ("tile", "dk"): (PREV, ds[..., LAST, PREV].transpose(-1, -2)
                         @ q[..., LAST, :]),
        ("tile", "dv"): (PREV, p[..., LAST, PREV].transpose(-1, -2)
                         @ do[..., LAST, :]),
        # off by one at the causal and ragged edges: each query of the last
        # tile misses its diagonal key (dQ); each key of the tile before
        # misses the last query (dK, dV)
        ("row", "dq"): (LAST, (ds.diagonal(dim1=-2, dim2=-1)[..., None]
                               * k)[..., LAST, :]),
        ("row", "dk"): (PREV, ds[..., -1:, PREV].transpose(-1, -2)
                        @ q[..., -1:, :]),
        ("row", "dv"): (PREV, p[..., -1:, PREV].transpose(-1, -2)
                        @ do[..., -1:, :]),
    }
    broken = {}
    for key, (rows, part) in missing.items():
        t = want[key[1]].float().clone()
        t[..., rows, :] -= part
        broken[key] = t.to(torch.bfloat16)
    return want, broken


@pytest.mark.parametrize("name", NAMES)
def test_gate_passes_the_plain_backward(grads, name):
    want, _ = grads
    assert chip_smoke.grad_tolerance_share(want[name], want[name]) == 0.0


@pytest.mark.parametrize("name", NAMES)
def test_gate_passes_one_bf16_ulp(grads, name):
    want, _ = grads
    ref = want[name]
    # one ulp away from zero in every element (sign and magnitude bits)
    moved = (ref.view(torch.int16) + 1).view(torch.bfloat16)
    assert bool((moved != ref).all())
    assert chip_smoke.grad_tolerance_share(moved, ref) <= 1.0


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("fault", ["tile", "row"])
def test_gate_refuses_a_missing_part_of_the_walk(grads, fault, name):
    want, broken = grads
    assert chip_smoke.grad_tolerance_share(broken[fault, name],
                                           want[name]) > 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gate_floor_on_a_zero_row(dtype):
    """A row of the reference that is zero (the first query's dQ, which is
    rounding noise) is held to the floor, a share of the tensor's largest
    element; a reference that is all zero must be met exactly."""
    atol = chip_smoke.TOL_D[dtype][0]
    ref = torch.zeros(1, 1, 4, 8, dtype=dtype)
    ref[..., 2:, :] = 4.0
    got = ref.clone()
    got[0, 0, 0, 3] = 2.0 * atol  # half of the floor of 4 * atol
    assert chip_smoke.grad_tolerance_share(got, ref) == pytest.approx(0.5)
    got[0, 0, 0, 3] = 8.0 * atol
    assert chip_smoke.grad_tolerance_share(got, ref) > 1.0
    zero = torch.zeros(1, 1, 4, 8, dtype=dtype)
    assert chip_smoke.grad_tolerance_share(zero, zero) == 0.0
    assert chip_smoke.grad_tolerance_share(got, zero) == float("inf")
