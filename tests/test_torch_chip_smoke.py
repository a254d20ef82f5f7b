"""The gate that ``chip_smoke.py`` holds the flash backward kernels to on the
card (``grad_tolerance_share`` with ``TOL_D``), tried here on the CPU at the
training step's sequence length (S 1024, D 64, bf16, causal).

It must pass the plain backward itself and the plain backward moved by one
bf16 ulp in every element, and refuse a backward whose walk misses a part
near the end of the sequence, where the gradients are smallest: one
64-wide tile (the key tile before the diagonal misses the last query tile
in dK and dV; the last query tile misses that key tile in dQ), or one row
(every key misses the last query; every query misses its diagonal key).

The forward at the Llama and BERT shapes is held to a row-scaled gate of
the same form (``TOL_F``): at S 4096 (head dim 128) it passes the plain
forward, one ulp and an emulation of the kernel's per-tile rounding (also
at BERT's non-causal S 512), and refuses outputs 10 % off in the last
query tile, which the absolute ``TOL_O`` would pass.

The MoE kernels' gates (``tolerance_share``, ``scatter_tolerance``,
``TOL_GATES``) are tried the same way: each passes the plain version and
refuses a gather that returns the clamped id's row for an invalid id, a
scatter-add that drops a duplicate or leaves a zero row unwritten, and a
gate that swaps a tie.  The scatter-add's inverse route is held bitwise to
its plain version: the gate must refuse a sum taken out of order (four
rows a destination), a dropped route read through its -1 padding, and a
row with no source left unwritten; the top-k gate a swapped tie at E = 300
(the kernel's G-lane route).
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


# ------------------------------------------------- the MoE kernels' gates
# chip_smoke.py holds the gather bitwise, the scatter-add bitwise (at most
# two rows on a destination, or integer values) or to an order bound
# (scatter_tolerance), and the gate's indices bitwise: each gate must pass
# the plain version and refuse a real fault.

def test_gather_gate_refuses_the_clamped_row_for_an_invalid_id():
    from hetu_tpu_torch.ops.cuda_kernels import embedding_gather_plain
    g = torch.Generator().manual_seed(0)
    table = torch.randn(16, 40, generator=g).to(torch.bfloat16)
    ids = torch.tensor([3, -1, 15, 16, 0, 22])
    ref = embedding_gather_plain(table, ids)
    assert chip_smoke.tolerance_share(ref.clone(), ref) == 0.0
    clamped = table[ids.clamp(0, 15)]  # the TPU kernel's DMA, unmasked
    assert chip_smoke.tolerance_share(clamped, ref) == float("inf")


def _pairs_case():
    g = torch.Generator().manual_seed(1)
    ids = torch.cat([torch.randperm(20, generator=g) - 2 for _ in range(2)])
    grads = torch.randn(ids.numel(), 24, generator=g)
    return ids, grads


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_scatter_gate_refuses_a_dropped_duplicate(dtype):
    from hetu_tpu_torch.ops.cuda_kernels import embedding_scatter_add_plain
    ids, grads = _pairs_case()
    grads = grads.to(dtype)
    ref = embedding_scatter_add_plain(grads, ids, 16)
    assert chip_smoke.tolerance_share(ref.clone(), ref) == 0.0
    # the second row of a destination that takes two is lost
    row = int(ids[(ids >= 0) & (ids < 16)][0])
    second = int((ids == row).nonzero()[1])
    keep = torch.ones(ids.numel(), dtype=torch.bool)
    keep[second] = False
    dropped = embedding_scatter_add_plain(grads[keep], ids[keep], 16)
    assert chip_smoke.tolerance_share(dropped, ref) == float("inf")


def test_scatter_gate_refuses_a_missing_zero_row():
    from hetu_tpu_torch.ops.cuda_kernels import embedding_scatter_add_plain
    ids, grads = _pairs_case()
    ids = ids[ids != 5]  # row 5 takes no gradient: it must be zeros
    grads = grads[:ids.numel()]
    ref = embedding_scatter_add_plain(grads, ids, 16)
    assert not ref[5].any()
    stale = ref.clone()
    stale[5] = 1e-30  # what an unwritten row of the output still held
    assert chip_smoke.tolerance_share(stale, ref) == float("inf")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_scatter_order_bound_passes_a_reordered_sum(dtype):
    """4096 rows on one destination, summed in reverse order: within the
    order bound; one row dropped: refused by the bound, and by the bitwise
    gate of the integer-valued case."""
    from hetu_tpu_torch.ops.cuda_kernels import embedding_scatter_add_plain
    g = torch.Generator().manual_seed(2)
    ids = torch.full((4096,), 3)
    grads = torch.randn(4096, 64, generator=g).to(dtype)
    ref = embedding_scatter_add_plain(grads, ids, 8)
    tol = chip_smoke.scatter_tolerance(grads, ids, 8, ref)
    flipped = embedding_scatter_add_plain(grads.flip(0), ids, 8)
    assert 0.0 <= chip_smoke.tolerance_share(flipped, ref, tol) <= 1.0
    short = embedding_scatter_add_plain(grads[1:], ids[1:], 8)
    assert chip_smoke.tolerance_share(short, ref, tol) > 1.0
    ints = torch.randint(-8, 9, (4096, 64), generator=g).to(dtype)
    exact = embedding_scatter_add_plain(ints, ids, 8)
    assert chip_smoke.tolerance_share(
        embedding_scatter_add_plain(ints.flip(0), ids, 8), exact) == 0.0
    assert chip_smoke.tolerance_share(
        embedding_scatter_add_plain(ints[1:], ids[1:], 8), exact) \
        == float("inf")


def test_topk_gate_refuses_a_swapped_tie():
    from hetu_tpu_torch.ops.cuda_kernels import topk_gating_plain
    logits = torch.zeros(8, 8)
    logits[4:, 2] = logits[4:, 6] = 1.0  # a tie between experts 2 and 6
    gates, idx = topk_gating_plain(logits, 2)
    assert idx[:4].tolist() == [[0, 1]] * 4 and idx[4:].tolist() == \
        [[2, 6]] * 4
    assert chip_smoke.tolerance_share(idx.clone(), idx) == 0.0
    assert chip_smoke.tolerance_share(
        gates, gates, chip_smoke.TOL_GATES[torch.float32]) == 0.0
    swapped = idx.clone()
    swapped[4] = torch.tensor([6, 2])
    assert chip_smoke.tolerance_share(swapped, idx) == float("inf")
    # a gate off by more than its tolerance is refused too
    off = gates + 2 * chip_smoke.TOL_GATES[torch.float32]
    assert chip_smoke.tolerance_share(
        off, gates, chip_smoke.TOL_GATES[torch.float32]) > 1.0


# ----------------------------------------- the scatter-add's inverse route

def _inverse_case(k=4, capacity=24):
    """The dispatch gradient of a top-k MoE routing (T 64, E 8): grads
    [E·C, 16] f32, the inverse ``token_slot [T, k]`` and the plain
    inverse route's result."""
    from hetu_tpu_torch.ops import make_slot_routes
    from hetu_tpu_torch.ops.cuda_kernels import (
        embedding_scatter_add_inverse_plain, topk_gating_plain,
    )
    g = torch.Generator().manual_seed(3)
    gates, idx = topk_gating_plain(torch.randn(64, 8, generator=g), k)
    slot_route, token_slot, _ = make_slot_routes(gates, idx, 8, capacity)
    grads = torch.randn(slot_route.numel(), 16, generator=g)
    return grads, token_slot, embedding_scatter_add_inverse_plain(
        grads, token_slot)


def test_inverse_gate_refuses_a_sum_out_of_order():
    """Four sources a row, summed in the order the map lists them (a
    token's choices) instead of ascending position: some rows round
    otherwise, and the bitwise gate sees it."""
    grads, inverse, ref = _inverse_case()
    assert chip_smoke.tolerance_share(ref.clone(), ref) == 0.0
    pos = inverse.long()
    assert bool((pos.sort(dim=1).values != pos).any())
    rows = torch.cat([grads, torch.zeros(1, grads.shape[1])])
    listed = torch.zeros_like(ref)
    for j in range(pos.shape[1]):
        listed += rows[torch.where(pos[:, j] >= 0, pos[:, j], grads.shape[0])]
    assert chip_smoke.tolerance_share(listed, ref) == float("inf")


def test_inverse_gate_refuses_a_dropped_route_read_through_its_padding():
    """A token whose route was dropped has -1 in its row of the map; a
    kernel that read grads[-1] (the last row) there leaves the row
    non-zero where the reference leaves the dropped route out."""
    grads, inverse, ref = _inverse_case(k=2, capacity=8)  # heavy drops
    dropped = (inverse < 0).any(dim=1).nonzero().reshape(-1)
    assert dropped.numel() > 0
    wrapped = ref.clone()
    wrapped[dropped] += grads[-1]
    assert chip_smoke.tolerance_share(wrapped, ref) == float("inf")


def test_inverse_gate_refuses_a_missing_zero_row():
    grads, inverse, ref = _inverse_case(k=2, capacity=8)
    empty = (inverse < 0).all(dim=1).nonzero().reshape(-1)
    assert empty.numel() > 0 and not ref[empty].any()
    stale = ref.clone()
    stale[empty[0]] = 1e-30  # what an unwritten row of the output held
    assert chip_smoke.tolerance_share(stale, ref) == float("inf")


def test_topk_gate_refuses_a_swapped_tie_at_300_experts():
    from hetu_tpu_torch.ops.cuda_kernels import topk_gating_plain
    logits = torch.randn(16, 300, generator=torch.Generator().manual_seed(4))
    logits[:, 17] = logits[:, 250] = 9.0  # a tie across two lanes' slices
    gates, idx = topk_gating_plain(logits, 2)
    assert idx[:, :2].tolist() == [[17, 250]] * 16
    swapped = idx.clone()
    swapped[3] = torch.tensor([250, 17], dtype=idx.dtype)
    assert chip_smoke.tolerance_share(idx.clone(), idx) == 0.0
    assert chip_smoke.tolerance_share(swapped, idx) == float("inf")


def test_gate_tolerance_takes_a_nan_only_where_the_reference_has_one():
    """The softmax of a row of -inf is NaN in both versions: the tolerance
    gate accepts a NaN there and refuses one anywhere else."""
    ref = torch.tensor([[float("nan"), float("nan")], [0.75, 0.25]])
    assert chip_smoke.tolerance_share(ref.clone(), ref, 1e-6) == 0.0
    bad = ref.clone()
    bad[1, 0] = float("nan")
    assert chip_smoke.tolerance_share(bad, ref, 1e-6) == float("inf")
    assert chip_smoke.tolerance_share(ref, bad, 1e-6) == float("inf")


# ------------------------- the Llama and BERT phases, rehearsed on the CPU
# Each new phase runs here at a tiny size through its real entry points up
# to its launch-count check, which fails because CPU tensors launch no
# kernel: every gate before it (statuses, vocabulary, the kernel path
# against the plain path, finite and falling loss, the masked forward's
# plain path) has passed by then.

TINY = dict(
    LLAMA_V=97, LLAMA_H=64, LLAMA_L=2, LLAMA_NH=4, LLAMA_FFN=96,
    LLAMA_P=128, LLAMA_HEAD_DIM=16, LLAMA_SLOTS=3, LLAMA_MAX_LEN=64,
    LLAMA_REQUESTS=5, LLAMA_PROMPT=(4, 40), LLAMA_GEN=(3, 8),
    LLAMA_TRAIN_L=2, LLAMA_TRAIN_B=2, LLAMA_TRAIN_S=64, LLAMA_STEPS=3,
    BERT_V=97, BERT_H=64, BERT_L=2, BERT_NH=4, BERT_FFN=96, BERT_P=64,
    BERT_B=4, BERT_S=32, BERT_STEPS=3)


@pytest.mark.parametrize("phase,reached", [
    ("phase_llama_serve", "flash_attention launches != layers x prefills"),
    ("phase_train_llama", "did not launch 2L forward"),
    ("phase_train_bert", "did not launch L of each flash kernel"),
])
def test_new_phase_rehearses_up_to_its_launch_count(monkeypatch, capsys,
                                                    phase, reached):
    for name, value in TINY.items():
        monkeypatch.setattr(chip_smoke, name, value)
    with pytest.raises(chip_smoke.SmokeFailure, match=reached):
        getattr(chip_smoke, phase)("cpu", 0, device="cpu")
    out = capsys.readouterr().out
    if phase == "phase_llama_serve":
        assert "'ok', 'ok', 'ok', 'ok', 'ok'" in out
    else:
        assert "kernel path vs plain path" in out and "losses:" in out
    if phase == "phase_train_bert":
        assert "masked forward: 0 flash launches, 2 warnings" in out


def test_bert_batch_is_the_examples_synthetic_batch():
    """``bert_synthetic_batch`` is ``examples/bert_pretrain.py``'s
    ``synthetic_batch``, read from the example's source (importing the
    example would set up JAX's devices): the same arrays from the same
    seed."""
    import ast
    src = (Path(__file__).resolve().parents[1] / "examples"
           / "bert_pretrain.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef)
              and n.name == "synthetic_batch")
    ns = {"np": np}
    exec(compile(ast.Module([fn], []), "bert_pretrain.py", "exec"), ns)
    want = ns["synthetic_batch"](np.random.default_rng(7), 6, 64, 500)
    got = chip_smoke.bert_synthetic_batch(np.random.default_rng(7), 6, 64,
                                          500)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    ids, tok, attn, mlm, nsp = got
    assert attn.all() and (mlm != -1).any() and set(np.unique(nsp)) <= {0, 1}


def test_flops_counts():
    """The MFU counts: Llama's 6 (N - V H) + 12 L H S a token (the untied
    head multiplies, the embedding gathers) and BERT's 6 N_nonemb + 6 V H
    + 12 L H S, at Llama-2-7B's and BERT-base's parameter counts."""
    class Stub:
        def __init__(self, c, n):
            self.c, self._n = c, n

        def parameters(self):
            return [torch.empty(self._n, device="meta")]

    from hetu_tpu_torch.models import BertConfig, LlamaConfig
    llama = Stub(LlamaConfig(num_layers=4), 1_071_681_536)
    fpt, n = chip_smoke._llama_flops_per_token(llama, 4096)
    assert fpt == 6 * (n - 32000 * 4096) + 12 * 4 * 4096 * 4096
    bert = Stub(BertConfig(), 110_106_428)
    fpt, _ = chip_smoke._bert_flops_per_token(bert, 512)
    n_emb = (30522 + 512 + 2) * 768
    assert fpt == 6 * (110_106_428 - n_emb) + 6 * 30522 * 768 \
        + 12 * 12 * 768 * 512


def _tiled_forward(q, k, v, causal, tile=64):
    """The forward kernel's rounding, emulated: keys in tiles of 64, each
    tile's p rounded to bf16 against the running row max, the O
    accumulator and l rescaled in f32 as the max grows, O / l rounded once
    at the end."""
    b, h, s, d = q.shape
    q, k, v = q.float(), k.float(), v.float()
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros(b, h, s, 1)
    o = torch.zeros(b, h, s, d)
    rows = torch.arange(s)[:, None]
    for j in range(0, s, tile):
        st = q @ k[:, :, j:j + tile].transpose(-1, -2) * d ** -0.5
        hide = (torch.arange(j, j + tile)[None, :] > rows) if causal \
            else torch.zeros(1, tile, dtype=torch.bool)
        st = st.masked_fill(hide, -1e30)
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(st - m_new).masked_fill(hide, 0.0)
        o = o * corr + p.to(torch.bfloat16).float() @ v[:, :, j:j + tile]
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
    return (o / l).to(torch.bfloat16)


def _bf16_inputs(shape, seed):
    g = np.random.default_rng(seed)
    return tuple(torch.from_numpy(g.standard_normal(
        shape, dtype=np.float32)).to(torch.bfloat16) for _ in range(3))


@pytest.fixture(scope="module")
def llama_forward():
    """The plain causal forward at the Llama training shape's sequence
    (S 4096, head dim 128, bf16) and the kernel's rounding emulated, from
    seeded inputs of shape (1, 2, 4096, 128)."""
    q, k, v = _bf16_inputs((1, 2, 4096, 128), 1)
    return (flash_attention_plain(q, k, v, causal=True)[0],
            _tiled_forward(q, k, v, True))


def test_forward_gate_passes_the_plain_forward_and_one_ulp(llama_forward):
    """The forward at the new shapes is held per output row (``TOL_F``):
    the plain forward itself and the same moved by one bf16 ulp in every
    element pass."""
    o, _ = llama_forward
    tol = chip_smoke.TOL_F
    assert chip_smoke.grad_tolerance_share(o, o, tol) == 0.0
    moved = (o.view(torch.int16) + 1).view(torch.bfloat16)
    assert chip_smoke.grad_tolerance_share(moved, o, tol) <= 1.0


def test_forward_gate_passes_the_kernels_rounding(llama_forward):
    """p rounded against each tile's running max, not the final one: at
    S 4096 causal and at BERT's non-causal S 512, within TOL_F (at the
    whole BERT batch of 16 this emulation used 1.13 of TOL_D)."""
    o, tiled = llama_forward
    assert chip_smoke.grad_tolerance_share(tiled, o, chip_smoke.TOL_F) \
        <= 1.0
    q, k, v = _bf16_inputs((2, 12, 512, 64), 2)
    assert chip_smoke.grad_tolerance_share(
        _tiled_forward(q, k, v, False),
        flash_attention_plain(q, k, v, causal=False)[0],
        chip_smoke.TOL_F) <= 1.0


def test_forward_gate_refuses_a_wrong_last_tile(llama_forward):
    """Outputs 10 % off in the last 64-row query tile: the absolute
    ``TOL_O`` (set for S <= 1024) waves them through, since the last rows'
    values are of its size; the row-scaled gate refuses them."""
    o, _ = llama_forward
    bad = o.clone()
    bad[..., -64:, :] = (bad[..., -64:, :].float() * 0.9).to(torch.bfloat16)
    diff = (bad.float() - o.float()).abs()
    bf = torch.bfloat16
    assert bool((diff <= chip_smoke.TOL_O[bf]
                 + chip_smoke.RTOL_O[bf] * o.float().abs()).all())
    assert chip_smoke.grad_tolerance_share(bad, o, chip_smoke.TOL_F) > 1.0


# ------------------------------------------------- the CTR phases' helpers
# train_ctr runs here at a tiny size up to its first launch-count check
# (the kernel-vs-plain gate on the uniform batch, which has passed by
# then); ps_ctr launches no kernel of the port and runs to its end.

TINY_CTR = dict(CTR_V=20000, CTR_B=128, CTR_HIDDEN=(16, 16),
                CTR_UNTOUCHED_SAMPLE=500, CTR_MASKED_SIZES=(128, 37))


def test_ctr_phase_rehearses_up_to_its_launch_count(monkeypatch, capsys):
    for name, value in TINY_CTR.items():
        monkeypatch.setattr(chip_smoke, name, value)
    with pytest.raises(chip_smoke.SmokeFailure,
                       match=r"did not launch 1 gather and 1 scatter-add "
                             r"\(uniform ids"):
        chip_smoke.phase_train_ctr("cpu", 0, device="cpu")
    out = capsys.readouterr().out
    assert "kernel path vs plain path, one step (uniform ids" in out
    assert "(bitwise); dense parameters bitwise" in out
    assert "500 untouched rows unchanged" in out


def test_ps_ctr_phase_runs_on_the_cpu(monkeypatch, capsys):
    """At the phase's batch and widths, on a table of 20000 rows: the two
    in-process arms, the two remote arms over two server processes, and
    the replay gate (every row bitwise the in-process table's)."""
    monkeypatch.setattr(chip_smoke, "CTR_PS_V", 20000)
    monkeypatch.setattr(chip_smoke, "CTR_PS_CACHE", 4096)
    out = chip_smoke.phase_ps_ctr("cpu", 0, device="cpu")
    arms = {"no cache", "HET cache", "remote: 2 servers", "remote: HET cache"}
    assert set(out) == arms | {"replay"}
    assert out["no cache"]["hit_rate"] is None
    assert out["remote: 2 servers"]["hit_rate"] is None
    assert out["HET cache"]["hit_rate"] > 0
    assert out["remote: HET cache"]["hit_rate"] > 0
    for name in arms:
        assert len(out[name]["losses"]) == chip_smoke.CTR_PS_STEPS
        assert out[name]["samples_per_s"] > 0
    assert out["replay"]["bitwise_rows"] == 20000
    # the pull and push bytes a step do not depend on the table's rows
    ops = out["remote: 2 servers"]["van_bytes_per_step"]
    ids = chip_smoke.CTR_B * chip_smoke.CTR_F
    assert ops["group_sparse_pull"] == ops["group_sparse_push"] == \
        ids * chip_smoke.CTR_DIM * 4
    printed = capsys.readouterr().out
    assert "hit rate" in printed and "20000 of 20000 rows bitwise" in printed


def test_van_servers_are_killed_and_a_failed_start_raises(monkeypatch):
    with chip_smoke.van_servers(2) as eps:
        assert len({port for _, port in eps}) == 2
        from hetu_tpu_torch.ps import van
        assert van.stats(*eps[0])["frames"] >= 1
    with pytest.raises(ConnectionError):
        van.stats(*eps[0], timeout_s=0.3)
    monkeypatch.setattr(chip_smoke, "_VAN_SERVER_SRC", "raise SystemExit(3)")
    with pytest.raises(chip_smoke.SmokeFailure, match="failed to start"):
        with chip_smoke.van_servers(1):
            pass


# ---- the MoE gates phase ----

TINY_GATES = dict(MOE_H=32, MOE_E=4, MOE_T=512, MOE_V=97, GATES_FFN=64)


@pytest.mark.parametrize("kind", ["hash", "ktop1", "balance", "sam"])
def test_gates_phase_rehearses_up_to_its_launch_count(monkeypatch, capsys,
                                                      kind):
    """Each gate at a tiny width: the kernel-vs-plain gate (loss, routes,
    every gradient) and 10 falling steps run; CPU tensors launch no
    kernel, so the phase stops at its launch count."""
    for name, value in TINY_GATES.items():
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "GATES", (kind,))
    with pytest.raises(chip_smoke.SmokeFailure,
                       match=rf"\[{kind}\] the step did not launch 2 "
                             rf"gathers, 2 scatter-adds"):
        chip_smoke.phase_train_moe_gates("cpu", 0, device="cpu")
    out = capsys.readouterr().out
    assert f"{kind}: kernel path vs plain path" in out
    assert f"[{kind}] gradients of" in out
    assert "embedding_gather 0" in out


def test_gates_phase_constants():
    """examples/moe_gates_train.py's loop at MoEConfig's widths: D 512, E
    8, FFN 4 D, cf 1.25, 16384 tokens, Adam(3e-3), 10 classes; 2560 slots
    an expert at k 1, 5120 for ktop1."""
    c = chip_smoke
    assert (c.MOE_H, c.MOE_E, c.GATES_FFN, c.MOE_CF, c.MOE_T) == \
        (512, 8, 2048, 1.25, 16384)
    assert (c.GATES_LR, c.GATES_CLASSES, c.GATES_STEPS) == (3e-3, 10, 10)
    assert c.GATES == ("hash", "ktop1", "balance", "sam")
    assert [c.gates_capacity(k) for k in c.GATES] == [2560, 5120, 2560, 2560]
    assert c.GATES_KTOP1_K == 2 and c.GATES_ITERS == 20


def test_gates_flops():
    """3 x the forward: the gate's scores (2 D E a token; SAM adds its
    group sum and score; hash none), the head (2 D 10 a token) and the
    expert FFN (4 D F a kept route)."""
    d, e, f, t = 512, 8, 2048, 16384
    head = 2 * d * 10
    assert chip_smoke._gates_flops("hash", 14517) == \
        3 * (t * head + 14517 * 4 * d * f)
    for kind in ("ktop1", "balance"):
        assert chip_smoke._gates_flops(kind, 100) == \
            3 * (t * (2 * d * e + head) + 100 * 4 * d * f)
    assert chip_smoke._gates_flops("sam", 100) == \
        3 * (t * (2 * d * e + d + head) + 2 * e * d + 100 * 4 * d * f)


LATER = {"train_cnn": 0, "train_rnn": 0, "train_gcn": 0, "gcn_sampled": 0,
         "train_compressed": 0}


def test_kernels_line_counts_the_gates_path():
    """rows 4 and 5 gain "train_moe_gates" (the four gates' steps summed);
    the top-k gate's entry reads 0 there.  Rows 4 to 6 carry the counts of
    the paths that launch none of the six too ("train_cnn", "train_rnn",
    "train_gcn", "gcn_sampled")."""
    gates = {k: {"launches": [0, 20, 20]} for k in chip_smoke.GATES}
    ctr = {"launches": [10, 10], "gather": {}, "scatter": {"uniform": {}}}
    for key, i in (("gather", 1), ("scatter", 2)):
        entry = chip_smoke._paths_entry(key, 80, ctr, gates, LATER)
        assert entry["launches_by_path"] == {
            "train_moe": 80, "train_moe_gates": 80, "ctr": 10, **LATER}
    assert chip_smoke._paths_entry("topk", 40, ctr, gates, LATER)[
        "launches_by_path"] == {"train_moe": 40, "train_moe_gates": 0,
                                **LATER}


def test_kernels_line_names_the_new_paths_for_every_kernel():
    """main() builds each of the six entries' ``launches_by_path`` with
    the five later paths, read from each phase's own counts."""
    src = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    main = src[src.index("def main("):]
    for key in LATER:
        assert f'"{key}": ' in main, key
    assert main.count("**later[0]") == 1 and main.count("**later[i]") == 1
    assert main.count("later[3 + i]") == 1
    order = [main.index(f"phase_{p}(card") for p in (
        "train_cnn", "train_rnn", "train_gcn", "gcn_sampled", "ops_zoo",
        "train_compressed", "kernel_shapes")]
    assert order == sorted(order)


def test_ctr_batches_are_drawn_as_bench_ctr_and_the_example_draw_them():
    g, ref = np.random.default_rng(3), np.random.default_rng(3)
    dx, ids, y = chip_smoke.ctr_batch(g, 64, 1000)
    np.testing.assert_array_equal(ids, ref.integers(0, 1000, (64, 26)))
    np.testing.assert_array_equal(dx, ref.standard_normal((64, 13)).astype(
        np.float32))
    np.testing.assert_array_equal(y, ref.integers(0, 2, 64))
    assert ids.dtype == np.int32 and dx.dtype == y.dtype == np.float32
    spec = importlib.util.spec_from_file_location(
        "ctr_wdl", Path(__file__).resolve().parents[1] / "examples"
        / "ctr_wdl.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    for got, want in zip(chip_smoke.synthetic_ctr(300, 26, 13, 5000, 4),
                         example.synthetic_ctr(300, 26, 13, 5000, 4)):
        np.testing.assert_array_equal(got, want)


def test_zipf_ids_are_skewed_and_in_range():
    """At the CTR vocabulary: id 0 takes about 1/zeta(1.2) = 18 % of the
    draws, and the clipped tail lands on the last row."""
    v = chip_smoke.CTR_V
    ids = chip_smoke.zipf_ids(np.random.default_rng(0), (2048, 26), v)
    assert ids.dtype == np.int32 and ids.min() == 0 and ids.max() == v - 1
    uniq, counts = np.unique(ids, return_counts=True)
    assert uniq[counts.argmax()] == 0 and counts.max() > 0.15 * ids.size
    assert counts[1] > counts[2] > counts[3]
    assert uniq.size < 0.2 * ids.size  # long duplicate runs


def test_ctr_roofline_is_bench_ctrs_formula():
    row_bytes, flops, seconds = chip_smoke.ctr_roofline(2048)
    assert row_bytes == 3 * 2048 * 26 * 16 * 4
    assert flops == 2 * 2048 * (429 * 256 + 256 * 256 + 256) * 3
    assert seconds == pytest.approx(row_bytes / 3.35e12 + flops / 989e12)


def _sgd_rows(grads, ids, touched, rows, lr, order):
    """One SGD step's touched rows, each row's gradients summed in f32 in
    ``order`` (positions), as p + ((p - lr g) - p)."""
    pos = torch.searchsorted(touched, ids)
    g = torch.zeros(touched.numel(), grads.shape[1])
    for i in order:
        g[pos[i]] += grads[i]
    return rows + ((rows - lr * g) - rows)


def test_sgd_row_tolerance_passes_a_reordered_sum_and_refuses_a_lost_one():
    """The kernel-vs-plain gate on the touched rows: rows of at most two
    sources must match bitwise; a row of many sources summed in another
    order passes; a dropped duplicate does not."""
    g = np.random.default_rng(5)
    ids = torch.tensor(np.concatenate([np.full(200, 7), [3, 3, 11],
                                       g.integers(20, 60, 40)]),
                       dtype=torch.int32)
    grads = torch.tensor(g.standard_normal((ids.numel(), 16)),
                         dtype=torch.float32)
    touched = torch.unique(ids)
    rows = torch.tensor(g.standard_normal((touched.numel(), 16)) * 0.01,
                        dtype=torch.float32)
    lr = 0.01
    n = ids.numel()
    ref = _sgd_rows(grads, ids, touched, rows, lr, range(n))
    tol = chip_smoke.sgd_row_tolerance(grads, ids, touched, rows, lr)
    assert tol.shape == rows.shape and tol.dtype == torch.float64
    runs = torch.bincount(torch.searchsorted(touched, ids))
    assert (tol[runs <= 2] == 0).all() and (tol[runs > 2] > 0).all()
    assert chip_smoke.tolerance_share(ref.clone(), ref, tol) == 0.0
    backwards = _sgd_rows(grads, ids, touched, rows, lr, reversed(range(n)))
    assert not torch.equal(backwards, ref)  # the long run rounds otherwise
    assert 0.0 < chip_smoke.tolerance_share(backwards, ref, tol) <= 1.0
    lost = _sgd_rows(grads, ids, touched, rows, lr, range(1, n))
    assert chip_smoke.tolerance_share(lost, ref, tol) > 1.0
    # a row of two sources in the other order is still bitwise
    pair = [i for i in range(n) if int(ids[i]) == 3]
    swapped = list(range(n))
    swapped[pair[0]], swapped[pair[1]] = pair[1], pair[0]
    assert chip_smoke.tolerance_share(
        _sgd_rows(grads, ids, touched, rows, lr, swapped), ref, tol) == 0.0


# ------------------------------------------------- paged serving's gates
# The near-tie rule (``near_tie_divergence``) holds each request's paged
# stream against its reference stream: equal streams pass; at the first
# difference the plain logits' gap between the reference's token s and
# the paged token p must be at most 4 tau of max|z|; later tokens are not
# compared.

TAU = 5e-2


def _logits(gaps, m=10.0, n=8):
    """Plain logits with max |z| = m: token 0 leads, token i trails it by
    gaps[i - 1] (shares of m)."""
    z = torch.zeros(n, dtype=torch.float64)
    z[0] = m
    for i, gap in enumerate(gaps, 1):
        z[i] = m - gap * m
    z[-1] = -m / 2
    return z


class _Calls:
    def __init__(self, z):
        self.z, self.seen = z, []

    def __call__(self, agreed):
        self.seen.append(list(agreed))
        return self.z


def test_near_tie_gate_passes_identical_streams():
    calls = _Calls(_logits([0.5]))
    assert chip_smoke.near_tie_divergence([0, 3, 5], [0, 3, 5], calls,
                                          TAU) is None
    assert calls.seen == []


def test_near_tie_gate_passes_a_divergence_within_four_tau():
    calls = _Calls(_logits([4 * TAU - 1e-3]))
    i, s, p, share = chip_smoke.near_tie_divergence([4, 0, 2], [4, 1, 2],
                                                    calls, TAU)
    assert (i, s, p) == (1, 0, 1) and share == pytest.approx(4 * TAU - 1e-3)
    assert calls.seen == [[4]]        # the prompt's agreed tokens only


def test_near_tie_gate_refuses_a_divergence_just_outside_four_tau():
    with pytest.raises(chip_smoke.SmokeFailure, match="away from a near tie"):
        chip_smoke.near_tie_divergence([0], [1], _Calls(
            _logits([4 * TAU + 1e-3])), TAU)


def test_near_tie_gate_refuses_a_token_that_was_not_the_runner_up():
    """Token 1 trails by a near tie, token 2 by far more: the paged path
    choosing token 2 fails though the reference's top two were close."""
    z = _logits([TAU, 0.9])
    chip_smoke.near_tie_divergence([0], [1], _Calls(z), TAU)
    with pytest.raises(chip_smoke.SmokeFailure, match="away from a near tie"):
        chip_smoke.near_tie_divergence([0], [2], _Calls(z), TAU)


def test_near_tie_gate_stops_comparing_after_the_first_divergence():
    calls = _Calls(_logits([TAU]))
    out = chip_smoke.near_tie_divergence([0, 0, 5, 6, 7], [0, 1, 9, 9, 9],
                                         calls, TAU)
    assert out[:3] == (1, 0, 1) and calls.seen == [[0]]
    with pytest.raises(chip_smoke.SmokeFailure, match="streams of"):
        chip_smoke.near_tie_divergence([0, 1], [0], calls, TAU)


def _replay(cache, warm, pairs):
    """The cache operations of the paged engine for the requests run one
    after another (match on the first chunk, adopt, write the rest of the
    prompt, register it, decode, free); returns the burst's prefix hits."""
    hits = 0
    for i, (prompt, gen) in enumerate([warm] + pairs):
        slot = cache.alloc()
        n_shared, pages = cache.match_prefix(prompt)
        if n_shared:
            cache.adopt_prefix(slot, n_shared, pages)
            hits += i > 0
        cache.prepare_write(slot, n_shared, len(prompt) - n_shared)
        cache.lengths[slot] = len(prompt)
        cache.register_prefix(slot, prompt)
        for t in range(gen - 1):
            cache.prepare_write(slot, len(prompt) + t, 1)
        cache.free(slot)
    return hits


def test_shared_prompt_hits_by_the_reference_rule():
    """The chip run's shared system prompt traffic (Llama-2-7B's
    vocabulary, 8 slots x 1024, page 16) through hetu_tpu's PagedKVCache
    and the port's: every burst request hits the 384-token prompt and
    nothing more, so the gate's 16 hits and 6144 tokens are the
    reference's."""
    from hetu_tpu.serve.kv_cache import KVCacheSpec as JaxSpec
    from hetu_tpu.serve.kv_cache import PagedKVCache as JaxPagedKVCache
    from hetu_tpu_torch.serve import KVCacheSpec, PagedKVCache

    warm, pairs = chip_smoke.shared_prompt_requests(0, chip_smoke.LLAMA_V)
    assert len(pairs) == chip_smoke.SYS_REQUESTS == 16
    assert all(p[:384] == warm[0][:384] for p, _ in pairs)
    kw = dict(page_size=chip_smoke.PAGE_SIZE)
    ref = JaxPagedKVCache(JaxSpec(1, 1, 1), chip_smoke.LLAMA_SLOTS,
                          chip_smoke.LLAMA_MAX_LEN, **kw)
    port = PagedKVCache(KVCacheSpec(1, 1, 1), chip_smoke.LLAMA_SLOTS,
                        chip_smoke.LLAMA_MAX_LEN, device="cpu", **kw)
    for cache in (ref, port):
        assert _replay(cache, warm, pairs) == 16
        assert cache.prefix_hit_tokens == 16 * chip_smoke.SYS_PROMPT == 6144
    assert port.cow_copies == ref.cow_copies
    assert list(port._prefix) == list(ref._prefix)


# The paged_serve phase at a size scaled down by page units (page 4 for 16,
# so a prompt spans as many pages and chunks as on the card; generation
# counts kept, since a decode step makes one token whatever the page):
# every gate of the phase runs, and CPU tensors launch no flash kernel, so
# it runs to its end.
TINY_PAGED = dict(
    V=97, H=64, L=2, NH=4, FFN=128, MAX_LEN=192, SLOTS=8, N_REQUESTS=16,
    GPT_PROMPT=(1, 32), LLAMA_V=97, LLAMA_H=64, LLAMA_L=2, LLAMA_NH=4,
    LLAMA_FFN=96, LLAMA_P=256, LLAMA_MAX_LEN=256, LLAMA_PROMPT=(1, 128),
    PAGE_SIZE=4, SYS_PROMPT=96, SYS_SUFFIX=(4, 32),
    CHUNK_CHECK_PROMPTS=(7, 25, 75, 128), CHUNK_CHECK_SIZES=(16, 64))


def test_paged_serve_phase_runs_on_the_cpu(monkeypatch, capsys):
    from hetu_tpu_torch.models import LlamaConfig, LlamaModel
    from hetu_tpu_torch.serve import ServeEngine

    for name, value in TINY_PAGED.items():
        monkeypatch.setattr(chip_smoke, name, value)
    c = chip_smoke
    cfg = LlamaConfig(vocab_size=c.LLAMA_V, hidden_size=c.LLAMA_H,
                      num_layers=c.LLAMA_L, num_heads=c.LLAMA_NH,
                      num_kv_heads=2, ffn_size=c.LLAMA_FFN,
                      max_position=c.LLAMA_P, attention_impl="flash")
    engine = ServeEngine(LlamaModel(cfg, device="cpu"),
                         num_slots=c.LLAMA_SLOTS, max_len=c.LLAMA_MAX_LEN,
                         device="cpu")
    out = c.phase_paged_serve("cpu", 0, engine, device="cpu")
    text = capsys.readouterr().out
    for part in ("gpt", "llama", "shared prompt"):
        assert f"[paged_serve] {part}: " in text
    assert "prefix hits 16, hit tokens 1536 (want 16 and 1536)" in text
    assert out["shared"]["shared"]["peak_pages"] < \
        out["shared"]["unshared"]["peak_pages"]
    assert out["llama"]["chunk_logits_share"] < c.TOL_LLAMA_LOGITS
    assert {m.attention_impl for m in engine.model.modules()
            if hasattr(m, "attention_impl")} == {"flash"}


# ---- the server phase, rehearsed on the CPU ----

# the phase at the sizes of tests/test_torch_migrate.py's migrate
# rehearsal: the bursts keep their 16 requests over 8 slots, so the
# server's 16 listeners, the admission queue and the mid-decode drains are
# the card's; CPU tensors launch no flash kernel, so every launch gate
# expects none
TINY_SERVER = dict(
    V=97, H=64, L=2, NH=4, FFN=128, MAX_LEN=192, SLOTS=8, N_REQUESTS=16,
    GPT_PROMPT=(1, 32), LLAMA_V=97, LLAMA_H=64, LLAMA_L=2, LLAMA_NH=4,
    LLAMA_FFN=96, LLAMA_P=256, LLAMA_MAX_LEN=256, LLAMA_PROMPT=(1, 128),
    WIRE_CHUNK=4096)


def test_server_phase_runs_on_the_cpu(monkeypatch, capsys):
    """Every gate of the phase runs: responses, the near-tie holds, the
    launch counts (none off the card), the failover's counters, the wire
    drains' rows and bytes.  llama_serve's run is the same burst straight
    through the scheduler; the migrate phase's re-prefill fit and
    in-process figures are stand-ins (only the crossover lines read
    them)."""
    from hetu_tpu_torch.models import LlamaConfig, LlamaModel
    from hetu_tpu_torch.serve import ServeEngine

    for name, value in TINY_SERVER.items():
        monkeypatch.setattr(chip_smoke, name, value)
    c = chip_smoke
    cfg = LlamaConfig(vocab_size=c.LLAMA_V, hidden_size=c.LLAMA_H,
                      num_layers=c.LLAMA_L, num_heads=c.LLAMA_NH,
                      num_kv_heads=2, ffn_size=c.LLAMA_FFN,
                      max_position=c.LLAMA_P, dtype=torch.bfloat16,
                      attention_impl="flash")
    engine = ServeEngine(LlamaModel(cfg, device="cpu"),
                         num_slots=c.LLAMA_SLOTS, max_len=c.LLAMA_MAX_LEN,
                         device="cpu")
    pairs = c.burst(np.random.default_rng(3), c.LLAMA_V, c.LLAMA_REQUESTS,
                    c.LLAMA_PROMPT, c.LLAMA_GEN)
    run = c._serve_burst(engine, pairs, "cpu")
    n_tok = sum(len(r.tokens) for r in run["requests"])
    llama_run = dict(tokens=[r.tokens for r in run["requests"]],
                     ttft_p50_ms=run["snap"]["ttft_p50_s"] * 1e3,
                     tokens_per_s=n_tok / run["wall"])
    migrated = {"llama": {
        "reprefill": {"ms_per_token": 0.01, "fixed_ms": 5.0},
        "slot->slot": {"export_ms": 1.0, "import_ms": 1.0}}}
    out = c.phase_server("cpu", 0, engine, llama_run, migrated,
                         device="cpu")
    text = capsys.readouterr().out
    for tag in ("gpt", "llama"):
        assert f"[server] {tag}: 16 clients," in text
        assert f"[server] {tag} served: " in text  # the near-tie counts
        assert out[tag]["launches"] == 0
    assert "[server] failover: the engine crashed after decode round 4" \
        in text
    assert out["failover"]["engine_restarts"] == 1
    # the requests in flight at the crash: as many as had arrived
    assert out["failover"]["requests_requeued"] >= 1
    assert "[server] gpt f32 wire none: 8 mid-decode slots" in text
    assert out["gpt_wire"]["exact"] == 16
    for codec in ("none", "bf16", "int8"):
        assert f"[server] llama wire {codec}: 8 mid-decode slots" in text
        assert f"[server] llama migration over the wire, {codec}" in text
        w = out["llama_wire"][codec]
        assert w["chunks"] == -(-w["wire_bytes"] // (4096 + 20)) > 1
    assert out["llama_wire"]["int8"]["ratio"] >= 1.9
    assert out["launches"] == 0
    assert {m.attention_impl for m in engine.model.modules()
            if hasattr(m, "attention_impl")} == {"flash"}


# ---- the CNN phase, rehearsed on the CPU ----

def test_conv_fc_macs_is_a_count_by_hand_of_resnet18():
    """ResNet-18 on 32 x 32: the stem, four stages of two blocks (the
    first of stages 2 to 4 strided, with its 1x1 downsample) and the
    head; 0.56 G multiply-adds a sample."""
    from hetu_tpu_torch.models import ResNet18

    def conv(c_out, hw, c_in, k=3):
        return c_out * hw * hw * c_in * k * k
    per_sample = conv(64, 32, 3) + 4 * conv(64, 32, 64)
    for c, hw in ((128, 16), (256, 8), (512, 4)):
        per_sample += conv(c, hw, c // 2) + 3 * conv(c, hw, c) \
            + conv(c, hw, c // 2, 1)
    per_sample += 512 * 10
    assert per_sample == 555_422_720
    got = chip_smoke.conv_fc_macs(ResNet18(device="cpu"),
                                  torch.zeros(2, 3, 32, 32))
    assert got == 2 * per_sample


# the phase at batch 8 on one repeated batch (ResNet-18 and the zoo at
# full width; the f32-vs-f64 step, the checkpoint round trip, the launch
# gates, which expect none): every gate runs
TINY_CNN = dict(CNN_B=8, CNN_STEPS=5, CNN_SUBSET=8, CNN_ZOO_STEPS=4,
                CNN_VALID=8)


def test_train_cnn_phase_runs_on_the_cpu(monkeypatch, capsys):
    for name, value in TINY_CNN.items():
        monkeypatch.setattr(chip_smoke, name, value)
    out = chip_smoke.phase_train_cnn("cpu", 0, device="cpu")
    text = capsys.readouterr().out
    assert "[train_cnn] checkpoint: loaded state equal to the saved one: " \
        "True" in text
    assert out["launches"] == [0] * 6
    assert out["flops"] == 6 * 8 * 555_422_720
    assert out["grad_gap"] <= chip_smoke.TOL_CNN_GRAD
    for name in ("vgg16", "lenet", "mlp"):
        assert out["zoo"][name]["losses"][-1] < out["zoo"][name]["losses"][0]


# ---- the RNN, GCN and op-zoo phases, rehearsed on the CPU ----

# the RNN phase at hidden 32, B 16 on a 32-sample subset, 12 steps a cell
TINY_RNN = dict(RNN_B=16, RNN_STEPS=12, RNN_SUBSET=32, RNN_HIDDEN=32)
# the graph at 3000 nodes and 20 000 drawn edges (128 features, 40
# classes, as on the card), hidden 32; sampling at 32 seeds a batch
TINY_GCN = dict(GCN_N=3000, GCN_EDGES=20_000, GCN_HIDDEN=32, GCN_STEPS=6,
                SAGE_SEEDS=32, SAGE_PAD_NODES=32 * 276 + 1,
                SAGE_PAD_EDGES=32 * 275)


def test_train_rnn_phase_runs_on_the_cpu(monkeypatch, capsys):
    for name, value in TINY_RNN.items():
        monkeypatch.setattr(chip_smoke, name, value)
    out = chip_smoke.phase_train_rnn("cpu", 0, device="cpu")
    assert out["launches"] == [0] * 6
    assert out["cells"].keys() == set(chip_smoke.RNN_CELLS)
    for cell in out["cells"].values():
        assert cell["losses"][-1] < cell["losses"][0]
        assert cell["grad_gap"] <= chip_smoke.TOL_RNN_GRAD
        assert cell["loss_gap"] <= chip_smoke.TOL_RNN_LOSS
    assert "[train_rnn] lstm: step median" in capsys.readouterr().out


def test_train_gcn_and_sampled_phases_run_on_the_cpu(monkeypatch, capsys):
    for name, value in TINY_GCN.items():
        monkeypatch.setattr(chip_smoke, name, value)
    out = chip_smoke.phase_train_gcn("cpu", 0, device="cpu")
    assert out["launches"] == [0] * 6
    assert out["losses"][-1] < out["losses"][0]
    assert out["grad_gap"] <= chip_smoke.TOL_GCN_GRAD
    text = capsys.readouterr().out
    assert "exact integers: True" in text and "ReLU pattern" in text
    out = chip_smoke.phase_gcn_sampled("cpu", 0, device="cpu")
    assert out["launches"] == [0] * 6
    assert len(out["batches"]) == chip_smoke.SAGE_BATCHES
    for b in out["batches"]:
        assert b["nodes"] < chip_smoke.SAGE_PAD_NODES
        assert b["edges"] <= chip_smoke.SAGE_PAD_EDGES
    assert np.mean(out["losses"][-3:]) < np.mean(out["losses"][:3])


def test_graph_is_arxivs_sizes_and_the_pads_hold_any_batch():
    """The card's graph: ogbn-arxiv's nodes, features and classes, its
    edges both ways; the pads are a full sample's counts (one padding
    node more)."""
    assert (chip_smoke.GCN_N, chip_smoke.GCN_F, chip_smoke.GCN_CLASSES,
            chip_smoke.GCN_EDGES) == (169_343, 128, 40, 1_166_243)
    assert (chip_smoke.SAGE_PAD_NODES, chip_smoke.SAGE_PAD_EDGES) == (
        141_313, 140_800)
    x, labels, src, dst, mask = chip_smoke._graph(0, 500, 16, 5, 3000, 0.9,
                                                  2.0, 0.54)
    assert x.shape == (500, 16) and src.size == dst.size == 6000
    np.testing.assert_array_equal(src[3000:], dst[:3000])
    intra = labels[src[:3000]] == labels[dst[:3000]]
    assert 0.85 < intra.mean() < 0.95 and 0.45 < mask.mean() < 0.65


def test_sampled_edge_gates_refuse_a_fake_edge_and_a_wide_fan_in():
    from hetu_tpu_torch.data.graph_sampler import SampledBatch
    src, dst, n = np.array([0, 1, 2]), np.array([1, 2, 0]), 3
    keys = chip_smoke.edge_keys(src, dst, n)

    def batch(es, ed):
        return SampledBatch(np.array([1, 0, 2]), np.array(es),
                            np.array(ed), np.zeros((3, 1), np.float32),
                            np.zeros(3, np.int64),
                            np.array([1, 0, 0], np.float32))
    fake = batch([1], [0])  # node 1 pulled node 0: (1, 0) is no edge
    assert not chip_smoke.sampled_edges_real(fake, keys, n)
    real = batch([2], [0])  # node 1 pulled node 2: (1, 2) is an edge
    assert chip_smoke.sampled_edges_real(real, keys, n)
    assert chip_smoke.fan_in_bounded(real, (1, 1))
    wide = batch([1, 2], [2, 2])  # a non-seed with 2 in-edges
    assert not chip_smoke.fan_in_bounded(wide, (5, 1))
    assert chip_smoke.fan_in_bounded(wide, (5, 2))


def test_ops_zoo_phase_runs_on_the_cpu(capsys):
    """On the CPU the phase compares each op with itself: it runs every
    case through the port, and an id out of range raises."""
    out = chip_smoke.phase_ops_zoo("cpu", device="cpu")
    assert out["cases"] > 90 and out["worst"][1] == 0.0
    names = {c[0] for c in chip_smoke._zoo_cases(np.random.default_rng(0))}
    from hetu_tpu_torch import ops
    families = ("elementwise", "shape", "matmul", "reduce")
    ported = {n for f in families for n in dir(getattr(ops, f))
              if not n.startswith("_") and callable(getattr(
                  getattr(ops, f), n)) and n in ops.__all__}
    assert ported - {"sam_group_sum", "sam_max"} <= names, \
        ported - names


# ---- the compression phase, rehearsed on the CPU ----

# the table at 20 000 rows (DPQ and MGQE at 4096), B 256; the float64 gate
# at 2048 rows
TINY_COMPRESSED = dict(CTR_V=20_000, CMP_V_CUT=4096, CMP_F64_V=2048,
                       CTR_B=256)


def test_train_compressed_phase_runs_on_the_cpu(monkeypatch, capsys):
    for name, value in TINY_COMPRESSED.items():
        monkeypatch.setattr(chip_smoke, name, value)
    out = chip_smoke.phase_train_compressed("cpu", 0, device="cpu")
    assert out["launches"] == [0] * 6
    assert out["methods"].keys() == set(chip_smoke.CMP_METHODS)
    for m in out["methods"].values():
        assert m["losses"][-1] < m["losses"][0]
    full = 20_000 * chip_smoke.CTR_DIM * 4
    for name in chip_smoke.CMP_STORAGE:
        assert out["methods"][name]["param_bytes"] < full
    assert out["f64"].keys() == set(chip_smoke.CMP_METHODS)
    for gaps in out["f64"].values():
        assert gaps["grad_gap"] <= chip_smoke.TOL_RNN_GRAD
    assert out["after"].keys() == {"full", "dpq", "prune", "pep", "autodim",
                                   "optembed"}
    text = capsys.readouterr().out
    assert "lookups bitwise the pruned rows: True" in text
    assert "a masked weight moved: False" in text


def test_compressed_float64_gate_refuses_a_dpq_code_flipped_unreplayed(
        monkeypatch):
    """A float64 pass that picks another code for one (id, subspace) moves
    the codebooks' gradient past the limit unless the f32 codes are
    replayed; replayed, the gate passes and counts the flip."""
    from hetu_tpu_torch.embedding_compress import layers
    model = chip_smoke.compressed_model(
        "dpq", 512, 16, 26, torch.Generator().manual_seed(0))
    ids, y = (torch.tensor(a) for a in chip_smoke.compressed_batches(
        np.random.default_rng(0), 512, n=1, b=64)[0])
    plain = layers.hard_codes

    def flipped(logits):
        codes = plain(logits)
        if logits.dtype == torch.float64:
            codes = codes.clone()
            codes.view(-1)[0] = (codes.view(-1)[0] + 1) % logits.shape[-1]
        return codes
    monkeypatch.setattr(layers, "hard_codes", flipped)
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.compressed_f32_vs_f64("dpq", model, ids, y, replay=False)
    out = chip_smoke.compressed_f32_vs_f64("dpq", model, ids, y)
    assert out["flips"] == 1
    assert out["grad_gap"] <= chip_smoke.TOL_RNN_GRAD


# ---- the pool phase, rehearsed on the CPU ----

# the phase at the sizes of TINY_SERVER's GPT: the burst keeps its 16
# requests over three members of 8 slots, so the routing, the holds, the
# drains (6 running slots on the busiest member), the kill and the chaos
# run are the card's; CPU tensors launch no flash kernel, so every launch
# gate expects none
TINY_POOL = dict(V=97, H=64, L=2, NH=4, FFN=128, POOL_V=97, POOL_P=256,
                 POOL_MAX_LEN=192, N_REQUESTS=16, GPT_PROMPT=(1, 32))


def test_pool_phase_runs_on_the_cpu(monkeypatch, capsys):
    """Every gate of the phase runs: the token-exact drains over the van
    and in process (one slot moved a running request, no prefill on the
    survivors for them), the kill's failover and the revive, the chaos
    run's pairs, the doctor and the near-tie holds, the launch counts
    (none off the card); the printed lines keep their schema."""
    import re

    for name, value in TINY_POOL.items():
        monkeypatch.setattr(chip_smoke, name, value)
    out = chip_smoke.phase_pool("cpu", 0, device="cpu")
    text = capsys.readouterr().out
    for tag in ("f32 drain over the van", "f32 drain in process",
                "f32 kill"):
        assert re.search(rf"\[pool\] {tag}: 16 requests over 3 members, "
                         r"m\d held at decode round 2 with \d+ requests "
                         r"\(\d+ running\); every response ok, 16 of 16 "
                         r"streams token-exact", text), tag
        assert out[tag]["exact"] == 16 and out[tag]["launches"] == 0
    for tag in ("f32 drain over the van", "f32 drain in process"):
        run = out[tag]
        assert run["slots"] > 0 and run["reprefill_tokens"] == 0
        assert re.search(rf"\[pool\] {tag}: m\d drained mid-decode, "
                         rf"{run['slots']} slots moved \(slots_migrated "
                         rf"{run['slots']}\), 0 prefill tokens on the "
                         r"survivors", text)
    assert out["f32 drain over the van"]["wire_bytes"] > 0
    assert out["f32 drain in process"]["wire_bytes"] == 0
    kill = out["f32 kill"]
    assert kill["failovers"] == 1 and kill["revived"] == 1
    assert kill["requests_failed_over"] >= 1
    assert "revive_member: back in routing, took 1 of 3 new requests" in text
    chaos = out["chaos"]
    # bf16: only a re-prefilled stream may part at a near tie (the phase
    # holds each to the rule); a migrated one keeps its K/V and goes on
    # token for token; the count of served requests is the burst's
    assert chaos["requests"] >= 16
    assert chaos["exact"] + chaos["near_ties"] == chaos["requests"]
    assert chaos["near_ties"] <= chaos["requests_failed_over"]
    assert chaos["failovers"] == 1 and chaos["launches"] == 0
    # the preemption moved the live slots of its parked member
    assert chaos["slots_migrated"] == sum(chaos["live_at_preempt"]) >= 1
    for kind, rec in (("serve_preempt", "serve.migrate"),
                      ("serve_engine_kill", "serve.failover")):
        assert chaos["report"][kind]["paired"] == 1
        assert re.search(rf"\[pool\] chaos: fault\.{kind} at step \d -> "
                         rf"{rec}: detection [\d.]+ ms, recovery [\d.]+ ms; "
                         rf"doctor: serve_recovery\.{kind} ← {kind} ← "
                         rf"{rec} closed", text), kind
    assert re.search(r"\[pool\] chaos: \d+ requests, every response ok",
                     text)
    assert re.search(r"TTFT p50 [\d.]+ ms, p99 [\d.]+ ms \[cpu\]", text)
    assert out["launches"] == 0
    assert re.search(r"\[pool\] peak [\d.]+ GiB allocated; phase [\d.]+ s; "
                     r"flash forwards launched 0 \[cpu\]", text)


def test_crosshost_phase_runs_on_the_cpu(monkeypatch, capsys):
    """The cross-process phase at TINY_POOL's widths, its member processes
    on the CPU: the burst, the drain, the kill and revive and the suspend
    token-exact; the bf16 chaos run's faults paired on the merged fleet
    timeline; no member with jax; the launch counts (none off the card);
    the printed lines keep their schema."""
    import re

    for name, value in TINY_POOL.items():
        monkeypatch.setattr(chip_smoke, name, value)
    out = chip_smoke.phase_crosshost("cpu", 0, device="cpu")
    text = capsys.readouterr().out
    f32, bf16 = out["f32"], out["bf16"]
    assert f32["burst_exact"] == 16
    assert f32["drain_slots"] >= 1 and f32["drain_reprefill_tokens"] == 0
    assert f32["drained_rc"] == 0 and f32["drain_wire_bytes"] > 0
    assert f32["failovers"] == 1 and f32["requests_failed_over"] >= 1
    assert f32["suspend"] == {"members_suspected": 1,
                              "members_suspect_cleared": 1,
                              "pool_failovers": 0, "same_incarnation": True}
    # three members, the revived one, then three bf16 members: none with jax
    assert f32["members_spawned"] == 4 and bf16["members_spawned"] == 3
    assert bf16["exact"] + bf16["near_ties"] == 16
    assert bf16["streams"] >= 4  # the controller and the three members
    assert out["launches"] == 0 and out["prefills"] > 0
    for tag in ("f32 kill", "f32 suspend", "bf16 chaos"):
        assert re.search(rf"\[crosshost\] {tag}: fault\.member_\w+ -> "
                         r"serve\.\w+: detection [\d.]+ ms, recovery "
                         r"[\d.]+ ms \[cpu\]", text), tag
    assert re.search(r"\[crosshost\] f32 burst: 16 requests over 3 member "
                     r"processes, every response ok, 16 of 16 streams "
                     r"token-exact", text)
    assert re.search(r"\[crosshost\] f32: 3 member processes \(pids \[[\d, "
                     r"]+\]\) READY after \[[\d., ]+\] s", text)
    assert re.search(r"\[crosshost\] f32 revive: a fresh process on member "
                     r"\d's slot READY after [\d.]+ s took a new request "
                     r"token-exact \[cpu\]", text)
    assert re.search(r"\[crosshost\] phase [\d.]+ s; \d+ prefills in the "
                     r"members, flash forwards launched 0 \[cpu\]", text)


def test_vanchaos_phase_runs_on_the_cpu(monkeypatch, capsys):
    """The durable-tier phase at TINY_POOL's widths, its member processes
    on the CPU: both held van kills token-exact at incarnations 2 and 3,
    each paired with van.promote on the merged timeline, the resilvers
    leaving both vans bitwise equal, the fence, the standby's promotion
    with every accepted rid ok, no jax anywhere, the launch counts (none
    off the card); the printed lines keep their schema."""
    import re

    for name, value in TINY_POOL.items():
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "VAN_CTRL_REQUESTS", 40)
    out = chip_smoke.phase_vanchaos("cpu", 0, device="cpu")
    text = capsys.readouterr().out
    f32, fence, bf16 = out["f32"], out["fence"], out["bf16"]
    assert [r["incarnation"] for r in f32["rounds"]] == [2, 3]
    for rnd, r in enumerate(f32["rounds"], 1):
        assert r["exact"] == 16 and r["tables_equal"] == 2
        assert r["resilver_rows"] > 0 and r["resilver_bytes"] > 0
        assert re.search(rf"\[vanchaos\] f32 round {rnd}: 16 requests over 2 "
                         r"member processes parked mid-decode, van \d+ "
                         rf"SIGKILLed; backup promoted to incarnation "
                         rf"{rnd + 1} .* 16 of 16 streams token-exact; "
                         r"resilver [\d.]+ s, \d+ rows, \d+ bytes; 2 tables "
                         r"bitwise equal on both vans", text), rnd
        assert re.search(rf"\[vanchaos\] f32 round {rnd}: fault\.van_kill -> "
                         r"van\.promote: detection [\d.]+ ms, recovery "
                         r"[\d.]+ ms", text), rnd
    assert len(f32["kill_ms"]) == 2
    assert len(f32["resilver_van_ready_s"]) >= 2
    assert fence["promoted_host_ms"] > 0 and len(fence["stop_ms"]) == 2
    assert "the stale handle raised VanFenced" in text
    assert bf16["accepted"] >= 3 and bf16["resolved"] >= bf16["accepted"]
    assert bf16["detect_to_promoted_s"] > 0
    assert out["launches"] == 0 and out["prefills"] > 0
    assert f32["prefills"] >= 32  # two rounds of 16, and nothing else
    assert re.search(r"\[vanchaos\] bf16 standby: controller SIGKILLed "
                     r"after \d+ accepts; the standby PROMOTED [\d.]+ s", text)
    assert re.search(r"\[vanchaos\] phase [\d.]+ s \(budget 90 s\); \d+ "
                     r"prefills in the members, flash forwards launched 0 "
                     r"\[cpu\]", text)


def test_kernels_line_counts_the_vanchaos_path():
    """main() runs the vanchaos phase right after crosshost; row 1 (the
    flash forward) gains "vanchaos" in its launches by path, from the
    phase's own count, and its summary line stays in the output's tail;
    the phase keeps the published widths and two members."""
    src = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    main = src[src.index("def main("):]
    order = [main.index(f"phase_{p}(card") for p in (
        "crosshost", "vanchaos", "train_llama")]
    assert order == sorted(order)
    row1 = main[main.index('"name": "flash_attention_fwd"'):
                main.index('"name": f"flash_attention_bwd_{k}"')]
    assert row1.count('"vanchaos": vanchaos["launches"]') == 1
    assert main.index("[vanchaos] summary:") < main.index("print(card)")
    assert chip_smoke.VAN_MEMBERS == 2
    assert chip_smoke.VAN_SPEC["promote_after_s"] == 0.3


def test_traffic_rate_sizing_and_trace_spec():
    """The traffic phase sizes its trace from the measured r1: a base rate
    of 0.3 r1, so the 10x peak asks three members' worth; the spec is the
    reference bench's two tenants over one 40 s diurnal period at
    GPT-2-small's vocabulary, and its events carry a catalog prompt of 2
    to 63 tokens, 16 tokens to generate, a tenant's SLO class and a
    deadline in its tenant's range."""
    from hetu_tpu_torch.traffic import synthesize
    from hetu_tpu_torch.traffic.loadgen import prompt_catalog

    assert chip_smoke.traffic_base_qps(20.0) == pytest.approx(6.0)
    assert chip_smoke.TRAFFIC_PEAK_X * chip_smoke.TRAFFIC_BASE_SHARE == \
        pytest.approx(chip_smoke.TRAFFIC_MAXM)
    spec = chip_smoke.traffic_spec(3, chip_smoke.traffic_base_qps(20.0))
    assert (spec.seed, spec.duration_s, spec.base_qps, spec.diurnal_peak_x,
            spec.diurnal_period_s, spec.vocab, spec.n_prompts,
            spec.max_prompt_len, spec.zipf_s) == (
        3, 40.0, pytest.approx(6.0), 10.0, None, 50257, 64, 64, 1.1)
    gold, bronze = spec.tenants
    assert (gold.name, gold.slo, gold.share, gold.deadline_lo_s,
            gold.deadline_hi_s, gold.burst_x, gold.max_tokens) == (
        "gold", "gold", 0.3, 8.0, 12.0, 1.0, 16)
    assert (bronze.name, bronze.slo, bronze.share, bronze.deadline_lo_s,
            bronze.deadline_hi_s, bronze.burst_x, bronze.burst_on_s,
            bronze.burst_off_s, bronze.max_tokens) == (
        "bronze", "bronze", 0.7, 1.0, 2.5, 3.0, 1.5, 2.0, 16)
    assert set(chip_smoke.TRAFFIC_SLO_CLASSES) == {"gold", "bronze"}
    assert chip_smoke.TRAFFIC_SLO_CLASSES["gold"]["ttft_slo_s"] == 2.5
    catalog = {tuple(p) for p in prompt_catalog(spec)}
    events = synthesize(spec)["events"]
    # a raised-cosine day: mean multiplier 5.5; bronze bursts on top
    assert 6.0 * 5.5 * 40.0 < len(events) < 6.0 * 5.5 * 40.0 * 2.5
    for ev in events:
        assert tuple(ev["prompt"]) in catalog
        assert 2 <= len(ev["prompt"]) <= 63
        assert all(1 <= t < 50257 for t in ev["prompt"])
        assert ev["max_tokens"] == 16 and ev["kind"] == "llm"
        assert ev["slo"] == ev["tenant"]
        lo, hi = (8.0, 12.0) if ev["tenant"] == "gold" else (1.0, 2.5)
        assert lo <= ev["deadline_s"] <= hi
    # prompt + generated tokens fit a member's slot
    assert 63 + 16 <= chip_smoke.POOL_MAX_LEN
    mid = sum(15.0 <= ev["t"] < 25.0 for ev in events)
    edge = sum(ev["t"] < 5.0 or ev["t"] >= 35.0 for ev in events)
    assert mid > 3 * edge


def test_traffic_fleet_sizes_and_quantiles():
    """Seconds at each fleet size run from the autoscaler's start to its
    stop, an up counting from its member's READY and a down from its
    drain's end; the quantile is the reference bench's."""
    acts = [{"action": "up", "t1": 12.0}, {"action": "up", "t1": 30.0},
            {"action": "down", "t1": 45.0}, {"action": "down", "t1": 48.5}]
    peak, spent = chip_smoke._traffic_fleet_sizes(acts, 2.0, 50.0)
    assert peak == 3
    assert spent == {1: 10.0 + 1.5, 2: 18.0 + 3.5, 3: 15.0}
    assert chip_smoke._quantile([], 0.99) is None
    assert chip_smoke._quantile([3.0, 1.0, 2.0], 0.5) == 2.0
    assert chip_smoke._quantile(list(range(100)), 0.99) == 99


def test_traffic_lines_keep_their_schema():
    """The phase's printed lines, from a set of numbers of the shape the
    phase returns."""
    import re

    out = {"r1": 25.5, "r1_wall_s": 1.255, "base_qps": 7.65, "events": 2600,
           "trace_bytes": 512000, "trace_sha256": "ab" * 32, "issued": 2600,
           "submit_errors": 0, "ok": 2100, "wall_s": 52.0, "ok_qps": 40.38,
           "issue_lag_s": {"p50": 0.012, "p99": 2.5, "max": 9.75},
           "submit_ms": {"p50": 1.25, "p99": 30.0, "max": 1500.5},
           "ledger": {"delta_appends": 4000, "compactions": 12,
                      "compaction_bytes": 1200000, "blob_put_calls": 9000,
                      "blob_put_errors": 2},
           "routed": {0: 1500, 1: 700, 2: 400},
           "tenants": {
               "gold": {"ok": 780, "shed": 0, "timeout": 0, "other": 0,
                        "n": 780, "shed_rate": 0.0, "ttft_p50_s": 0.05,
                        "ttft_p99_s": 1.2},
               "bronze": {"ok": 1320, "shed": 400, "timeout": 100,
                          "other": 0, "n": 1820, "shed_rate": 0.2198,
                          "ttft_p50_s": 0.5, "ttft_p99_s": None}},
           "gold_p99_met": True,
           "actions": [{"action": "up", "slot": 1, "reason": "shed_rate",
                        "decision_to_ready_s": 14.2, "spawn_ready_s": 13.9,
                        "ready_to_route_ms": 3.5},
                       {"action": "down", "slot": 2, "reason": "idle",
                        "target": 0, "decision_to_drained_s": 0.8,
                        "moved": 3, "slots": 2, "queued": 1, "rc": 0}],
           "peak_members": 3, "time_at_size": {1: 10.0, 2: 12.5, 3: 20.0},
           "scrape": {"n": 150, "p50_ms": 4.5, "max_ms": 40.2},
           "ups": 2, "downs": 2, "exact_moved": 3, "exact_sampled": 64,
           "launches": 24000, "prefills": 2000, "members_spawned": 5,
           "seconds": 95.5, "peak_gib": {0: 0.8, 1: 0.8, 2: 0.8}}
    text = "\n".join(chip_smoke.traffic_lines(out, "H100, 700.00 W"))
    card = r"\[H100, 700\.00 W\]"
    for pattern in (
            r"\[traffic\] r1 25\.500 ok requests/s \(32 closed-loop "
            r"requests, 8 in flight, 1\.255 s, token-exact\) on 1 member; "
            r"base_qps 7\.650, peak 10x ",
            r"\[traffic\] trace: 2600 events over 40 s, 512000 bytes, "
            r"sha256 abababababababab, synthesized again byte-identical ",
            r"\[traffic\] replay: 2600 issued open-loop \(0 refused\), "
            r"2100 ok in 52\.000 s, ok-QPS 40\.380 ",
            r"\[traffic\] submit path: issue behind the trace p50 0\.012 s, "
            r"p99 2\.500 s, max 9\.750 s; a submit call p50 1\.250 ms, "
            r"p99 30\.000 ms, max 1500\.500 ms; ledger 4000 delta appends, "
            r"12 compactions \(1200000 bytes\); control blob puts 9000 \(2 "
            r"attempts failed\) ",
            r"\[traffic\] tenant gold: ok 780, shed 0, timeout 0 of 780, "
            r"shed rate 0\.0000; TTFT p50 0\.0500 s, p99 1\.2000 s; p99 met "
            r"its 2\.5 s budget ",
            r"\[traffic\] tenant bronze: ok 1320, shed 400, timeout 100 of "
            r"1820, shed rate 0\.2198; TTFT p50 0\.5000 s, p99 - s ",
            r"\[traffic\] scale 1: up slot 1 \(shed_rate\): decision -> "
            r"READY 14\.200 s \(spawn -> READY line 13\.900 s\), READY -> "
            r"first routed request 3\.500 ms ",
            r"\[traffic\] scale 2: down slot 2 \(idle\) into member 0: "
            r"decision -> drained 0\.800 s, 3 requests moved \(2 live "
            r"slots, 1 queued\), exit 0 ",
            r"\[traffic\] fleet: peak 3 members; seconds at each size "
            r"\{1: 10\.0, 2: 12\.5, 3: 20\.0\}; requests routed by member "
            r"\{0: 1500, 1: 700, 2: 400\} ",
            r"\[traffic\] scrape: 150 ticks, p50 4\.500 ms, max 40\.200 ms "
            r"a tick's fleet_metrics ",
            r"\[traffic\] gates: 2 up, 2 down, each a traffic\.scale span "
            r"with its reason; every accepted request ok, shed or timeout; "
            r"3 moved \+ 64 sampled ok streams token-exact, moved slots "
            r"prefilled nothing; flash forwards 24000 = 12 x 2000 prefills; "
            r"5 member processes, none with jax ",
            r"\[traffic\] phase 95\.5 s \(budget 120 s\); peak GiB by "
            r"member \{0: 0\.8, 1: 0\.8, 2: 0\.8\} "):
        assert re.search(pattern + card, text), pattern
    assert "missed" not in text
    out["actions"][0]["ready_to_route_ms"] = None
    assert "READY -> first routed request none before it was drained" in \
        "\n".join(chip_smoke.traffic_lines(out, "cpu"))
    out["gold_p99_met"] = False
    assert "p99 missed its 2.5 s budget" in "\n".join(
        chip_smoke.traffic_lines(out, "cpu"))


def test_kernels_line_counts_the_traffic_path():
    """main() runs the traffic phase right after vanchaos; row 1 (the
    flash forward) gains "traffic" in its launches by path, from the
    phase's own count, and its summary line (with the script's seconds)
    stays in the output's tail."""
    src = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    main = src[src.index("def main("):]
    order = [main.index(f"phase_{p}(card") for p in (
        "vanchaos", "traffic", "train_llama")]
    assert order == sorted(order)
    row1 = main[main.index('"name": "flash_attention_fwd"'):
                main.index('"name": f"flash_attention_bwd_{k}"')]
    assert row1.count('"traffic": traffic["launches"]') == 1
    assert main.index("[traffic] summary:") < main.index("print(card)")
    assert chip_smoke.TRAFFIC_POLICY == {
        "min_members": 1, "max_members": 3, "interval_s": 0.3,
        "queue_high": 2.0, "queue_low": 0.5, "shed_high": 0.02,
        "shed_low": 0.005, "up_ticks": 2, "down_ticks": 4,
        "up_cooldown_s": 1.0, "down_cooldown_s": 2.0}


class _Probe:
    def __init__(self, prefilled):
        self.prefilled = prefilled


def test_drain_gate_refuses_a_reprefill_on_a_survivor():
    """The zero re-prefill gate: a survivor that prefilled a migrated
    request's prompt (plus its tokens, as a fold does) fails the phase;
    one that prefilled only other prompts passes."""
    from types import SimpleNamespace

    class _Metrics:
        def count(self, name):
            return 2

    def pool_of(probes):
        m0 = SimpleNamespace(
            scheduler=SimpleNamespace(metrics=SimpleNamespace(
                registry=chip_smoke_registry())),
            engine=SimpleNamespace(inner=probes[0]))
        return SimpleNamespace(metrics=_Metrics(), members={"m0": m0})

    running = [SimpleNamespace(prompt=[5, 6, 7]),
               SimpleNamespace(prompt=[8, 9])]
    held = {"name": "m0", "running": running}
    ok = [_Probe([[5, 6, 7], [8, 9]]), _Probe([[1, 2]]), _Probe([])]
    out = chip_smoke._drain_gates("t", pool_of(ok), ok,
                                  {"held": held, "slot_map": {0: 1, 1: 2}})
    assert out["reprefill_tokens"] == 0 and out["slots"] == 2
    bad = [_Probe([[5, 6, 7], [8, 9]]), _Probe([[8, 9, 4, 4]]), _Probe([])]
    with pytest.raises(chip_smoke.SmokeFailure, match="prefilled 4 tokens"):
        chip_smoke._drain_gates("t", pool_of(bad), bad,
                                {"held": held, "slot_map": {0: 1, 1: 2}})
    with pytest.raises(chip_smoke.SmokeFailure, match="1 slots moved"):
        chip_smoke._drain_gates("t", pool_of(ok), ok,
                                {"held": held, "slot_map": {0: 1}})


def test_park_busy_parks_where_a_request_outlives_the_round():
    """The chaos run's preemption lands on a parked member with a running
    request: a round whose only request ends in it is let go, and the
    next round, with a request that outlives it, stays parked."""
    import threading
    from types import SimpleNamespace

    probe = chip_smoke._PoolProbe(SimpleNamespace(
        cache=None, metrics=None, decode=lambda: None))
    last = SimpleNamespace(tokens=[1, 2, 3], max_tokens=4)
    rounds = [{0: last},
              {0: last, 1: SimpleNamespace(tokens=[1], max_tokens=4)}]
    sched = SimpleNamespace(_running={})

    def loop():
        # each round starts once the park is asked for, as a member under
        # continuous traffic decodes round after round
        for running in rounds:
            assert probe.park.wait(10)
            sched._running = running
            probe.decode()

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    try:
        assert chip_smoke._park_busy(probe, sched) == 1
        assert probe.decodes == 1 and sched._running is rounds[1]
    finally:
        probe.unpark.set()
        t.join(10)
    assert not t.is_alive() and probe.decodes == 2


def chip_smoke_registry():
    from hetu_tpu_torch.telemetry import MetricsRegistry
    return MetricsRegistry()


def test_kernels_line_counts_the_pool_path():
    """main() runs the pool phase right after the server phase and row 1
    (the flash forward) gains "pool" in its launches by path, read from
    the phase's own count; the final line is unchanged."""
    src = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    main = src[src.index("def main("):]
    order = [main.index(f"phase_{p}(card") for p in (
        "server", "pool", "train_llama")]
    assert order == sorted(order)
    assert main.count('"pool": pool["launches"]') == 1
    row1 = main[main.index('"name": "flash_attention_fwd"'):
                main.index('"name": f"flash_attention_bwd_{k}"')]
    assert '"pool": pool["launches"]' in row1
    assert '"server": server["launches"]' in row1
    assert 'print(json.dumps({"ok": True, "device": {' in main
    assert chip_smoke.POOL_V == 50257 and chip_smoke.POOL_P == 1024
    assert (chip_smoke.POOL_MEMBERS, chip_smoke.POOL_SLOTS,
            chip_smoke.POOL_MAX_LEN) == (3, 8, 512)


# ---- the supervise phase ----

TINY_SUPERVISE = dict(H=64, L=2, SUP_L=2, NH=4, FFN=128, SUP_V=97, SUP_S=64,
                      SUP_B=2,
                      CTR_PS_V=20000, CTR_B=128, CTR_HIDDEN=(16, 16))


def test_supervise_phase_runs_on_the_cpu(monkeypatch, capsys):
    """Both arms at tiny widths, their processes on the CPU: the two
    uninterrupted runs bitwise equal, the child preempted at step 6 by a
    real SIGTERM, the corrupt checkpoint skipped, step 4 restored and the
    resumed run bitwise the uninterrupted one; the shard killed, repaired
    bitwise from its snapshot and every fault paired; no child with jax
    or hetu_tpu (the phase's own gate); no launch off the card; the
    printed lines and the summary keep their schema."""
    import re

    for name, value in TINY_SUPERVISE.items():
        monkeypatch.setattr(chip_smoke, name, value)
    out = chip_smoke.phase_supervise("cpu", 0, device="cpu")
    text = capsys.readouterr().out
    gpt, ps = out["gpt"], out["ps"]
    assert gpt["reproducible"] and gpt["bitwise"] and gpt["max_gap"] == 0.0
    assert [s for s, _, _ in gpt["saves"]] == [4, 6, 8, 12]
    assert gpt["restore"][0] == 4 and gpt["restore"][3] == 1
    assert gpt["sigterm_exit_s"] > 0 and gpt["resume_first_step_s"] > 0
    assert gpt["step_ms"] > 0 and gpt["bare_ms"] > 0
    assert set(gpt["launches_by_arm"]) == {"uninterrupted_1",
                                           "uninterrupted_2", "preempted",
                                           "resumed"}
    c = ps["counters"]
    assert c["shards_killed"] == 1 and c["van_errors_injected"] == 2
    assert c["nan_injected"] == 1 and c["nonfinite_steps_skipped"] == 1
    assert c["retries"] >= 2 and c["shard_repairs"] >= 1
    assert ps["recovered"] >= 1 and len(ps["snapshot_ms"]) == 7
    assert ps["death_to_repaired_s"] > 0 and ps["repair_ms"] > 0
    assert out["launches"] == [0] * 6 and out["ps_launches"] == [0] * 6
    assert out["seconds"] > 0
    for pattern in (
            r"\[supervise\] gpt: the two uninterrupted arms bitwise equal "
            r"\(\d+ of \d+ leaves bitwise, max \|d\| 0\.000e\+00\); step "
            r"median supervised [\d.]+ ms, bare [\d.]+ ms, overhead "
            r"-?[\d.]+ %",
            r"\[supervise\] gpt resumed: skipped the corrupt checkpoint of "
            r"step 6 \(CRC\), restored step 4 \(resumed_from_step 4\), ran "
            r"steps 4-11, DONE 12",
            r"\[supervise\] gpt resume vs uninterrupted: (\d+) of \1 leaves",
            r"\[supervise\] gpt preempted: save of step 6: \d+ bytes in "
            r"[\d.]+ ms",
            r"SIGTERM -> the child's exit [\d.]+ s; the resumed child's "
            r"start -> its first step [\d.]+ s",
            r"\[supervise\] ps counters: shards_killed 1, "
            r"van_errors_injected 2, nan_injected 1, "
            r"nonfinite_steps_skipped 1",
            r"\[supervise\] ps: fault\.kill_shard -> recovery\.shard_repair:"
            r" detection [\d.]+ ms, recovery [\d.]+ ms \[cpu\]",
            r"\[supervise\] ps: fault\.nan_grad -> recovery\.nonfinite_skip",
            r"\[supervise\] ps: 7 snapshots of [\d.]+ MB pulled .* the "
            r"repair of shard 1 \(10000 rows and slots bitwise the snapshot "
            r"of before its death; the live shard unchanged\)",
            r"\[supervise\] phase [\d.]+ s \(budget 100 s\); launches of the"
            r" six kernels: gpt \[0, 0, 0, 0, 0, 0\], ps \[0, 0, 0, 0, 0, "
            r"0\] \[cpu\]"):
        assert re.search(pattern, text), pattern


def test_supervise_resume_rule_holds_a_leaf_to_the_twins_gap():
    """The resume gate's per-leaf gaps: bitwise leaves read 0; a leaf one
    ulp away reads its difference and is not bitwise."""
    a = [np.arange(4, dtype=np.float32), np.array([1, 2], np.uint32)]
    b = [a[0].copy(), a[1].copy()]
    assert chip_smoke._sup_gaps(a, b) == [(0.0, True), (0.0, True)]
    b[0][2] = np.nextafter(np.float32(2), np.float32(3))
    (gap, same), _ = chip_smoke._sup_gaps(a, b)
    assert not same and gap == pytest.approx(2.0 ** -22)


def test_kernels_line_counts_the_supervise_paths():
    """main() runs the supervise phase right after ps_ctr; every row's
    launches by path gains "supervise" (the GPT arm, its children
    included) and "supervise_ps" (the PS arm) through ``later``, and the
    phase's summary line stays in the output's tail after traffic's; the
    phase keeps GPT-2-small's published widths and its schedule."""
    src = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    main = src[src.index("def main("):]
    order = [main.index(f"phase_{p}(card") for p in (
        "ps_ctr", "supervise", "train_cnn")]
    assert order == sorted(order)
    assert main.count('"supervise": supervise["launches"][i]') == 1
    assert main.count('"supervise_ps": supervise["ps_launches"][i]') == 1
    assert main.index("[traffic] summary:") < \
        main.index("[supervise] summary:") < main.index("print(card)")
    assert (chip_smoke.SUP_V, chip_smoke.SUP_S, chip_smoke.SUP_B,
            chip_smoke.SUP_STEPS) == (50257, 1024, 8, 12)
    assert (chip_smoke.SUP_CKPT_EVERY, chip_smoke.SUP_KEEP,
            chip_smoke.SUP_HOLD_AT) == (4, 2, 5)
    # 3 of GPT-2-small's 12 layers, its widths unchanged
    assert chip_smoke.SUP_L == 3 and chip_smoke.L == 12
    spec = chip_smoke._sup_spec(0, "cpu")
    assert (spec["L"], spec["H"], spec["NH"], spec["FFN"]) == (3, 768, 12,
                                                              3072)
    assert chip_smoke.SUP_PS_SCHEDULE == dict(
        steps=40, seed=11, van_errors=2, nan_steps=1, kill_shards=1,
        n_shards=2)
    assert "jax" not in chip_smoke._SUP_CHILD_SRC


# ---- the elastic phase ----

TINY_ELASTIC = dict(ELASTIC_FEATURES=8, ELASTIC_OUT=4, ELASTIC_SAMPLES=256,
                    ELASTIC_GB=24, ELASTIC_STEPS=24)


def test_elastic_phase_runs_on_the_cpu(monkeypatch, capsys):
    """The three arms at the reference tests' 8 x 4 size and 24 steps,
    every gate live: the twins bitwise and within the bound of the numpy
    replay, a falling loss; the worker kill's shrink, 5 survivor steps, the
    grow, widths {2, 3}, the kill paired with ``elastic.reshard``; the
    controller kill under a standby process (PROMOTED, ALLDONE, incarnation
    2, a ``takeover`` resize, the weights bitwise the twins' where nothing
    was re-pushed, paired with ``ctrl.takeover``); no process of the phase
    with jax or torch; no launch; the lines keep their schema."""
    import re

    for name, value in TINY_ELASTIC.items():
        monkeypatch.setattr(chip_smoke, name, value)
    out = chip_smoke.phase_elastic("cpu", 0)
    text = capsys.readouterr().out
    a, b, c = out["a"], out["b"], out["c"]
    assert a["max_gap"] <= chip_smoke.ELASTIC_REPLAY_TOL * a["scale"]
    assert a["loss_last"] < a["loss_first"]
    assert len(a["step_ms"]) == 2 and all(x > 0 for x in a["step_ms"])
    assert all(x > 0 for x in a["mib"])
    assert b["kill_step"] == 2 and b["detect_s"] < 10.0
    assert b["shrink_s"] >= b["detect_s"] and b["ready_s"] > 0
    assert b["grow_resume"] >= b["shrink_resume"]
    assert c["kill_step"] == 4 and c["incarnation"] >= 2
    assert c["handoff_s"] >= c["detect_s"] > 0
    if c["repushed"] == 0:
        assert c["gap"] == 0.0
    assert b["ready"] == 4 and c["ready"] == 3  # (b)'s replacement too
    assert out["launches"] == [0] * 6 and out["seconds"] > 0
    for pattern in (
            r"\[elastic\] \(a\) clean twins: verify_consumed passed in both;"
            r" final weights \[8, 4\] f32 bitwise equal; max \|d\| to the "
            r"numpy replay [\d.e+-]+ \(bound 1e-05 x max\|w\| [\d.]+\); loss "
            r"of steps 0-3 [\d.]+ -> steps 20-23 [\d.]+; step ms median "
            r"\[[\d., ]+\]; van MiB a step \[[\d., ]+\] \(the apply's "
            r"[\d.]+\); .* 6 workers READY jax=0 torch=0 \[cpu\]",
            r"\[elastic\] \(b\) worker kill: worker \d SIGKILLed at step 2; "
            r"kill -> lease expiry [\d.]+ s, kill -> shrink published "
            r"\(width 2, resume \d+\) [\d.]+ s; replacement spawn -> READY "
            r"[\d.]+ s, READY -> grow published \(width 3, resume \d+\) "
            r"[\d.]+ s; widths \{2, 3\}, verify_consumed passed; "
            r"ps\.dp_repush_duplicates \d+; step ms median [\d.]+",
            r"\[elastic\] \(c\) controller kill: controller process READY "
            r"after [\d.]+ s .* SIGKILLed at step 4; kill -> ctrl\.takeover "
            r"start [\d.]+ s, kill -> hand-off complete [\d.]+ s "
            r"\(incarnation \d+, resume \d+\); the standby PROMOTED [\d.]+ s "
            r".* ALLDONE [\d.]+ s later; verify_consumed passed; "
            r"ps\.dp_repush_duplicates \d+, final weights .*controller and "
            r"standby map neither torch nor jax, 3 workers READY jax=0 "
            r"torch=0 \[cpu\]",
            r"\[elastic\] \(a\) run 2: median ms of a step's parts, rank 0 "
            r"\(its push is the ordered apply\) \{'bar_sync': [\d.]+, "
            r"'pull': [\d.]+, 'grad': [\d.]+, 'push': [\d.]+\}, ranks 1-2 ",
            r"\[elastic\] phase [\d.]+ s \(budget 60 s: (met|missed)\); "
            r"\d+ BLAS threads a process; launches of the six kernels "
            r"\[0, 0, 0, 0, 0, 0\] \[cpu\]"):
        assert re.search(pattern, text), (pattern, text)


def test_elastic_replay_is_the_step_body_in_numpy():
    """The replay the twins are held to: one step of it at the tiny size
    is the worker's step body (each rank's gradient from the step's
    weights, applied rank by rank), computed here by hand."""
    from hetu_tpu_torch.resilience.multicontroller import (
        WorkerSpec, make_schedule,
    )

    tiny = dict(ELASTIC_FEATURES=8, ELASTIC_OUT=4, ELASTIC_SAMPLES=256,
                ELASTIC_GB=24, ELASTIC_STEPS=1)
    old = {k: getattr(chip_smoke, k) for k in tiny}
    try:
        for k, v in tiny.items():
            setattr(chip_smoke, k, v)
        got = chip_smoke._elastic_replay(3)
    finally:
        for k, v in old.items():
            setattr(chip_smoke, k, v)
    sched = make_schedule(WorkerSpec(port=0, slot=-1, n_slots=3, steps=1,
                                     global_batch=24, features=8, out_dim=4,
                                     n_samples=256, data_seed=3))
    x, y = sched.global_batch(0)
    want = np.zeros((8, 4), np.float32)
    for r in range(3):  # w starts at 0: each slice's gradient is -2/B X^T Y
        xs, ys = x[8 * r:8 * (r + 1)], y[8 * r:8 * (r + 1)]
        want = want - np.float32(0.05) * ((2.0 / 24) * (xs.T @ (-ys)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert chip_smoke._elastic_step_mib(3) == 48.0 * (
        chip_smoke.ELASTIC_FEATURES * chip_smoke.ELASTIC_OUT) / (1024 * 1024)


def test_kernels_line_counts_the_elastic_path():
    """main() runs the elastic phase right after supervise; every row's
    launches by path gains "elastic" through ``later``, its summary line
    stays before the card line; the phase keeps its widths, steps and
    budget."""
    src = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    main = src[src.index("def main("):]
    order = [main.index(f"phase_{p}(card") for p in (
        "supervise", "elastic", "train_cnn")]
    assert order == sorted(order)
    assert main.count('"elastic": elastic["launches"][i]') == 1
    assert main.index("[supervise] summary:") < \
        main.index("[elastic] summary:") < main.index("print(card)")
    assert (chip_smoke.ELASTIC_WORKERS, chip_smoke.ELASTIC_FEATURES,
            chip_smoke.ELASTIC_OUT, chip_smoke.ELASTIC_SAMPLES,
            chip_smoke.ELASTIC_GB, chip_smoke.ELASTIC_LR,
            chip_smoke.ELASTIC_STEPS) == (3, 1024, 1024, 6144, 768, 0.05, 48)
    assert chip_smoke.ELASTIC_BUDGET_S == 60.0
    assert chip_smoke._elastic_step_mib(3) == 48.0


def test_supervise_weights_draw_the_specs_depth(monkeypatch):
    """The supervise arm's GPT draws as many layers as its spec names
    (``jax_layout_weights(..., layers=)``), in the parent and in a child
    alike; the other callers keep drawing ``L``."""
    for name, value in dict(H=8, FFN=16).items():
        monkeypatch.setattr(chip_smoke, name, value)
    w = chip_smoke.jax_layout_weights(0, 16, 11, layers=3)
    assert w["blocks"]["attn"]["qkv_weight"].shape == (3, 8, 24)
    assert w["blocks"]["ffn_out"]["bias"].shape == (3, 8)
    assert chip_smoke.jax_layout_weights(0, 16, 11)["blocks"]["ln1"][
        "scale"].shape == (chip_smoke.L, 8)
    a = chip_smoke.jax_layout_weights(0, 16, 11, layers=3)
    assert all(np.array_equal(x, y) for x, y in zip(
        a["blocks"]["ffn_in"].values(), w["blocks"]["ffn_in"].values()))


# ---- the recsys phase ----

TINY_RECSYS = dict(RECSYS_V=20000, RECSYS_CACHE=4096, RECSYS_REQUESTS=256,
                   CTR_HIDDEN=(16, 16), RECSYS_WIRE_REQUESTS=8,
                   RECSYS_SENTINEL_S=0.5)


def test_recsys_phase_runs_on_the_cpu(monkeypatch, capsys):
    """Every arm at a 20000-row table, a 16-wide tower and a 3 s trace,
    every gate live: (a) all ok, the buckets bitwise through both
    engines, the float64 gate, a hit rate above 0; (b) the sentinel
    within pull_bound, the kill's failover, the revive (the dead cache
    closed once), the wire within 1e-6; (c) the seeded shard kill
    degraded, recovered and paired; (d) the trace's statuses; no launch;
    the lines and the summary keep their schema."""
    import re

    for name, value in TINY_RECSYS.items():
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "RECSYS_TRACE", dict(
        chip_smoke.RECSYS_TRACE, duration_s=3.0, base_qps=20.0,
        n_prompts=256, key_space=20000))
    out = chip_smoke.phase_recsys("cpu", 0, device="cpu")
    text = capsys.readouterr().out
    ab = out["ab"]
    for name in ("cached", "cache-less"):
        assert ab[name]["max_err"] <= chip_smoke.RECSYS_TOL_F64
        assert ab[name]["batches"] == 256 // 8 and ab[name]["shapes"] == 6
        assert ab[name]["qps"] > 0 and ab[name]["ttfr_p99_ms"] > 0
    assert ab["cached"]["hit_rate"] > 0 and ab["cache-less"]["hit_rate"] == 0
    assert ab["cache-less"]["bytes_saved"] == 0
    assert out["pool"]["lag_max"] <= 1 and out["pool"]["wire_gap"] <= 1e-6
    assert out["kill"]["degraded_lookups"] > 0
    assert out["kill"]["window_ms"] > 0
    assert set(out["trace"]["counts"]) <= {"ok", "shed", "timeout"}
    assert out["launches"] == [0] * 6 and out["seconds"] > 0
    for pattern in (
            r"\[recsys\] WideDeep\(26, 16, 13, \(16, 16\)\) f32 on cpu; "
            r"PartitionedPSTable\(20000, 16, f32, adagrad\) over 2 van "
            r"shard processes made in [\d.]+ ms",
            r"\[recsys\] \(a\) cached: 256 requests in waves of 8, 32 "
            r"batches, every response ok; QPS [\d.]+, TTFR p50 [\d.]+ ms, "
            r"p99 [\d.]+ ms; hit rate [\d.]+, PS bytes pulled \d+, saved "
            r"\d+; median span ms gather [\d.]+, dispatch [\d.]+, "
            r"device_wait [\d.]+; max \|p - p_float64\| [\d.e+-]+ \(limit "
            r"1e-05\); 6 of 6 bucket shapes \[cpu\]",
            r"\[recsys\] \(a\) one fixed batch of each bucket \[8, 16, 32, "
            r"64, 128, 256\] bitwise equal through both engines",
            r"\[recsys\] \(b\) sentinel: \d+ requests by 4 clients while a "
            r"trainer thread made \d+ sets of row 19999 over the van, every "
            r"response ok; \d+ sentinel rows served, lag max -?\d versions",
            r"\[recsys\] \(b\) kill_member: 16 requests every one ok, "
            r"pool_failovers 1 after [\d.]+ ms .* the dead engine's cache "
            r"closed once, the revived member scored \d+ of 4",
            r"\[recsys\] \(b\) wire: 8 requests through pool.frontend\(\) "
            r"and a RecsysClient, every one ok",
            r"\[recsys\] \(c\) shard kill: FaultSchedule.generate\(steps=8, "
            r"seed=1234, kill_shards=1, n_shards=2\) SIGKILLed shard \d at "
            r"step \d+; \d+ requests, every one ok, \d+ degraded lookups; "
            r"kill -> first degraded answer [\d.]+ ms, degraded window "
            r"[\d.]+ ms, restart -> recovered -?[\d.]+ ms .* fault.kill_shard "
            r"paired with serve.recsys_degrade, no cache left degraded",
            r"\[recsys\] \(d\) open-loop trace: \d+ CTR events over 3 s "
            r"\(base 20/s, diurnal peak x10\) through ctr_submitter: .*ok "
            r"\d+.*; TTFR p50 [\d.]+ ms, p99 [\d.]+ ms; the replay behind "
            r"the trace p99 -?[\d.]+ ms",
            r"\[recsys\] phase [\d.]+ s \(budget 45 s: (met|missed)\); "
            r"launches of the six kernels \[0, 0, 0, 0, 0, 0\] \[cpu\]"):
        assert re.search(pattern, text), (pattern, text)
    assert re.fullmatch(
        r"\[recsys\] summary: phase [\d.]+ s \(budget 45 s\); \(a\) QPS "
        r"cached [\d.]+, cache-less [\d.]+, TTFR p99 cached [\d.]+ ms, "
        r"cache-less [\d.]+ ms, hit rate [\d.]+; \(b\) sentinel lag max "
        r"-?\d+, failover [\d.]+ ms, wire max \|d\| [\d.e+-]+; \(c\) kill "
        r"-> degraded [\d.]+ ms, window [\d.]+ ms, restart -> recovered "
        r"-?[\d.]+ ms; \(d\) \d+ events, ok \d+(, shed \d+)?(, timeout "
        r"\d+)?, TTFR p99 [\d.]+ ms; launches \[0, 0, 0, 0, 0, 0\] \[cpu\]",
        chip_smoke.recsys_summary(out, "cpu"))


def test_kernels_line_counts_the_recsys_path():
    """main() runs the recsys phase right after ps_ctr; every row's
    launches by path gains "recsys" through ``later``; its summary line
    sits in the output's tail between traffic's and supervise's; the
    phase keeps train_ctr's widths, ps_ctr's table and cache, the
    engines' buckets and the arms' sizes."""
    src = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    main = src[src.index("def main("):]
    order = [main.index(f"phase_{p}(card") for p in (
        "ps_ctr", "recsys", "supervise", "train_cnn")]
    assert order == sorted(order)
    assert main.count('"recsys": recsys["launches"][i]') == 1
    assert main.index("[traffic] summary:") < \
        main.index("print(recsys_summary(") < \
        main.index("[supervise] summary:") < main.index("print(card)")
    c = chip_smoke
    assert (c.CTR_F, c.CTR_DIM, c.CTR_DENSE, c.CTR_HIDDEN) == (
        26, 16, 13, (256, 256))
    assert (c.RECSYS_V, c.RECSYS_CACHE, c.RECSYS_PULL_BOUND) == (
        1_000_000, 131072, 1)
    assert (c.RECSYS_MAX_BATCH, c.RECSYS_MIN_BUCKET) == (256, 8)
    assert (c.RECSYS_REQUESTS, c.RECSYS_WAVE, c.RECSYS_ROUNDS) == (
        4096, 8, 2)
    assert (c.RECSYS_TOL_F64, c.RECSYS_TOL_WIRE) == (1e-5, 1e-6)
    assert c.RECSYS_WIRE_REQUESTS == 64
    assert c.RECSYS_KILL_SCHEDULE == dict(steps=8, seed=1234, kill_shards=1,
                                          n_shards=2)
    assert c.RECSYS_TRACE == dict(duration_s=10.0, base_qps=50.0,
                                  diurnal_peak_x=10.0, n_prompts=65536,
                                  fields=26, dense_dim=13,
                                  key_space=1_000_000)
    assert c.RECSYS_BUDGET_S == 45.0


def test_recsys_weights_are_drawn_in_the_references_layout():
    """The tower's weights come from a numpy draw in the JAX package's
    tree (a Linear's weight [in, out]) through ``interop``: the same seed
    gives the same tensors, another seed others."""
    from hetu_tpu_torch import interop

    a, b = (chip_smoke.recsys_model(s, "cpu") for s in (0, 0))
    c = chip_smoke.recsys_model(1, "cpu")
    tree = chip_smoke.recsys_jax_layout_weights(0, a)
    assert tree["deep"]["0"]["weight"].shape == (26 * 16 + 13, 256)
    assert tree["wide"]["weight"].shape == (13, 1)
    back = interop.params_to_jax(a.state_dict(), a)
    assert np.array_equal(back["deep"]["0"]["weight"],
                          tree["deep"]["0"]["weight"])
    for (n, p), (_, q), (_, r) in zip(a.named_parameters(),
                                      b.named_parameters(),
                                      c.named_parameters()):
        assert torch.equal(p, q) and not torch.equal(p, r), n


TINY_MESH = dict(V=64, H=32, NH=4, FFN=64, PAGE_SIZE=4, MESH_L=2, MESH_B=4,
                 MESH_S=16, MESH_STEPS=3, MESH_F32_L=2, MESH_F32_B=2,
                 MESH_F32_S=16, MESH_F32_STEPS=2, MESH_SERVE_L=2,
                 MESH_REQS=3, MESH_PROMPT=5, MESH_GEN=6, MESH_SERVE_LEN=16)


def test_mesh_phase_runs_on_the_cpu(monkeypatch, capsys):
    """The mesh phase at a tiny width in two gloo rank processes on the
    CPU, every gate live but the launch counts (no kernel off the card)
    and (e), which needs the card: (a) tp = 2 within its gates, the ffn
    weight still tp-split; (b) dp = 2 exact and int8; (c) both engines'
    tokens equal; (d) every collective exact, nothing staged; the lines
    keep their schema."""
    import re
    import sys

    for name, value in TINY_MESH.items():
        monkeypatch.setattr(chip_smoke, name, value)
    # the ranks unpickle their body as chip_smoke.mesh_rank (the widths
    # reach them in its spec)
    monkeypatch.setitem(sys.modules, "chip_smoke", chip_smoke)
    out = chip_smoke.phase_mesh("cpu", 0, device="cpu")
    text = capsys.readouterr().out
    assert out["launches"] == [0] * 6 and out["staged"] == {}
    assert out["nccl"] == {} and out["seconds"] > 0
    for r in (0, 1):
        for arm in (f"(a) rank {r} tp=2 bf16", f"(a) rank {r} tp=2 f32",
                    f"(b) rank {r} dp=2 exact, unequal valid counts",
                    f"(b) rank {r} dp=2 int8 vs the exact arm"):
            line = next(x for x in text.splitlines() if arm + ":" in x)
            assert re.search(r"worst relative gap \S+ \(gate \S+\) \[cpu\]",
                             line), line
        assert f"(a) rank {r}: ffn_in.weight (Shard(dim=0),)" in text
        for name in ("slot", "paged"):
            assert f"(c) rank {r} tp=2 {name} engine: 3 x 6 tokens equal" \
                in text
        assert re.search(rf"\(d\) rank {r} collectives on cpu, max \|d\| / "
                         rf"max\|ref\|: psum 0\.0e\+00.*grouped_allreduce "
                         rf"0\.0e\+00; staged through the host: none", text)
    assert re.search(r"\[mesh\] two ranks over gloo on cpu: \S+ s, the "
                     r"ranks up after \S+ s", text)
    assert "[mesh] phase " in text


def test_mesh_phase_gates_and_wiring():
    """The gates are the ones fixed before the first card run; main runs
    the phase before the kernel shapes, gives its launches to all six
    rows and prints its summary before the card line."""
    import inspect

    assert chip_smoke.TOL_MESH_BF16 == 2 ** -7
    assert chip_smoke.TOL_MESH_F32 == 2e-4
    assert chip_smoke.MESH_INT8_REL == 0.10
    assert chip_smoke.TOL_MESH_COLL == 1e-6
    assert chip_smoke.MESH_BUDGET_S == 90.0
    # GPT-2-small at full width; depth cut to 4 of 12 layers
    assert (chip_smoke.V, chip_smoke.H, chip_smoke.NH, chip_smoke.FFN,
            chip_smoke.MESH_L) == (50304, 768, 12, 3072, 4)
    main = inspect.getsource(chip_smoke.main)
    assert main.index("phase_mesh(card") < main.index(
        "phase_kernel_shapes(card")
    assert main.count('"mesh": mesh["launches"][i]') == 1
    assert main.index("[elastic] summary:") < main.index(
        "[mesh] summary:") < main.index("print(card)")
    with pytest.raises(chip_smoke.SmokeFailure, match="loss gap"):
        chip_smoke._mesh_gate("x", [1.0], [1.1], 1e-3, "cpu")
    exp = chip_smoke.mesh_expected(1)
    assert set(exp) == {
        "psum", "pmean", "all_gather", "reduce_scatter", "all_to_all",
        "hierarchical_all_to_all", "quantized_psum_int8",
        "quantized_psum_bf16", "quantized_pmean_int8", "ppermute_shift",
        "grouped_allreduce"}


TINY_SHARDED = dict(
    SHARDED_V=64, SHARDED_H=32, SHARDED_NH=4, SHARDED_FFN=64, SHARDED_E=4,
    SHARDED_K=2, SHARDED_CF=2.0, SHARDED_L=2, SHARDED_M=2, SHARDED_B=4,
    SHARDED_S=16, SHARDED_STEPS=2, SHARDED_F32_L=2, SHARDED_F32_S=8,
    SHARDED_F32_STEPS=2, SHARDED_RING=(1, 2, 16, 8), SHARDED_PIPE_D=8,
    SHARDED_PIPE_L=2, SHARDED_PIPE_B=8, SHARDED_PIPE_M=2, SHARDED_RUNS=2)


def test_sharded_phase_runs_on_the_cpu(monkeypatch, capsys):
    """The sharded phase's rank work at a tiny width in two gloo rank
    processes on the CPU (the mesh phase's world, without its arms), every
    gate live but the launch counts (no kernel off the card) and the
    timings: each arm within its gate of the single process, nothing
    dropped; the rings, Ulysses and GPipe within theirs; the lines keep
    their schema."""
    import re
    import sys

    from hetu_tpu_torch.parallel import ranks

    for name, value in {**TINY_MESH, **TINY_SHARDED}.items():
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setitem(sys.modules, "chip_smoke", chip_smoke)
    res = ranks.run(chip_smoke.mesh_rank, 2, backend="gloo", timeout_s=600,
                    args=({"seed": 0, "device": "cpu", "mesh": False,
                           "sharded": True,
                           "consts": chip_smoke.rank_consts()},))
    out = chip_smoke.phase_sharded("cpu", [r["sharded"] for r in res],
                                   device="cpu")
    text = capsys.readouterr().out
    assert out["launches"] == [0] * 6 and out["seconds"] > 0
    for name in ("single", "pp2", "sp2", "tp2", "ep2", "dp2"):
        line = next(x for x in text.splitlines()
                    if f"(a) arms {name} rank 0:" in x)
        assert re.search(r"worst relative gap to the single process \S+ "
                         r"\(gate 7\.812e-03\); dropped share 0; step ms "
                         r"after the first", line), line
        assert f"(e) arms {name}: launches over the ranks [0, 0, 0, 0, 0, " \
            "0]" in text
    for name in ("single", "sp2", "ep2"):
        assert f"(a) f32 {name} rank 0:" in text
    for tag in ("(b) ring", "(c) ulysses"):
        for kind in ("non-causal", "causal"):
            assert f"{tag} {kind} rank 1 [1, 2, 16, 8] bf16 sp=2: " \
                "tolerance shares O, dQ, dK, dV" in text
    assert re.search(r"\(d\) GPipe pp=2 rank 1 vs the sequential stack", text)
    assert re.search(r"\[sharded\] phase \S+ s \(budget 75 s: (met|missed)\)",
                     text)
    # the ranks staged nothing on the cpu; the single arm is rank 0's
    assert out["staged"] == {n: {} for n in ("pp2", "sp2", "tp2", "ep2",
                                             "dp2")}
    assert "single" not in res[1]["sharded"]["arms"]


def test_sharded_phase_gates_and_wiring():
    """The gates fixed before the first card run, the model at MoEConfig's
    widths, the launch counts derived from the code, and main's wiring:
    the phase after the mesh phase in its world, its launches on all six
    rows, its summary before the card line."""
    import inspect

    assert chip_smoke.TOL_SHARDED_BF16 == 2 ** -7
    assert chip_smoke.TOL_SHARDED_F32 == 2e-4
    assert chip_smoke.TOL_SHARDED_PIPE == (1e-5, 1e-4)
    assert chip_smoke.SHARDED_BUDGET_S == 75.0
    assert (chip_smoke.SHARDED_V, chip_smoke.SHARDED_H, chip_smoke.SHARDED_NH,
            chip_smoke.SHARDED_FFN, chip_smoke.SHARDED_E, chip_smoke.SHARDED_K,
            chip_smoke.SHARDED_CF) == (32000, 512, 8, 2048, 8, 2, 4.0)
    assert (chip_smoke.SHARDED_L, chip_smoke.SHARDED_M, chip_smoke.SHARDED_B,
            chip_smoke.SHARDED_S, chip_smoke.SHARDED_STEPS) == (4, 2, 8, 1024,
                                                                 3)
    exp = chip_smoke.sharded_expected
    assert exp(None, 4, 3) == [24, 24, 24, 24, 48, 48]
    assert exp({"pp": 2}, 4, 3) == [36, 36, 36, 36, 72, 72]
    assert exp({"sp": 2}, 4, 3) == [72, 72, 72, 48, 96, 96]
    for axes in ({"tp": 2}, {"ep": 2}, {"dp": 2}):
        assert exp(axes, 4, 3) == [48, 48, 48, 48, 96, 96]
    assert exp({"sp": 2}, 2, 2) == [24, 24, 24, 16, 32, 32]
    main = inspect.getsource(chip_smoke.main)
    assert main.index("phase_mesh(card, args.seed, sharded=True") < \
        main.index("phase_sharded(card") < main.index(
            "phase_kernel_shapes(card")
    assert main.count('"sharded": sharded["launches"][i]') == 1
    assert main.index("[mesh] summary:") < main.index(
        "[sharded] summary:") < main.index("print(card)")
    with pytest.raises(chip_smoke.SmokeFailure, match="loss gap"):
        chip_smoke.phase_sharded("cpu", [{
            "arms": {"single": _arm([1.0]), **{n: _arm([1.1]) for n in (
                "pp2", "sp2", "tp2", "ep2", "dp2")}},
            "f32": {}, "seq": {}, "pipe": {}, "t_start": 0, "t_end": 1}],
            device="cpu")


def _arm(losses):
    return dict(losses=losses, times=[0.1], launches=[0] * 6,
                dropped=[0.0], staged={})


TINY_DPPIPE = dict(
    DPPIPE_GCN=(301, 8, 900), DPPIPE_GCN_RUNS=2, DPPIPE_PIPE_D=8,
    DPPIPE_PIPE_L=2, DPPIPE_PIPE_B=16, DPPIPE_GPT_B=8, DPPIPE_GPT_S=16,
    DPPIPE_HET_D=8, DPPIPE_HET_L=4, DPPIPE_HET_B=8, DPPIPE_HET_M=4)


def test_dppipe_phase_runs_on_the_cpu(monkeypatch, capsys):
    """The dppipe phase's rank work at a tiny width in two gloo rank
    processes on the CPU (the mesh phase's world, without its arms),
    every gate live but the launch counts (no kernel off the card) and
    the timings: (a) the resizes, the losses against the fault-free run,
    both ranks' states equal after the grow, the f32 parameters and rng;
    (b) the masks against the Executor and one process, the empty group
    frozen; (c) both routes within their gates; (d) the tanh stack and
    the GPT blocks; (e) HetPipe against its replay, two workers, the
    staleness trip; the lines keep their schema."""
    import re
    import sys

    from hetu_tpu_torch.parallel import ranks

    for name, value in {**TINY_MESH, **TINY_DPPIPE}.items():
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setitem(sys.modules, "chip_smoke", chip_smoke)
    res = ranks.run(chip_smoke.mesh_rank, 2, backend="gloo", timeout_s=600,
                    threads=1,
                    args=({"seed": 0, "device": "cpu", "mesh": False,
                           "dppipe": True,
                           "consts": chip_smoke.rank_consts()},))
    out = chip_smoke.phase_dppipe("cpu", [r["dppipe"] for r in res],
                                  device="cpu")
    text = capsys.readouterr().out
    assert out["launches"] == [0] * 6 and out["seconds"] > 0
    assert len(out["downtime"]) == 2
    for key in ("a_bf16", "a_f32"):
        for r in (0, 1):
            assert re.search(
                rf"\(a\) {key} rank {r}: resizes \[\('shrink', 1\), "
                rf"\('grow', 2\)\] at steps \[2, 4\], downtime_s \[\S+, "
                rf"\S+\]; 6 steps, {6 - 2 * r} trained here", text)
        assert f"(a) {key}: after the grow both ranks' parameters, slots, " \
            "step and rng bitwise equal" in text
    assert "rng words bitwise equal" in text
    for r in (0, 1):
        assert f"(b) rank {r}: preduce group losses" in text
        assert "[0,0] left parameters and slots bitwise" in text
        for route in ("gather", "ring"):
            assert re.search(rf"\(c\) rank {r} {route}: tolerance shares y, "
                             rf"dh \[\S+, \S+\] against one process's "
                             rf"coo_spmm", text)
        assert f"(d) 1F1B GPT blocks rank {r} B=8 S=16 bf16: loss" in text
        assert re.search(rf"\(e\) rank {r} one worker pp=2 sync_every 2 .*"
                         rf"stalled peer: 1 wave then a staleness trip",
                         text)
    assert "(b) [1,0] and the next step: losses" in text
    assert "vs one process on rank 0's shard" in text
    assert "(c) graph: 301 nodes + 1 isolated padding node" in text
    assert re.search(r"\(e\) two workers pp=1 .* clocks \[12, 12\]", text)
    for k in "abcde":
        assert f"(f) ({k}) launches over both ranks, rows 1-6 [0, 0, 0, 0, " \
            "0, 0]" in text
    assert re.search(r"\[dppipe\] phase \S+ s \(budget 60 s: (met|missed)\)",
                     text)


def test_dppipe_phase_gates_and_wiring():
    """The gates fixed before the first card run, the model at GPT-2-small's
    width and the mesh phase's depth, the launch counts derived from the
    code, and main's wiring: the phase after the sharded phase in the
    mesh phase's world, its launches on all six rows, its summary before
    the card line."""
    import inspect

    assert chip_smoke.TOL_DPPIPE_BF16 == 2 ** -7
    assert chip_smoke.TOL_DPPIPE_F32 == (2e-4, 1e-5)
    assert chip_smoke.TOL_DPPIPE_GCN == (1e-4, 1e-5)
    assert chip_smoke.TOL_DPPIPE_PIPE == (1e-5, 1e-4)
    assert chip_smoke.TOL_DPPIPE_HET == 1e-4
    assert chip_smoke.DPPIPE_BUDGET_S == 60.0
    assert chip_smoke.DPPIPE_GCN == (169_343, 128, 1_166_243)
    assert (chip_smoke.DPPIPE_M, chip_smoke.DPPIPE_GPT_B,
            chip_smoke.DPPIPE_GPT_S) == (8, 8, 512)
    assert chip_smoke.DPPIPE_M > 2 * 2  # the 1F1B stash slots wrap
    assert (chip_smoke.DPPIPE_STEPS, chip_smoke.DPPIPE_LOSS_AT,
            chip_smoke.DPPIPE_JOIN_AT) == (6, 2, 4)
    exp = chip_smoke.dppipe_expected()
    assert exp == {"a": [220, 132, 132, 0, 0, 0],
                   "b": [128, 64, 64, 0, 0, 0], "c": [0] * 6,
                   "d": [96, 32, 32, 0, 0, 0], "e": [0] * 6}
    assert [sum(v[i] for v in exp.values()) for i in range(6)] == \
        [444, 228, 228, 0, 0, 0]
    main = inspect.getsource(chip_smoke.main)
    assert "phase_mesh(card, args.seed, sharded=True, dppipe=True)" in main
    assert main.index("phase_sharded(card") < main.index(
        "phase_dppipe(card") < main.index("phase_kernel_shapes(card")
    assert main.count('"dppipe": dppipe["launches"][i]') == 1
    assert main.index("[sharded] summary:") < main.index(
        "[dppipe] summary:") < main.index("print(card)")
    assert "TOL_DPPIPE_BF16" in chip_smoke.rank_consts()
    with pytest.raises(chip_smoke.SmokeFailure, match="dppipe x: loss gap"):
        chip_smoke._mesh_gate("x", [1.0], [1.1], 1e-3, "cpu", phase="dppipe")
    with pytest.raises(chip_smoke.SmokeFailure, match="1 losses, 2 expected"):
        chip_smoke._mesh_gate("x", [1.0], [1.0, 1.0], 1e-3, "cpu",
                              phase="dppipe")


TINY_MPMD = dict(V=64, H=32, NH=4, FFN=64, MPMD_L=2, MPMD_B=4, MPMD_S=16,
                 MPMD_EL=dict(steps=24, n_microbatches=4, width=8, batch=8,
                              step_sleep_s=0.08))


def test_mpmd_phase_runs_on_the_cpu(monkeypatch, capsys):
    """The mpmd phase at a tiny width on the CPU, every gate live but the
    launch counts (no kernel off the card) and the timings: (a) three
    stage processes (stage dps [2, 1]) against the stack in one process,
    step 2 equal to step 1, the edge bytes; (b) GPipe and the stage kill
    bitwise the clean run, the kill paired with the replacement, the
    stash GPipe [3, 3, 3] against 1F1B [3, 2, 1]; (c) the standby's
    PROMOTED, RESOLVED, ALLDONE over a pipeline adopted mid-run, the
    digests equal; no numpy process with jax or torch; the lines keep
    their schema."""
    import re

    for name, value in TINY_MPMD.items():
        monkeypatch.setattr(chip_smoke, name, value)
    out = chip_smoke.phase_mpmd("cpu", 0, device="cpu")
    text = capsys.readouterr().out
    a, b, c = out["a"], out["b"], out["c"]
    assert out["launches"] == [0] * 6 and out["seconds"] > 0
    assert a["loss_gap"] <= chip_smoke.TOL_MPMD_LOSS
    assert a["grad_share"] <= 1.0
    mb_bytes = 1 * 16 * 32 * 4  # a microbatch [1, S, H] in f32
    for key, n in (("0.0", 2), ("0.1", 2), ("1.0", 4)):
        for d in ("fwd", "bwd"):
            assert a["edges"][key][f"edge0.{d}"] == {
                "logical": 2 * n * mb_bytes, "wire": 2 * n * mb_bytes}
    assert b["stash"] == {"gpipe": [3, 3, 3], "1f1b": [3, 2, 1]}
    assert 0 < b["detect_s"] <= b["recover_s"]
    assert c["incarnation"] >= 2 and c["promoted_s"] > 0
    for pattern in (
            r"\[mpmd\] \(a\) stage 0 replica 1: step ms \[\S+, \S+\]; edges "
            r".* step 2 vs step 1 bitwise .* READY 0 1 jax=0 \[cpu\]",
            r"\[mpmd\] \(a\) stage_dps \[2, 1\] GPT-2-small H=32 NH=4 FFN=64 "
            r"bf16 flash no remat, 2 blocks \(1 a stage\) B=4 S=16 M=4: "
            r"loss/M \[\S+, \S+\] vs the stack in one process \S+ \(gap "
            r"\S+, gate 7\.812e-03\); gradients' largest share \S+ of 0\.03 "
            r"max\|G\| .* launches over the three processes \[0, 0, 0, 0, 0,"
            r" 0\] \(expected \[16, 16, 16, 0, 0, 0\]\)",
            r"\[mpmd\] \(b\) gpipe: final parameters bitwise equal to the "
            r"clean 1F1B run's",
            r"\[mpmd\] \(b\) kill: final parameters bitwise equal to the "
            r"clean 1F1B run's",
            r"\[mpmd\] \(b\) stage 1 SIGKILLed at step 5: detect \S+ s, "
            r"recover \S+ s .* GPipe \(stash_limit 3\) \[3, 3, 3\] vs 1F1B "
            r"\[3, 2, 1\]; .* every stage READY jax=0 torch=0 \[cpu\]",
            r"\[mpmd\] \(c\) controller SIGKILLed at progress step 5: "
            r"standby PROMOTED \S+ s .* digests equal \(b\)'s clean run; the"
            r" van and \d+ READY lines \(controller, standby, stages\) all "
            r"jax=0 torch=0 \[cpu\]",
            r"\[mpmd\] phase \S+ s \(budget 60 s: (met|missed)\); launches "
            r"rows 1-6 \[0, 0, 0, 0, 0, 0\] \[cpu\]"):
        assert re.search(pattern, text), (pattern, text)


def test_mpmd_phase_gates_and_wiring():
    """The gates fixed before the first card run, GPT-2-small's width at
    the mesh phase's depth, the launch count derived from the schedule,
    and main's wiring: the phase after dppipe, its launches on all six
    rows of the kernels line, its summary before the card line."""
    import inspect

    assert chip_smoke.TOL_MPMD_LOSS == 2 ** -7
    assert chip_smoke.MPMD_STEP_RTOL == 1e-6
    assert chip_smoke.MPMD_BUDGET_S == 60.0
    assert chip_smoke.MPMD_DPS == (2, 1)
    assert chip_smoke.MPMD_L == chip_smoke.MESH_L == 4
    assert (chip_smoke.MPMD_B, chip_smoke.MPMD_S, chip_smoke.MPMD_M,
            chip_smoke.MPMD_STEPS) == (4, 256, 4, 2)
    assert (chip_smoke.H, chip_smoke.NH, chip_smoke.FFN) == (768, 12, 3072)
    assert chip_smoke.MPMD_EL["width"] == 64 and \
        chip_smoke.MPMD_EL["batch"] == 64 and \
        chip_smoke.MPMD_EL["n_microbatches"] == 8
    assert chip_smoke.mpmd_expected() == [32, 32, 32, 0, 0, 0]
    main = inspect.getsource(chip_smoke.main)
    assert main.index("phase_dppipe(card") < main.index(
        "phase_mpmd(card") < main.index("phase_kernel_shapes(card")
    assert main.count('"mpmd": mpmd["launches"][i]') == 1
    assert main.index("[dppipe] summary:") < main.index(
        "[mpmd] summary:") < main.index("print(card)")
    consts = chip_smoke.mpmd_consts()
    assert {"V", "H", "NH", "FFN", "MPMD_L", "MPMD_DPS"} <= set(consts)
