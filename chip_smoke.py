#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``hetu_tpu_torch``) on one NVIDIA
GPU: the quickest proof that the port still builds, runs and agrees with
itself on the card.

Run from the root of the repository on a machine with an H100:

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure ends the run with a non-zero exit and
without the final result line:

1. device — the card's name and power limit; TF32 off.
2. build  — nvcc builds every CUDA kernel of the port (one process per
   source, all started together).
3. kernel — each kernel (flash forward, flash backward dK/dV and dQ)
   against its plain PyTorch version on the card, at the main paths'
   shapes and at edge cases (stated tolerances), then timed with CUDA
   events beside its plain version, one PyTorch library call as a
   yardstick (never used by the port) and its roofline bound.
4. slice  — GPT-2-small (published widths, seeded random weights in the
   JAX package's layout, loaded through ``interop.params_from_jax``)
   served by ``ServeEngine`` + ``ContinuousBatchingScheduler`` over 16
   seeded requests; every kernel of the path must have launched, and the
   kernel path's prefill logits must agree with the plain path's.
5. profile — where a prefill step and a decode step spend their time: the
   host clock, the card's busy share and its largest kernels
   (torch.profiler).
6. train  — GPT-2-small at ``bench.py`` ``bench_gpt``'s width and shape
   (B 16, S 1024, bf16, flash, recomputation, fused CE, AdamW): the kernel
   path's loss and every gradient against the plain path's on one batch,
   then 10 ``Executor.run("train")`` steps on one seeded batch (finite,
   falling loss; 2·L flash forwards and L of each backward kernel a step),
   step time, tokens/s, MFU, peak memory and one profiled step.

The last three lines of standard output are the card's name and power
limit (as nvidia-smi gives them), the kernel report
``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# GPT-2-small at the serving bench's widths (bench.py bench_serve)
V, H, L, NH, FFN, MAX_LEN, SLOTS, N_REQUESTS = (
    50304, 768, 12, 12, 3072, 512, 8, 16)
HEAD_DIM = H // NH

# kernel-vs-plain tolerances on the card.  bf16: the kernel rounds the
# probabilities to bf16 against its running (per-tile) row max, the plain
# version against the final max, so O may differ by about one bf16 ulp of
# values of size ~1 (2^-7 = 7.8e-3); 2e-2 leaves headroom.  f32: only the
# order of f32 sums differs.  The LSE is f32 in both types.
TOL_O = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# plus a relative term for bf16 outputs above 1, where one bf16 ulp
# (2^-8 relative) exceeds 4e-3
RTOL_O = {torch.bfloat16: 1e-2, torch.float32: 0.0}
TOL_LSE = 1e-4
# kernel path vs plain path, last-position prefill logits of the bf16
# model: twelve layers of bf16 rounding at different points (the plain
# composition normalises before rounding the probabilities)
TOL_LOGITS = 5e-2
# backward kernels vs the plain backward, dQ/dK/dV, as (ATOL, ATOL_ROW,
# RTOL): each element passes when |d| <= ATOL * max|ref| + ATOL_ROW *
# max|ref row| + RTOL * |ref|, where the row is the element's own output
# row (its query for dQ, its key for dK and dV).  ATOL is a floor for rows
# that are rounding noise (the first query's dQ is exactly zero in exact
# arithmetic, since dP_00 = delta_0 there).  A bound in absolute units
# alone cannot serve: along a causal sequence the gradients shrink (with
# randn inputs and scale 1/8, p_ij is about 1/i, so the rms of dK_j and
# dV_j is about sqrt(2.7 (1/j - 1/S)): 0.013 at j = 960 of 1024, while the
# first rows reach a few units), and a bound that spares the first rows
# waves through errors in the last tiles of the size of their values.
# Both versions round p and dS to the input type at the same points
# and sum in f32, so in f32 only the order of the sums may differ (2^-24
# per term; 1e-5 is a hundredfold margin).  In bf16 a sum summed in
# another order may land one ulp away when rounded to bf16 once at the end
# (one ulp is at most 2^-7 of the value), and a p or dS next to a rounding
# boundary may flip by one ulp, which moves an element near zero by about
# 2^-8 of its row's size.  The floors, 2^-16 (bf16) and 1e-6 (f32) of the
# largest element, stay far below the last tiles' values.
TOL_D = {torch.bfloat16: (2 ** -16, 2 ** -8, 2 ** -7),
         torch.float32: (1e-6, 1e-5, 1e-5)}
# training step, kernel path vs plain path (attention_impl="xla") on one
# batch of the bf16 model.  The paths round at other points: the flash
# forward rounds p against the running max, the plain path the normalised
# probabilities; the plain backward rounds dP (a bf16 product) where the
# kernels keep it in f32 and round dS.  Sound kernels read a loss gap of
# 5.2e-5 and gradients within 1.22e-2 of each parameter's largest element
# on an H100 (seed 0); the limits leave a margin of 20 and of 2.5 over
# those readings.  The script also prints the gap between the plain bf16
# path and an f32 model: the size of a difference in bf16 rounding alone.
TOL_TRAIN_LOSS = 1e-3
TOL_TRAIN_GRAD = 3e-2  # max |dG| <= TOL_TRAIN_GRAD * max |G_plain|

# the training phase's shape: bench.py bench_gpt
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 16, 1024, 10, 1e-4

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_BF16_FLOP_S = 989e12    # dense bf16 tensor cores, H100 SXM data sheet


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


# ---------------------------------------------------------------- timing

def device_ms(fn, runs: int = 60, warmup: int = 5) -> float:
    """Median device time of one ``fn()`` call, from CUDA events.  A spin
    kernel keeps the stream busy while each pair of events and the call are
    enqueued, so the events time the device work, not the host's launch
    overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    for start, end in ev:
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def flash_bound(b, h, s_q, s_k, d, causal, elem_bytes=2, kernel="fwd"):
    """Least time (ms) an H100 could take for one flash kernel on these
    shapes: each input read once, each output written once, against the
    operations the causal mask leaves, per visible (query, key) pair:

    * ``fwd``: two products of 2*D (q.k, p.v); reads q, k, v; writes O
      and the f32 LSE;
    * ``dkdv``: four (q.k, dO.v, p^T.dO, dS^T.q), 8*D; reads q, k, v, dO
      and the f32 LSE and delta; writes dK and dV;
    * ``dq``: three (q.k, dO.v, dS.k), 6*D; the same reads; writes dQ.
    """
    if causal:
        pairs = sum(min(max(i + s_k - s_q + 1, 0), s_k) for i in range(s_q))
    else:
        pairs = s_q * s_k
    bh = b * h
    if kernel == "fwd":
        flops = 4 * d * pairs * bh
        nbytes = (2 * s_q + 2 * s_k) * bh * d * elem_bytes + bh * s_q * 4
    else:
        reads = (2 * s_q + 2 * s_k) * bh * d * elem_bytes + 2 * bh * s_q * 4
        if kernel == "dkdv":
            flops, nbytes = 8 * d * pairs * bh, reads + 2 * s_k * bh * d \
                * elem_bytes
        else:
            flops, nbytes = 6 * d * pairs * bh, reads + s_q * bh * d \
                * elem_bytes
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOP_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- phases

def phase_device(card):
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(f"[device] nvidia-smi: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}")


def phase_build():
    from hetu_tpu_torch.ops.cuda_kernels import build
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    build.build(*names)
    print(f"[build] {', '.join(names)}: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    for n in names:
        for line in build.log_path(n).read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {n}: {line.strip()}")


def _qkv(shape_q, s_k, dtype, gen):
    b, h, s_q, d = shape_q
    mk = lambda s: torch.randn(b, h, s, d, generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)
    return mk(s_q), mk(s_k), mk(s_k)


def phase_kernel(card):
    from hetu_tpu_torch.ops.cuda_kernels.flash_attention import (
        flash_attention, flash_attention_plain,
    )
    gen = torch.Generator(device="cuda").manual_seed(1234)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for s in (16, 32, 64, 128, 256, 512):
            cases.append((dtype, (1, NH, s, HEAD_DIM), s, True, "main"))
        cases += [
            (dtype, (TRAIN_B, NH, TRAIN_S, HEAD_DIM), TRAIN_S, True,
             "train"),
            (dtype, (2, NH, 128, HEAD_DIM), 128, False, "full"),
            (dtype, (1, NH, 64, HEAD_DIM), 256, True, "cross S_q<S_k"),
            (dtype, (1, NH, 100, HEAD_DIM), 100, True, "ragged"),
            (dtype, (1, NH, 100, HEAD_DIM), 100, False, "ragged full"),
            (dtype, (1, NH, 128, HEAD_DIM), 64, True, "S_q>S_k"),
            (dtype, (1, 2, 48, 128), 48, True, "D=128"),
        ]
    max_err_train = None  # reported beside the timings at the same shape
    with torch.inference_mode():
        for dtype, shape, s_k, causal, tag in cases:
            q, k, v = _qkv(shape, s_k, dtype, gen)
            o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
            o_p, lse_p = flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            diff = (o.float() - o_p.float()).abs()
            err_o = diff.max().item()
            err_lse = (lse - lse_p).abs().max().item()
            ok = bool((diff <= TOL_O[dtype]
                       + RTOL_O[dtype] * o_p.float().abs()).all()) \
                and err_lse <= TOL_LSE and bool(torch.isfinite(o).all())
            masked = shape[2] - s_k if causal and shape[2] > s_k else 0
            if masked:  # rows that see no key are exactly 0
                ok = ok and not o[:, :, :masked].any() \
                    and not o_p[:, :, :masked].any()
            print(f"[kernel] flash_attention {str(dtype)[6:]:8s} "
                  f"{tag:14s} q{tuple(shape)} S_k={s_k} causal={causal}: "
                  f"max|dO|={err_o:.3e} (tol {TOL_O[dtype]:g} + "
                  f"{RTOL_O[dtype]:g}*|O|) "
                  f"max|dLSE|={err_lse:.3e} (tol {TOL_LSE:g})"
                  + (f" zero rows={masked}" if masked else "")
                  + f" {'ok' if ok else 'FAIL'}")
            check(ok, f"flash_attention disagrees with its plain version "
                      f"({tag}, {dtype}, q{tuple(shape)}, S_k={s_k})")
            if tag == "train" and dtype == torch.bfloat16:
                max_err_train = err_o

        timings = {}
        for b, s in ((1, 128), (1, 512), (TRAIN_B, TRAIN_S)):
            q, k, v = _qkv((b, NH, s, HEAD_DIM), s, torch.bfloat16, gen)
            runs = 60 if b == 1 else 20
            ms = device_ms(lambda: flash_attention(q, k, v, causal=True),
                           runs)
            plain_ms = device_ms(
                lambda: flash_attention_plain(q, k, v, causal=True), runs)
            lib_ms = device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True), runs)
            bound_ms, bound_by = flash_bound(b, NH, s, s, HEAD_DIM, True)
            timings[(b, s)] = dict(ms=ms, plain_ms=plain_ms,
                                   library_ms=lib_ms, bound_ms=bound_ms,
                                   bound_by=bound_by)
            print(f"[kernel] flash_attention bf16 causal q({b},{NH},{s},"
                  f"{HEAD_DIM}): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                  f"ms, library (SDPA, yardstick only) {lib_ms:.4f} ms, "
                  f"bound {bound_ms:.5f} ms ({bound_by}) [{card}]")
    return max_err_train, timings


def grad_tolerance_share(got, ref):
    """The largest share of its tolerance (``TOL_D``) that any element of
    ``got`` uses against ``ref`` (both ``[..., rows, D]``): at most 1
    passes.  Where ``ref`` is all zero, ``got`` must be too."""
    atol, atol_row, rtol = TOL_D[ref.dtype]
    r = ref.float().abs()
    diff = (got.float() - ref.float()).abs()
    tol = atol * r.max() + atol_row * r.amax(-1, keepdim=True) + rtol * r
    share = torch.where(tol > 0, diff / tol.clamp_min(torch.finfo(
        torch.float32).tiny), torch.where(diff > 0, float("inf"), 0.0))
    return share.max().item()


def _bwd_inputs(shape_q, s_k, dtype, causal, gen):
    """q, k, v, dO, and the LSE and delta the forward pass gives them."""
    from hetu_tpu_torch.ops.cuda_kernels.flash_attention import (
        flash_attention_plain,
    )
    q, k, v = _qkv(shape_q, s_k, dtype, gen)
    do = torch.randn(q.shape, generator=gen, device="cuda",
                     dtype=torch.float32).to(dtype)
    o, lse = flash_attention_plain(q, k, v, causal=causal)
    b, h, s_q, _ = q.shape
    delta = (do.float() * o.float()).sum(-1).reshape(b * h, s_q, 1)
    return q, k, v, do, lse, delta


def phase_kernel_bwd(card):
    """The two backward kernels against the plain backward, at the
    training step's shape and at edge cases, then timed at that shape."""
    from hetu_tpu_torch.ops.cuda_kernels.flash_attention import (
        flash_attention_bwd_dkdv, flash_attention_bwd_dq,
        flash_attention_bwd_plain,
    )
    gen = torch.Generator(device="cuda").manual_seed(4321)
    main = (TRAIN_B, NH, TRAIN_S, HEAD_DIM)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        cases += [
            (dtype, main, TRAIN_S, True, "main"),
            (dtype, (2, NH, 128, HEAD_DIM), 128, False, "full"),
            (dtype, (1, NH, 64, HEAD_DIM), 256, True, "cross S_q<S_k"),
            (dtype, (1, NH, 128, HEAD_DIM), 64, True, "S_q>S_k"),
            (dtype, (1, NH, 100, HEAD_DIM), 100, True, "ragged"),
            (dtype, (1, NH, 100, HEAD_DIM), 100, False, "ragged full"),
            (dtype, (1, 2, 48, 128), 48, True, "D=128"),
            (dtype, (1, 2, 40, 32), 72, True, "D=32 ragged"),
        ]
    max_err = {}
    with torch.no_grad():
        for dtype, shape, s_k, causal, tag in cases:
            args = _bwd_inputs(shape, s_k, dtype, causal, gen)
            dk, dv = flash_attention_bwd_dkdv(*args, causal=causal)
            dq = flash_attention_bwd_dq(*args, causal=causal)
            want = flash_attention_bwd_plain(*args, causal=causal)
            torch.cuda.synchronize()
            ok, errs, shares = True, {}, {}
            for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                      want):
                errs[name] = (got.float() - ref.float()).abs().max().item()
                shares[name] = grad_tolerance_share(got, ref)
                ok = ok and got.dtype == ref.dtype \
                    and bool(torch.isfinite(got).all()) \
                    and shares[name] <= 1.0
            masked = shape[2] - s_k if causal and shape[2] > s_k else 0
            if masked:  # rows that see no key give dQ = 0 exactly
                ok = ok and not dq[:, :, :masked].any() \
                    and not want[0][:, :, :masked].any()
            atol, atol_row, rtol = TOL_D[dtype]
            print(f"[kernel] flash_attention_bwd {str(dtype)[6:]:8s} "
                  f"{tag:14s} q{tuple(shape)} S_k={s_k} causal={causal}: "
                  + " ".join(f"max|{n}|={e:.3e}" for n, e in errs.items())
                  + f" (tol {atol:g}*max|ref| + {atol_row:g}*max|ref row| "
                  f"+ {rtol:g}*|ref|; share "
                  f"of tol used " + " ".join(
                      f"{n} {s:.3g}" for n, s in shares.items()) + ")"
                  + (f" zero dQ rows={masked}" if masked else "")
                  + f" {'ok' if ok else 'FAIL'}")
            check(ok, f"flash backward kernels disagree with the plain "
                      f"backward ({tag}, {dtype}, q{tuple(shape)}, "
                      f"S_k={s_k})")
            if tag == "main" and dtype == torch.bfloat16:
                max_err = {"dkdv": max(errs["dk"], errs["dv"]),
                           "dq": errs["dq"]}

        args = _bwd_inputs(main, TRAIN_S, torch.bfloat16, True, gen)
        timings = {
            "dkdv": device_ms(lambda: flash_attention_bwd_dkdv(
                *args, causal=True), 20),
            "dq": device_ms(lambda: flash_attention_bwd_dq(
                *args, causal=True), 20)}
        plain_ms = device_ms(lambda: flash_attention_bwd_plain(
            *args, causal=True), 20)
    # the yardstick: SDPA's backward alone, on the same q, k, v and dO
    q, k, v, do = (t.detach().requires_grad_(i < 3)
                   for i, t in enumerate(args[:4]))
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                           is_causal=True)
    lib_ms = device_ms(lambda: torch.autograd.grad(
        out, (q, k, v), do, retain_graph=True), 20)
    report = {}
    for name in ("dkdv", "dq"):
        bound_ms, bound_by = flash_bound(*main[:2], TRAIN_S, TRAIN_S,
                                         HEAD_DIM, True, kernel=name)
        report[name] = dict(ms=timings[name], plain_ms=plain_ms,
                            library_ms=lib_ms, bound_ms=bound_ms,
                            bound_by=bound_by, max_abs_err=max_err[name])
        print(f"[kernel] flash_attention_bwd_{name} bf16 causal q{main}: "
              f"kernel {timings[name]:.4f} ms, plain backward (dQ, dK, dV "
              f"together) {plain_ms:.4f} ms, library (SDPA backward, "
              f"yardstick only) {lib_ms:.4f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by}) [{card}]")
    return report


def jax_layout_weights(seed: int, max_position: int = MAX_LEN) -> dict:
    """GPT-2-small parameters in the JAX package's layout and with its
    initialisers: normal(0.02) embeddings, Xavier-uniform MHA and Linear
    weights (``[in, out]``, stacked ``[L, ...]``), zero biases, unit
    LayerNorm scales."""
    g = np.random.default_rng(seed)

    def normal(*shape):
        return 0.02 * g.standard_normal(shape, dtype=np.float32)

    def xavier(*shape):  # (L, in, out)
        lim = np.float32(np.sqrt(6.0 / (shape[-2] + shape[-1])))
        return (g.random(shape, dtype=np.float32) * 2 - 1) * lim

    z = lambda *shape: np.zeros(shape, np.float32)
    o = lambda *shape: np.ones(shape, np.float32)
    return {
        "tok_emb": normal(V, H), "pos_emb": normal(max_position, H),
        "blocks": {
            "attn": {"qkv_weight": xavier(L, H, 3 * H),
                     "qkv_bias": z(L, 3 * H),
                     "out_weight": xavier(L, H, H), "out_bias": z(L, H)},
            "ln1": {"scale": o(L, H), "bias": z(L, H)},
            "ffn_in": {"weight": xavier(L, H, FFN), "bias": z(L, FFN)},
            "ffn_out": {"weight": xavier(L, FFN, H), "bias": z(L, H)},
            "ln2": {"scale": o(L, H), "bias": z(L, H)},
        },
        "ln_f_scale": o(H), "ln_f_bias": z(H),
    }


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_slice(card, seed, device="cuda"):
    from hetu_tpu_torch import interop
    from hetu_tpu_torch.layers import MultiHeadAttention
    from hetu_tpu_torch.models import GPTConfig, GPTModel
    from hetu_tpu_torch.ops.cuda_kernels import (
        flash_attention, flash_attention_bwd_dkdv, flash_attention_bwd_dq,
    )
    from hetu_tpu_torch.serve import (
        ContinuousBatchingScheduler, Request, ServeEngine, ServeMetrics,
    )
    from hetu_tpu_torch.telemetry import trace

    cfg = GPTConfig(vocab_size=V, hidden_size=H, num_layers=L, num_heads=NH,
                    ffn_size=FFN, max_position=MAX_LEN, dtype=torch.bfloat16,
                    attention_impl="flash")
    t0 = time.perf_counter()
    model = GPTModel(cfg, device=device)
    model.load_state_dict(interop.params_from_jax(jax_layout_weights(seed),
                                                  cfg))
    engine = ServeEngine(model, num_slots=SLOTS, max_len=MAX_LEN,
                         device=device)
    del model
    _sync(device)
    print(f"[slice] GPT-2-small V={V} H={H} L={L} heads={NH} ffn={FFN} "
          f"bf16 flash, {SLOTS} slots x {MAX_LEN}: built in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card"
          if device == "cuda" else "")

    # warm every prompt bucket the run reaches and the decode step
    ContinuousBatchingScheduler(engine).run(
        [Request(prompt=[1] * n, max_tokens=2) for n in (10, 20, 40, 100)])

    g = np.random.default_rng(seed)
    requests = [Request(
        prompt=[int(t) for t in g.integers(0, V, int(g.integers(4, 129)))],
        max_tokens=int(g.integers(8, 65))) for _ in range(N_REQUESTS)]
    metrics = ServeMetrics()
    sched = ContinuousBatchingScheduler(engine, metrics=metrics)
    tracer = trace.enable()
    counters = (flash_attention, flash_attention_bwd_dkdv,
                flash_attention_bwd_dq)
    for c in counters:  # count the main path's launches only
        c.launches = 0
    _sync(device)
    t0 = time.perf_counter()
    sched.run(requests)
    _sync(device)
    wall = time.perf_counter() - t0
    launches, bwd_dkdv, bwd_dq = (c.launches for c in counters)
    trace.disable()

    prefills = [e for e in tracer.events if e["name"] == "serve.prefill"]
    decodes = [e for e in tracer.events if e["name"] == "serve.decode"]
    statuses = [r.status for r in requests]
    print(f"[slice] statuses: {statuses}")
    check(all(s == "ok" for s in statuses), "a request did not finish ok")
    check(all(len(r.tokens) == r.max_tokens for r in requests),
          "a request generated the wrong number of tokens")
    check(all(0 <= t < V for r in requests for t in r.tokens),
          "a generated token is outside the vocabulary")
    print(f"[slice] flash_attention.launches = {launches}, prefills = "
          f"{len(prefills)}, layers = {L}")
    check(len(prefills) == N_REQUESTS, "one prefill per request expected")
    check(launches == L * len(prefills) > 0,
          "flash_attention launches != layers x prefills")
    check(bwd_dkdv == bwd_dq == 0, "serving launched a backward kernel")

    n_tok = sum(len(r.tokens) for r in requests)
    snap = metrics.snapshot()
    step_ms = statistics.median(e["dur"] for e in decodes) / 1e3
    print(f"[slice] generated {n_tok} tokens in {wall:.3f} s: "
          f"{n_tok / wall:.1f} tokens/s [{card}]")
    print(f"[slice] TTFT p50 {snap['ttft_p50_s'] * 1e3:.2f} ms, p90 "
          f"{snap['ttft_p90_s'] * 1e3:.2f} ms [{card}]")
    print(f"[slice] decode step median {step_ms:.3f} ms over "
          f"{len(decodes)} steps ({SLOTS} slots) [{card}]")
    per_bucket = {}
    for e in prefills:
        per_bucket.setdefault(e["args"]["bucket"], []).append(e["dur"] / 1e3)
    for b in sorted(per_bucket):
        print(f"[slice] prefill bucket {b}: median "
              f"{statistics.median(per_bucket[b]):.3f} ms over "
              f"{len(per_bucket[b])} prompts [{card}]")

    # the kernel path against the plain path, same weights
    plain = copy.deepcopy(engine.model)
    for m in plain.modules():
        if isinstance(m, MultiHeadAttention):
            m.attention_impl = "xla"
    with torch.inference_mode():
        for n in (7, 33, 90, 128):
            ids = torch.tensor(g.integers(0, V, (1, n)), device=device)
            lk, _, _ = engine.model.prefill_with_cache(ids, last_index=n - 1)
            lp, _, _ = plain.prefill_with_cache(ids, last_index=n - 1)
            lk, lp = lk.float(), lp.float()
            check(lk.shape == (1, V) and bool(torch.isfinite(lk).all()),
                  "prefill logits are not finite [1, V]")
            err = (lk - lp).abs().max().item()
            top2 = lp[0].topk(2).values
            margin = (top2[0] - top2[1]).item()
            same = int(lk[0].argmax()) == int(lp[0].argmax())
            print(f"[slice] prompt {n}: kernel vs plain path logits "
                  f"max|d|={err:.3e} (tol {TOL_LOGITS:g}), top-2 margin "
                  f"{margin:.3e}, first token equal: {same}")
            check(err <= TOL_LOGITS, "kernel path logits disagree with the "
                                     "plain path")
            check(same or margin <= TOL_LOGITS,
                  "greedy first token differs beyond the tolerance")
    return launches, engine


def _device_intervals(prof):
    """(start, end, name) of every kernel, copy and set the profiler saw on
    the card, in microseconds."""
    from torch.autograd import DeviceType
    return [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def _busy_us(intervals):
    """Time the card was busy: the union of the intervals."""
    busy, end = 0.0, float("-inf")
    for s, e, _ in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _short(kernel: str) -> str:
    for noise in ("void ", "at::native::", "(anonymous namespace)::"):
        kernel = kernel.replace(noise, "")
    return kernel[:110]


def phase_profile(engine, card, steps=20):
    """Where the time of one serving step goes: the host clock around
    ``steps`` prefills (bucket 128) and ``steps`` decode steps (all slots
    active), then the same windows again under torch.profiler for the
    card's busy time and the kernels that take it.  The busy share divides
    the profiled busy time by the unprofiled wall time (the profiler slows
    the host, not the kernels); both unprofiled windows run before the
    profiler first starts."""
    from torch.profiler import ProfilerActivity, profile
    g = np.random.default_rng(1)
    prompt = [int(t) for t in g.integers(0, V, 100)]
    slots = [engine.alloc_slot() for _ in range(SLOTS)]
    for s in slots:
        engine.prefill(s, prompt)
    windows = {"prefill": lambda: engine.prefill(slots[0], prompt),
               "decode": engine.decode}

    def run(step):
        for _ in range(steps):
            step()
        torch.cuda.synchronize()

    wall_us = {}
    for name, step in windows.items():
        run(step)  # warm
        t0 = time.perf_counter()
        run(step)
        wall_us[name] = (time.perf_counter() - t0) * 1e6
    for name, step in windows.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(step)
        _profile_table(prof, name, card, wall_us[name], steps)
    for s in slots:
        engine.release(s)


def _profile_table(prof, tag, card, wall_us, steps=1):
    """Print the card's busy share of ``wall_us`` (host time of ``steps``
    unprofiled steps) and its 8 largest kernels; returns the busy share."""
    iv = _device_intervals(prof)
    if not iv:
        print(f"[profile] {tag}: device time not measured (the profiler "
              f"recorded no kernel) [{card}]")
        return None
    busy = _busy_us(iv)
    print(f"[profile] {tag}: {wall_us / steps / 1e3:.3f} ms a step on the "
          f"host clock, card busy {busy / steps / 1e3:.3f} ms "
          f"({100 * busy / wall_us:.1f} %), {len(iv) / steps:.0f} device "
          f"ops a step [{card}]")
    by_name, by_kind = {}, {}
    for s, e, n in iv:
        t, c = by_name.get(n, (0.0, 0))
        by_name[n] = (t + e - s, c + 1)
        by_kind[_kind(n)] = by_kind.get(_kind(n), 0.0) + e - s
    print(f"[profile] {tag}: split " + ", ".join(
        f"{k} {t / steps / 1e3:.3f} ms ({100 * t / busy:.1f} %)"
        for k, t in sorted(by_kind.items(), key=lambda x: -x[1])))
    for n, (t, c) in sorted(by_name.items(), key=lambda x: -x[1][0])[:8]:
        print(f"[profile] {tag}:   {100 * t / busy:5.1f} % of busy "
              f"{t / steps:8.1f} us a step x{c / steps:<5g} {_short(n)}")
    return busy / wall_us


def _kind(kernel: str) -> str:
    """The port's own kernels, cuBLAS's GEMMs, copies and fills, and the
    rest (PyTorch's elementwise and reduction kernels)."""
    if _short(kernel).startswith(("flash_fwd_kernel", "flash_bwd_")):
        return "flash kernels"
    if any(t in kernel for t in ("nvjet", "gemm", "xmma", "cutlass")):
        return "GEMMs"
    if any(t in kernel.lower() for t in ("copy", "memcpy", "memset")):
        return "copies and fills"
    return "other"


def _gpt_flops_per_token(model, seq):
    """bench.py's count: 6 x non-embedding params + 6 V H for the tied head
    + 12 L H S for attention."""
    c = model.c
    n_params = sum(p.numel() for p in model.parameters())
    n_nonemb = n_params - c.vocab_size * c.hidden_size \
        - c.max_position * c.hidden_size
    return (6 * n_nonemb + 6 * c.vocab_size * c.hidden_size
            + 12 * c.num_layers * c.hidden_size * seq), n_params


def phase_train(card, seed, device="cuda"):
    """GPT-2-small training steps at bench_gpt's width and shape."""
    from torch.profiler import ProfilerActivity, profile

    from hetu_tpu_torch import interop
    from hetu_tpu_torch.layers import MultiHeadAttention
    from hetu_tpu_torch.models import GPTConfig, GPTModel
    from hetu_tpu_torch.ops.cuda_kernels import (
        flash_attention, flash_attention_bwd_dkdv, flash_attention_bwd_dq,
    )
    from hetu_tpu_torch.optim import AdamWOptimizer
    from hetu_tpu_torch.train import Executor

    cfg = GPTConfig(vocab_size=V, hidden_size=H, num_layers=L, num_heads=NH,
                    ffn_size=FFN, max_position=TRAIN_S, dropout_rate=0.0,
                    dtype=torch.bfloat16, attention_impl="flash", remat=True,
                    fused_ce=True)
    t0 = time.perf_counter()
    model = GPTModel(cfg, device=device)
    model.load_state_dict(interop.params_from_jax(
        jax_layout_weights(seed, TRAIN_S), cfg))
    g = np.random.default_rng(seed + 1)
    batch = (torch.tensor(g.integers(0, V, (TRAIN_B, TRAIN_S)),
                          device=device),)
    _sync(device)
    print(f"[train] GPT-2-small V={V} H={H} L={L} heads={NH} ffn={FFN} "
          f"B={TRAIN_B} S={TRAIN_S} bf16 flash remat fused-CE AdamW"
          f"({TRAIN_LR:g}): built in {time.perf_counter() - t0:.1f} s")

    # the kernel path against the plain path, one batch, same weights
    plain = copy.deepcopy(model)
    for m in plain.modules():
        if isinstance(m, MultiHeadAttention):
            m.attention_impl = "xla"

    def loss_and_grads(m):
        params = dict(m.named_parameters())
        loss, _ = m.lm_loss_fn()(params, {}, batch, None, True)
        grads = torch.autograd.grad(loss, list(params.values()))
        return float(loss.detach()), dict(zip(params, grads))

    loss_k, grads_k = loss_and_grads(model)
    loss_p, grads_p = loss_and_grads(plain)
    del plain
    # the control: the same weights and batch through an f32 model (plain
    # attention, no recomputation), whose gap to the plain bf16 path is
    # what bf16 rounding alone moves the loss by
    ref = GPTModel(dataclasses.replace(cfg, dtype=torch.float32,
                                       attention_impl="xla", remat=False),
                   device=device)
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        loss_f32 = float(ref.lm_loss_fn()(dict(ref.named_parameters()), {},
                                          batch, None, False)[0])
    del ref
    check(np.isfinite(loss_k) and np.isfinite(loss_p), "a loss is not finite")
    print(f"[train] kernel path vs plain path: loss {loss_k:.6f} vs "
          f"{loss_p:.6f}, |d|={abs(loss_k - loss_p):.3e} "
          f"(tol {TOL_TRAIN_LOSS:g}); control, plain bf16 path vs f32 "
          f"model: loss {loss_f32:.6f}, |d|={abs(loss_p - loss_f32):.3e}")
    check(abs(loss_k - loss_p) <= TOL_TRAIN_LOSS,
          "kernel path loss disagrees with the plain path")
    ratios = {}
    for name, gp in grads_p.items():
        gk = grads_k[name]
        check(bool(torch.isfinite(gk).all()), f"gradient of {name} is not "
                                              f"finite")
        scale = gp.abs().max().item()
        err = (gk - gp).abs().max().item()
        ratios[name] = err / scale if scale > 0 else (0.0 if err == 0
                                                      else float("inf"))
    worst = sorted(ratios.items(), key=lambda x: -x[1])
    print(f"[train] gradients of {len(ratios)} parameters: max|dG| / "
          f"max|G_plain| <= {worst[0][1]:.3e} (tol {TOL_TRAIN_GRAD:g}); "
          f"worst: " + ", ".join(f"{n} {r:.3e}" for n, r in worst[:3]))
    check(worst[0][1] <= TOL_TRAIN_GRAD,
          f"kernel path gradient of {worst[0][0]} disagrees with the plain "
          f"path")
    del grads_k, grads_p

    ex = Executor(model.lm_loss_fn(), AdamWOptimizer(TRAIN_LR), seed=seed)
    state = ex.init_state(model)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    counters = (flash_attention, flash_attention_bwd_dkdv,
                flash_attention_bwd_dq)
    for c in counters:  # count the main path's launches only
        c.launches = 0
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        _sync(device)
        t0 = time.perf_counter()
        state, met = ex.run("train", state, batch)
        losses.append(float(met["loss"]))
        _sync(device)
        times.append(time.perf_counter() - t0)
    launches = [c.launches for c in counters]
    print(f"[train] losses: {' '.join(f'{x:.4f}' for x in losses)}")
    check(all(np.isfinite(losses)), "a training loss is not finite")
    check(losses[-1] < losses[0], "the loss did not fall")
    print(f"[train] launches in {TRAIN_STEPS} steps: flash_attention "
          f"{launches[0]}, bwd_dkdv {launches[1]}, bwd_dq {launches[2]} "
          f"(a step: {[n / TRAIN_STEPS for n in launches]}, expected "
          f"[{2 * L}, {L}, {L}])")
    check(launches == [2 * L * TRAIN_STEPS, L * TRAIN_STEPS,
                       L * TRAIN_STEPS],
          "the training step did not launch 2L forward and L of each "
          "backward kernel a step")

    step_s = statistics.median(times[1:])
    fpt, n_params = _gpt_flops_per_token(model, TRAIN_S)
    tokens = TRAIN_B * TRAIN_S
    mfu = fpt * tokens / step_s / H100_BF16_FLOP_S
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[train] step median {step_s * 1e3:.3f} ms (steps 2-"
          f"{TRAIN_STEPS}; first {times[0] * 1e3:.3f} ms), "
          f"{tokens / step_s:.1f} tokens/s, MFU {100 * mfu:.2f} % "
          f"({fpt * tokens / 1e12:.2f} TFLOP a step by bench.py's count, "
          f"{n_params / 1e6:.1f} M params, over 989 TFLOP/s), peak "
          f"{peak_gib:.2f} GiB allocated [{card}]")

    # one profiled step
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, met = ex.run("train", state, batch)
        float(met["loss"])
        torch.cuda.synchronize()
    busy = _profile_table(prof, "train step", card, step_s * 1e6)
    return dict(launches=launches, step_ms=step_s * 1e3,
                tokens_per_s=tokens / step_s, mfu=mfu, peak_gib=peak_gib,
                busy_share=busy, losses=losses)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and requests")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test runs on the "
              "card only", file=sys.stderr)
        return 2
    try:
        import hetu_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2

    card = card_line()
    phase_device(card)
    phase_build()
    max_err, timings = phase_kernel(card)
    bwd = phase_kernel_bwd(card)
    serve_launches, engine = phase_slice(card, args.seed)
    phase_profile(engine, card)
    del engine
    torch.cuda.empty_cache()
    train = phase_train(card, args.seed)

    shape = [TRAIN_B, NH, TRAIN_S, HEAD_DIM]
    src = "hetu_tpu/ops/pallas_kernels/flash_attention.py"
    t = timings[(TRAIN_B, TRAIN_S)]
    report = {"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "hetu_tpu_torch/csrc/flash_attention.cu",
         "replaces": f"{src}:52", "launches": train["launches"][0],
         "max_abs_err": max_err,
         **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")},
         "shape": shape, "dtype": "bfloat16",
         "launches_by_path": {"serve": serve_launches,
                              "train": train["launches"][0]},
         # the serving path's largest prompt bucket, and S = 512
         "serve_s128": timings[(1, 128)], "serve_s512": timings[(1, 512)]},
        *({"name": f"flash_attention_bwd_{k}", "route": "cuda",
           "source": "hetu_tpu_torch/csrc/flash_attention_bwd.cu",
           "replaces": f"{src}:{line}", "launches": train["launches"][i],
           "max_abs_err": bwd[k]["max_abs_err"],
           **{f: bwd[k][f] for f in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
           "shape": shape, "dtype": "bfloat16"}
          for i, k, line in ((1, "dkdv", 198), (2, "dq", 239)))]}
    print(card)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
