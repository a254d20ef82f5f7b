#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``hetu_tpu_torch``) on one NVIDIA
GPU: the quickest proof that the port still builds, runs and agrees with
itself on the card.

Run from the root of the repository on a machine with an H100:

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure ends the run with a non-zero exit and
without the final result line:

1. device — the card's name and power limit; TF32 off.
2. build  — nvcc builds every CUDA source of the port (one process per
   source, all started together).
3. kernel — each kernel (flash forward, flash backward dK/dV and dQ;
   then, in kernel_moe, the row gather, its scatter-add and the top-k
   gate) against its plain PyTorch version on the card, at the main
   paths' shapes and at edge cases (stated tolerances), then timed with
   CUDA events beside its plain version, one PyTorch library call as a
   yardstick (never used by the port) and its roofline bound.  The
   tensor-core flash kernels (bf16; f32 runs the scalar ones) also at
   edges of their tiles and ring, at head dims 20 to 128, on the attention
   layer's transposed views and on unaligned inputs, two launches bitwise
   equal, with each case's route and the kernels' TFLOP/s and share of
   the bound; and the whole backward (delta, operands, both kernels)
   beside SDPA's backward.
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
7. train_moe — the MoE transformer at ``MoEConfig``'s widths (V 32000,
   H 512, 4 layers, 8 heads, ffn 2048, 8 experts, top-2, capacity factor
   1.25), bf16, B 32 x S 512.  On one batch the kernel path (top-k
   kernel, gather dispatch and combine) against two paths that launch
   none of the three kernels: the plain path (the plain gate and the
   gather's plain version), held to the loss limit, the same routes in
   every layer and every gradient; and the einsum dispatch, held to the
   loss limit and the same routes in the first layer.  Then 10 Executor
   steps (finite, falling loss; L gates, 2·L gathers and 2·L scatter-adds
   a step), step time, tokens/s, MFU, peak memory and one profiled step.

The last three lines of standard output are the card's name and power
limit (as nvidia-smi gives them), the kernel report
``{"kernels": [...]}`` (all six kernels: the three flash kernels, the top-k
gate, the gather and the scatter-add) and ``{"ok": true, "device":
{...}}``.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import functools
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

# the MoE training slice: MoEConfig's widths (hetu_tpu/models/
# moe_transformer.py:24-35), bf16, at bench.py bench_moe's T (B 32 x S 512)
MOE_V, MOE_H, MOE_L, MOE_NH, MOE_FFN, MOE_E, MOE_K, MOE_CF = (
    32000, 512, 4, 8, 2048, 8, 2, 1.25)
MOE_B, MOE_S, MOE_STEPS, MOE_LR = 32, 512, 10, 1e-4
MOE_T = MOE_B * MOE_S
MOE_C = max(1, int(MOE_CF * MOE_T * MOE_K / MOE_E))  # 5120 slots an expert
MOE_BENCH_D = 768  # bench.py bench_moe's layer width
# MoE kernels against their plain versions.  The gather copies rows and the
# scatter-add sums at most two rows in f32 and rounds once (a + b is the
# same in either order), so both must be bitwise equal to their plain
# versions at the path's shapes; so must a scatter of small integers
# (exact sums in any order), however many duplicates.  Under heavy
# duplicates of random values the plain version's atomics sum in another
# order: each f32 sum of n terms lies within (n - 1) * 2^-24 * sum|g| of the
# exact one, so the two within twice that, and a bf16 result may land one
# ulp (at most 2^-7 of the value) away.  The gate's indices must be equal;
# its gates differ at most by the rounding of exp and the division (1e-6
# in f32 for values <= 1) or one bf16 ulp of a value below 1 (2^-8).
TOL_GATES = {torch.float32: 1e-6, torch.bfloat16: 2 ** -8}

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


def flash_flops(b, h, s_q, s_k, d, causal, kernel="fwd"):
    """Operations of one flash kernel on these shapes, per (query, key) pair
    the causal mask leaves visible: ``fwd`` two products of 2*D (q.k, p.v);
    ``dkdv`` four (q.k, dO.v, p^T.dO, dS^T.q), 8*D; ``dq`` three (q.k,
    dO.v, dS.k), 6*D."""
    if causal:
        pairs = sum(min(max(i + s_k - s_q + 1, 0), s_k) for i in range(s_q))
    else:
        pairs = s_q * s_k
    return {"fwd": 4, "dkdv": 8, "dq": 6}[kernel] * d * pairs * b * h


def flash_bound(b, h, s_q, s_k, d, causal, elem_bytes=2, kernel="fwd"):
    """Least time (ms) an H100 could take for one flash kernel on these
    shapes: each input read once, each output written once, against the
    operations of :func:`flash_flops`:

    * ``fwd``: reads q, k, v; writes O and the f32 LSE;
    * ``dkdv``: reads q, k, v, dO and the f32 LSE and delta; writes dK and
      dV;
    * ``dq``: the same reads; writes dQ.
    """
    bh = b * h
    flops = flash_flops(b, h, s_q, s_k, d, causal, kernel)
    if kernel == "fwd":
        nbytes = (2 * s_q + 2 * s_k) * bh * d * elem_bytes + bh * s_q * 4
    else:
        reads = (2 * s_q + 2 * s_k) * bh * d * elem_bytes + 2 * bh * s_q * 4
        outs = (2 * s_k if kernel == "dkdv" else s_q) * bh * d * elem_bytes
        nbytes = reads + outs
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
            if any(w in line.lower() for w in ("registers", "spill",
                                               "warning")):
                print(f"[build] {n}: {line.strip()}")


def _qkv(shape_q, s_k, dtype, gen):
    b, h, s_q, d = shape_q
    mk = lambda s: torch.randn(b, h, s, d, generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)
    return mk(s_q), mk(s_k), mk(s_k)


def phase_kernel(card):
    """The forward kernel against its plain version on each route (bf16 on
    tensor cores, f32 on the scalar kernel), at the main paths' shapes and
    at edge cases across the tensor-core kernel's tiles and ring, head dims
    20 (padded to 24), 32, 40 and 128, the attention layer's transposed
    views and an unaligned view; two launches bitwise equal; then timed at
    the serving and training shapes beside SDPA and the bound."""
    from hetu_tpu_torch.ops.cuda_kernels.flash_attention import (
        flash_attention, flash_attention_plain, fwd_design, route,
    )
    gen = torch.Generator(device="cuda").manual_seed(1234)
    main = (TRAIN_B, NH, TRAIN_S, HEAD_DIM)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for s in (16, 32, 64, 128, 256, 512):
            cases.append((dtype, (1, NH, s, HEAD_DIM), s, True, "main"))
        cases += [
            (dtype, main, TRAIN_S, True, "train"),
            (dtype, (2, NH, 128, HEAD_DIM), 128, False, "full"),
            (dtype, (1, NH, 64, HEAD_DIM), 256, True, "cross S_q<S_k"),
            (dtype, (1, NH, 100, HEAD_DIM), 100, True, "ragged"),
            (dtype, (1, NH, 100, HEAD_DIM), 100, False, "ragged full"),
            (dtype, (1, NH, 128, HEAD_DIM), 64, True, "S_q>S_k"),
            (dtype, (1, 2, 48, 128), 48, True, "D=128"),
            # across the tensor-core kernel's 64-row tiles and its ring
            (dtype, (1, 2, 100, HEAD_DIM), 190, True, "S_q<S_k ragged"),
            (dtype, (1, 2, 190, HEAD_DIM), 100, True, "S_q>S_k ragged"),
            (dtype, (1, 2, 1000, HEAD_DIM), 1000, True, "S=1000"),
            (dtype, (2, 3, 130, HEAD_DIM), 130, True, "S=130"),
            (dtype, (1, 1, 300, HEAD_DIM), 300, False, "B*H=1 full"),
            (dtype, (1, 3, 130, 32), 130, True, "D=32"),
            # D = 40 fills a 64-column box (zeros past 40); D = 20 is
            # padded to 24 by one copy (TMA rows are multiples of 16 bytes)
            (dtype, (1, 3, 130, 40), 150, True, "D=40"),
            (dtype, (1, 2, 70, 20), 90, True, "D=20 padded"),
            (dtype, (1, 3, 200, 128), 200, True, "D=128 S=200"),
            (dtype, (1, 3, 70, 128), 90, False, "D=128 full"),
            # strided inputs: read in place by TMA (bf16), or copied once
            (dtype, (2, NH, 256, HEAD_DIM), 256, True, "layer views",
             "views"),
            (dtype, (1, 2, 130, HEAD_DIM), 130, True, "unaligned",
             "unaligned"),
        ]
    max_err_train = None  # reported beside the timings at the same shape
    with torch.inference_mode():
        for dtype, shape, s_k, causal, tag, *layout in cases:
            if layout == ["views"]:
                q, k, v = _layer_views(shape, dtype, gen)[:3]
            else:
                q, k, v = (_relaid(t, *layout) if layout else t
                           for t in _qkv(shape, s_k, dtype, gen))
            o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
            o_p, lse_p = flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            diff = (o.float() - o_p.float()).abs()
            err_o = diff.max().item()
            err_lse = (lse - lse_p).abs().max().item()
            ok = o.shape == o_p.shape and o.dtype == dtype \
                and bool((diff <= TOL_O[dtype]
                          + RTOL_O[dtype] * o_p.float().abs()).all()) \
                and err_lse <= TOL_LSE and bool(torch.isfinite(o).all())
            masked = shape[2] - s_k if causal and shape[2] > s_k else 0
            if masked:  # rows that see no key are exactly 0
                ok = ok and not o[:, :, :masked].any() \
                    and not o_p[:, :, :masked].any()
            kind, d_run = route(dtype, shape[3])
            print(f"[kernel] flash_attention {str(dtype)[6:]:8s} "
                  f"{tag:14s} q{tuple(shape)} S_k={s_k} causal={causal} "
                  f"route {kind} D={d_run}: "
                  f"max|dO|={err_o:.3e} (tol {TOL_O[dtype]:g} + "
                  f"{RTOL_O[dtype]:g}*|O|) "
                  f"max|dLSE|={err_lse:.3e} (tol {TOL_LSE:g})"
                  + (f" zero rows={masked}" if masked else "")
                  + f" {'ok' if ok else 'FAIL'}")
            check(ok, f"flash_attention disagrees with its plain version "
                      f"({tag}, {dtype}, q{tuple(shape)}, S_k={s_k})")
            if tag == "train" and dtype == torch.bfloat16:
                max_err_train = err_o

        # no atomics: each output row is written once by one CTA
        q, k, v = _layer_views(main, torch.bfloat16, gen)[:3]
        again = [flash_attention(q, k, v, causal=True, return_lse=True)
                 for _ in range(2)]
        torch.cuda.synchronize()
        same = all(torch.equal(_bits(a), _bits(b))
                   for a, b in zip(*again))
        print(f"[kernel] flash_attention bf16 q{main} on the layer's views: "
              f"two launches bitwise equal: {same}")
        check(same, "two launches of the forward kernel differ")
        del again
        views_ms = device_ms(lambda: flash_attention(q, k, v, causal=True),
                             20)

        design = fwd_design()
        print(f"[kernel] flash_attention bf16 kernel as built: "
              f"{design['warpgroups']} warpgroup(s) on {design['queries']} "
              f"queries a CTA, a {design['stages']}-stage K/V ring")
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
            tflops = flash_flops(b, NH, s, s, HEAD_DIM, True) / ms / 1e9
            timings[(b, s)] = dict(ms=ms, plain_ms=plain_ms,
                                   library_ms=lib_ms, bound_ms=bound_ms,
                                   bound_by=bound_by, tflops=tflops)
            print(f"[kernel] flash_attention bf16 causal q({b},{NH},{s},"
                  f"{HEAD_DIM}): kernel {ms:.4f} ms "
                  f"({tflops:.1f} TFLOP/s, {100 * bound_ms / ms:.1f} % of "
                  f"the bound), plain {plain_ms:.4f} ms, library (SDPA, "
                  f"yardstick only) {lib_ms:.4f} ms, {ms / lib_ms:.2f}x "
                  f"SDPA, bound {bound_ms:.5f} ms ({bound_by}) [{card}]")
        print(f"[kernel] flash_attention bf16 causal q{main} on the layer's "
              f"transposed views: {views_ms:.4f} ms (read in place; "
              f"contiguous inputs {timings[(TRAIN_B, TRAIN_S)]['ms']:.4f} "
              f"ms) [{card}]")
    return max_err_train, timings, design


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


def _relaid(t, layout):
    """``t``'s values in another memory layout: ``views``, a transposed
    ``[B, H, S, D]`` view of a ``[B, S, H, D]`` tensor, as the attention
    layer passes them; ``unaligned``, a contiguous view that starts 2 bytes
    past a 16-byte boundary (TMA cannot read it in place)."""
    if layout == "views":
        b, h, s, d = t.shape
        return torch.empty(b, s, h, d, dtype=t.dtype,
                           device=t.device).transpose(1, 2).copy_(t)
    if layout == "unaligned":
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        return buf[1:].view(t.shape).copy_(t)
    return t


def _bwd_inputs(shape_q, s_k, dtype, causal, gen, layout="contiguous"):
    """q, k, v, dO (in ``layout``, see :func:`_relaid`), and the LSE and
    delta the forward pass gives them."""
    from hetu_tpu_torch.ops.cuda_kernels.flash_attention import (
        flash_attention_plain,
    )
    q, k, v = _qkv(shape_q, s_k, dtype, gen)
    do = torch.randn(q.shape, generator=gen, device="cuda",
                     dtype=torch.float32).to(dtype)
    q, k, v, do = (_relaid(t, layout) for t in (q, k, v, do))
    o, lse = flash_attention_plain(q, k, v, causal=causal)
    b, h, s_q, _ = q.shape
    delta = (do.float() * o.float()).sum(-1).reshape(b * h, s_q, 1)
    return q, k, v, do, lse, delta


def _layer_views(shape, dtype, gen):
    """q, k, v and dO as the attention layer hands them to the backward:
    transposed ``[B, H, S, D]`` views of the fused QKV projection's
    ``[B, S, 3, H, D]`` output and of the output projection's gradient
    ``[B, S, H, D]``; O and the LSE from the forward."""
    from hetu_tpu_torch.ops.cuda_kernels.flash_attention import (
        flash_attention_plain,
    )
    b, h, s, d = shape
    qkv = torch.randn(b, s, 3, h, d, generator=gen, device="cuda").to(dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    do = torch.randn(b, s, h, d, generator=gen, device="cuda").to(
        dtype).transpose(1, 2)
    o, lse = flash_attention_plain(q, k, v, causal=True)
    return q, k, v, o, lse, do


def phase_kernel_bwd(card):
    """The two backward kernels against the plain backward, at the
    training step's shape and at edge cases that cross the tensor-core
    kernels' tile and ring edges; two launches bitwise equal; then timed at
    that shape, each kernel and the whole ``flash_attention_bwd`` (delta,
    operand preparation and both kernels, on the attention layer's
    transposed views) beside SDPA's backward."""
    from hetu_tpu_torch.ops.cuda_kernels.flash_attention import (
        _operands, bwd_delta, flash_attention_bwd,
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
            # across the tensor-core kernels' 64-row tiles and 3-stage ring
            (dtype, (1, 2, 1000, HEAD_DIM), 1000, True, "S=1000"),
            (dtype, (2, 3, 130, HEAD_DIM), 130, True, "S=130"),
            (dtype, (1, 2, 100, HEAD_DIM), 190, True, "S_q<S_k ragged"),
            (dtype, (1, 2, 190, HEAD_DIM), 100, True, "S_q>S_k ragged"),
            (dtype, (1, 3, 200, 128), 200, True, "D=128 S=200"),
            (dtype, (1, 3, 130, 32), 130, True, "D=32 S=130"),
            (dtype, (1, 2, 70, 20), 90, True, "D=20 padded"),
            (dtype, (1, 1, 257, HEAD_DIM), 257, True, "B*H=1"),
            (dtype, (1, 1, 300, HEAD_DIM), 300, False, "B*H=1 full"),
            # strided inputs: read in place by TMA (bf16), or copied once
            (dtype, (2, NH, 256, HEAD_DIM), 256, True, "layer views",
             "views"),
            (dtype, (1, 2, 130, HEAD_DIM), 130, True, "unaligned",
             "unaligned"),
        ]
    max_err = {}
    with torch.no_grad():
        for dtype, shape, s_k, causal, tag, *layout in cases:
            args = _bwd_inputs(shape, s_k, dtype, causal, gen, *layout)
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
                    and got.shape == ref.shape \
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
        # no atomics: each output row is written once, so two launches
        # give the same bits
        again = [flash_attention_bwd_dkdv(*args, causal=True)
                 + (flash_attention_bwd_dq(*args, causal=True),)
                 for _ in range(2)]
        torch.cuda.synchronize()
        same = all(torch.equal(_bits(a), _bits(b))
                   for a, b in zip(*again))
        print(f"[kernel] flash_attention_bwd bf16 main q{main}: two launches "
              f"of each kernel bitwise equal: {same}")
        check(same, "two launches of the backward kernels differ")
        del again
        timings = {
            "dkdv": device_ms(lambda: flash_attention_bwd_dkdv(
                *args, causal=True), 20),
            "dq": device_ms(lambda: flash_attention_bwd_dq(
                *args, causal=True), 20)}
        plain_ms = device_ms(lambda: flash_attention_bwd_plain(
            *args, causal=True), 20)
        q, k, v, o, lse, do = _layer_views(main, torch.bfloat16, gen)
        whole_ms = device_ms(lambda: flash_attention_bwd(
            q, k, v, o, lse, do, causal=True), 20)
        # its parts outside the kernels
        delta_ms = device_ms(lambda: bwd_delta(do, o), 20)
        prep_ms = device_ms(lambda: _operands(q, k, v, do), 20)
    # the yardstick: SDPA's backward alone, on the same views
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                           is_causal=True)
    lib_ms = device_ms(lambda: torch.autograd.grad(
        out, (q, k, v), do, retain_graph=True), 20)
    print(f"[kernel] flash_attention_bwd bf16 causal q{main}, the "
          f"attention layer's transposed views: whole backward (delta, "
          f"operands, dK/dV and dQ kernels) {whole_ms:.4f} ms (delta alone "
          f"{delta_ms:.4f} ms, operand copies alone {prep_ms:.4f} ms), "
          f"library (SDPA backward, yardstick only) {lib_ms:.4f} ms, "
          f"{whole_ms / lib_ms:.2f}x [{card}]")
    report = {}
    for name in ("dkdv", "dq"):
        bound_ms, bound_by = flash_bound(*main[:2], TRAIN_S, TRAIN_S,
                                         HEAD_DIM, True, kernel=name)
        tflops = flash_flops(*main[:2], TRAIN_S, TRAIN_S, HEAD_DIM, True,
                             kernel=name) / timings[name] / 1e9
        report[name] = dict(ms=timings[name], plain_ms=plain_ms,
                            library_ms=lib_ms, bound_ms=bound_ms,
                            bound_by=bound_by, max_abs_err=max_err[name],
                            whole_bwd_ms=whole_ms)
        print(f"[kernel] flash_attention_bwd_{name} bf16 causal q{main}: "
              f"kernel {timings[name]:.4f} ms ({tflops:.1f} TFLOP/s, "
              f"{100 * bound_ms / timings[name]:.1f} % of the bound), plain "
              f"backward (dQ, dK, dV together) {plain_ms:.4f} ms, library "
              f"(SDPA backward, yardstick only) {lib_ms:.4f} ms, bound "
              f"{bound_ms:.5f} ms ({bound_by}) [{card}]")
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
    """The port's own kernels (flash, MoE), cuBLAS's GEMMs, copies and
    fills, and the rest (PyTorch's elementwise and reduction kernels)."""
    if _short(kernel).startswith(("flash_fwd_", "flash_bwd_")):
        return "flash kernels"
    if _short(kernel).startswith(("gather_kernel", "scatter_add_kernel",
                                  "topk_gating_kernel")):
        return "MoE kernels"
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


def _loss_and_grads(model, batch):
    """The training loss of ``batch`` and every parameter's gradient."""
    params = dict(model.named_parameters())
    loss, _ = model.lm_loss_fn()(params, {}, batch, None, True)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def _check_grads(tag, grads_k, grads_p):
    """Every kernel-path gradient finite and within ``TOL_TRAIN_GRAD`` of
    the largest element of the plain path's."""
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
    print(f"[{tag}] gradients of {len(ratios)} parameters: max|dG| / "
          f"max|G_plain| <= {worst[0][1]:.3e} (tol {TOL_TRAIN_GRAD:g}); "
          f"worst: " + ", ".join(f"{n} {r:.3e}" for n, r in worst[:3]))
    check(worst[0][1] <= TOL_TRAIN_GRAD,
          f"kernel path gradient of {worst[0][0]} disagrees with the plain "
          f"path")
    return worst[0][1]


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

    loss_k, grads_k = _loss_and_grads(model, batch)
    loss_p, grads_p = _loss_and_grads(plain, batch)
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
    _check_grads("train", grads_k, grads_p)
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


# ------------------------------------------------------------------ MoE

def _bits(t):
    """``t``'s bits as integers, so that equality is bitwise (-0.0 is not
    0.0, a NaN equals itself)."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return t.contiguous().view(ints[t.dtype]) if t.dtype in ints else t


def tolerance_share(got, ref, tol=None):
    """The largest share of its tolerance that any element of ``got`` uses
    against ``ref`` (at most 1 passes): ``tol`` is a bound per element (a
    tensor or a number); without one the gate is bitwise, and any
    difference uses an infinite share."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        return float("inf")
    if tol is None:
        return 0.0 if torch.equal(_bits(got), _bits(ref)) else float("inf")
    diff = (got.double() - ref.double()).abs()
    tol = torch.as_tensor(tol, dtype=torch.float64, device=diff.device)
    share = torch.where(tol > 0, diff / tol.clamp_min(1e-300),
                        torch.where(diff > 0, float("inf"), 0.0))
    return share.max().item() if share.numel() else 0.0


def scatter_tolerance(grads, ids, num_rows, ref):
    """The bound of the note on ``TOL_GATES`` for a scatter-add summed in
    another order: per row, 2 (n - 1) 2^-24 sum|g| over its n rows, plus
    one bf16 ulp (2^-7 |ref|) for a bf16 result."""
    ids = ids.long()
    valid = (ids >= 0) & (ids < num_rows)
    n = torch.bincount(ids[valid], minlength=num_rows).double()
    s = torch.zeros(num_rows, grads.shape[1], dtype=torch.float64,
                    device=grads.device).index_add_(
        0, ids[valid], grads[valid].double().abs())
    tol = 2 * (n - 1).clamp_min(0)[:, None] * 2 ** -24 * s
    if ref.dtype == torch.bfloat16:
        tol = tol + 2 ** -7 * ref.double().abs()
    return tol


def moe_routing(t, e, k, capacity, gen, device="cuda"):
    """The path's row ids from seeded random logits: ``slot_token [E*C]``
    (-1 for an empty slot) and ``token_slot [T*k]`` (-1 for a dropped
    route), as ``MoELayer`` makes them."""
    from hetu_tpu_torch.ops import make_slot_routing
    from hetu_tpu_torch.ops.cuda_kernels import topk_gating_plain
    logits = torch.randn(t, e, generator=gen, device=device)
    gates, idx = topk_gating_plain(logits, k)
    slot_token, token_slot, _ = make_slot_routing(gates, idx, e, capacity)
    return slot_token, token_slot.reshape(-1)


def _rows(n, d, dtype, gen, integers=False):
    if integers:  # small integers: every sum exact, in any order
        return torch.randint(-8, 9, (n, d), generator=gen, device="cuda",
                             dtype=torch.int32).to(dtype)
    return torch.randn(n, d, generator=gen, device="cuda").to(dtype)


def gather_bound(table, ids):
    """Least time (ms) for the gather: the ids and each distinct valid row
    read once, the output written once, over the HBM rate."""
    valid = ids[(ids >= 0) & (ids < table.shape[0])]
    row = table.shape[1] * table.element_size()
    nbytes = ids.numel() * 4 + torch.unique(valid).numel() * row \
        + ids.numel() * row
    return nbytes / H100_BYTES_PER_S * 1e3


def scatter_bound(grads, ids, num_rows):
    """Least time (ms) for the scatter-add: the ids and each valid gradient
    row read once, the ``[num_rows, D]`` result written once.  The adds
    (one per element of a valid row) are far below the bytes."""
    row = grads.shape[1] * grads.element_size()
    n_valid = int(((ids >= 0) & (ids < num_rows)).sum())
    nbytes = ids.numel() * 4 + n_valid * row + num_rows * row
    return nbytes / H100_BYTES_PER_S * 1e3


def topk_bound(t, e, k, elem_bytes=4):
    """Least time (ms) for the gate: logits read once, gates and int32
    indices written once."""
    return (t * e * elem_bytes + t * k * (elem_bytes + 4)) \
        / H100_BYTES_PER_S * 1e3


def phase_kernel_moe(card):
    """The gather, scatter-add and top-k kernels against their plain
    versions at the MoE step's shapes, at bench_moe's width and at edge
    cases; then timed at the step's shapes."""
    from hetu_tpu_torch.ops.cuda_kernels import (
        embedding_gather, embedding_gather_plain, embedding_scatter_add,
        embedding_scatter_add_plain, topk_gating, topk_gating_plain,
    )
    gen = torch.Generator(device="cuda").manual_seed(2468)
    t, ec = MOE_T, MOE_E * MOE_C
    slot_token, token_slot = moe_routing(t, MOE_E, MOE_K, MOE_C, gen)
    heavy = torch.full((4096,), 37, dtype=torch.int32, device="cuda")
    mixed = torch.cat([heavy, torch.tensor([-1, 5, 37, 10 ** 6], device="cuda",
                                           dtype=torch.int32)])
    ragged = torch.randint(-3, 70, (300,), generator=gen, device="cuda")
    # each id in [-3, 70) twice, in a random order: at most two rows meet
    # on a destination, so the plain version's atomics cannot reorder a sum
    twice = torch.cat([torch.randperm(73, generator=gen, device="cuda") - 3
                       for _ in range(2)])
    errs = {}

    def report(name, tag, share, err, ok_extra=True):
        ok = share <= 1.0 and ok_extra
        print(f"[kernel_moe] {name} {tag}: max|d|={err:.3e} share of "
              f"tolerance used {share:.3g} {'ok' if ok else 'FAIL'}")
        check(ok, f"{name} disagrees with its plain version ({tag})")

    with torch.no_grad():
        # gather: (table rows, dtype, ids, tag) -- bitwise
        gathers = [
            (t, MOE_H, torch.bfloat16, slot_token, "dispatch"),
            (ec, MOE_H, torch.float32, token_slot, "combine"),
            (t, MOE_BENCH_D, torch.bfloat16, slot_token, "dispatch D=768"),
            (ec, MOE_BENCH_D, torch.float32, token_slot, "combine D=768"),
            (64, MOE_H, torch.bfloat16, torch.full((500,), -1, device="cuda"),
             "all invalid"),
            (64, 100, torch.bfloat16, ragged, "D=100 bf16"),
            (64, 100, torch.float32, ragged, "D=100 f32"),
            (64, 33, torch.bfloat16, ragged, "D=33 bf16"),
            (1, MOE_H, torch.float32, torch.zeros(1, dtype=torch.int32,
                                                  device="cuda"), "T=1"),
        ]
        for rows, d, dtype, ids, tag in gathers:
            table = _rows(rows, d, dtype, gen)
            got = embedding_gather(table, ids)
            ref = embedding_gather_plain(table, ids)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item() \
                if got.numel() else 0.0
            report("embedding_gather", f"{tag} {tuple(table.shape)} "
                   f"{str(dtype)[6:]} ids {ids.numel()}",
                   tolerance_share(got, ref), err)
            errs.setdefault("gather", 0.0)
            errs["gather"] = max(errs["gather"], err)

        # scatter-add: (grads rows, D, dtype, ids, num_rows, tag, integers,
        # bitwise)
        scatters = [
            (ec, MOE_H, torch.bfloat16, slot_token, t, "dispatch bwd", False,
             True),
            (t * MOE_K, MOE_H, torch.float32, token_slot, ec, "combine bwd",
             False, True),
            (ec, MOE_BENCH_D, torch.bfloat16, slot_token, t,
             "dispatch bwd D=768", False, True),
            (t * MOE_K, MOE_BENCH_D, torch.float32, token_slot, ec,
             "combine bwd D=768", False, True),
            (500, MOE_H, torch.float32, torch.full((500,), -1, device="cuda"),
             64, "all invalid", False, True),
            (146, 100, torch.bfloat16, twice, 64, "D=100 bf16", False, True),
            (146, 100, torch.float32, twice, 64, "D=100 f32", False, True),
            (300, 100, torch.float32, ragged, 64, "D=100 f32 x~5", False,
             False),
            (4100, MOE_H, torch.float32, mixed, 64, "heavy x4096 integers",
             True, True),
            (4100, MOE_H, torch.bfloat16, mixed, 64, "heavy x4096 integers",
             True, True),
            (4100, MOE_H, torch.float32, mixed, 64, "heavy x4096 randn",
             False, False),
            (4100, MOE_H, torch.bfloat16, mixed, 64, "heavy x4096 randn",
             False, False),
        ]
        for n, d, dtype, ids, num_rows, tag, ints, bitwise in scatters:
            grads = _rows(n, d, dtype, gen, integers=ints)
            got = embedding_scatter_add(grads, ids, num_rows)
            again = embedding_scatter_add(grads, ids, num_rows)
            ref = embedding_scatter_add_plain(grads, ids, num_rows)
            torch.cuda.synchronize()
            tol = None if bitwise else scatter_tolerance(grads, ids,
                                                         num_rows, ref)
            err = (got.float() - ref.float()).abs().max().item()
            report("embedding_scatter_add",
                   f"{tag} grads {tuple(grads.shape)} {str(dtype)[6:]} -> "
                   f"{num_rows} rows ({'bitwise' if bitwise else 'order bound'}"
                   f"; two launches equal)", tolerance_share(got, ref, tol),
                   err, tolerance_share(got, again) == 0.0)
            if bitwise:
                errs["scatter"] = max(errs.get("scatter", 0.0), err)

        # top-k: (T, E, k, dtype, tag, logits kind)
        topks = [
            (t, MOE_E, MOE_K, torch.float32, "path", "randn"),
            (t, MOE_E, MOE_K, torch.bfloat16, "bf16", "randn"),
            (4096, MOE_E, MOE_K, torch.float32, "all-equal rows", "equal"),
            (4096, MOE_E, MOE_E, torch.float32, "pairs of ties", "pairs"),
            (4096, MOE_E, MOE_E, torch.float32, "k = E", "randn"),
            (4096, 64, MOE_K, torch.float32, "E = 64", "randn"),
            (4096, 7, 3, torch.float32, "E = 7", "randn"),
            (512, 256, 4, torch.bfloat16, "E = 256 bf16", "randn"),
            (1, MOE_E, MOE_K, torch.float32, "T = 1", "randn"),
        ]
        for tt, e, k, dtype, tag, kind in topks:
            if kind == "equal":
                logits = torch.zeros(tt, e, device="cuda", dtype=dtype)
            elif kind == "pairs":  # every value twice in each row
                half = torch.randn(tt, e // 2, generator=gen, device="cuda")
                logits = half.repeat_interleave(2, dim=1).to(dtype)
            else:
                logits = torch.randn(tt, e, generator=gen,
                                     device="cuda").to(dtype)
            gates, idx = topk_gating(logits, k)
            g_ref, i_ref = topk_gating_plain(logits, k)
            torch.cuda.synchronize()
            err = (gates.float() - g_ref.float()).abs().max().item()
            report("topk_gating", f"{tag} logits ({tt}, {e}) "
                   f"{str(dtype)[6:]} k={k} (idx equal, gates tol "
                   f"{TOL_GATES[dtype]:g})",
                   tolerance_share(gates, g_ref, TOL_GATES[dtype]), err,
                   tolerance_share(idx, i_ref) == 0.0)
            if tag == "path":
                errs["topk"] = err

        # timings at the step's shapes: one dispatch and one combine call
        # for the gather and the scatter, summed (a layer makes both), and
        # one gate call
        x_disp = _rows(t, MOE_H, torch.bfloat16, gen)
        y_comb = _rows(ec, MOE_H, torch.float32, gen)
        g_disp = _rows(ec, MOE_H, torch.bfloat16, gen)
        g_comb = _rows(t * MOE_K, MOE_H, torch.float32, gen)
        logits = torch.randn(t, MOE_E, generator=gen, device="cuda")
        clamp = lambda ids, n: ids.long().clamp(0, n - 1)
        s_ids, c_ids = clamp(slot_token, t), clamp(token_slot, ec)
        calls = {
            "gather": [
                (lambda: embedding_gather(x_disp, slot_token),
                 lambda: embedding_gather_plain(x_disp, slot_token),
                 lambda: torch.index_select(x_disp, 0, s_ids),
                 gather_bound(x_disp, slot_token)),
                (lambda: embedding_gather(y_comb, token_slot),
                 lambda: embedding_gather_plain(y_comb, token_slot),
                 lambda: torch.index_select(y_comb, 0, c_ids),
                 gather_bound(y_comb, token_slot))],
            "scatter": [
                (lambda: embedding_scatter_add(g_disp, slot_token, t),
                 lambda: embedding_scatter_add_plain(g_disp, slot_token, t),
                 lambda: torch.zeros(t, MOE_H, dtype=g_disp.dtype,
                                     device="cuda").index_add_(
                     0, s_ids, g_disp),
                 scatter_bound(g_disp, slot_token, t)),
                (lambda: embedding_scatter_add(g_comb, token_slot, ec),
                 lambda: embedding_scatter_add_plain(g_comb, token_slot, ec),
                 lambda: torch.zeros(ec, MOE_H, dtype=g_comb.dtype,
                                     device="cuda").index_add_(
                     0, c_ids, g_comb),
                 scatter_bound(g_comb, token_slot, ec))],
            "topk": [
                (lambda: topk_gating(logits, MOE_K),
                 lambda: topk_gating_plain(logits, MOE_K),
                 lambda: torch.softmax(torch.topk(logits, MOE_K).values, -1),
                 topk_bound(t, MOE_E, MOE_K))],
        }
        report_ms = {}
        for name, sites in calls.items():
            per = [dict(ms=device_ms(k_fn, 40), plain_ms=device_ms(p_fn, 20),
                        library_ms=device_ms(l_fn, 40), bound_ms=bound)
                   for k_fn, p_fn, l_fn, bound in sites]
            for site, m in zip(("dispatch", "combine"), per):
                label = f"{name} {site}" if len(per) > 1 else name
                print(f"[kernel_moe] {label} at the step's shape: kernel {m['ms']:.4f} ms, plain "
                      f"{m['plain_ms']:.4f} ms, library (yardstick only) "
                      f"{m['library_ms']:.4f} ms, bound {m['bound_ms']:.5f} "
                      f"ms (bytes) [{card}]")
            report_ms[name] = {f: sum(m[f] for m in per)
                               for f in ("ms", "plain_ms", "library_ms",
                                         "bound_ms")}
            report_ms[name]["bound_by"] = "bytes"
            report_ms[name]["max_abs_err"] = errs[name]
            if len(per) > 1:
                report_ms[name]["by_call"] = dict(zip(("dispatch", "combine"),
                                                      per))
    return report_ms


def moe_jax_layout_weights(seed: int) -> dict:
    """MoE transformer parameters in the JAX package's layout and with its
    initialisers: normal(0.02) embeddings, Xavier-uniform attention and
    gate weights (``[in, out]``), He-normal experts (fan
    ``int(sqrt(E*D*F))``, the reference's rule for 3-D shapes), zero
    biases, unit LayerNorm scales."""
    g = np.random.default_rng(seed)
    h, e, f = MOE_H, MOE_E, MOE_FFN

    def normal(std, *shape):
        return np.float32(std) * g.standard_normal(shape, dtype=np.float32)

    def xavier(*shape):
        lim = np.float32(np.sqrt(6.0 / (shape[0] + shape[1])))
        return (g.random(shape, dtype=np.float32) * 2 - 1) * lim

    def he(*shape):
        return normal(np.sqrt(2.0 / int(np.sqrt(np.prod(shape)))), *shape)

    z = lambda *shape: np.zeros(shape, np.float32)
    o = lambda *shape: np.ones(shape, np.float32)
    p = {"tok_emb": normal(0.02, MOE_V, h), "pos_emb": normal(0.02, MOE_S, h)}
    for layer in range(MOE_L):
        p[f"layer{layer}"] = {
            "attn": {"qkv_weight": xavier(h, 3 * h), "qkv_bias": z(3 * h),
                     "out_weight": xavier(h, h), "out_bias": z(h)},
            "ln1": {"scale": o(h), "bias": z(h)},
            "ln2": {"scale": o(h), "bias": z(h)},
            "moe": {"gate": {"gate_w": xavier(h, e)},
                    "experts": {"w1": he(e, h, f), "b1": z(e, f),
                                "w2": he(e, f, h), "b2": z(e, h)}}}
    return p


def _moe_flops(routed):
    """Model FLOPs of one training step (forward and backward, 3x the
    forward): per token and layer, the attention projections (8 H^2), the
    scores and the weighted sum over the whole sequence (4 S H, as bench.py
    counts attention) and the gate (2 H E); per routed (token, choice) and
    layer, the expert FFN (4 H F); per token, the LM head (2 H V).  Routed
    routes are bounded by capacity: min(E*C, T*k), as bench.py bench_moe
    counts them."""
    per_token = MOE_L * (8 * MOE_H ** 2 + 4 * MOE_S * MOE_H
                         + 2 * MOE_H * MOE_E) + 2 * MOE_H * MOE_V
    return 3 * (MOE_T * per_token + MOE_L * routed * 4 * MOE_H * MOE_FFN)


def _moe_pass(model, batch):
    """The training loss of ``batch``, every gradient, and each layer's
    expert indices ``[T, k]``."""
    routes = []
    hooks = [layer.moe.gate.register_forward_hook(
        lambda mod, inp, out: routes.append(out[1].detach()))
        for layer in model.layers]
    try:
        loss, grads = _loss_and_grads(model, batch)
    finally:
        for h in hooks:
            h.remove()
    return routes, loss, grads


def _plain_gather_moe(moe, x):
    """``MoELayer.forward``'s gather path written out with the gather's
    plain version (PyTorch indexing, differentiated by autograd) in place of
    the ``routed_gather`` kernels: the MoE layer of the plain path."""
    from hetu_tpu_torch import ops
    from hetu_tpu_torch.ops.cuda_kernels import embedding_gather_plain
    tokens = x.reshape(-1, x.shape[-1])
    t, d = tokens.shape
    e, k = moe.experts.num_experts, moe.gate.k
    capacity = max(1, int(moe.capacity_factor * t * k / e))
    gates, idx, aux = moe.gate(tokens)
    slot_token, token_slot, _ = ops.make_slot_routing(gates, idx, e, capacity)
    xe = embedding_gather_plain(tokens, slot_token).reshape(e, capacity, d)
    ye = moe.experts(xe).reshape(e * capacity, d)
    picked = embedding_gather_plain(ye, token_slot.reshape(-1))
    out = (gates[..., None].to(picked.dtype)
           * picked.reshape(t, k, d)).sum(dim=1)
    return out.reshape(x.shape), aux


def phase_train_moe(card, seed, device="cuda"):
    """The MoE transformer's training step at MoEConfig's widths, bf16,
    B 32 x S 512: the kernel path against the plain path and the einsum
    dispatch on one batch, then 10 Executor steps."""
    from torch.profiler import ProfilerActivity, profile

    from hetu_tpu_torch import interop
    from hetu_tpu_torch.models import MoEConfig, MoETransformer
    from hetu_tpu_torch.ops.cuda_kernels import (
        embedding_gather, embedding_scatter_add, topk_gating,
    )
    from hetu_tpu_torch.optim import AdamWOptimizer
    from hetu_tpu_torch.train import Executor

    cfg = MoEConfig(vocab_size=MOE_V, hidden_size=MOE_H, num_layers=MOE_L,
                    num_heads=MOE_NH, ffn_size=MOE_FFN, num_experts=MOE_E,
                    top_k=MOE_K, capacity_factor=MOE_CF, max_position=MOE_S,
                    dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = MoETransformer(cfg, device=device)
    model.load_state_dict(interop.params_from_jax(
        moe_jax_layout_weights(seed), cfg))
    g = np.random.default_rng(seed + 2)
    batch = (torch.tensor(g.integers(0, MOE_V, (MOE_B, MOE_S)),
                          device=device),)
    _sync(device)
    print(f"[train_moe] MoE transformer V={MOE_V} H={MOE_H} L={MOE_L} "
          f"heads={MOE_NH} ffn={MOE_FFN} experts={MOE_E} top-{MOE_K} "
          f"cf={MOE_CF} (C={MOE_C}) B={MOE_B} S={MOE_S} bf16, AdamW"
          f"({MOE_LR:g}): built in {time.perf_counter() - t0:.1f} s")
    counters = (topk_gating, embedding_gather, embedding_scatter_add)

    # the kernel path against two plain paths, one batch, same weights:
    # "plain" is the same composition with the plain gate and the gather's
    # plain version (PyTorch indexing, differentiated by autograd), so the
    # two round alike up to the MoE outputs and route every token alike;
    # "einsum" is the dense-mask dispatch and combine, whose f32 GEMM
    # rounds the combine's sum otherwise: one bf16 ulp in a layer's output
    # then moves the gate logits of later layers and flips the experts of
    # the tokens whose top-3 logits nearly tie, a discontinuity of the
    # function, not a fault.  So the gradients are held against "plain",
    # and "einsum" is held to the loss limit and to identical routes in the
    # first layer, with the flips of the later layers printed.
    variants = {"plain": ("xla", "gather"), "einsum": ("xla", "einsum")}
    routes_k, loss_k, grads_k = _moe_pass(model, batch)
    results = {}
    for name, (impl, dispatch) in variants.items():
        other = copy.deepcopy(model)
        for layer in other.layers:
            layer.moe.gate.impl, layer.moe.dispatch_impl = impl, dispatch
            if name == "plain":
                layer.moe.forward = functools.partial(_plain_gather_moe,
                                                      layer.moe)
        for c in counters:
            c.launches = 0
        routes_p, loss_p, grads_p = _moe_pass(other, batch)
        check(all(c.launches == 0 for c in counters),
              f"the {name} MoE path launched a kernel")
        del other
        check(np.isfinite(loss_k) and np.isfinite(loss_p),
              "a loss is not finite")
        flips = [int((a != b).any(-1).sum()) for a, b in zip(routes_k,
                                                              routes_p)]
        print(f"[train_moe] kernel path vs {name} path: loss {loss_k:.6f} vs "
              f"{loss_p:.6f}, |d|={abs(loss_k - loss_p):.3e} (tol "
              f"{TOL_TRAIN_LOSS:g}); tokens routed otherwise by layer: "
              f"{flips}")
        check(abs(loss_k - loss_p) <= TOL_TRAIN_LOSS,
              f"kernel path loss disagrees with the {name} path")
        check(flips[0] == 0, f"the {name} path routes the first layer "
                             f"otherwise")
        if name == "plain":
            check(not any(flips), "the plain path routes a token otherwise")
            grad_ratio = _check_grads("train_moe", grads_k, grads_p)
        else:
            worst = max((grads_k[n] - g).abs().max().item()
                        / g.abs().max().item() for n, g in grads_p.items())
            print(f"[train_moe] einsum path gradients (reported, not held): "
                  f"max|dG| / max|G_einsum| <= {worst:.3e}")
            if device == "cuda":
                print(f"[train_moe] peak "
                      f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                      f"allocated through the einsum path's [T, E, C] masks")
        results[name] = dict(loss_gap=abs(loss_k - loss_p), flips=flips)
        del grads_p
    del grads_k
    if device == "cuda":
        torch.cuda.empty_cache()

    ex = Executor(model.lm_loss_fn(), AdamWOptimizer(MOE_LR), seed=seed)
    state = ex.init_state(model)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for c in counters:  # count the main path's launches only
        c.launches = 0
    losses, times, dropped = [], [], []
    for _ in range(MOE_STEPS):
        _sync(device)
        t0 = time.perf_counter()
        state, met = ex.run("train", state, batch)
        losses.append(float(met["loss"]))
        _sync(device)
        times.append(time.perf_counter() - t0)
    launches = [c.launches for c in counters]
    print(f"[train_moe] losses: {' '.join(f'{x:.4f}' for x in losses)} "
          f"(last: lm {float(met['lm_loss']):.4f}, aux "
          f"{float(met['aux_loss']):.5f})")
    check(all(np.isfinite(losses)), "a training loss is not finite")
    check(losses[-1] < losses[0], "the loss did not fall")
    print(f"[train_moe] launches in {MOE_STEPS} steps: topk_gating "
          f"{launches[0]}, embedding_gather {launches[1]}, "
          f"embedding_scatter_add {launches[2]} (a step: "
          f"{[n / MOE_STEPS for n in launches]}, expected "
          f"[{MOE_L}, {2 * MOE_L}, {2 * MOE_L}])")
    check(launches == [MOE_L * MOE_STEPS, 2 * MOE_L * MOE_STEPS,
                       2 * MOE_L * MOE_STEPS],
          "the MoE step did not launch L gates, 2L gathers and 2L scatters "
          "a step")

    with torch.no_grad():  # the routes each layer keeps, after the steps
        h = (model.tok_emb[batch[0]] + model.pos_emb[None]).to(cfg.dtype)
        for layer in model.layers:
            h = h + layer.attn(layer.ln1(h))
            m, _, met_l = layer.moe(layer.ln2(h), return_metrics=True)
            dropped.append(float(met_l["dropped_frac"]))
            h = h + m.to(h.dtype)
    routed = sum(round(MOE_T * MOE_K * (1 - d)) for d in dropped) / MOE_L
    step_s = statistics.median(times[1:])
    flops = _moe_flops(min(MOE_C * MOE_E, MOE_T * MOE_K))
    mfu = flops / step_s / H100_BF16_FLOP_S
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if device == "cuda" else 0.0
    print(f"[train_moe] dropped share of routes by layer: "
          f"{' '.join(f'{d:.4f}' for d in dropped)} (mean routed "
          f"{routed:.0f} of {MOE_T * MOE_K})")
    print(f"[train_moe] step median {step_s * 1e3:.3f} ms (steps 2-"
          f"{MOE_STEPS}; first {times[0] * 1e3:.3f} ms), "
          f"{MOE_T / step_s:.1f} tokens/s, MFU {100 * mfu:.2f} % "
          f"({flops / 1e12:.3f} TFLOP a step, {flops / MOE_T / 1e6:.1f} "
          f"MFLOP a token, routes bounded by capacity, over 989 TFLOP/s), "
          f"peak {peak_gib:.2f} GiB allocated [{card}]")

    # the expert FFN alone, forward and backward, at the step's [E, C, D];
    # and its first product's forward both ways: bf16 tensor cores with an
    # f32 output (what _F32Bmm runs) and the up-cast f32 product
    experts = model.layers[0].moe.experts
    xe = torch.randn(MOE_E, MOE_C, MOE_H, device=device,
                     dtype=cfg.dtype).requires_grad_()
    if device == "cuda":
        def ffn():
            y = experts(xe)
            torch.autograd.grad(y, [xe, *experts.parameters()],
                                torch.ones_like(y))
        w1 = experts.w1.detach().to(cfg.dtype)
        x = xe.detach()
        out_f32 = device_ms(lambda: torch.bmm(x, w1,
                                              out_dtype=torch.float32), 10)
        upcast = device_ms(lambda: torch.bmm(x.float(), w1.float()), 10)
        print(f"[train_moe] expert FFN forward + backward at ({MOE_E}, "
              f"{MOE_C}, {MOE_H}): {device_ms(ffn, 10):.3f} ms a layer; "
              f"its first product [{MOE_E}, {MOE_C}, {MOE_H}] x [{MOE_E}, "
              f"{MOE_H}, {MOE_FFN}]: bf16 with f32 output {out_f32:.4f} ms, "
              f"up-cast f32 {upcast:.4f} ms [{card}]")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, met = ex.run("train", state, batch)
        float(met["loss"])
        _sync(device)
    busy = _profile_table(prof, "train_moe step", card, step_s * 1e6)
    return dict(launches=launches, step_ms=step_s * 1e3,
                tokens_per_s=MOE_T / step_s, mfu=mfu, peak_gib=peak_gib,
                busy_share=busy, losses=losses, grad_ratio=grad_ratio,
                paths=results)


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
    max_err, timings, design = phase_kernel(card)
    bwd = phase_kernel_bwd(card)
    moe_kernels = phase_kernel_moe(card)
    serve_launches, engine = phase_slice(card, args.seed)
    phase_profile(engine, card)
    del engine
    torch.cuda.empty_cache()
    train = phase_train(card, args.seed)
    torch.cuda.empty_cache()
    moe = phase_train_moe(card, args.seed)

    shape = [TRAIN_B, NH, TRAIN_S, HEAD_DIM]
    src = "hetu_tpu/ops/pallas_kernels/flash_attention.py"
    t = timings[(TRAIN_B, TRAIN_S)]
    report = {"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "hetu_tpu_torch/csrc/flash_attention.cu",
         "replaces": f"{src}:52", "launches": train["launches"][0],
         "max_abs_err": max_err,
         **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "tflops")},
         "design": design,
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
                                     "bound_by", "library_ms",
                                     "whole_bwd_ms")},
           "shape": shape, "dtype": "bfloat16"}
          for i, k, line in ((1, "dkdv", 198), (2, "dq", 239))),
        *({"name": name, "route": "cuda",
           "source": f"hetu_tpu_torch/csrc/{src_file}",
           "replaces": f"hetu_tpu/ops/pallas_kernels/embedding.py:{line}",
           "launches": moe["launches"][i],
           **{f: moe_kernels[key][f] for f in (
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")},
           "per": per, **({"by_call": moe_kernels[key]["by_call"]}
                          if "by_call" in moe_kernels[key] else {})}
          for name, key, i, src_file, line, per in (
              ("topk_gating", "topk", 0, "topk_gating.cu", 175,
               f"one call, logits [{MOE_T}, {MOE_E}] f32, k {MOE_K}"),
              ("embedding_gather", "gather", 1, "embedding.cu", 35,
               f"the sum of a layer's two calls: dispatch (table "
               f"[{MOE_T}, {MOE_H}] bf16, {MOE_E * MOE_C} ids) and "
               f"combine ([{MOE_E * MOE_C}, {MOE_H}] f32, "
               f"{MOE_T * MOE_K} ids)"),
              ("embedding_scatter_add", "scatter", 2, "embedding.cu", 75,
               f"the sum of a layer's two calls: dispatch backward "
               f"([{MOE_E * MOE_C}, {MOE_H}] bf16 -> {MOE_T} rows) and "
               f"combine backward ([{MOE_T * MOE_K}, {MOE_H}] f32 -> "
               f"{MOE_E * MOE_C} rows)")))]}
    print(card)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
