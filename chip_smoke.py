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
   then, in kernel_moe, the row gather, its scatter-add by both routes
   (through the MoE routing's inverse maps, the route the MoE step runs,
   bitwise against the sorted route too; and on sorted ids, timed with its
   split into sort, segments and kernel) and the top-k gate from E 7 to
   65536) against its plain PyTorch version on the card, at the main
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
8. llama_serve — Llama-2-7B at full width and depth (LlamaConfig's
   defaults), bf16, flash, weights drawn on the card from ``--seed``;
   ``ServeEngine`` + ``ContinuousBatchingScheduler`` with 8 slots x 1024
   (cut from max_position 4096) over 16 seeded requests (prompts of 4-512
   tokens, 8-64 generated); 32 flash forwards a prefill; the kernel path's
   last-position prefill logits against the plain path's on the same
   weights; a profiled prefill and decode step.
9. paged_serve — ``PagedServeEngine`` (16-token pages, 64-token chunks)
   under the scheduler against the slot engine: (a) GPT-2-small in f32,
   the slice phase's burst; (b) Llama-2-7B in bf16, llama_serve's burst
   on llama_serve's serving copy against its plain path, and the chunked
   prefill's last logits (chunks of 64 and 256) against the one-pass
   prefill's; (c) a 384-token system prompt before 16 distinct turns,
   prefix sharing on against off (16 hits of 384 tokens, a lower peak of
   pages).  Every request's tokens held to the near-tie rule
   (``near_tie_divergence``), no flash launch, every page freed once a
   burst drains; TTFT, decode, chunk times, pages, hits, COW copies and
   a profiled paged prefill and decode step.
10. migrate — live KV-slot migration in this process
   (``serve/migrate.py``): ``migrate_inflight`` moves a burst whose 8
   admitted requests are mid-decode (the rest queued) from one engine to
   another on three routes, slot -> slot, slot -> paged and paged ->
   paged: (a) GPT-2-small in f32, the slice phase's burst, every stream
   token-exact against the unmigrated burst; (b) Llama-2-7B in bf16 on
   llama_serve's serving copy, its burst held to llama_serve's streams by
   the near-tie rule.  The adopter adopts one slot per mid-decode request
   and prefills only the queued prompts (its flash forwards: one a layer
   for each, on a slot engine); every slot and page is freed once the
   burst drains.  Then llama_serve's burst drained slot -> slot through
   one payload (``export_payload`` -> ``adopt_payload``) with each codec:
   the imported rows bitwise the exported ones (none, bf16) or within
   blockmax / 254 (int8, at least 1.9x fewer bytes on the wire); payload
   bytes, export, pack, unpack and import ms (and per GB), the re-prefill
   of the same contexts on the adopter and the crossover between the two.
11. train_llama — Llama-2-7B's widths at 4 layers (cut from 32), bf16,
   flash, recomputation, fused CE, AdamW, B 4 x S 4096: the kernel-vs-plain
   gate, then 10 Executor steps (2·L forwards and L of each backward kernel
   a step), step time, tokens/s, MFU, peak memory, one profiled step.
12. train_bert — BERT-base (BASELINE.json's config #3), bf16, flash,
   dropout 0.1, B 16 x S 512 from ``examples/bert_pretrain.py``'s
   synthetic stream, no attention mask (the non-causal kernels): a masked
   forward takes the plain path and launches no kernel; the kernel-vs-plain
   gate with both paths drawing dropout from the same generators; 10
   Executor steps (L of each kernel a step), step time, samples/s, MFU,
   peak memory, one profiled step.
13. train_ctr — device-resident Wide & Deep at ``bench.py`` bench_ctr's
   widths, uncut (a [33 000 000, 16] f32 table drawn on the card, 26
   sparse and 13 dense fields, hidden (256, 256), B 2048, SGD(0.01)): the
   kernel path against the plain path (``emb_impl="xla"`` and the
   deduplicate sum by ``index_add_``), one step from the same state on a
   uniform and a Zipf-skewed batch (loss and dense parameters bitwise,
   touched rows within the bound of a sequential f32 sum carried through
   the update, 10^5 untouched rows unchanged); 10 sparse steps on one batch
   (finite, falling loss; 1 gather and 1 scatter-add a step; peak memory
   under the table plus 1 GB), step time, samples/s, bench_ctr's roofline,
   one profiled step; the masked step over BucketedLoader's buckets; the
   gather (cold rows) and the deduplicate sum at the step's shapes against
   their plain versions, timed beside them, ``index_select`` /
   ``index_add_`` and the bound.
14. ps_ctr — ``WideDeep`` (Adam) on 1M-row ``PSEmbedding`` rows through
   ``examples/ctr_wdl.py``'s pipeline (prefetch, pull, step, push), B 2048,
   20 steps: bench_ctr's PS leg (sgd, no cache), then an adagrad table
   behind the HET cache (131072 rows, lfuopt); falling loss, a hit rate
   above 0; pull, step and push times and samples/s.
15. kernel_shapes — the three flash kernels at the new paths' shapes:
   (1, 32, S, 128) causal for S = 128, 512 and 1024 (the forward), (4, 32,
   4096, 128) causal and (16, 12, 512, 64) non-causal (forward and
   backward), each held against its plain version, timed beside it, SDPA
   and the bound.

The last three lines of standard output are the card's name and power
limit (as nvidia-smi gives them), the kernel report
``{"kernels": [...]}`` (all six kernels: the three flash kernels, the top-k
gate, the gather and the scatter-add, the last two with their CTR
launches and times) and ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import functools
import itertools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# GPT-2-small at the serving bench's widths (bench.py bench_serve); the
# serving burst's prompt lengths and generation counts
V, H, L, NH, FFN, MAX_LEN, SLOTS, N_REQUESTS = (
    50304, 768, 12, 12, 3072, 512, 8, 16)
GPT_PROMPT, GPT_GEN = (4, 128), (8, 64)
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
# the bf16 forward at the Llama and BERT shapes, held per output row as
# the backward is (an absolute bound is blind in the last rows of a long
# causal sequence), in TOL_D's form.  The kernel rounds each p to bf16
# against its running max, the plain version against the final one: each
# p may land one bf16 ulp apart, and the sum moves an output element by
# up to 2^-8 of sum_j p_j |v_j|, which exceeds the row's largest |O| where
# the row's terms cancel.  Over 6-13 M elements the tail of that reaches
# 2^-8 of the row max: TOL_D read 0.988 of its limit on an H100 at (1, 32,
# 1024, 128), and an emulation of the kernel's per-tile rounding on the
# CPU 1.13 at (16, 12, 512, 64).  A row term of 2^-7 keeps a margin of
# about two (0.49-0.61 in that emulation over three seeds) and refuses
# outputs 10 % off in the last query tile at S 4096.
TOL_F = {torch.bfloat16: (2 ** -16, 2 ** -7, 2 ** -7)}
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

# Llama-2-7B (LlamaConfig's defaults; hetu_tpu/models/llama.py:31-45)
LLAMA_V, LLAMA_H, LLAMA_L, LLAMA_NH, LLAMA_FFN, LLAMA_P = (
    32000, 4096, 32, 32, 11008, 4096)
LLAMA_HEAD_DIM = LLAMA_H // LLAMA_NH  # 128
# serving: 8 slots x 1024 (cut from max_position 4096: a 4.3 GB cache),
# one closed burst of 16 requests
LLAMA_SLOTS, LLAMA_MAX_LEN, LLAMA_REQUESTS = 8, 1024, 16
LLAMA_PROMPT, LLAMA_GEN = (4, 512), (8, 64)
LLAMA_FWD_S = (128, 512, 1024)  # the forward timed at (1, 32, S, 128)
# kernel path vs plain path, last-position prefill logits of the bf16
# Llama-2-7B, as a share of the largest |logit|: the two paths round p at
# other points, about one bf16 ulp (2^-8 relative) of each layer's
# attention output; added up in quadrature over 32 layers that is about
# 2.2e-2 of the residual stream, which the final RMSNorm and the head
# carry into the logits.  5e-2 leaves a margin of two over that estimate.
TOL_LLAMA_LOGITS = 5e-2
# paged serving: the pool's page of 16 tokens, the default chunk (4 pages).
# The near-tie rule's bound for f32 GPT-2-small: f32's unit roundoff 2^-24,
# times sqrt(768) products in each sum, times 12 layers (about 2e-5), with
# a margin of five; it is also TOL_O[float32].  bf16 Llama-2-7B is held to
# TOL_LLAMA_LOGITS.  The shared system prompt: 384 tokens (24 whole
# pages), a distinct user turn of 16-128 tokens for each of 16 requests,
# 8-64 generated each.  The chunked prefill is held at the model level at
# these prompt lengths and chunk sizes.
PAGE_SIZE = 16
TOL_F32_LOGITS = 1e-4
SYS_PROMPT, SYS_SUFFIX, SYS_GEN, SYS_REQUESTS = 384, (16, 128), (8, 64), 16
CHUNK_CHECK_PROMPTS, CHUNK_CHECK_SIZES = (7, 100, 300, 512), (64, 256)
# migration: the source's scheduler steps before every in-flight request
# moves (a slot engine's 8 admitted requests then hold 5 tokens each, none
# finished: 8 generated at least; a paged source steps on until its
# chunked prefills are done, at most 8 chunks of 64); a paged source's
# chunk budget a step, so that every prefill in flight advances a chunk
# each step; the drain's codecs
MIGRATE_STEPS, MIGRATE_CHUNKS = 4, 64
MIGRATE_CODECS = ("none", "bf16", "int8")
# training: Llama-2-7B's widths, depth cut to 4 layers (f32 weights,
# gradients and AdamW's two slots: 17 GB; at 32 layers 108 GB), at the
# config's max_position and bench_gpt's 16384 tokens a step
LLAMA_TRAIN_L, LLAMA_TRAIN_B, LLAMA_TRAIN_S = 4, 4, 4096
LLAMA_STEPS, LLAMA_LR = 10, 1e-4

# BERT-base (BertConfig's defaults; BASELINE.json's config #3), B 16 x S 512
BERT_V, BERT_H, BERT_L, BERT_NH, BERT_FFN, BERT_P = (
    30522, 768, 12, 12, 3072, 512)
BERT_B, BERT_S, BERT_STEPS, BERT_LR, BERT_WD, BERT_DROPOUT = (
    16, 512, 10, 1e-4, 0.01, 0.1)

# CTR: bench.py bench_ctr's Wide & Deep at the scale of Criteo-Kaggle's
# hashed vocabulary (BASELINE.json's config #4), uncut: a [33M, 16] f32
# table on the card (2.11 GB), 26 sparse fields, 13 dense, hidden (256,
# 256), B 2048, SGD(0.01); the masked step over BucketedLoader's buckets of
# CTR_MASKED_SIZES; one batch of Zipf-skewed ids (a = 1.2, clipped to V)
# for long duplicate runs.  The PS leg: WideDeep with Adam(1e-3) on a
# 1M-row PSEmbedding (bench_ctr's PS leg: sgd, lr 0.01; then the example's
# adagrad table, lr 0.05, behind a 131072-row lfuopt HET cache)
CTR_V, CTR_F, CTR_DIM, CTR_DENSE, CTR_HIDDEN = (
    33_000_000, 26, 16, 13, (256, 256))
CTR_B, CTR_STEPS, CTR_LR, CTR_ZIPF_A = 2048, 10, 0.01, 1.2
CTR_MASKED_SIZES = (2048, 1500, 700, 37)
CTR_UNTOUCHED_SAMPLE = 100_000
CTR_PS_V, CTR_PS_CACHE, CTR_PS_STEPS, CTR_PS_LR = 1_000_000, 131072, 20, 1e-3
CTR_GATHER_SETS = 32  # id sets the gather's timing cycles through

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


def grad_tolerance_share(got, ref, tol=TOL_D):
    """The largest share of its tolerance (``tol``: ``TOL_D`` for the
    gradients, ``TOL_F`` for the forward's output) that any element of
    ``got`` uses against ``ref`` (both ``[..., rows, D]``): at most 1
    passes.  Where ``ref`` is all zero, ``got`` must be too."""
    atol, atol_row, rtol = tol[ref.dtype]
    r = ref.float().abs()
    diff = (got.float() - ref.float()).abs()
    limit = atol * r.max() + atol_row * r.amax(-1, keepdim=True) + rtol * r
    share = torch.where(limit > 0, diff / limit.clamp_min(torch.finfo(
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


def burst(g, vocab, n, prompt_len, gen):
    """``n`` requests' (prompt, max_tokens), drawn from ``g``: a prompt
    length in the inclusive range ``prompt_len``, that many tokens of
    ``vocab``, then a generation count in the inclusive range ``gen``."""
    out = []
    for _ in range(n):
        prompt = [int(t) for t in g.integers(
            0, vocab, int(g.integers(prompt_len[0], prompt_len[1] + 1)))]
        out.append((prompt, int(g.integers(gen[0], gen[1] + 1))))
    return out


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
    requests = [Request(prompt=p, max_tokens=m) for p, m in burst(
        g, V, N_REQUESTS, GPT_PROMPT, GPT_GEN)]
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


def phase_profile(engine, card, steps=20, vocab=V, tag=""):
    """Where the time of one serving step goes: the host clock around
    ``steps`` prefills (bucket 128) and ``steps`` decode steps (all slots
    active), then the same windows again under torch.profiler for the
    card's busy time and the kernels that take it.  The busy share divides
    the profiled busy time by the unprofiled wall time (the profiler slows
    the host, not the kernels); both unprofiled windows run before the
    profiler first starts.  Prompts draw from ``vocab``; ``tag`` prefixes
    the windows' names."""
    from torch.profiler import ProfilerActivity, profile
    g = np.random.default_rng(1)
    prompt = [int(t) for t in g.integers(0, vocab, 100)]
    slots = [engine.alloc_slot() for _ in range(engine.cache.num_slots)]
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
        _profile_table(prof, tag + name, card, wall_us[name], steps)
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
    """The port's own kernels (flash; gather, scatter-add and gate),
    cuBLAS's GEMMs, copies and fills, and the rest (PyTorch's elementwise
    and reduction kernels)."""
    if _short(kernel).startswith(("flash_fwd_", "flash_bwd_")):
        return "flash kernels"
    if _short(kernel).startswith(("gather_kernel", "scatter_add_kernel",
                                  "topk_small_kernel", "topk_group_kernel",
                                  "topk_wide_kernel")):
        return "gather, scatter-add and gate kernels"
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


def _loss_and_grads(model, batch, fn=None, gen=None):
    """The training loss of ``batch`` under ``fn`` (default: the model's
    ``lm_loss_fn()``), dropout drawn from ``gen``, and every parameter's
    gradient."""
    params = dict(model.named_parameters())
    fn = model.lm_loss_fn() if fn is None else fn
    loss, _ = fn(params, {}, batch, gen, True)
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
    tensor or a number), and NaNs must sit where the reference has them;
    without one the gate is bitwise, and any difference uses an infinite
    share."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        return float("inf")
    if tol is None:
        return 0.0 if torch.equal(_bits(got), _bits(ref)) else float("inf")
    diff = (got.double() - ref.double()).abs()
    # a NaN where the reference has one agrees (the softmax of a row of
    # -inf); a NaN anywhere else uses an infinite share
    diff = torch.where(got.isnan() & ref.isnan(), 0.0, diff)
    tol = torch.as_tensor(tol, dtype=torch.float64, device=diff.device)
    share = torch.where(tol > 0, diff / tol.clamp_min(1e-300),
                        torch.where(diff > 0, float("inf"), 0.0))
    share = share.nan_to_num(nan=float("inf"))
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
    """The path's row ids from seeded random logits, as ``MoELayer`` makes
    them: ``slot_token [E*C]`` (-1 for an empty slot) and ``token_slot
    [T*k]`` (-1 for a dropped route), the dispatch's and the combine's
    gather ids; and their inverse maps, ``token_slot [T, k]`` and
    ``slot_route [E*C, 1]``, which the gradients of those gathers read."""
    from hetu_tpu_torch.ops import make_slot_routes
    from hetu_tpu_torch.ops.cuda_kernels import topk_gating_plain
    logits = torch.randn(t, e, generator=gen, device=device)
    gates, idx = topk_gating_plain(logits, k)
    slot_route, token_slot, _ = make_slot_routes(gates, idx, e, capacity)
    return (slot_route // k, token_slot.reshape(-1), token_slot,
            slot_route[:, None])


def inverse_of(ids, num_rows):
    """The inverse map of any ids: ``[num_rows, m]`` int32, row r listing
    the positions i with ``ids[i] == r`` in descending order, then -1 (m
    the largest count), so that the kernel has to sort them."""
    ids = ids.long()
    valid = (ids >= 0) & (ids < num_rows)
    rows = ids[valid]
    pos = torch.arange(ids.numel(), device=ids.device)[valid]
    order = torch.argsort(rows, stable=True)
    rows, pos = rows[order], pos[order]
    counts = torch.bincount(rows, minlength=num_rows)
    col = torch.arange(rows.numel(), device=ids.device) \
        - (counts.cumsum(0) - counts)[rows]
    inv = torch.full((num_rows, max(1, int(counts.max()))), -1,
                     dtype=torch.int32, device=ids.device)
    inv[rows, col] = pos.to(torch.int32)
    return inv.sort(dim=1, descending=True).values


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
        embedding_scatter_add_inverse_plain, embedding_scatter_add_plain,
        topk_gating, topk_gating_plain,
    )
    gen = torch.Generator(device="cuda").manual_seed(2468)
    t, ec = MOE_T, MOE_E * MOE_C
    slot_token, token_slot, inv_disp, inv_comb = moe_routing(
        t, MOE_E, MOE_K, MOE_C, gen)
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

        # the scatter-add's inverse route (the MoE step's): bitwise against
        # its plain version, against the sorted route on the same ids and
        # against a second launch.  (tag, grads rows, D, dtype, ids,
        # inverse); new cases draw from a generator of their own
        gen_inv = torch.Generator(device="cuda").manual_seed(1357)
        drops = moe_routing(4096, MOE_E, MOE_K, int(0.5 * 4096 * MOE_K
                                                    / MOE_E), gen_inv)
        k4 = moe_routing(4096, MOE_E, 4, int(MOE_CF * 4096 * 4 / MOE_E),
                         gen_inv)
        small = moe_routing(512, MOE_E, MOE_K, int(MOE_CF * 512 * MOE_K
                                                   / MOE_E), gen_inv)

        def both(tag, r, d, dtypes=(torch.bfloat16, torch.float32)):
            """The dispatch's and the combine's gradient on routing r."""
            s_tok, t_slot, i_disp, i_comb = r
            return [(f"{tag} dispatch bwd", s_tok.numel(), d, dt, s_tok,
                     i_disp) for dt in dtypes] + \
                   [(f"{tag} combine bwd", t_slot.numel(), d, dt, t_slot,
                     i_comb) for dt in dtypes]

        inverses = [
            ("dispatch bwd", ec, MOE_H, torch.bfloat16, slot_token, inv_disp),
            ("combine bwd", t * MOE_K, MOE_H, torch.float32, token_slot,
             inv_comb),
            ("dispatch bwd D=768", ec, MOE_BENCH_D, torch.bfloat16,
             slot_token, inv_disp),
            ("combine bwd D=768", t * MOE_K, MOE_BENCH_D, torch.float32,
             token_slot, inv_comb),
            *both("cf 0.5 (heavy drops)", drops, MOE_H),
            *both("k=4 (m=4)", k4, MOE_H),
            *both("D=100", small, 100),
            *both("D=33", small, 33, (torch.bfloat16,)),
            ("all-empty inverse", 500, MOE_H, torch.float32,
             torch.full((500,), -1, device="cuda"),
             torch.full((64, 2), -1, dtype=torch.int32, device="cuda")),
            # any ids, up to 32 sources a row, listed in descending order
            *((f"ragged ids x~{n // 73}", n, 100, dt, ids,
               inverse_of(ids, 64))
              for n in (300, 600)
              for ids in [torch.randint(-3, 70, (n,), generator=gen_inv,
                                        device="cuda")]
              for dt in (torch.bfloat16, torch.float32)),
        ]
        for tag, n, d, dtype, ids, inv in inverses:
            grads = _rows(n, d, dtype, gen_inv)
            num_rows = inv.shape[0]
            got = embedding_scatter_add(grads, ids, num_rows, inverse=inv)
            again = embedding_scatter_add(grads, ids, num_rows, inverse=inv)
            ref = embedding_scatter_add_inverse_plain(grads, inv)
            sorted_route = embedding_scatter_add(grads, ids, num_rows)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            report("embedding_scatter_add inverse",
                   f"{tag} grads {tuple(grads.shape)} {str(dtype)[6:]} -> "
                   f"inverse {tuple(inv.shape)} (bitwise: plain, sorted "
                   f"route, two launches)", tolerance_share(got, ref), err,
                   tolerance_share(got, sorted_route) == 0.0
                   and tolerance_share(got, again) == 0.0)
            errs["scatter_inverse"] = max(errs.get("scatter_inverse", 0.0),
                                          err)

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
            # any E: one thread a token up to 32, G lanes up to 1024, a
            # warp over shared memory above, a scratch row past its size
            *((tt, e, k, dtype, f"E = {e} {str(dtype)[6:]}", "randn")
              for tt, e, k in ((4096, 32, 2), (4096, 33, 3), (1024, 300, 4),
                               (512, 1024, 2), (256, 2048, 2))
              for dtype in (torch.float32, torch.bfloat16)),
            (256, 64, 64, torch.float32, "k = E = 64", "randn"),
            (64, 20000, 2, torch.float32, "E = 20000", "randn"),
            (16, 65536, 4, torch.float32, "E = 65536 (scratch row)", "randn"),
            *((512, e, 3, torch.float32, f"rows of -inf E = {e}", "-inf")
              for e in (MOE_E, 300, 2048)),
        ]
        for tt, e, k, dtype, tag, kind in topks:
            if kind == "equal":
                logits = torch.zeros(tt, e, device="cuda", dtype=dtype)
            elif kind == "pairs":  # every value twice in each row
                half = torch.randn(tt, e // 2, generator=gen, device="cuda")
                logits = half.repeat_interleave(2, dim=1).to(dtype)
            elif kind == "-inf":
                # every fourth row all -inf (index 0 first); every other
                # row -inf but for one value, so that later passes pick
                # among -inf again
                logits = torch.randn(tt, e, generator=gen_inv,
                                     device="cuda").to(dtype)
                logits[0::4] = float("-inf")
                keep = torch.randint(0, e, (tt,), generator=gen_inv,
                                     device="cuda")
                lone = torch.full_like(logits, float("-inf"))
                lone.scatter_(1, keep[:, None], logits.gather(1,
                                                              keep[:, None]))
                logits[1::2] = lone[1::2]
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
            "scatter_inverse": [
                (lambda: embedding_scatter_add(g_disp, slot_token, t,
                                               inverse=inv_disp),
                 lambda: embedding_scatter_add_inverse_plain(g_disp,
                                                             inv_disp),
                 lambda: torch.zeros(t, MOE_H, dtype=g_disp.dtype,
                                     device="cuda").index_add_(
                     0, s_ids, g_disp),
                 scatter_bound(g_disp, slot_token, t)),
                (lambda: embedding_scatter_add(g_comb, token_slot, ec,
                                               inverse=inv_comb),
                 lambda: embedding_scatter_add_inverse_plain(g_comb,
                                                             inv_comb),
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
        # the scatter-add by route.  The sorted route's time holds the sort;
        # the inverse route's headline adds the price of its design, the
        # build of slot_route (the forward's index_put of the route ids and
        # the division that gives slot_token)
        from hetu_tpu_torch.ops.moe_ops import slot_route_of
        ts_long, within = inv_disp.long(), inv_disp >= 0
        build_ms = device_ms(
            lambda: slot_route_of(ts_long, within, ec) // MOE_K, 40)

        def slot_token_only():  # what the step built before: token ids
            st = torch.full((ec + 1,), -1, dtype=torch.int32, device="cuda")
            st[torch.where(within, ts_long, ec)] = torch.arange(
                t, dtype=torch.int32, device="cuda")[:, None].expand(t,
                                                                     MOE_K)
            return st[:ec]
        token_only_ms = device_ms(slot_token_only, 40)
        print(f"[kernel_moe] slot_route build at the step's shape "
              f"(token_slot [{t}, {MOE_K}] -> [{ec}], then // {MOE_K}): "
              f"{build_ms:.4f} ms; the slot_token build it replaces "
              f"{token_only_ms:.4f} ms [{card}]")
        sorted_route = report_ms.pop("scatter")
        sorted_route["split"] = _scatter_split(
            card, {"dispatch": (g_disp, slot_token, t),
                   "combine": (g_comb, token_slot, ec)})
        inverse = report_ms.pop("scatter_inverse")
        inverse.update(kernel_ms=inverse["ms"], slot_route_build_ms=build_ms,
                       slot_token_build_ms=token_only_ms,
                       ms=inverse["ms"] + build_ms)
        report_ms["scatter"] = dict(
            inverse, max_abs_err=max(inverse["max_abs_err"],
                                     sorted_route["max_abs_err"]),
            by_route={"inverse": dict(inverse), "sorted": sorted_route})
        print(f"[kernel_moe] scatter-add, a layer's two calls: inverse route "
              f"{inverse['kernel_ms']:.4f} ms + slot_route build "
              f"{build_ms:.4f} ms = {inverse['ms']:.4f} ms; sorted route "
              f"{sorted_route['ms']:.4f} ms; bound "
              f"{inverse['bound_ms']:.5f} ms [{card}]")
        report_ms["topk"]["by_shape"] = _topk_by_shape(card, gen)
    return report_ms


def _scatter_split(card, sites, phase="kernel_moe"):
    """The sorted route's time split, at each call's shape: the stable sort
    of the ids, the rest of ``scatter_segments`` (the searchsorted and the
    casts) and the kernel alone on precomputed segments."""
    from hetu_tpu_torch.ops.cuda_kernels.embedding import (
        _scatter_sorted, scatter_segments,
    )
    split = {}
    for site, (grads, ids, num_rows) in sites.items():
        perm, offsets = scatter_segments(ids, num_rows)
        out = torch.empty(num_rows, grads.shape[1], dtype=grads.dtype,
                          device="cuda")
        sort_ms = device_ms(lambda: torch.sort(ids.to(torch.int32),
                                               stable=True), 40)
        segments_ms = device_ms(lambda: scatter_segments(ids, num_rows), 40)
        kernel_ms = device_ms(
            lambda: _scatter_sorted(grads, perm, offsets, out), 40)
        split[site] = dict(sort_ms=sort_ms,
                           searchsorted_and_casts_ms=segments_ms - sort_ms,
                           kernel_alone_ms=kernel_ms,
                           bound_ms=scatter_bound(grads, ids, num_rows))
        print(f"[{phase}] scatter-add {site}, sorted route split: sort "
              f"{sort_ms:.4f} ms, searchsorted and casts "
              f"{segments_ms - sort_ms:.4f} ms, kernel alone "
              f"{kernel_ms:.4f} ms (bound {split[site]['bound_ms']:.5f} "
              f"ms) [{card}]")
    return split


# the gate's timed shapes: (T, E, k, dtype); the first is the MoE step's
TOPK_SHAPES = ((MOE_T, MOE_E, MOE_K, torch.float32),
               (MOE_T, 64, MOE_K, torch.float32),
               (MOE_T, 256, MOE_K, torch.bfloat16),
               (4096, 1024, MOE_K, torch.float32))


def _topk_by_shape(card, gen):
    """The gate kernel's time at each of ``TOPK_SHAPES`` beside its plain
    version, the library call and the bound."""
    from hetu_tpu_torch.ops.cuda_kernels import topk_gating, topk_gating_plain
    out = {}
    for tt, e, k, dtype in TOPK_SHAPES:
        logits = torch.randn(tt, e, generator=gen, device="cuda").to(dtype)
        m = dict(ms=device_ms(lambda: topk_gating(logits, k), 40),
                 plain_ms=device_ms(lambda: topk_gating_plain(logits, k), 10),
                 library_ms=device_ms(lambda: torch.softmax(
                     torch.topk(logits.float(), k).values, -1).to(dtype), 40),
                 bound_ms=topk_bound(tt, e, k, logits.element_size()),
                 bound_by="bytes")
        key = f"[{tt}, {e}] {str(dtype)[6:]} k {k}"
        out[key] = m
        print(f"[kernel_moe] topk_gating {key}: kernel {m['ms']:.4f} ms, "
              f"plain {m['plain_ms']:.4f} ms, library {m['library_ms']:.4f} "
              f"ms, bound {m['bound_ms']:.5f} ms [{card}]")
    return out


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


# ------------------------------------------------------ Llama and BERT

def _set_attention_impl(model, impl):
    """Point every attention layer of ``model`` at ``impl`` ("flash" or
    the plain "xla"): the same weights through the other path."""
    for m in model.modules():
        if hasattr(m, "attention_impl"):
            m.attention_impl = impl


def _flash_counters():
    from hetu_tpu_torch.ops.cuda_kernels import (
        flash_attention, flash_attention_bwd_dkdv, flash_attention_bwd_dq,
    )
    return flash_attention, flash_attention_bwd_dkdv, flash_attention_bwd_dq


def _step_stats(times):
    """Median and spread (min, max) of steps 2 onwards, in ms."""
    rest = [t * 1e3 for t in times[1:]]
    return statistics.median(rest), min(rest), max(rest)


def _llama_flops_per_token(model, seq):
    """bench.py's count adapted to the untied head: 6 x the parameters
    that multiply (all but the ``tok_emb`` gather; ``lm_head`` is one) + 12
    L H S for attention."""
    c = model.c
    n_params = sum(p.numel() for p in model.parameters())
    return (6 * (n_params - c.vocab_size * c.hidden_size)
            + 12 * c.num_layers * c.hidden_size * seq), n_params


def _bert_flops_per_token(model, seq):
    """bench.py's count for the encoder: 6 x the non-embedding parameters
    + 6 V H for the MLM head tied to ``tok_emb`` (logits at every
    position, as the reference forms them) + 12 L H S for attention."""
    c = model.c
    n_params = sum(p.numel() for p in model.parameters())
    n_emb = (c.vocab_size + c.max_position + c.type_vocab_size) \
        * c.hidden_size
    return (6 * (n_params - n_emb) + 6 * c.vocab_size * c.hidden_size
            + 12 * c.num_layers * c.hidden_size * seq), n_params


def _peak_gib(device):
    return torch.cuda.max_memory_allocated() / 2 ** 30 \
        if device == "cuda" else 0.0


def phase_llama_serve(card, seed, device="cuda"):
    """Llama-2-7B served through ServeEngine + ContinuousBatchingScheduler:
    one closed burst, the launches of the path, the kernel path against
    the plain path on the same weights."""
    from hetu_tpu_torch.models import LlamaConfig, LlamaModel
    from hetu_tpu_torch.serve import (
        ContinuousBatchingScheduler, Request, ServeEngine, ServeMetrics,
    )
    from hetu_tpu_torch.telemetry import trace

    cfg = LlamaConfig(vocab_size=LLAMA_V, hidden_size=LLAMA_H,
                      num_layers=LLAMA_L, num_heads=LLAMA_NH,
                      ffn_size=LLAMA_FFN, max_position=LLAMA_P,
                      dtype=torch.bfloat16, attention_impl="flash")
    t0 = time.perf_counter()
    # drawn on the card: 6.7 B f32 parameters would take 27 GB of host RAM
    model = LlamaModel(cfg, generator=torch.Generator(
        device=device).manual_seed(seed), device=device)
    n_params = sum(p.numel() for p in model.parameters())
    engine = ServeEngine(model, num_slots=LLAMA_SLOTS,
                         max_len=LLAMA_MAX_LEN, device=device)
    del model
    if device == "cuda":
        torch.cuda.empty_cache()
    _sync(device)
    serving_gib = sum(p.numel() * p.element_size()
                      for p in engine.model.parameters()) / 2 ** 30
    print(f"[llama_serve] Llama-2-7B V={LLAMA_V} H={LLAMA_H} L={LLAMA_L} "
          f"heads={LLAMA_NH} head_dim={LLAMA_HEAD_DIM} ffn={LLAMA_FFN} "
          f"({n_params / 1e9:.3f} B params) bf16 flash, {LLAMA_SLOTS} slots "
          f"x {LLAMA_MAX_LEN}: built in {time.perf_counter() - t0:.1f} s, "
          f"serving copy {serving_gib:.2f} GiB"
          + (f", {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the "
             f"card" if device == "cuda" else ""))

    # warm the prompt buckets the burst reaches and the decode step
    ContinuousBatchingScheduler(engine).run(
        [Request(prompt=[1] * n, max_tokens=2)
         for n in (10, 20, 40, 100, 200, 400)])

    g = np.random.default_rng(seed + 3)
    requests = [Request(prompt=p, max_tokens=m) for p, m in burst(
        g, LLAMA_V, LLAMA_REQUESTS, LLAMA_PROMPT, LLAMA_GEN)]
    metrics = ServeMetrics()
    sched = ContinuousBatchingScheduler(engine, metrics=metrics)
    tracer = trace.enable()
    counters = _flash_counters()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for c in counters:  # count this path's launches only
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
    print(f"[llama_serve] statuses: {statuses}")
    check(all(s == "ok" for s in statuses), "a request did not finish ok")
    check(all(len(r.tokens) == r.max_tokens for r in requests),
          "a request generated the wrong number of tokens")
    check(all(0 <= t < LLAMA_V for r in requests for t in r.tokens),
          "a generated token is outside the vocabulary")
    print(f"[llama_serve] flash_attention.launches = {launches}, prefills "
          f"= {len(prefills)}, layers = {LLAMA_L}")
    check(len(prefills) == LLAMA_REQUESTS, "one prefill per request "
                                           "expected")
    check(launches == LLAMA_L * len(prefills) > 0,
          "flash_attention launches != layers x prefills")
    check(bwd_dkdv == bwd_dq == 0, "serving launched a backward kernel")

    n_tok = sum(len(r.tokens) for r in requests)
    snap = metrics.snapshot()
    step_ms = statistics.median(e["dur"] for e in decodes) / 1e3
    print(f"[llama_serve] generated {n_tok} tokens in {wall:.3f} s: "
          f"{n_tok / wall:.1f} tokens/s; prompts "
          f"{sum(len(r.prompt) for r in requests)} tokens [{card}]")
    print(f"[llama_serve] TTFT p50 {snap['ttft_p50_s'] * 1e3:.2f} ms, p90 "
          f"{snap['ttft_p90_s'] * 1e3:.2f} ms [{card}]")
    print(f"[llama_serve] decode step median {step_ms:.3f} ms over "
          f"{len(decodes)} steps ({LLAMA_SLOTS} slots); peak "
          f"{_peak_gib(device):.2f} GiB allocated [{card}]")
    per_bucket = {}
    for e in prefills:
        per_bucket.setdefault(e["args"]["bucket"], []).append(e["dur"] / 1e3)
    for b in sorted(per_bucket):
        print(f"[llama_serve] prefill bucket {b}: median "
              f"{statistics.median(per_bucket[b]):.3f} ms over "
              f"{len(per_bucket[b])} prompts [{card}]")

    # the kernel path against the plain path: the same serving copy with
    # its attention layers flipped to "xla" (no second 7B model)
    worst = 0.0
    with torch.inference_mode():
        for n in (7, 100, 300, LLAMA_PROMPT[1]):
            ids = torch.tensor(g.integers(0, LLAMA_V, (1, n)), device=device)
            lk, _, _ = engine.model.prefill_with_cache(ids, last_index=n - 1)
            _set_attention_impl(engine.model, "xla")
            lp, _, _ = engine.model.prefill_with_cache(ids, last_index=n - 1)
            _set_attention_impl(engine.model, "flash")
            lk, lp = lk.float(), lp.float()
            check(lk.shape == (1, LLAMA_V) and bool(torch.isfinite(lk).all()),
                  "prefill logits are not finite [1, V]")
            share = ((lk - lp).abs().max() / lp.abs().max()).item()
            worst = max(worst, share)
            top2 = lp[0].topk(2).values
            same = int(lk[0].argmax()) == int(lp[0].argmax())
            print(f"[llama_serve] prompt {n}: kernel vs plain path logits "
                  f"max|d| / max|logit| = {share:.3e} (tol "
                  f"{TOL_LLAMA_LOGITS:g}; max|logit| "
                  f"{lp.abs().max().item():.3f}), top-2 margin "
                  f"{(top2[0] - top2[1]).item():.3e}, first token equal: "
                  f"{same}")
            check(share <= TOL_LLAMA_LOGITS, "kernel path logits disagree "
                                             "with the plain path")
    phase_profile(engine, card, steps=10, vocab=LLAMA_V, tag="llama_serve ")
    return dict(launches=launches, ttft_p50_ms=snap["ttft_p50_s"] * 1e3,
                ttft_p90_ms=snap["ttft_p90_s"] * 1e3, decode_ms=step_ms,
                tokens_per_s=n_tok / wall, logits_share=worst,
                peak_gib=_peak_gib(device),
                tokens=[r.tokens for r in requests]), engine


# ------------------------------------------------------------ paged serving

def near_tie_divergence(ref, got, logits_after, tau):
    """The near-tie rule for the two greedy streams of one request: ``ref``
    the reference path's tokens (the slot engine's, or a paged engine's
    without prefix sharing), ``got`` those of the path under test.

    While the tokens agree, go on.  At the first position ``i`` where
    ``ref`` chose s and ``got`` chose p, the plain path's logits z after
    the prompt and the agreed tokens (``logits_after(ref[:i])``, 1-D) must
    give z[s] - z[p] <= 4 tau M, M = max|z|: each engine's logits lie
    within tau M of the plain ones, so s won on one path and p on the
    other only if the slot path's gap is at most 2 tau M, and the
    recomputed z adds tau M at each of its two entries.  Later tokens are
    not compared (the histories differ).  Returns None for streams equal
    to the end, else ``(i, s, p, (z[s] - z[p]) / M)``; raises past the
    bound."""
    check(len(ref) == len(got),
          f"streams of {len(ref)} and {len(got)} tokens")
    for i, (s, p) in enumerate(zip(ref, got)):
        if s == p:
            continue
        z = torch.as_tensor(logits_after(list(ref[:i]))).double()
        share = ((z[s] - z[p]) / z.abs().max()).item()
        check(share <= 4 * tau,
              f"token {i} differs ({s} -> {p}) away from a near tie: "
              f"z[s] - z[p] = {share:.3e} of max|z|, above 4 tau = "
              f"{4 * tau:g}")
        return i, int(s), int(p), share
    return None


def shared_prompt_requests(seed, vocab):
    """A chat service's traffic: one system prompt of ``SYS_PROMPT``
    tokens, then a distinct user turn of ``SYS_SUFFIX`` tokens for each of
    ``SYS_REQUESTS`` requests, ``SYS_GEN`` generated each.  Returns the
    warm request (the system prompt and a turn of its own) and the
    burst, as (prompt, max_tokens) pairs."""
    g = np.random.default_rng(seed + 5)
    system = [int(t) for t in g.integers(0, vocab, SYS_PROMPT)]
    turns = burst(g, vocab, SYS_REQUESTS + 1, SYS_SUFFIX, SYS_GEN)
    pairs = [(system + turn, m) for turn, m in turns]
    return pairs[0], pairs[1:]


class _Served:
    """A serving copy handed to a further engine as it is: the engine's
    ``inference_copy()`` returns it, so two engines share one copy of the
    weights."""

    def __init__(self, model):
        self.c = model.c
        self._model = model

    def inference_copy(self):
        return self._model


def _serve_burst(engine, pairs, device):
    """Run (prompt, max_tokens) pairs through a fresh scheduler (and fresh
    metrics) on ``engine``.  Hard: every request ok, with max_tokens
    tokens, all in the vocabulary.  Returns the requests, wall seconds,
    trace events, the peak of pages in use (paged engines) and the
    metrics snapshot."""
    from hetu_tpu_torch.serve import (
        ContinuousBatchingScheduler, Request, ServeMetrics,
    )
    from hetu_tpu_torch.telemetry import trace

    engine.metrics = ServeMetrics()
    sched = ContinuousBatchingScheduler(engine)
    reqs = [Request(prompt=list(p), max_tokens=m) for p, m in pairs]
    paged = hasattr(engine, "begin_prefill")
    peak = 0
    tracer = trace.enable()
    _sync(device)
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    while sched.has_work():
        sched.step()
        if paged:
            peak = max(peak, engine.cache.pages_in_use)
    _sync(device)
    wall = time.perf_counter() - t0
    trace.disable()
    vocab = engine.model.c.vocab_size
    check(all(r.status == "ok" for r in reqs),
          f"a request did not finish ok: {[r.status for r in reqs]}")
    check(all(len(r.tokens) == r.max_tokens for r in reqs),
          "a request generated the wrong number of tokens")
    check(all(0 <= t < vocab for r in reqs for t in r.tokens),
          "a generated token is outside the vocabulary")
    return dict(requests=reqs, wall=wall, events=tracer.events,
                peak_pages=peak, snap=engine.metrics.snapshot())


def _burst_line(tag, name, run, card):
    """Print a burst's throughput, TTFT, decode step and (paged) chunk
    times by bucket, pages and prefix counts; returns the numbers."""
    snap, ev = run["snap"], run["events"]
    n_tok = sum(len(r.tokens) for r in run["requests"])
    decodes = [e["dur"] / 1e3 for e in ev if e["name"] == "serve.decode"]
    out = dict(tokens_per_s=n_tok / run["wall"],
               ttft_p50_ms=snap["ttft_p50_s"] * 1e3,
               ttft_p90_ms=snap["ttft_p90_s"] * 1e3,
               decode_ms=statistics.median(decodes),
               peak_pages=run["peak_pages"],
               prefix_hit_tokens=snap.get("prefix_hit_tokens", 0),
               cow_copies=snap.get("cow_copies", 0))
    print(f"[paged_serve] {tag} {name}: {n_tok} tokens in "
          f"{run['wall']:.3f} s, {out['tokens_per_s']:.1f} tokens/s; TTFT "
          f"p50 {out['ttft_p50_ms']:.2f} ms, p90 {out['ttft_p90_ms']:.2f} "
          f"ms; decode step median {out['decode_ms']:.3f} ms over "
          f"{len(decodes)} steps [{card}]")
    chunks = {}
    for e in ev:
        if e["name"] == "serve.prefill_chunk":
            chunks.setdefault(e["args"]["bucket"], []).append(e["dur"] / 1e3)
    for b in sorted(chunks):
        print(f"[paged_serve] {tag} {name}: serve.prefill_chunk bucket {b}: "
              f"median {statistics.median(chunks[b]):.3f} ms over "
              f"{len(chunks[b])} chunks [{card}]")
    if chunks:
        print(f"[paged_serve] {tag} {name}: peak pages in use "
              f"{out['peak_pages']}, prefix hits "
              f"{snap.get('prefix_hits', 0)} ({out['prefix_hit_tokens']} "
              f"tokens), COW copies {out['cow_copies']} [{card}]")
    out["chunks"] = sum(len(v) for v in chunks.values())
    out["prefills"] = sum(e["name"] == "serve.prefill" for e in ev)
    return out


def _hold_streams(tag, ref_run, got_run, logits_after, tau,
                  phase="paged_serve"):
    """The near-tie rule over every request of two runs of one burst;
    prints the counts.  Returns the diverged requests' shares."""
    shares = []
    for i, (r, q) in enumerate(zip(ref_run["requests"],
                                   got_run["requests"])):
        d = near_tie_divergence(r.tokens, q.tokens,
                                lambda agreed, r=r: logits_after(
                                    r.prompt + agreed), tau)
        if d is not None:
            print(f"[{phase}] {tag}: request {i} diverged at a near "
                  f"tie: token {d[0]} {d[1]} -> {d[2]}, (z[s] - z[p]) / M "
                  f"= {d[3]:.3e} (bound 4 tau = {4 * tau:g})")
            shares.append(d[3])
    n = len(ref_run["requests"])
    print(f"[{phase}] {tag}: {n - len(shares)} of {n} requests "
          f"token-exact to the end, {len(shares)} diverged at a near tie")
    return shares


def _warm_pairs(lengths, max_len):
    """Prompts of 1s that reach each prefill bucket a burst will, two
    tokens each (the lengths that fit ``max_len``)."""
    return [([1] * n, 2) for n in lengths if n + 2 < max_len]


def _drained(cache, tag):
    """Hard, once a burst drains: no slot holds a page, and evicting the
    prefix index returns every page to the free list with both refcounts
    at 0."""
    check(cache.num_free == cache.num_slots, f"{tag}: a slot is still held")
    check(not cache.ref_table.any(), f"{tag}: a page table ref is left")
    check(cache.pages_in_use == cache.reclaimable_pages,
          f"{tag}: a page is held by something other than the index")
    while cache._evict_one_entry():
        pass
    check(not cache.ref_index.any()
          and sorted(cache._free_pages) == list(range(1, cache.num_pages)),
          f"{tag}: the free list is not whole after the index is evicted")


def _no_flash(tag, counters):
    launches = [c.launches for c in counters]
    check(launches == [0, 0, 0],
          f"{tag}: the paged path launched flash kernels {launches}")


def _plain_logits(model, device):
    """The plain path's last-position logits after a token list."""
    def logits_after(tokens):
        ids = torch.tensor([tokens], device=device)
        with torch.inference_mode():
            lg, _, _ = model.prefill_with_cache(ids,
                                                last_index=len(tokens) - 1)
        return lg[0].float().cpu()
    return logits_after


def phase_paged_serve(card, seed, llama_engine, device="cuda"):
    """Paged serving (PagedServeEngine + the scheduler's page-budget
    admission and chunked prefill) against the slot engine: (a) GPT-2-small
    in f32, (b) Llama-2-7B in bf16 on ``llama_engine``'s serving copy, with
    a model-level check of the chunked prefill, (c) a shared system prompt
    on the same copy.  Every request ok with its tokens; streams held to
    the near-tie rule; no flash launch on the paged path; every page back
    on the free list once a burst drains."""
    from hetu_tpu_torch import interop
    from hetu_tpu_torch.models import GPTConfig, GPTModel
    from hetu_tpu_torch.serve import PagedServeEngine, ServeEngine

    counters = _flash_counters()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = {}

    # (a) GPT-2-small, f32, the plain attention path
    cfg = GPTConfig(vocab_size=V, hidden_size=H, num_layers=L, num_heads=NH,
                    ffn_size=FFN, max_position=MAX_LEN)
    model = GPTModel(cfg, device=device)
    model.load_state_dict(interop.params_from_jax(
        jax_layout_weights(seed, MAX_LEN), cfg))
    slot = ServeEngine(model, num_slots=SLOTS, max_len=MAX_LEN,
                       device=device)
    paged = PagedServeEngine(_Served(slot.model), num_slots=SLOTS,
                             max_len=MAX_LEN, page_size=PAGE_SIZE,
                             device=device)
    del model
    print(f"[paged_serve] gpt: GPT-2-small f32 xla, {SLOTS} slots x "
          f"{MAX_LEN}, page {PAGE_SIZE}, chunk {paged.prefill_chunk}, "
          f"{paged.cache.num_pages} pages")
    warm = _warm_pairs((10, 20, 40, 100), MAX_LEN)
    pairs = burst(np.random.default_rng(seed), V, N_REQUESTS, GPT_PROMPT,
                  GPT_GEN)
    for e in (slot, paged):
        _serve_burst(e, warm, device)
    ref = _serve_burst(slot, pairs, device)
    for c in counters:
        c.launches = 0
    got = _serve_burst(paged, pairs, device)
    _no_flash("gpt", counters)
    _drained(paged.cache, "gpt")
    out["gpt"] = {"slot": _burst_line("gpt", "slot", ref, card),
                  "paged": _burst_line("gpt", "paged", got, card),
                  "near_ties": _hold_streams(
                      "gpt", ref, got, _plain_logits(slot.model, device),
                      TOL_F32_LOGITS)}
    del slot, paged
    if device == "cuda":
        torch.cuda.empty_cache()

    # (b) Llama-2-7B, bf16: the slot engine's plain path against the paged
    # engine on the same serving copy
    model = llama_engine.model
    paged = PagedServeEngine(_Served(model), num_slots=LLAMA_SLOTS,
                             max_len=LLAMA_MAX_LEN, page_size=PAGE_SIZE,
                             device=device)
    pool_gib = 2 * paged.cache.k.numel() * paged.cache.k.element_size() \
        / 2 ** 30
    weight_bytes = sum(p.numel() * p.element_size()
                       for n, p in model.named_parameters() if n != "tok_emb")
    print(f"[paged_serve] llama: Llama-2-7B bf16, one serving copy for "
          f"both engines, {LLAMA_SLOTS} slots x {LLAMA_MAX_LEN}, page "
          f"{PAGE_SIZE}, chunk {paged.prefill_chunk}, "
          f"{paged.cache.num_pages} pages ({pool_gib:.2f} GiB of K and V)")
    warm = _warm_pairs((10, 20, 40, 100, 200, 400), LLAMA_MAX_LEN)
    pairs = burst(np.random.default_rng(seed + 3), LLAMA_V, LLAMA_REQUESTS,
                  LLAMA_PROMPT, LLAMA_GEN)
    _set_attention_impl(model, "xla")
    _serve_burst(llama_engine, warm, device)
    ref = _serve_burst(llama_engine, pairs, device)
    _set_attention_impl(model, "flash")
    _serve_burst(paged, warm, device)
    for c in counters:
        c.launches = 0
    got = _serve_burst(paged, pairs, device)
    _no_flash("llama", counters)
    _drained(paged.cache, "llama")
    plain = _plain_logits(model, device)
    _set_attention_impl(model, "xla")
    llama = {"slot": _burst_line("llama", "slot (xla)", ref, card),
             "paged": _burst_line("llama", "paged", got, card),
             "near_ties": _hold_streams("llama", ref, got, plain,
                                        TOL_LLAMA_LOGITS)}
    ms = weight_bytes / H100_BYTES_PER_S * 1e3
    print(f"[paged_serve] llama: reckoning: each chunk reads the "
          f"{weight_bytes / 1e9:.2f} GB of matmul weights, at least "
          f"{ms:.2f} ms at 3.35 TB/s; the burst's {llama['paged']['chunks']}"
          f" chunks at least {ms * llama['paged']['chunks']:.1f} ms against "
          f"the slot engine's {llama['slot']['prefills']} prefills at least "
          f"{ms * llama['slot']['prefills']:.1f} ms: paged TTFT is "
          f"expected above the slot engine's")

    # the chunked prefill against the one-pass prefill, model level
    g = np.random.default_rng(seed + 4)
    worst = 0.0
    with torch.inference_mode():
        for n in CHUNK_CHECK_PROMPTS:
            ids = torch.tensor(g.integers(0, LLAMA_V, (1, n)), device=device)
            want, _, _ = model.prefill_with_cache(ids, last_index=n - 1)
            want = want.float()
            m = want.abs().max()
            for chunk in CHUNK_CHECK_SIZES:
                t = -(-n // chunk) * chunk
                spec = paged.cache.spec
                kc = torch.zeros(spec.num_layers, 1, t, spec.num_kv_heads,
                                 spec.head_dim, dtype=spec.dtype,
                                 device=device)
                vc = torch.zeros_like(kc)
                padded = torch.zeros(1, t, dtype=ids.dtype, device=device)
                padded[:, :n] = ids
                for start in range(0, n, chunk):
                    lg, _, _ = model.prefill_chunk_with_cache(
                        padded[:, start:start + chunk], kc, vc, start,
                        last_index=min(chunk, n - start) - 1)
                lg = lg.float()
                check(bool(torch.isfinite(lg).all()),
                      "chunked prefill logits are not finite")
                share = ((lg - want).abs().max() / m).item()
                worst = max(worst, share)
                print(f"[paged_serve] llama: prompt {n}, chunks of {chunk}: "
                      f"chunked vs one-pass prefill logits max|d| / "
                      f"max|logit| = {share:.3e} (tol {TOL_LLAMA_LOGITS:g})")
                check(share <= TOL_LLAMA_LOGITS, "chunked prefill logits "
                                                 "disagree with the prefill")
    llama["chunk_logits_share"] = worst
    out["llama"] = llama
    del paged
    if device == "cuda":
        torch.cuda.empty_cache()

    # (c) the shared system prompt: prefix sharing on against off, both
    # on the same serving copy
    warm, pairs = shared_prompt_requests(seed, LLAMA_V)
    _set_attention_impl(model, "flash")
    runs = {}
    for sharing in (False, True):
        e = PagedServeEngine(_Served(model), num_slots=LLAMA_SLOTS,
                             max_len=LLAMA_MAX_LEN, page_size=PAGE_SIZE,
                             prefix_sharing=sharing, device=device)
        _serve_burst(e, [warm], device)
        for c in counters:
            c.launches = 0
        runs[sharing] = _serve_burst(e, pairs, device)
        _no_flash("shared prompt", counters)
        _drained(e.cache, "shared prompt")
        if sharing:
            shared_engine = e
        else:
            del e
    _set_attention_impl(model, "xla")
    snap = runs[True]["snap"]
    print(f"[paged_serve] shared prompt: {SYS_PROMPT}-token system prompt, "
          f"{SYS_REQUESTS} requests: prefix hits "
          f"{snap.get('prefix_hits', 0)}, hit tokens "
          f"{snap.get('prefix_hit_tokens', 0)} (want {SYS_REQUESTS} and "
          f"{SYS_REQUESTS * SYS_PROMPT})")
    check(snap.get("prefix_hits", 0) == SYS_REQUESTS
          and snap.get("prefix_hit_tokens", 0) == SYS_REQUESTS * SYS_PROMPT,
          "the shared system prompt was not hit by every request")
    shared = {"unshared": _burst_line("shared prompt", "sharing off",
                                      runs[False], card),
              "shared": _burst_line("shared prompt", "sharing on",
                                    runs[True], card),
              "near_ties": _hold_streams("shared prompt", runs[False],
                                         runs[True], plain,
                                         TOL_LLAMA_LOGITS)}
    check(runs[True]["peak_pages"] < runs[False]["peak_pages"],
          "prefix sharing did not lower the peak of pages in use")
    _set_attention_impl(model, "flash")
    out["shared"] = shared
    out["peak_gib"] = _peak_gib(device)
    print(f"[paged_serve] peak {out['peak_gib']:.2f} GiB allocated [{card}]")
    if device == "cuda":
        phase_profile(shared_engine, card, steps=5, vocab=LLAMA_V,
                      tag="paged_serve ")
    return out


# ----------------------------------------------------------------- migration

def _span_ms(events, name):
    """Total duration (ms) and bytes of the trace spans called ``name``."""
    spans = [e for e in events if e["name"] == name]
    return (sum(e["dur"] for e in spans) / 1e3,
            sum(e.get("args", {}).get("bytes", 0) for e in spans))


def _released(engine, tag):
    """Hard, once a burst has left ``engine``: every slot free (and, on a
    paged engine, every page back on the free list once the prefix index
    is evicted, so the next route starts on an empty index)."""
    if hasattr(engine, "begin_prefill"):
        _drained(engine.cache, tag)
    check(engine.cache.num_free == engine.cache.num_slots,
          f"{tag}: a slot is still held")


def _mid_decode(sched, reqs, tag):
    """Step ``sched`` MIGRATE_STEPS times, and on until no chunked prefill
    is in flight: then every slot must hold a request mid-decode and none
    may have finished.  Returns the mid-decode requests and the queued
    ones."""
    for r in reqs:
        sched.submit(r)
    for _ in range(MIGRATE_STEPS):
        sched.step()
    while sched._prefilling and not any(r.done.is_set() for r in reqs):
        sched.step()
    running = list(sched._running.values())
    queued = [r for r in reqs if r not in running]
    check(len(running) == sched.engine.cache.num_slots
          and all(r.tokens for r in running)
          and not any(r.done.is_set() for r in reqs),
          f"{tag}: {len(running)} of {len(reqs)} requests are mid-decode "
          f"({sum(r.done.is_set() for r in reqs)} finished) once no "
          f"prefill is in flight")
    return running, queued


def _expected_adopter_launches(engine, queued, device):
    """Flash forwards the adopter launches: one a layer for each queued
    prompt it prefills, on a slot engine whose attention is flash and on
    the card; the paged prefill launches none."""
    flash = any(getattr(m, "attention_impl", None) == "flash"
                for m in engine.model.modules())
    if device != "cuda" or not flash or hasattr(engine, "begin_prefill"):
        return 0
    return engine.model.c.num_layers * len(queued)


def _finish_route(tag, dst, s2, reqs, queued, slot_map, n_running, device,
                  counters):
    """Drain the adopter and hold what it did: every request ok, one
    adopted slot for each mid-decode request, no prefill but the queued
    prompts', their flash forwards only, every slot and page freed.
    Returns the adopter's flash launches."""
    while s2.has_work():
        s2.step()
    _sync(device)
    launches = counters[0].launches
    vocab = dst.model.c.vocab_size
    check(all(r.status == "ok" and len(r.tokens) == r.max_tokens
              for r in reqs), f"{tag}: a request did not finish ok: "
                              f"{[r.status for r in reqs]}")
    check(all(0 <= t < vocab for r in reqs for t in r.tokens),
          f"{tag}: a generated token is outside the vocabulary")
    adopted = dst.metrics.count("slots_adopted")
    prefilled = dst.metrics.count("prefill_tokens")
    want = sum(len(r.prompt) for r in queued)
    check(len(slot_map) == adopted == n_running,
          f"{tag}: {adopted} slots adopted for {n_running} mid-decode "
          f"requests")
    check(prefilled == want,
          f"{tag}: the adopter prefilled {prefilled} tokens; the queued "
          f"prompts hold {want} (a migrated request was prefilled again)")
    expect = _expected_adopter_launches(dst, queued, device)
    check(launches == expect, f"{tag}: the adopter launched {launches} "
                              f"flash forwards, not {expect}")
    _released(dst, tag)
    return launches


def _migrate_route(tag, route, src, dst, pairs, card, device, hold):
    """One burst on a scheduler over ``src``, stepped until every slot is
    mid-decode, then moved whole to a scheduler over ``dst`` by
    ``migrate_inflight`` and drained there.  ``hold(requests)`` holds the
    streams to the unmigrated burst's and returns (token-exact count,
    note); returns the route's numbers."""
    from hetu_tpu_torch.serve import (
        ContinuousBatchingScheduler, Request, ServeMetrics, migrate,
    )
    from hetu_tpu_torch.telemetry import trace

    counters = _flash_counters()
    src.metrics, dst.metrics = ServeMetrics(), ServeMetrics()
    s1 = ContinuousBatchingScheduler(src,
                                     prefill_chunks_per_step=MIGRATE_CHUNKS)
    s2 = ContinuousBatchingScheduler(dst)
    reqs = [Request(prompt=list(p), max_tokens=m) for p, m in pairs]
    for c in counters:
        c.launches = 0
    running, queued = _mid_decode(s1, reqs, f"{tag} {route}")
    src_launches = counters[0].launches
    for c in counters:
        c.launches = 0
    tracer = trace.enable()
    _sync(device)
    t0 = time.perf_counter()
    slot_map = migrate.migrate_inflight(s1, s2)
    _sync(device)
    total_ms = (time.perf_counter() - t0) * 1e3
    trace.disable()
    check(not s1.has_work(), f"{tag} {route}: the source kept work")
    _released(src, f"{tag} {route} source")
    launches = _finish_route(f"{tag} {route}", dst, s2, reqs, queued,
                             slot_map, len(running), device, counters)
    export_ms, nbytes = _span_ms(tracer.events, "serve.export_slots")
    import_ms, _ = _span_ms(tracer.events, "serve.adopt_slots")
    exact, near = hold(reqs)
    gb = nbytes / 1e9
    print(f"[migrate] {tag} {route}: {exact} of {len(reqs)} streams "
          f"token-exact{near}; {len(running)} mid-decode slots adopted "
          f"({nbytes / 1e6:.3f} MB of K/V: export {export_ms:.3f} ms "
          f"({export_ms / gb:.1f} ms/GB), import {import_ms:.3f} ms "
          f"({import_ms / gb:.1f} ms/GB), migrate_inflight "
          f"{total_ms:.3f} ms), {len(queued)} queued re-prefilled "
          f"({sum(len(r.prompt) for r in queued)} prompt tokens), adopter "
          f"flash launches {launches} [{card}]")
    return dict(exact=exact, bytes=nbytes, export_ms=export_ms,
                import_ms=import_ms, migrate_ms=total_ms,
                tokens=sum(len(r.prompt) + len(r.tokens) - 1
                           for r in running),
                launches=src_launches + launches)


def _int8_rows_ok(got, rows):
    """The int8 codec's gate on one slot's imported rows ``got`` against
    the exported ``rows`` (the same device): its f32 decode within the
    reference's bound, blockmax / 254 (+1e-7) an element, for each
    (layer, head) block, and the imported rows bitwise that decode
    rounded to the cache's type.  Returns the largest error as a share of
    the bound."""
    from hetu_tpu_torch.quantwire import q8_decode_axes, q8_encode_axes

    a = rows.float()
    dec = q8_decode_axes(*q8_encode_axes(rows, (1, 3)))
    bound = a.abs().amax(dim=(1, 3), keepdim=True) / 254 + 1e-7
    err = (dec - a).abs()
    check(bool((err <= bound).all()),
          "int8 codec: an element is off by more than blockmax / 254")
    check(torch.equal(dec.to(rows.dtype), got),
          "int8 codec: the imported rows are not the decode rounded to "
          "the cache's type")
    return (err / bound).max().item()


def _drain_codec(codec, src, dst, pairs, card, device):
    """llama_serve's burst drained from the slot engine ``src`` to the
    slot engine ``dst`` through one payload (export_payload ->
    adopt_payload -> release_exported) with ``codec``; the imported rows
    held to the exported ones before the source lets them go."""
    from hetu_tpu_torch.serve import (
        ContinuousBatchingScheduler, Request, ServeMetrics, migrate,
    )
    from hetu_tpu_torch.telemetry import trace

    tag = f"llama drain {codec}"
    counters = _flash_counters()
    src.metrics, dst.metrics = ServeMetrics(), ServeMetrics()
    s1 = ContinuousBatchingScheduler(src)
    s2 = ContinuousBatchingScheduler(dst)
    reqs = [Request(prompt=list(p), max_tokens=m) for p, m in pairs]
    for c in counters:
        c.launches = 0
    running, queued = _mid_decode(s1, reqs, tag)
    src_launches = counters[0].launches
    contexts = [list(r.prompt) + list(r.tokens) for r in running]
    for c in counters:
        c.launches = 0
    tracer = trace.enable()
    _sync(device)
    t0 = time.perf_counter()
    payload, exported = migrate.export_payload(s1, codec=codec)
    _sync(device)
    t1 = time.perf_counter()
    adopted, slot_map = migrate.adopt_payload(s2, payload)
    _sync(device)
    t2 = time.perf_counter()
    trace.disable()
    worst = 0.0
    for s_slot, d_slot in slot_map.items():
        n = int(dst.cache.lengths[d_slot])
        for got, rows in ((dst.cache.k[:, d_slot, :n],
                           src.cache.k[:, s_slot, :n]),
                          (dst.cache.v[:, d_slot, :n],
                           src.cache.v[:, s_slot, :n])):
            if codec == "int8":
                worst = max(worst, _int8_rows_ok(got, rows))
            else:
                check(torch.equal(got, rows), f"{tag}: the imported rows "
                                              f"are not the exported rows")
    migrate.release_exported(s1, exported)
    _released(src, f"{tag} source")
    by_rid = {r.rid: i for i, r in enumerate(reqs)}
    order = [by_rid[r.rid] for r in adopted]
    queued_rids = {r.rid for r in queued}
    launches = _finish_route(
        tag, dst, s2, adopted, [r for r in adopted if r.rid in queued_rids],
        slot_map, len(running), device, counters)
    # the streams in submission order; tokens only, since a request
    # keeps its scheduler (and so the engine) alive through ``owner``
    streams = [None] * len(reqs)
    for i, r in zip(order, adopted):
        streams[i] = r.tokens
    reg = s1.metrics.registry.metrics()
    out = dict(payload=len(payload),
               logical=reg["serve.migrate.bytes_logical"].value,
               wire=reg["serve.migrate.bytes_wire"].value,
               export_ms=_span_ms(tracer.events, "serve.export_slots")[0],
               pack_ms=_span_ms(tracer.events, "serve.migrate.pack")[0],
               unpack_ms=_span_ms(tracer.events, "serve.migrate.unpack")[0],
               import_ms=_span_ms(tracer.events, "serve.adopt_slots")[0],
               export_payload_ms=(t1 - t0) * 1e3,
               adopt_payload_ms=(t2 - t1) * 1e3, int8_share=worst,
               mid_decode=len(running), contexts=contexts,
               launches=src_launches + launches, tokens=streams)
    gb, n = out["logical"] / 1e9, len(running)
    print(f"[migrate] {tag}: payload {out['payload'] / 1e6:.3f} MB "
          f"({out['logical'] / 1e6:.3f} MB of K/V logical, "
          f"{out['wire'] / 1e6:.3f} MB on the wire) for {n} mid-decode "
          f"slots and {len(queued)} queued records [{card}]")
    print(f"[migrate] {tag}: "
          + ", ".join(f"{stage} {out[stage + '_ms']:.3f} ms "
                      f"({out[stage + '_ms'] / gb:.1f} ms/GB, "
                      f"{out[stage + '_ms'] / n:.3f} ms a request)"
                      for stage in ("export", "pack", "unpack", "import"))
          + f"; export_payload {out['export_payload_ms']:.3f} ms, "
          f"adopt_payload {out['adopt_payload_ms']:.3f} ms"
          + (f"; int8 error up to {worst:.3f} of blockmax / 254"
             if codec == "int8" else "; imported rows bitwise the exported")
          + f" [{card}]")
    return out


def _reprefill_ms(engine, contexts, device):
    """The other arm of bench_migrate: each migrated context prefilled
    again on ``engine`` (the second of two runs), in ms."""
    out = []
    for ctx in contexts:
        slot = engine.alloc_slot()
        for _ in range(2):
            _sync(device)
            t0 = time.perf_counter()
            engine.prefill(slot, ctx)
            _sync(device)
            dt = (time.perf_counter() - t0) * 1e3
        engine.release(slot)
        out.append((len(ctx), dt))
    return out


def phase_migrate(card, seed, llama_engine, llama_ref, device="cuda"):
    """Live KV-slot migration (serve/migrate.py) between engines in this
    process, through ``migrate_inflight`` on three routes (slot -> slot,
    slot -> paged, paged -> paged): (a) GPT-2-small in f32, every stream
    token-exact against the unmigrated burst; (b) Llama-2-7B in bf16 on
    ``llama_engine``'s serving copy, streams held to ``llama_ref``
    (llama_serve's burst) by the near-tie rule; then llama_serve's burst
    drained slot -> slot through one payload with each codec, the
    imported rows bitwise (none, bf16) or within the int8 bound, and the
    re-prefill of the same contexts timed beside it.  The adopter prefills
    only the queued prompts."""
    from types import SimpleNamespace

    from hetu_tpu_torch import interop
    from hetu_tpu_torch.models import GPTConfig, GPTModel
    from hetu_tpu_torch.serve import PagedServeEngine, ServeEngine

    t_phase = time.perf_counter()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = {"launches": 0}

    def engines(model, slots, max_len):
        a = ServeEngine(model, num_slots=slots, max_len=max_len,
                        device=device)
        served = _Served(a.model)
        return (a, ServeEngine(served, num_slots=slots, max_len=max_len,
                               device=device),
                *(PagedServeEngine(served, num_slots=slots, max_len=max_len,
                                   page_size=PAGE_SIZE, device=device)
                  for _ in range(2)))

    # (a) GPT-2-small, f32, the plain attention path
    cfg = GPTConfig(vocab_size=V, hidden_size=H, num_layers=L, num_heads=NH,
                    ffn_size=FFN, max_position=MAX_LEN)
    model = GPTModel(cfg, device=device)
    model.load_state_dict(interop.params_from_jax(
        jax_layout_weights(seed, MAX_LEN), cfg))
    slot_a, slot_b, paged_a, paged_b = engines(model, SLOTS, MAX_LEN)
    del model
    pairs = burst(np.random.default_rng(seed), V, N_REQUESTS, GPT_PROMPT,
                  GPT_GEN)
    ref = [r.tokens for r in _serve_burst(slot_a, pairs, device)["requests"]]

    def exact(reqs):
        got = [r.tokens for r in reqs]
        check(got == ref, "gpt: a migrated stream differs from the "
                          "unmigrated burst")
        return len(got), ""

    out["gpt"] = {}
    for route, src, dst in (("slot->slot", slot_a, slot_b),
                            ("slot->paged", slot_a, paged_a),
                            ("paged->paged", paged_a, paged_b)):
        r = _migrate_route("gpt", route, src, dst, pairs, card, device,
                           exact)
        out["gpt"][route] = r
        out["launches"] += r["launches"]
    del slot_a, slot_b, paged_a, paged_b
    if device == "cuda":
        torch.cuda.empty_cache()

    # (b) Llama-2-7B, bf16, on llama_serve's serving copy
    model = llama_engine.model
    served = _Served(model)
    slot_b = ServeEngine(served, num_slots=LLAMA_SLOTS,
                         max_len=LLAMA_MAX_LEN, device=device)
    paged_a, paged_b = (PagedServeEngine(
        served, num_slots=LLAMA_SLOTS, max_len=LLAMA_MAX_LEN,
        page_size=PAGE_SIZE, device=device) for _ in range(2))
    pairs = burst(np.random.default_rng(seed + 3), LLAMA_V, LLAMA_REQUESTS,
                  LLAMA_PROMPT, LLAMA_GEN)
    ref_run = {"requests": [SimpleNamespace(prompt=list(p), tokens=t)
                            for (p, _), t in zip(pairs, llama_ref)]}
    plain = _plain_logits(model, device)

    def near_tie(tag):
        def hold(reqs):
            _set_attention_impl(model, "xla")
            try:
                shares = _hold_streams(tag, ref_run, {"requests": reqs},
                                       plain, TOL_LLAMA_LOGITS,
                                       phase="migrate")
            finally:
                _set_attention_impl(model, "flash")
            return len(reqs) - len(shares), \
                f" ({len(shares)} parted at a near tie)"
        return hold

    llama = out["llama"] = {}
    for route, src, dst in (("slot->slot", llama_engine, slot_b),
                            ("slot->paged", llama_engine, paged_a),
                            ("paged->paged", paged_a, paged_b)):
        r = _migrate_route("llama", route, src, dst, pairs, card, device,
                           near_tie(f"llama {route}"))
        llama[route] = r
        out["launches"] += r["launches"]
    del paged_a, paged_b

    drains = llama["drain"] = {}
    for codec in MIGRATE_CODECS:
        d = drains[codec] = _drain_codec(codec, llama_engine, slot_b, pairs,
                                         card, device)
        out["launches"] += d["launches"]
        if codec == "int8":
            n_exact = sum(a == b for a, b in zip(d["tokens"], llama_ref))
            print(f"[migrate] llama drain int8: {n_exact} of "
                  f"{len(llama_ref)} streams token-exact (no gate: the "
                  f"codec is lossy)")
        else:
            near_tie(f"llama drain {codec}")(
                [SimpleNamespace(tokens=t) for t in d["tokens"]])
    for codec in MIGRATE_CODECS:
        d = drains[codec]
        d["ratio"] = drains["none"]["wire"] / d["wire"]
        print(f"[migrate] llama drain {codec}: {d['ratio']:.3f}x fewer bytes "
              f"on the wire than none")
    check(drains["int8"]["ratio"] >= 1.9,
          "int8 codec: the payload is not 1.9x smaller than none on the "
          "bf16 cache")

    # the other arm: the migrated contexts prefilled again on the adopter
    re = _reprefill_ms(slot_b, drains["none"]["contexts"], device)
    n_tok = np.array([n for n, _ in re], float)
    ms = np.array([t for _, t in re])
    slope, icpt = np.polyfit(n_tok, ms, 1)
    llama["reprefill"] = dict(tokens=n_tok.tolist(), ms=ms.tolist(),
                              ms_per_token=slope, fixed_ms=icpt)
    print(f"[migrate] llama re-prefill of the {len(re)} migrated contexts "
          f"({int(n_tok.min())}-{int(n_tok.max())} tokens) on the adopter: "
          f"{ms.sum():.3f} ms in all, fit {icpt:.3f} ms + {slope:.5f} ms a "
          f"token [{card}]")
    tok = sum(len(c) - 1 for c in drains["none"]["contexts"])
    for name, mig in (
            ("in-process (export + import)",
             llama["slot->slot"]["export_ms"]
             + llama["slot->slot"]["import_ms"]),
            *((f"payload {c} (export + pack + unpack + import)",
               drains[c]["export_ms"] + drains[c]["pack_ms"]
               + drains[c]["unpack_ms"] + drains[c]["import_ms"])
              for c in MIGRATE_CODECS)):
        per_tok = mig / tok
        cross = icpt / (per_tok - slope) if per_tok > slope else None
        print(f"[migrate] llama migration {name}: {mig:.3f} ms for {tok} "
              f"cached tokens, {per_tok:.5f} ms a token against "
              f"re-prefill's {slope:.5f} + {icpt:.3f} ms fixed: "
              + (f"migration wins below {cross:.0f} tokens of context"
                 if cross is not None else
                 "migration wins at every context length")
              + f" [{card}]")
    out["peak_gib"] = _peak_gib(device)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[migrate] peak {out['peak_gib']:.2f} GiB allocated; phase "
          f"{out['seconds']:.1f} s; flash forwards launched on the routes "
          f"and drains {out['launches']} [{card}]")
    return out


def phase_train_llama(card, seed, device="cuda"):
    """Llama-2-7B's widths at 4 layers: the kernel-vs-plain gate, then 10
    Executor steps at B 4 x S 4096."""
    from torch.profiler import ProfilerActivity, profile

    from hetu_tpu_torch.models import LlamaConfig, LlamaModel
    from hetu_tpu_torch.optim import AdamWOptimizer
    from hetu_tpu_torch.train import Executor

    cfg = LlamaConfig(vocab_size=LLAMA_V, hidden_size=LLAMA_H,
                      num_layers=LLAMA_TRAIN_L, num_heads=LLAMA_NH,
                      ffn_size=LLAMA_FFN, max_position=LLAMA_P,
                      dtype=torch.bfloat16, attention_impl="flash",
                      remat=True, fused_ce=True, ce_row_chunk=2048)
    t0 = time.perf_counter()
    model = LlamaModel(cfg, generator=torch.Generator(
        device=device).manual_seed(seed + 1), device=device)
    g = np.random.default_rng(seed + 5)
    batch = (torch.tensor(g.integers(0, LLAMA_V, (LLAMA_TRAIN_B,
                                                  LLAMA_TRAIN_S)),
                          device=device),)
    _sync(device)
    print(f"[train_llama] Llama-2-7B widths, {LLAMA_TRAIN_L} layers (cut "
          f"from {LLAMA_L}) B={LLAMA_TRAIN_B} S={LLAMA_TRAIN_S} bf16 flash "
          f"remat fused-CE AdamW({LLAMA_LR:g}): built in "
          f"{time.perf_counter() - t0:.1f} s")

    # the kernel path against the plain path, one batch, same weights:
    # the attention layers flipped to "xla" in place
    loss_k, grads_k = _loss_and_grads(model, batch)
    _set_attention_impl(model, "xla")
    loss_p, grads_p = _loss_and_grads(model, batch)
    _set_attention_impl(model, "flash")
    check(np.isfinite(loss_k) and np.isfinite(loss_p), "a loss is not finite")
    print(f"[train_llama] kernel path vs plain path: loss {loss_k:.6f} vs "
          f"{loss_p:.6f}, |d|={abs(loss_k - loss_p):.3e} (tol "
          f"{TOL_TRAIN_LOSS:g}); peak "
          f"{_peak_gib(device):.2f} GiB allocated through the plain "
          f"path's [{LLAMA_TRAIN_B}, {LLAMA_NH}, {LLAMA_TRAIN_S}, "
          f"{LLAMA_TRAIN_S}] f32 scores")
    check(abs(loss_k - loss_p) <= TOL_TRAIN_LOSS,
          "kernel path loss disagrees with the plain path")
    grad_ratio = _check_grads("train_llama", grads_k, grads_p)
    del grads_k, grads_p
    if device == "cuda":
        torch.cuda.empty_cache()

    ex = Executor(model.lm_loss_fn(), AdamWOptimizer(LLAMA_LR), seed=seed)
    state = ex.init_state(model)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    counters = _flash_counters()
    for c in counters:  # count this path's launches only
        c.launches = 0
    losses, times = [], []
    for _ in range(LLAMA_STEPS):
        _sync(device)
        t0 = time.perf_counter()
        state, met = ex.run("train", state, batch)
        losses.append(float(met["loss"]))
        _sync(device)
        times.append(time.perf_counter() - t0)
    launches = [c.launches for c in counters]
    n = LLAMA_TRAIN_L
    print(f"[train_llama] losses: {' '.join(f'{x:.4f}' for x in losses)}")
    check(all(np.isfinite(losses)), "a training loss is not finite")
    check(losses[-1] < losses[0], "the loss did not fall")
    print(f"[train_llama] launches in {LLAMA_STEPS} steps: flash_attention "
          f"{launches[0]}, bwd_dkdv {launches[1]}, bwd_dq {launches[2]} "
          f"(a step: {[k / LLAMA_STEPS for k in launches]}, expected "
          f"[{2 * n}, {n}, {n}])")
    check(launches == [2 * n * LLAMA_STEPS, n * LLAMA_STEPS,
                       n * LLAMA_STEPS],
          "the Llama step did not launch 2L forward and L of each backward "
          "kernel a step")

    med, lo, hi = _step_stats(times)
    fpt, n_params = _llama_flops_per_token(model, LLAMA_TRAIN_S)
    tokens = LLAMA_TRAIN_B * LLAMA_TRAIN_S
    mfu = fpt * tokens / (med / 1e3) / H100_BF16_FLOP_S
    peak = _peak_gib(device)
    print(f"[train_llama] step median {med:.3f} ms (steps 2-{LLAMA_STEPS}: "
          f"{lo:.3f}-{hi:.3f}; first {times[0] * 1e3:.3f} ms), "
          f"{tokens / med * 1e3:.1f} tokens/s, MFU {100 * mfu:.2f} % "
          f"({fpt * tokens / 1e12:.2f} TFLOP a step: 6 (N - V H) + 12 L H S "
          f"a token, {n_params / 1e6:.1f} M params, over 989 TFLOP/s), "
          f"peak {peak:.2f} GiB allocated [{card}]")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, met = ex.run("train", state, batch)
        float(met["loss"])
        _sync(device)
    busy = _profile_table(prof, "train_llama step", card, med * 1e3)
    return dict(launches=launches, step_ms=med, step_spread_ms=(lo, hi),
                tokens_per_s=tokens / med * 1e3, mfu=mfu, peak_gib=peak,
                busy_share=busy, losses=losses, grad_ratio=grad_ratio)


def bert_synthetic_batch(g, b, s, vocab):
    """``examples/bert_pretrain.py``'s ``synthetic_batch`` (its lines
    31-67): a sticky-Markov stream over per-sequence 16-token topic
    vocabularies, NSP negatives switching topic at the segment boundary,
    15 % of positions masked (id 4) for MLM.  Returns (ids, token types,
    attention mask of ones, MLM labels with -1 unmasked, NSP labels)."""
    half = s // 2
    topic_a = g.integers(5, vocab, (b, 16))
    topic_b = g.integers(5, vocab, (b, 16))
    nsp = g.integers(0, 2, (b,)).astype(np.int32)
    pick = g.integers(0, 16, (b, s))
    stay = g.random((b, s)) < 0.9
    redraw = ~stay
    redraw[:, 0] = True
    redraw[nsp == 0, half] = True
    seg_vocab = np.where((np.arange(s)[None, :] < half)
                         | (nsp[:, None] == 1),
                         np.take_along_axis(topic_a, pick, 1),
                         np.take_along_axis(topic_b, pick, 1))
    last_redraw = np.maximum.accumulate(
        np.where(redraw, np.arange(s)[None, :], 0), axis=1)
    ids = np.take_along_axis(seg_vocab, last_redraw, 1).astype(np.int32)
    tok_type = (np.arange(s)[None] >= half).astype(np.int32) * np.ones(
        (b, 1), np.int32)
    attn = np.ones((b, s), np.int32)
    mlm = np.where(g.random((b, s)) < 0.15, ids, -1).astype(np.int32)
    masked_ids = np.where(mlm != -1, 4, ids)
    return masked_ids, tok_type, attn, mlm, nsp


def phase_train_bert(card, seed, device="cuda"):
    """BERT-base pretraining at B 16 x S 512 without a mask: the masked
    forward's plain path, the kernel-vs-plain gate, then 10 Executor
    steps."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from hetu_tpu_torch.models import BertConfig, BertModel
    from hetu_tpu_torch.optim import AdamWOptimizer
    from hetu_tpu_torch.train import Executor

    cfg = BertConfig(vocab_size=BERT_V, hidden_size=BERT_H,
                     num_layers=BERT_L, num_heads=BERT_NH, ffn_size=BERT_FFN,
                     max_position=BERT_P, dropout_rate=BERT_DROPOUT,
                     dtype=torch.bfloat16, attention_impl="flash")
    t0 = time.perf_counter()
    model = BertModel(cfg, generator=torch.Generator(
        device=device).manual_seed(seed + 2), device=device)
    ids, tok, attn, mlm, nsp = (
        torch.tensor(a, device=device) for a in bert_synthetic_batch(
            np.random.default_rng(seed + 6), BERT_B, BERT_S, BERT_V))
    batch = (ids, tok, None, mlm, nsp)  # no mask: the non-causal kernels
    _sync(device)
    print(f"[train_bert] BERT-base V={BERT_V} H={BERT_H} L={BERT_L} "
          f"heads={BERT_NH} ffn={BERT_FFN} B={BERT_B} S={BERT_S} bf16 flash "
          f"dropout {BERT_DROPOUT:g} AdamW({BERT_LR:g}, wd {BERT_WD:g}), "
          f"{int((mlm != -1).sum())} MLM targets: built in "
          f"{time.perf_counter() - t0:.1f} s")
    counters = _flash_counters()

    # a masked forward (the example's all-ones mask) takes the plain path
    # in every block, as the reference does: it warns, launches nothing,
    # and equals the plain layers' output bit for bit
    for c in counters:
        c.launches = 0
    with torch.no_grad(), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        seq_k = model.encode(ids, tok, attn)
        _set_attention_impl(model, "xla")
        seq_p = model.encode(ids, tok, attn)
        _set_attention_impl(model, "flash")
    masked_launches = sum(c.launches for c in counters)
    warned = sum("ignores explicit masks" in str(w.message) for w in caught)
    same = torch.equal(seq_k, seq_p)
    print(f"[train_bert] masked forward: {masked_launches} flash launches, "
          f"{warned} warnings (one a block), equal to the plain path: "
          f"{same}")
    check(masked_launches == 0, "a masked forward launched a flash kernel")
    check(warned == BERT_L, "a masked flash block did not warn")
    check(same, "the masked forward differs from the plain path")
    del seq_k, seq_p

    # the kernel path against the plain path, one batch, same weights,
    # both drawing dropout from generators of one seed
    def dropout_gen():
        return torch.Generator(device=device).manual_seed(seed + 7)

    loss_k, grads_k = _loss_and_grads(model, batch, model.pretrain_loss_fn(),
                                      dropout_gen())
    _set_attention_impl(model, "xla")
    loss_p, grads_p = _loss_and_grads(model, batch, model.pretrain_loss_fn(),
                                      dropout_gen())
    _set_attention_impl(model, "flash")
    check(np.isfinite(loss_k) and np.isfinite(loss_p), "a loss is not finite")
    print(f"[train_bert] kernel path vs plain path: loss {loss_k:.6f} vs "
          f"{loss_p:.6f}, |d|={abs(loss_k - loss_p):.3e} (tol "
          f"{TOL_TRAIN_LOSS:g})")
    check(abs(loss_k - loss_p) <= TOL_TRAIN_LOSS,
          "kernel path loss disagrees with the plain path")
    grad_ratio = _check_grads("train_bert", grads_k, grads_p)
    del grads_k, grads_p

    ex = Executor(model.pretrain_loss_fn(),
                  AdamWOptimizer(BERT_LR, weight_decay=BERT_WD), seed=seed)
    state = ex.init_state(model)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for c in counters:  # count this path's launches only
        c.launches = 0
    losses, times = [], []
    for _ in range(BERT_STEPS):
        _sync(device)
        t0 = time.perf_counter()
        state, met = ex.run("train", state, batch)
        losses.append(float(met["loss"]))
        _sync(device)
        times.append(time.perf_counter() - t0)
    launches = [c.launches for c in counters]
    print(f"[train_bert] losses: {' '.join(f'{x:.4f}' for x in losses)} "
          f"(last: mlm {float(met['mlm_loss']):.4f}, nsp "
          f"{float(met['nsp_loss']):.4f})")
    check(all(np.isfinite(losses)), "a training loss is not finite")
    check(losses[-1] < losses[0], "the loss did not fall")
    print(f"[train_bert] launches in {BERT_STEPS} steps: flash_attention "
          f"{launches[0]}, bwd_dkdv {launches[1]}, bwd_dq {launches[2]} "
          f"(a step: {[k / BERT_STEPS for k in launches]}, expected "
          f"[{BERT_L}, {BERT_L}, {BERT_L}])")
    check(launches == [BERT_L * BERT_STEPS] * 3,
          "the BERT step did not launch L of each flash kernel a step")

    med, lo, hi = _step_stats(times)
    fpt, n_params = _bert_flops_per_token(model, BERT_S)
    tokens = BERT_B * BERT_S
    mfu = fpt * tokens / (med / 1e3) / H100_BF16_FLOP_S
    peak = _peak_gib(device)
    print(f"[train_bert] step median {med:.3f} ms (steps 2-{BERT_STEPS}: "
          f"{lo:.3f}-{hi:.3f}; first {times[0] * 1e3:.3f} ms), "
          f"{BERT_B / med * 1e3:.1f} samples/s, {tokens / med * 1e3:.1f} "
          f"tokens/s, MFU {100 * mfu:.2f} % ({fpt * tokens / 1e12:.2f} TFLOP "
          f"a step: 6 N_nonemb + 6 V H + 12 L H S a token, "
          f"{n_params / 1e6:.1f} M params, over 989 TFLOP/s), peak "
          f"{peak:.2f} GiB allocated [{card}]")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, met = ex.run("train", state, batch)
        float(met["loss"])
        _sync(device)
    busy = _profile_table(prof, "train_bert step", card, med * 1e3)
    return dict(launches=launches, step_ms=med, step_spread_ms=(lo, hi),
                samples_per_s=BERT_B / med * 1e3, mfu=mfu, peak_gib=peak,
                busy_share=busy, losses=losses, grad_ratio=grad_ratio)


# ------------------------------------------------------------------- CTR

def ctr_batch(g, b, vocab):
    """``(dense_x [b, 13] f32, ids [b, 26] int32, labels [b] f32)`` drawn as
    bench.py bench_ctr draws them: ids, then dense features, then labels."""
    ids = g.integers(0, vocab, (b, CTR_F)).astype(np.int32)
    dx = g.standard_normal((b, CTR_DENSE)).astype(np.float32)
    y = g.integers(0, 2, b).astype(np.float32)
    return dx, ids, y


def zipf_ids(g, shape, vocab, a=CTR_ZIPF_A):
    """Zipf-skewed ids in [0, vocab): numpy's Zipf(a) draws, clipped to
    vocab, minus one, so id 0 is the most frequent."""
    return (np.minimum(g.zipf(a, shape), vocab) - 1).astype(np.int32)


def sgd_row_tolerance(grads, ids, touched, rows, lr):
    """The bound the kernel-vs-plain gate holds the touched table rows to
    after one sparse SGD step, ``[len(touched), D]`` f64, computed over the
    touched rows only (never ``[V, D]``).

    ``touched`` (ascending) are the distinct ids of ``ids``; ``grads [N,
    D]`` the step's row gradients; ``rows`` the touched rows before the
    step.  A row with at most two sources sums bitwise alike on both paths
    (a + b is the same in either order), so its bound is 0.  A row of n > 2
    sources with magnitudes S = sum |g| sums within (n - 1) 2^-24 S of the
    exact sum on each path, 2 (n - 1) 2^-24 S apart (the bound of a
    sequential f32 sum, as ``TOL_GATES``' note states); the update ``p +
    ((p - lr g) - p)`` carries lr times that into the row and adds four
    roundings of at most 2^-24 of |p| + 2 lr S each."""
    flat = ids.reshape(-1).to(touched.dtype)
    pos = torch.searchsorted(touched, flat)
    u, d = touched.numel(), grads.shape[-1]
    n = torch.bincount(pos, minlength=u).double()[:, None]
    s = torch.zeros(u, d, dtype=torch.float64, device=grads.device) \
        .index_add_(0, pos, grads.reshape(-1, d).double().abs())
    tol = lr * 2 * (n - 1) * 2 ** -24 * s \
        + 2 ** -22 * (rows.double().abs() + 2 * lr * s)
    return torch.where(n > 2, tol, 0.0)


def ctr_roofline(b):
    """bench.py bench_ctr's roofline (bench.py:391-395) with H100 figures:
    (bytes, flops, seconds) of three row passes of B · 26 · 16 f32 (gather
    read, sparse update read and write) over the HBM rate, plus the MLP's
    forward and backward FLOPs over the dense bf16 peak, as bench_ctr
    counts them."""
    row_bytes = 3.0 * b * CTR_F * CTR_DIM * 4
    in_dim = CTR_F * CTR_DIM + CTR_DENSE
    mlp_flops = 2.0 * b * (in_dim * CTR_HIDDEN[0] + CTR_HIDDEN[0]
                           * CTR_HIDDEN[1] + CTR_HIDDEN[1]) * 3
    return row_bytes, mlp_flops, \
        row_bytes / H100_BYTES_PER_S + mlp_flops / H100_BF16_FLOP_S


def _recording_sgd(lr):
    """SGD(lr) whose sparse path keeps the last IndexedSlices it was given
    (the step's row gradients, before deduplication)."""
    from hetu_tpu_torch.optim import SGDOptimizer

    class RecordingSGD(SGDOptimizer):
        slices = None

        def apply_indexed(self, p, slices, slots, lr, step):
            self.slices = slices
            return super().apply_indexed(p, slices, slots, lr, step)
    return RecordingSGD(lr)


def _ctr_step_once(model, batch, plain):
    """One sparse SGD step from the model's state: the kernel path, or the
    plain path (``emb_impl="xla"`` and deduplicate's segment sum by the
    scatter-add's plain version, ``index_add_``).  Returns ``(loss tensor,
    row gradients, their ids)``."""
    import hetu_tpu_torch.ops.cuda_kernels as ck
    opt = _recording_sgd(CTR_LR)
    step = model.sparse_step_fn(opt)
    if not plain:
        loss, _ = step(*batch)
    else:
        saved = model.emb.impl, ck.embedding_scatter_add
        model.emb.impl = "xla"
        ck.embedding_scatter_add = ck.embedding_scatter_add_plain
        try:
            loss, _ = step(*batch)
        finally:
            model.emb.impl, ck.embedding_scatter_add = saved
    return loss, opt.slices.values, opt.slices.indices


def _ctr_kernel_vs_plain(model, batch, tag, gen):
    """The kernel path against the plain path, one step each from the same
    state, restored after each (only the touched rows and the dense
    parameters are kept: never a second table).  Returns the gate's
    readings."""
    from hetu_tpu_torch.ops.cuda_kernels import (
        embedding_gather, embedding_scatter_add,
    )
    table = model.emb.weight
    dev = table.device
    ids = batch[1]
    touched = torch.unique(ids.reshape(-1))
    net = dict(model.net.named_parameters())
    cand = torch.randint(0, table.shape[0], (2 * CTR_UNTOUCHED_SAMPLE,),
                         generator=gen, device=dev)
    touched_rows = touched.long()
    untouched = cand[~torch.isin(cand, touched_rows)][:CTR_UNTOUCHED_SAMPLE]
    with torch.no_grad():
        rows0, others0 = table[touched_rows].clone(), table[untouched].clone()
        net0 = {n: p.detach().clone() for n, p in net.items()}

    def restore():
        with torch.no_grad():
            table[touched_rows] = rows0
            for n, p in net.items():
                p.copy_(net0[n])

    out, launches = {}, {}
    for path in ("kernel", "plain"):
        embedding_gather.launches = embedding_scatter_add.launches = 0
        loss, grads, gids = _ctr_step_once(model, batch, path == "plain")
        _sync(dev.type)
        launches[path] = (embedding_gather.launches,
                          embedding_scatter_add.launches)
        with torch.no_grad():
            out[path] = (loss, table[touched_rows].clone(),
                         {n: p.detach().clone() for n, p in net.items()})
            if path == "kernel":
                kept = tolerance_share(table[untouched], others0)
                tol = sgd_row_tolerance(grads, gids, touched, rows0, CTR_LR)
        restore()
    (loss_k, rows_k, net_k), (loss_p, rows_p, net_p) = out["kernel"], \
        out["plain"]
    runs = torch.bincount(torch.searchsorted(touched, ids.reshape(-1)))
    loss_share = tolerance_share(loss_k, loss_p)
    net_share = max(tolerance_share(net_k[n], net_p[n]) for n in net)
    row_share = tolerance_share(rows_k, rows_p, tol)
    bitwise_rows = tolerance_share(rows_k, rows_p) == 0.0
    print(f"[train_ctr] kernel path vs plain path, one step ({tag}: "
          f"{ids.numel()} ids, {touched.numel()} distinct, longest run "
          f"{int(runs.max())}, {int((runs > 2).sum())} rows of more than two "
          f"sources): loss {float(loss_k):.7f} vs {float(loss_p):.7f} "
          f"({'bitwise' if loss_share == 0 else 'DIFFERS'}); dense "
          f"parameters {'bitwise' if net_share == 0 else 'DIFFER'}; touched "
          f"rows share of the sum bound used {row_share:.3g} "
          f"({'bitwise' if bitwise_rows else 'not bitwise'}); "
          f"{untouched.numel()} untouched rows "
          f"{'unchanged' if kept == 0 else 'CHANGED'}; launches (gather, "
          f"scatter-add) kernel path {launches['kernel']}, plain path "
          f"{launches['plain']}")
    check(np.isfinite(float(loss_k)), f"the CTR loss is not finite ({tag})")
    check(loss_share == 0.0, f"kernel path loss differs from the plain "
                             f"path's ({tag})")
    check(net_share == 0.0, f"kernel path dense parameters differ from the "
                            f"plain path's ({tag})")
    check(row_share <= 1.0, f"kernel path table rows outside the bound of "
                            f"a sequential f32 sum ({tag})")
    check(kept == 0.0, f"the kernel path changed an untouched row ({tag})")
    check(launches["plain"] == (0, 0), "the plain CTR path launched a kernel")
    check(launches["kernel"] == (1, 1),
          f"the CTR step did not launch 1 gather and 1 scatter-add "
          f"({tag}: {launches['kernel']})")
    return dict(row_share=row_share, bitwise_rows=bitwise_rows,
                longest_run=int(runs.max()), distinct=touched.numel())


def _ctr_kernel_timings(card, table, grads, ids, zipf, gen):
    """The gather and the deduplicate sum at the CTR step's shapes: each
    kernel against its plain version (the deduplicate sum bitwise against
    the CPU's sequential sum, which adds in the kernel's order), then timed
    beside its plain version, the PyTorch call and the bound.  The gather
    cycles through CTR_GATHER_SETS batches of ids, so that its rows come
    cold from HBM, as a new batch finds them (its hot reading, the same ids
    every call, is printed too)."""
    from hetu_tpu_torch.ops.cuda_kernels import (
        embedding_gather, embedding_gather_plain, embedding_scatter_add,
        embedding_scatter_add_plain,
    )
    from hetu_tpu_torch.ops.embedding import IndexedSlices
    v, d = table.shape
    n = ids.numel()
    flat = ids.reshape(-1)
    for tag, id_set in (("uniform", flat), ("zipf", zipf.reshape(-1))):
        got = embedding_gather(table, id_set)
        check(tolerance_share(got, embedding_gather_plain(table, id_set))
              == 0.0, f"embedding_gather disagrees with its plain version "
                      f"at the CTR shape ({tag})")
        sl = IndexedSlices(id_set, grads, (v, d))
        dd = sl.deduplicate()
        ref = IndexedSlices(id_set.cpu(), grads.cpu(), (v, d)).deduplicate()
        ok = tolerance_share(dd.values.cpu(), ref.values) == 0.0 \
            and tolerance_share(dd.indices.cpu(), ref.indices) == 0.0
        print(f"[train_ctr] at the CTR shape ({tag} ids): gather bitwise its "
              f"plain version; deduplicate {'bitwise' if ok else 'DIFFERS'} "
              f"against the CPU's sequential sum")
        check(ok, f"deduplicate's scatter-add disagrees with the sequential "
                  f"sum at the CTR shape ({tag})")
    sets = [flat] + [torch.randint(0, v, (n,), generator=gen,
                                   device=table.device, dtype=torch.int32)
                     for _ in range(CTR_GATHER_SETS - 1)]
    cycle = itertools.cycle(sets)
    gather = dict(
        ms=device_ms(lambda: embedding_gather(table, next(cycle)), 64),
        plain_ms=device_ms(lambda: embedding_gather_plain(table,
                                                          next(cycle)), 32),
        library_ms=device_ms(lambda: torch.index_select(table, 0,
                                                        next(cycle)), 64),
        hot_ms=device_ms(lambda: embedding_gather(table, flat), 64),
        hot_library_ms=device_ms(lambda: torch.index_select(table, 0, flat),
                                 64),
        bound_ms=gather_bound(table, flat), bound_by="bytes",
        max_abs_err=0.0)
    print(f"[train_ctr] embedding_gather table [{v}, {d}] f32, {n} ids "
          f"(cold rows): kernel {gather['ms']:.4f} ms, plain "
          f"{gather['plain_ms']:.4f} ms, index_select (yardstick only) "
          f"{gather['library_ms']:.4f} ms, bound {gather['bound_ms']:.5f} ms "
          f"(bytes); the same ids every call: kernel {gather['hot_ms']:.4f} "
          f"ms, index_select {gather['hot_library_ms']:.4f} ms [{card}]")
    scatter = {}
    for tag, id_set in (("uniform", flat), ("zipf", zipf.reshape(-1))):
        sidx, order = torch.sort(id_set, stable=True)
        svals = grads[order]
        first = torch.ones(n, dtype=torch.bool, device=table.device)
        first[1:] = sidx[1:] != sidx[:-1]
        seg = torch.cumsum(first, 0, dtype=torch.int32) - 1
        sl = IndexedSlices(id_set, grads, (v, d))
        m = dict(
            ms=device_ms(lambda: embedding_scatter_add(svals, seg, n), 40),
            plain_ms=device_ms(lambda: embedding_scatter_add_plain(
                svals, seg, n), 40),
            library_ms=device_ms(lambda: torch.zeros(
                n, d, device=table.device).index_add_(0, seg, svals), 40),
            bound_ms=scatter_bound(svals, seg, n), bound_by="bytes",
            deduplicate_ms=device_ms(sl.deduplicate, 20),
            longest_run=int(torch.bincount(seg).max()), max_abs_err=0.0)
        m["split"] = _scatter_split(card, {f"deduplicate ({tag} ids)":
                                           (svals, seg, n)}, "train_ctr")
        scatter[tag] = m
        print(f"[train_ctr] deduplicate's scatter-add ({tag} ids, {n} rows "
              f"of {d} f32, longest run {m['longest_run']}): kernel "
              f"{m['ms']:.4f} ms, plain {m['plain_ms']:.4f} ms, index_add_ "
              f"(yardstick only) {m['library_ms']:.4f} ms, bound "
              f"{m['bound_ms']:.5f} ms (bytes); the whole deduplicate "
              f"{m['deduplicate_ms']:.4f} ms [{card}]")
    return gather, scatter


def phase_train_ctr(card, seed, device="cuda"):
    """Device-resident Wide & Deep at bench_ctr's widths (a [33M, 16] f32
    table on the card, B 2048, SGD): the kernel path against the plain path
    on a uniform and a Zipf batch, 10 sparse steps on one batch, the masked
    step over BucketedLoader's buckets, the kernels at the step's shapes."""
    from torch.profiler import ProfilerActivity, profile

    from hetu_tpu_torch.data.bucketing import BucketedLoader
    from hetu_tpu_torch.models import WideDeepDevice
    from hetu_tpu_torch.ops.cuda_kernels import (
        embedding_gather, embedding_scatter_add,
    )
    from hetu_tpu_torch.optim import SGDOptimizer

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed)
    model = WideDeepDevice(CTR_V, CTR_F, CTR_DIM, CTR_DENSE, CTR_HIDDEN,
                           emb_impl="auto", generator=gen, device=device)
    g = np.random.default_rng(seed)
    batch = tuple(torch.tensor(a, device=device)
                  for a in ctr_batch(g, CTR_B, CTR_V))
    zipf = torch.tensor(zipf_ids(g, (CTR_B, CTR_F), CTR_V), device=device)
    _sync(device)
    table_gb = model.emb.weight.numel() * 4 / 1e9
    print(f"[train_ctr] WideDeepDevice V={CTR_V} fields={CTR_F} "
          f"dim={CTR_DIM} dense={CTR_DENSE} hidden={CTR_HIDDEN} f32, table "
          f"{table_gb:.3f} GB drawn on the {device}, B={CTR_B}, "
          f"SGD({CTR_LR:g}): built in {time.perf_counter() - t0:.1f} s")

    gates = {"uniform": _ctr_kernel_vs_plain(model, batch, "uniform ids",
                                             gen),
             "zipf": _ctr_kernel_vs_plain(model, (batch[0], zipf, batch[2]),
                                          f"Zipf a={CTR_ZIPF_A} ids", gen)}

    step = model.sparse_step_fn(SGDOptimizer(CTR_LR))
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    embedding_gather.launches = embedding_scatter_add.launches = 0
    losses, times = [], []
    for _ in range(CTR_STEPS):
        _sync(device)
        t1 = time.perf_counter()
        loss, _ = step(*batch)
        losses.append(float(loss))
        _sync(device)
        times.append(time.perf_counter() - t1)
    launches = [embedding_gather.launches, embedding_scatter_add.launches]
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    print(f"[train_ctr] losses: {' '.join(f'{x:.5f}' for x in losses)}")
    check(all(np.isfinite(losses)), "a CTR training loss is not finite")
    check(losses[-1] < losses[0], "the CTR loss did not fall")
    print(f"[train_ctr] launches in {CTR_STEPS} steps: embedding_gather "
          f"{launches[0]}, embedding_scatter_add {launches[1]} (expected "
          f"{CTR_STEPS} each)")
    check(launches == [CTR_STEPS, CTR_STEPS], "the CTR step did not launch "
                                              "1 gather and 1 scatter-add")
    limit = model.emb.weight.numel() * 4 + 1e9
    print(f"[train_ctr] peak allocated over the timed steps "
          f"{peak / 1e9:.3f} GB (table {table_gb:.3f} GB; limit "
          f"{limit / 1e9:.3f} GB) [{card}]")
    check(peak < limit, "the CTR step allocated a table-sized tensor")
    med, lo, hi = _step_stats(times)
    row_bytes, mlp_flops, roof_s = ctr_roofline(CTR_B)
    print(f"[train_ctr] step median {med:.3f} ms (steps 2-{CTR_STEPS}: "
          f"{lo:.3f}-{hi:.3f} ms; first {times[0] * 1e3:.3f} ms), "
          f"{CTR_B / med * 1e3:.1f} samples/s; bench_ctr's roofline "
          f"({row_bytes / 1e6:.2f} MB of rows at 3.35 TB/s + "
          f"{mlp_flops / 1e9:.3f} GFLOP at 989 TFLOP/s = "
          f"{roof_s * 1e3:.5f} ms, {CTR_B / roof_s:.4g} samples/s): "
          f"{100 * roof_s * 1e3 / med:.3f} % reached [{card}]")

    masked = model.masked_step_fn(SGDOptimizer(CTR_LR))
    loader = BucketedLoader((ctr_batch(g, n, CTR_V)
                             for n in CTR_MASKED_SIZES), CTR_B)
    embedding_gather.launches = embedding_scatter_add.launches = 0
    masked_losses, buckets = [], []
    for dx, ids, y, n_valid in loader:
        loss, _ = masked(dx, ids, y, n_valid)
        masked_losses.append(float(loss))
        buckets.append((n_valid, dx.shape[0]))
    masked_launches = (embedding_gather.launches,
                       embedding_scatter_add.launches)
    print(f"[train_ctr] masked steps (n_valid, bucket) {buckets}: losses "
          f"{' '.join(f'{x:.5f}' for x in masked_losses)}; launches "
          f"{masked_launches}")
    check(all(np.isfinite(masked_losses)), "a masked CTR loss is not finite")
    check(masked_launches == (len(buckets),) * 2,
          "the masked CTR step did not launch 1 gather and 1 scatter-add")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loss, _ = step(*batch)
        float(loss)
        _sync(device)
    busy = _profile_table(prof, "train_ctr step", card, med * 1e3)

    opt = _recording_sgd(CTR_LR)
    model.sparse_step_fn(opt)(*batch)
    gather, scatter = _ctr_kernel_timings(
        card, model.emb.weight.detach(), opt.slices.values,
        batch[1], zipf, gen)
    return dict(launches=launches, step_ms=med, step_spread_ms=(lo, hi),
                samples_per_s=CTR_B / med * 1e3, peak_gb=peak / 1e9,
                busy_share=busy, losses=losses, gates=gates,
                roofline_share=roof_s * 1e3 / med, gather=gather,
                scatter=scatter)


def synthetic_ctr(n, fields, dense, vocab, seed):
    """examples/ctr_wdl.py's Criteo-shaped synthetic clickstream: clicks
    correlate with a few hidden field weights and the dense features."""
    g = np.random.default_rng(seed)
    sparse = g.integers(0, vocab, (n, fields)).astype(np.int64)
    dense_x = g.standard_normal((n, dense)).astype(np.float32)
    w_hidden = g.standard_normal(fields)
    logit = (sparse % 7 - 3) @ w_hidden * 0.2 + dense_x[:, :3].sum(-1) * 0.5
    y = (logit + g.standard_normal(n) > 0).astype(np.float32)
    return sparse, dense_x, y


def phase_ps_ctr(card, seed, device="cuda"):
    """Wide & Deep on PSEmbedding rows through examples/ctr_wdl.py's
    pipeline (prefetch, pull, step, push) at B 2048: once on bench_ctr's
    PS leg (1M rows, sgd, no cache), once behind the HET cache (adagrad,
    lfuopt, 131072 rows)."""
    from hetu_tpu_torch.models import WideDeep
    from hetu_tpu_torch.optim import AdamOptimizer
    from hetu_tpu_torch.ps import PSEmbedding

    sparse, dense_x, y = synthetic_ctr(CTR_B * 64, CTR_F, CTR_DENSE,
                                       CTR_PS_V, seed)
    n = sparse.shape[0]

    def batch_at(it):
        lo = (it * CTR_B) % (n - CTR_B)
        return sparse[lo:lo + CTR_B], dense_x[lo:lo + CTR_B], \
            y[lo:lo + CTR_B]

    runs = {"no cache": dict(optimizer="sgd", lr=0.01),
            "HET cache": dict(optimizer="adagrad", lr=0.05,
                              cache_capacity=CTR_PS_CACHE,
                              cache_policy="lfuopt", pull_bound=0)}
    out = {}
    for name, kw in runs.items():
        t0 = time.perf_counter()
        emb = PSEmbedding(CTR_PS_V, CTR_DIM, seed=seed,
                          pin_memory=device == "cuda", **kw)
        model = WideDeep(CTR_F, CTR_DIM, CTR_DENSE, CTR_HIDDEN,
                         generator=torch.Generator(device=device).manual_seed(
                             seed), device=device)
        step = model.hybrid_step_fn(AdamOptimizer(CTR_PS_LR))
        built = time.perf_counter() - t0
        losses, pulls, steps, pushes = [], [], [], []
        emb.prefetch(batch_at(0)[0])
        for it in range(CTR_PS_STEPS):
            ids, dx, yy = batch_at(it)
            t1 = time.perf_counter()
            rows = emb.pull_prefetched()
            t2 = time.perf_counter()
            loss, _, g_rows = step(dx, rows, yy)
            losses.append(float(loss))
            t3 = time.perf_counter()
            emb.push(ids, g_rows)
            t4 = time.perf_counter()
            if it + 1 < CTR_PS_STEPS:
                emb.prefetch(batch_at(it + 1)[0])
            pulls.append(t2 - t1)
            steps.append(t3 - t2)
            pushes.append(t4 - t3)
        emb.flush()
        t5 = time.perf_counter()
        emb.pull(batch_at(0)[0])
        raw_pull = time.perf_counter() - t5
        hit = emb.cache.hit_rate if emb.cache is not None else None
        emb.close()
        ms = {k: statistics.median(v[1:]) * 1e3 for k, v in
              (("pull", pulls), ("step", steps), ("push", pushes))}
        total = ms["pull"] + ms["step"] + ms["push"]
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        cache = f", cache {CTR_PS_CACHE} lfuopt" if hit is not None else ""
        print(f"[ps_ctr] {name}: PSEmbedding({CTR_PS_V}, {CTR_DIM}, "
              f"{kw['optimizer']}, lr {kw['lr']:g}{cache}) + WideDeep hidden {CTR_HIDDEN} Adam({CTR_PS_LR:g}), B "
              f"{CTR_B}, built in {built:.1f} s; losses "
              f"{' '.join(f'{x:.4f}' for x in losses)}")
        print(f"[ps_ctr] {name}: medians of steps 2-{CTR_PS_STEPS}: pull "
              f"(waited on the prefetch) {ms['pull']:.3f} ms, step (copy in, "
              f"forward, backward, Adam) {ms['step']:.3f} ms, push "
              f"{ms['push']:.3f} ms; {CTR_B / total * 1e3:.1f} samples/s; a "
              f"pull not overlapped {raw_pull * 1e3:.3f} ms"
              f"{'; hit rate %.4f' % hit if hit is not None else ''} "
              f"[{card}]")
        check(all(np.isfinite(losses)), f"a ps_ctr loss is not finite "
                                        f"({name})")
        check(last < first, f"the ps_ctr loss did not fall ({name}: mean of "
                            f"the first five {first:.4f}, of the last five "
                            f"{last:.4f})")
        if hit is not None:
            check(hit > 0, "the HET cache never hit")
        out[name] = dict(ms, samples_per_s=CTR_B / total * 1e3,
                         raw_pull_ms=raw_pull * 1e3, hit_rate=hit,
                         losses=losses)
    return out


def _fwd_case(card, shape, causal, gen, runs, tag):
    """The forward kernel at ``shape`` (bf16, contiguous): held against
    its plain version with the row-scaled ``TOL_F``, then timed beside it,
    SDPA and the bound.  ``TOL_O`` is absolute and was set for S <= 1024:
    along a causal sequence of 4096 the rms of output row i falls to about
    sqrt(e / i) (0.026 at the last row), so it would wave through errors
    of a tenth of the last rows' values."""
    from hetu_tpu_torch.ops.cuda_kernels.flash_attention import (
        flash_attention, flash_attention_plain,
    )
    b, h, s, d = shape
    q, k, v = _qkv(shape, s, torch.bfloat16, gen)
    with torch.inference_mode():
        o = flash_attention(q, k, v, causal=causal)
        o_p, _ = flash_attention_plain(q, k, v, causal=causal)
        err = (o.float() - o_p.float()).abs().max().item()
        share = grad_tolerance_share(o, o_p, TOL_F)
        ok = share <= 1.0 and bool(torch.isfinite(o).all())
        del o, o_p
        ms = device_ms(lambda: flash_attention(q, k, v, causal=causal), runs)
        plain_ms = device_ms(lambda: flash_attention_plain(
            q, k, v, causal=causal), max(3, runs // 10), 1)
        lib_ms = device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal), runs)
    bound_ms, bound_by = flash_bound(b, h, s, s, d, causal)
    tflops = flash_flops(b, h, s, s, d, causal) / ms / 1e9
    print(f"[kernel_shapes] flash_attention bf16 {tag} q{tuple(shape)} "
          f"causal={causal}: max|dO|={err:.3e} (share of TOL_F used "
          f"{share:.3g}) {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms ({tflops:.1f} "
          f"TFLOP/s, {100 * bound_ms / ms:.1f} % of the bound), plain "
          f"{plain_ms:.4f} ms, library (SDPA, yardstick only) {lib_ms:.4f} "
          f"ms, {ms / lib_ms:.2f}x SDPA, bound {bound_ms:.5f} ms "
          f"({bound_by}) [{card}]")
    check(ok, f"flash_attention disagrees with its plain version ({tag})")
    return dict(shape=list(shape), causal=causal, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                tflops=tflops, max_abs_err=err, tol_share=share)


def _bwd_case(card, shape, causal, gen, tag):
    """Both backward kernels at ``shape`` (bf16, contiguous): held against
    the plain backward with ``TOL_D``, then timed beside it, the whole
    ``flash_attention_bwd``, SDPA's backward and the bounds."""
    from hetu_tpu_torch.ops.cuda_kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_dkdv,
        flash_attention_bwd_dq, flash_attention_bwd_plain,
    )
    b, h, s, d = shape
    args = _bwd_inputs(shape, s, torch.bfloat16, causal, gen)
    with torch.no_grad():
        dk, dv = flash_attention_bwd_dkdv(*args, causal=causal)
        dq = flash_attention_bwd_dq(*args, causal=causal)
        want = flash_attention_bwd_plain(*args, causal=causal)
        errs, shares = {}, {}
        for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            errs[name] = (got.float() - ref.float()).abs().max().item()
            shares[name] = grad_tolerance_share(got, ref)
        ok = all(x <= 1.0 for x in shares.values())
        del dk, dv, dq, want
        ms = {"dkdv": device_ms(lambda: flash_attention_bwd_dkdv(
            *args, causal=causal), 20),
              "dq": device_ms(lambda: flash_attention_bwd_dq(
                  *args, causal=causal), 20)}
        plain_ms = device_ms(lambda: flash_attention_bwd_plain(
            *args, causal=causal), 3, 1)
        q, k, v, do = args[:4]
        o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        whole_ms = device_ms(lambda: flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal), 20)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qg, kg, vg, is_causal=causal)
    lib_ms = device_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), 20)
    print(f"[kernel_shapes] flash_attention_bwd bf16 {tag} q{tuple(shape)} "
          f"causal={causal}: " + " ".join(
              f"max|{n}|={e:.3e}" for n, e in errs.items())
          + " (share of TOL_D used " + " ".join(
              f"{n} {x:.3g}" for n, x in shares.items())
          + f") {'ok' if ok else 'FAIL'}; whole backward {whole_ms:.4f} ms, "
          f"plain backward {plain_ms:.4f} ms, library (SDPA backward, "
          f"yardstick only) {lib_ms:.4f} ms, {whole_ms / lib_ms:.2f}x "
          f"[{card}]")
    check(ok, f"flash backward kernels disagree with the plain backward "
              f"({tag})")
    report = {}
    for name in ("dkdv", "dq"):
        bound_ms, bound_by = flash_bound(b, h, s, s, d, causal, kernel=name)
        tflops = flash_flops(b, h, s, s, d, causal, kernel=name) \
            / ms[name] / 1e9
        report[name] = dict(
            shape=list(shape), causal=causal, ms=ms[name], plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
            tflops=tflops, whole_bwd_ms=whole_ms,
            max_abs_err=(max(errs["dk"], errs["dv"]) if name == "dkdv"
                         else errs["dq"]))
        print(f"[kernel_shapes] flash_attention_bwd_{name} bf16 {tag} "
              f"q{tuple(shape)}: kernel {ms[name]:.4f} ms ({tflops:.1f} "
              f"TFLOP/s, {100 * bound_ms / ms[name]:.1f} % of the bound), "
              f"bound {bound_ms:.5f} ms ({bound_by}) [{card}]")
    return report


def phase_kernel_shapes(card):
    """The flash kernels at the Llama and BERT paths' shapes: the
    serving forward at (1, 32, S, 128), the Llama training step's (4, 32,
    4096, 128) causal and BERT's (16, 12, 512, 64) non-causal, forward and
    backward.  Run after the model phases, with the card's memory free:
    the plain versions at (4, 32, 4096, 128) hold [4, 32, 4096, 4096] f32
    scores (8.6 GB each)."""
    gen = torch.Generator(device="cuda").manual_seed(2468)
    fwd = {}
    for s in LLAMA_FWD_S:
        fwd[f"llama_serve_s{s}"] = _fwd_case(
            card, (1, LLAMA_NH, s, LLAMA_HEAD_DIM), True, gen, 60,
            f"llama_serve S={s}")
    train = (LLAMA_TRAIN_B, LLAMA_NH, LLAMA_TRAIN_S, LLAMA_HEAD_DIM)
    bert = (BERT_B, BERT_NH, BERT_S, BERT_H // BERT_NH)
    fwd["llama_train"] = _fwd_case(card, train, True, gen, 20,
                                   "llama_train")
    torch.cuda.empty_cache()
    fwd["bert_train"] = _fwd_case(card, bert, False, gen, 20, "bert_train")
    bwd = {"llama_train": _bwd_case(card, train, True, gen, "llama_train")}
    torch.cuda.empty_cache()
    bwd["bert_train"] = _bwd_case(card, bert, False, gen, "bert_train")
    return fwd, {k: {tag: r[k] for tag, r in bwd.items()}
                 for k in ("dkdv", "dq")}


def _ctr_entry(key, moe_launches, ctr):
    """The CTR path's part of a kernel's entry in the kernels line: the
    launches by path, and the times at the CTR step's shapes."""
    if key == "gather":
        shape = (f"ctr: table [{CTR_V}, {CTR_DIM}] f32, {CTR_B * CTR_F} ids "
                 f"(cold rows, {CTR_GATHER_SETS} batches in turn)")
        return {"launches_by_path": {"train_moe": moe_launches,
                                     "ctr": ctr["launches"][0]},
                "by_shape": {shape: ctr["gather"]}}
    if key == "scatter":
        return {"launches_by_path": {"train_moe": moe_launches,
                                     "ctr": ctr["launches"][1]},
                "by_shape": {
                    f"ctr deduplicate: {CTR_B * CTR_F} rows of {CTR_DIM} f32 "
                    f"-> {CTR_B * CTR_F} segments, sorted route ({tag} ids)":
                        m for tag, m in ctr["scatter"].items()}}
    return {}


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
    torch.cuda.empty_cache()
    llama_serve, llama_engine = phase_llama_serve(card, args.seed)
    phase_paged_serve(card, args.seed, llama_engine)
    migrate = phase_migrate(card, args.seed, llama_engine,
                            llama_serve["tokens"])
    del llama_engine
    torch.cuda.empty_cache()
    llama_train = phase_train_llama(card, args.seed)
    torch.cuda.empty_cache()
    bert = phase_train_bert(card, args.seed)
    torch.cuda.empty_cache()
    ctr = phase_train_ctr(card, args.seed)
    torch.cuda.empty_cache()
    phase_ps_ctr(card, args.seed)
    shapes_fwd, shapes_bwd = phase_kernel_shapes(card)

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
                              "train": train["launches"][0],
                              "llama_serve": llama_serve["launches"],
                              "paged_serve": 0,
                              "migrate": migrate["launches"],
                              "llama_train": llama_train["launches"][0],
                              "bert_train": bert["launches"][0]},
         # the serving path's largest prompt bucket, and S = 512
         "serve_s128": timings[(1, 128)], "serve_s512": timings[(1, 512)],
         # the Llama (head dim 128) and BERT (non-causal) paths' shapes
         "by_shape": shapes_fwd},
        *({"name": f"flash_attention_bwd_{k}", "route": "cuda",
           "source": "hetu_tpu_torch/csrc/flash_attention_bwd.cu",
           "replaces": f"{src}:{line}", "launches": train["launches"][i],
           "max_abs_err": bwd[k]["max_abs_err"],
           **{f: bwd[k][f] for f in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms",
                                     "whole_bwd_ms")},
           "shape": shape, "dtype": "bfloat16",
           "launches_by_path": {"train": train["launches"][i],
                                "llama_train": llama_train["launches"][i],
                                "bert_train": bert["launches"][i]},
           "by_shape": shapes_bwd[k]}
          for i, k, line in ((1, "dkdv", 198), (2, "dq", 239))),
        *({"name": name, "route": "cuda",
           "source": f"hetu_tpu_torch/csrc/{src_file}",
           "replaces": f"hetu_tpu/ops/pallas_kernels/embedding.py:{line}",
           "launches": moe["launches"][i],
           **{f: moe_kernels[key][f] for f in (
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")},
           "per": per, **{f: moe_kernels[key][f]
                          for f in ("by_call", "by_route", "by_shape")
                          if f in moe_kernels[key]},
           **_ctr_entry(key, moe["launches"][i], ctr)}
          for name, key, i, src_file, line, per in (
              ("topk_gating", "topk", 0, "topk_gating.cu", 175,
               f"one call, logits [{MOE_T}, {MOE_E}] f32, k {MOE_K}"),
              ("embedding_gather", "gather", 1, "embedding.cu", 35,
               f"the sum of a layer's two calls: dispatch (table "
               f"[{MOE_T}, {MOE_H}] bf16, {MOE_E * MOE_C} ids) and "
               f"combine ([{MOE_E * MOE_C}, {MOE_H}] f32, "
               f"{MOE_T * MOE_K} ids)"),
              ("embedding_scatter_add", "scatter", 2, "embedding.cu", 75,
               f"the inverse route the MoE step runs: the sum of a layer's "
               f"two calls, dispatch backward ([{MOE_E * MOE_C}, {MOE_H}] "
               f"bf16 -> {MOE_T} rows, inverse [{MOE_T}, {MOE_K}]) and "
               f"combine backward ([{MOE_T * MOE_K}, {MOE_H}] f32 -> "
               f"{MOE_E * MOE_C} rows, inverse [{MOE_E * MOE_C}, 1]), plus "
               f"the slot_route build; by_route has both routes")))]}
    print(card)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
