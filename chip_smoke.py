#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``hetu_tpu_torch``) on one NVIDIA
GPU: the quickest proof that the port still builds, runs and agrees with
itself on the card.

Run from the root of the repository on a machine with an H100:

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure ends the run with a non-zero exit and
without the final result line:

1. device — the card's name and power limit; TF32 off.
2. build  — nvcc builds every CUDA kernel of the serving path.
3. kernel — each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at edge cases (stated tolerances), then
   timed with CUDA events beside its plain version, one PyTorch library
   call as a yardstick (never used by the port) and its roofline bound.
4. slice  — GPT-2-small (published widths, seeded random weights in the
   JAX package's layout, loaded through ``interop.params_from_jax``)
   served by ``ServeEngine`` + ``ContinuousBatchingScheduler`` over 16
   seeded requests; every kernel of the path must have launched, and the
   kernel path's prefill logits must agree with the plain path's.
5. profile — where a prefill step and a decode step spend their time: the
   host clock, the card's busy share and its largest kernels
   (torch.profiler).

The last three lines of standard output are the card's name and power
limit (as nvidia-smi gives them), the kernel report
``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import copy
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


def flash_bound(b, h, s_q, s_k, d, causal, elem_bytes=2):
    """Least time (ms) an H100 could take for the flash forward on these
    shapes: each input read once, each output written once, against the
    operations the causal mask leaves (two products of 2*D per visible
    (query, key) pair)."""
    if causal:
        pairs = sum(min(max(i + s_k - s_q + 1, 0), s_k) for i in range(s_q))
    else:
        pairs = s_q * s_k
    flops = 4 * d * pairs * b * h
    nbytes = (2 * s_q + 2 * s_k) * b * h * d * elem_bytes + b * h * s_q * 4
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
            (dtype, (2, NH, 128, HEAD_DIM), 128, False, "full"),
            (dtype, (1, NH, 64, HEAD_DIM), 256, True, "cross S_q<S_k"),
            (dtype, (1, NH, 100, HEAD_DIM), 100, True, "ragged"),
            (dtype, (1, NH, 100, HEAD_DIM), 100, False, "ragged full"),
            (dtype, (1, NH, 128, HEAD_DIM), 64, True, "S_q>S_k"),
            (dtype, (1, 2, 48, 128), 48, True, "D=128"),
        ]
    max_err_main = 0.0
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
            if tag == "main" and dtype == torch.bfloat16:
                max_err_main = max(max_err_main, err_o)

        timings = {}
        for s in (128, 512):
            q, k, v = _qkv((1, NH, s, HEAD_DIM), s, torch.bfloat16, gen)
            ms = device_ms(lambda: flash_attention(q, k, v, causal=True))
            plain_ms = device_ms(
                lambda: flash_attention_plain(q, k, v, causal=True))
            lib_ms = device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True))
            bound_ms, bound_by = flash_bound(1, NH, s, s, HEAD_DIM, True)
            timings[s] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
            print(f"[kernel] flash_attention bf16 causal q(1,{NH},{s},"
                  f"{HEAD_DIM}): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                  f"ms, library (SDPA, yardstick only) {lib_ms:.4f} ms, "
                  f"bound {bound_ms:.5f} ms ({bound_by}) [{card}]")
    return max_err_main, timings


def jax_layout_weights(seed: int) -> dict:
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
        "tok_emb": normal(V, H), "pos_emb": normal(MAX_LEN, H),
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
    from hetu_tpu_torch.ops.cuda_kernels import flash_attention
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
    flash_attention.launches = 0  # count the main path's launches only
    _sync(device)
    t0 = time.perf_counter()
    sched.run(requests)
    _sync(device)
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
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
        iv = _device_intervals(prof)
        if not iv:
            print(f"[profile] {name}: device time not measured (the "
                  f"profiler recorded no kernel) [{card}]")
            continue
        busy = _busy_us(iv)
        print(f"[profile] {name}: {wall_us[name] / steps / 1e3:.3f} ms a "
              f"step on the host clock, card busy {busy / steps / 1e3:.3f} "
              f"ms ({100 * busy / wall_us[name]:.1f} %), "
              f"{len(iv) / steps:.0f} device ops a step [{card}]")
        by_name = {}
        for s, e, n in iv:
            t, c = by_name.get(n, (0.0, 0))
            by_name[n] = (t + e - s, c + 1)
        for n, (t, c) in sorted(by_name.items(), key=lambda x: -x[1][0])[:8]:
            print(f"[profile] {name}:   {100 * t / busy:5.1f} % of busy "
                  f"{t / steps:8.1f} us a step x{c / steps:<5g} {_short(n)}")
    for s in slots:
        engine.release(s)


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
    launches, engine = phase_slice(card, args.seed)
    phase_profile(engine, card)

    main_s = 128  # the run's largest prompt bucket (prompts of 4..128)
    t = timings[main_s]
    report = {"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "hetu_tpu_torch/csrc/flash_attention.cu",
        "replaces": "hetu_tpu/ops/pallas_kernels/flash_attention.py:52",
        "launches": launches, "max_abs_err": max_err,
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "shape": [1, NH, main_s, HEAD_DIM], "dtype": "bfloat16",
        "at_s512": timings[512]}]}
    print(card)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
