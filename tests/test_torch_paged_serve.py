"""The paged serving slice of hetu_tpu_torch against hetu_tpu on the CPU.

The same parameters, drawn with numpy from a seed in the JAX package's
layout, go into both packages (into the port through ``interop``): GPT at
V 97, H 64, 2 layers, 4 heads, max_position 64, and a GQA Llama (4 query
heads over 2 kv heads), the sizes of ``tests/test_paged_kv.py``, whose
tests (all but migration and the mesh) are mirrored here.  Then:

* ``chunk_attention`` equals JAX's within 1e-5 (f32 ops of values ~1);
* ``prefill_chunk_with_cache`` logits, K and V equal JAX's within 1e-4
  (f32 through two layers; only the order of sums differs), from start 0,
  mid-prompt, and with a pad tail past ``max_position``;
* greedy tokens are exact: the port's ``PagedServeEngine`` against its slot
  ``ServeEngine`` and against hetu_tpu's ``PagedServeEngine``, alone and
  under the scheduler;
* the host bookkeeping (page tables, both refcounts, the free lists, the
  reservations, the prefix index and its counters) equals the reference's
  after every scheduler step of the same traffic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu.ops.attention import chunk_attention as jax_chunk_attention
from hetu_tpu.serve import ContinuousBatchingScheduler as JaxScheduler
from hetu_tpu.serve import PagedServeEngine as JaxPagedServeEngine
from hetu_tpu.serve import Request as JaxRequest
from hetu_tpu_torch import ops
from hetu_tpu_torch.ops.cuda_kernels import flash_attention
from hetu_tpu_torch.serve import (
    ContinuousBatchingScheduler, PagedServeEngine, Request, ServeEngine,
)
from test_torch_gpt_serve import _jax_model as _jax_gpt
from test_torch_gpt_serve import _torch_model as _torch_gpt
from test_torch_llama import _jax_model as _jax_llama
from test_torch_llama import _jax_vars as _jax_llama_vars
from test_torch_llama import _torch_model as _torch_llama

torch.set_num_threads(2)

TOL_OP = 1e-5  # chunk_attention, f32
TOL = 1e-4     # logits, K and V through two layers, f32
V, P = 97, 64


@pytest.fixture(scope="module")
def gpt():
    """(JAX model, JAX variables, the port's model), GPT, plain path."""
    jm, jv = _jax_gpt("xla")
    return jm, jv, _torch_gpt("xla")


@pytest.fixture(scope="module")
def llama():
    """The same for the GQA Llama."""
    return (_jax_llama("gqa", "xla"), _jax_llama_vars("gqa"),
            _torch_llama("gqa", "xla"))


def _paged(model, **kw):
    kw.setdefault("page_size", 8)
    return PagedServeEngine(model, device="cpu", **kw)


def _slot(model, **kw):
    return ServeEngine(model, device="cpu", **kw)


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(0, V, n)]


def _greedy(engine, prompt, n):
    slot = engine.alloc_slot()
    toks = [engine.prefill(slot, prompt)]
    for _ in range(n - 1):
        toks.append(engine.decode()[slot])
    engine.release(slot)
    return toks


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


# ---- chunk_attention ----

@pytest.mark.parametrize("nkv", [4, 2])
def test_chunk_attention_matches_jax(nkv):
    g = np.random.default_rng(nkv)
    b, nh, s_c, t, d = 3, 4, 8, 32, 16
    q = g.standard_normal((b, nh, s_c, d)).astype(np.float32)
    k = g.standard_normal((b, t, nkv, d)).astype(np.float32)
    v = g.standard_normal((b, t, nkv, d)).astype(np.float32)
    starts = np.array([0, 11, 24], np.int32)      # the last one at T - S_c
    want = jax_chunk_attention(*(jnp.asarray(x) for x in (q, k, v, starts)))
    got = ops.chunk_attention(*(torch.from_numpy(x)
                                for x in (q, k, v, starts)))
    _close(got, want, TOL_OP)


def test_chunk_attention_from_zero_over_the_chunk_is_causal_attention():
    g = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(g.standard_normal((2, 4, 16, 8)).astype(
        np.float32)) for _ in range(3))
    got = ops.chunk_attention(q, k.transpose(1, 2), v.transpose(1, 2),
                              torch.zeros(2, dtype=torch.int32))
    _close(got, ops.causal_attention(q, k, v), TOL_OP)


# ---- prefill_chunk_with_cache against JAX ----

def _chunk_case(jm, jv, tm, case):
    """JAX's and the port's (logits, k, v) for one chunk over one cache:
    ``start0`` a chunk of 16 into an empty cache of 32; ``mid`` a chunk of
    8 at 16 behind a prefilled prompt of 16; ``pad_tail`` 4 real tokens at
    60 padded to a chunk of 16, positions 60..75 past max_position 64, in
    a cache of 80 (the engine's extended view)."""
    c = tm.c
    nkv = getattr(c, "num_kv_heads", None) or c.num_heads
    start, s, t = {"start0": (0, 16, 32), "mid": (16, 8, 32),
                   "pad_tail": (60, 16, 80)}[case]
    g = np.random.default_rng(7)
    kc = np.zeros((c.num_layers, 1, t, nkv, c.hidden_size // c.num_heads),
                  np.float32)
    vc = np.zeros_like(kc)
    if start:
        hist = g.integers(0, V, (1, start)).astype(np.int32)
        _, k, v = jm.prefill_with_cache(jv, jnp.asarray(hist))
        kc[:, :, :start], vc[:, :, :start] = np.asarray(k), np.asarray(v)
    ids = g.integers(0, V, (1, s)).astype(np.int32)
    last = 3 if case == "pad_tail" else s - 1
    if case == "pad_tail":
        ids[:, 4:] = 0
    want = jm.prefill_chunk_with_cache(jv, jnp.asarray(ids), jnp.asarray(kc),
                                       jnp.asarray(vc), start,
                                       last_index=last)
    with torch.inference_mode():
        got = tm.prefill_chunk_with_cache(
            torch.from_numpy(ids), torch.from_numpy(kc.copy()),
            torch.from_numpy(vc.copy()), start, last_index=last)
    return want, got


@pytest.mark.parametrize("case", ["start0", "mid", "pad_tail"])
@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_prefill_chunk_logits_and_kv_match_jax(request, name, case):
    jm, jv, tm = request.getfixturevalue(name)
    want, got = _chunk_case(jm, jv, tm, case)
    assert got[0].shape == (1, V)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_a_pad_tail_past_max_position_leaves_the_real_tokens_alone(
        request, name):
    """Pad positions past the position table clamp to its last row: their
    K/V rows are finite (a NaN there would reach the real queries through
    0 * NaN in the masked product), and the real tokens' logits and rows
    are those of the same chunk without the padding, within TOL (the GEMMs
    over 16 rows and over 4 may add in another order)."""
    _, _, tm = request.getfixturevalue(name)
    c = tm.c
    nkv = getattr(c, "num_kv_heads", None) or c.num_heads
    shape = (c.num_layers, 1, 80, nkv, c.hidden_size // c.num_heads)
    g = np.random.default_rng(8)
    hist = torch.from_numpy(g.standard_normal(shape).astype(np.float32))
    hist[:, :, 60:] = 0
    ids = torch.from_numpy(g.integers(0, V, (1, 16)))
    ids[:, 4:] = 0
    outs = []
    with torch.inference_mode():
        for s in (16, 4):
            kc, vc = hist.clone(), hist.clone()
            lg, kc, vc = tm.prefill_chunk_with_cache(ids[:, :s], kc, vc, 60,
                                                     last_index=3)
            outs.append((lg, kc[:, :, :64], vc[:, :, :64]))
            assert torch.isfinite(kc).all() and torch.isfinite(vc).all()
    for padded, alone in zip(*outs):
        _close(padded, alone.numpy())


# ---- paged against slot, and against the reference's paged engine ----

@pytest.fixture(scope="module")
def jax_gpt_paged(gpt):
    jm, jv, _ = gpt
    return JaxPagedServeEngine(jm, jv, num_slots=2, max_len=64, page_size=8)


@pytest.mark.parametrize("prompt_len", [1, 5, 9, 17, 33])
def test_gpt_paged_vs_slot_parity(gpt, jax_gpt_paged, prompt_len):
    _, _, tm = gpt
    prompt = _prompt(prompt_len, prompt_len)
    want = _greedy(_slot(tm, num_slots=2, max_len=64), prompt, 12)
    assert _greedy(_paged(tm, num_slots=2, max_len=64), prompt, 12) == want
    assert _greedy(jax_gpt_paged, prompt, 12) == want


@pytest.mark.parametrize("prompt_len", [1, 7, 19])
def test_llama_gqa_paged_vs_slot_parity(llama, prompt_len):
    jm, jv, tm = llama
    prompt = _prompt(100 + prompt_len, prompt_len)
    want = _greedy(_slot(tm, num_slots=2, max_len=64), prompt, 10)
    paged = _paged(tm, num_slots=2, max_len=64)
    assert _greedy(paged, prompt, 10) == want
    assert paged.cache.k.shape[3] == tm.c.num_kv_heads
    assert _greedy(JaxPagedServeEngine(jm, jv, num_slots=2, max_len=64,
                                       page_size=8), prompt, 10) == want


def test_parity_independent_of_chunk_split(gpt):
    """One chunk or many page-aligned chunks: the same tokens, and the
    reference's with chunks of 8."""
    jm, jv, tm = gpt
    prompt = _prompt(42, 37)
    one = _greedy(_paged(tm, num_slots=1, max_len=64, prefill_chunk=64),
                  prompt, 10)
    assert _greedy(_paged(tm, num_slots=1, max_len=64, prefill_chunk=8),
                   prompt, 10) == one
    assert _greedy(JaxPagedServeEngine(jm, jv, num_slots=1, max_len=64,
                                       page_size=8, prefill_chunk=8),
                   prompt, 10) == one


# ---- prefix sharing ----

def _run(engine, prompts, max_tokens, cls=Request, sched=None):
    sched = sched or ContinuousBatchingScheduler
    reqs = [cls(prompt=list(p), max_tokens=max_tokens) for p in prompts]
    sched(engine).run(reqs)
    assert [r.status for r in reqs] == ["ok"] * len(reqs)
    return [r.tokens for r in reqs]


def test_shared_prefix_divergent_suffixes_token_exact(llama):
    """System-prompt traffic: the paged engine shares the prefix (hits
    counted) and every request decodes as on the slot engine and on the
    reference's paged engine."""
    jm, jv, tm = llama
    g = np.random.default_rng(3)
    prefix = [int(t) for t in g.integers(0, V, 17)]
    prompts = [prefix + [int(t) for t in g.integers(0, V, k)]
               for k in (5, 9, 3)]
    want = _run(_slot(tm, num_slots=4, max_len=64), prompts, 8)
    paged = _paged(tm, num_slots=4, max_len=64)
    assert _run(paged, prompts, 8) == want
    assert _run(JaxPagedServeEngine(jm, jv, num_slots=4, max_len=64,
                                    page_size=8), prompts, 8,
                JaxRequest, JaxScheduler) == want
    snap = paged.metrics.snapshot()
    # the 2nd and 3rd requests share the prefix's two full 8-token pages
    assert snap["prefix_hits"] >= 2
    assert snap["prefix_hit_tokens"] >= 2 * 16
    assert 0.0 < snap["prefix_hit_rate"] < 1.0


def test_identical_prompts_full_dedup_and_cow(gpt):
    """The second of two identical prompts shares all but one recomputed
    token, which copies the shared tail page; both decode the unshared
    tokens."""
    _, _, tm = gpt
    prompt = _prompt(5, 21)
    want = _greedy(_slot(tm, num_slots=1, max_len=64), prompt, 8)
    paged = _paged(tm, num_slots=2, max_len=64)
    assert _run(paged, [prompt, prompt], 8) == [want, want]
    assert paged.cache.cow_copies >= 1
    assert paged.cache.prefix_hit_tokens >= len(prompt) - 1
    assert paged.metrics.snapshot()["cow_copies"] == paged.cache.cow_copies


def test_cow_isolation_between_forks(gpt):
    """Requests forked off one shared prefix do not corrupt each other:
    interleaved decode equals each sequence decoded alone."""
    _, _, tm = gpt
    g = np.random.default_rng(9)
    prefix = [int(t) for t in g.integers(0, V, 16)]   # page-aligned
    sufa = [int(t) for t in g.integers(0, V, 3)]
    sufb = [int(t) for t in g.integers(0, V, 3)]
    want_a, want_b = (_greedy(_paged(tm, num_slots=1, max_len=64),
                              prefix + s, 10) for s in (sufa, sufb))
    e = _paged(tm, num_slots=2, max_len=64)
    sa = e.alloc_slot()
    ta = [e.prefill(sa, prefix + sufa)]
    sb = e.alloc_slot()
    tb = [e.prefill(sb, prefix + sufb)]  # shares the prefix pages
    for _ in range(9):
        out = e.decode()
        ta.append(out[sa])
        tb.append(out[sb])
    assert ta == want_a and tb == want_b


def test_refcount_release_on_free(gpt):
    """Freeing every slot leaves only index-held (reclaimable) pages;
    evicting the index empties the pool: no leaked page, no double
    free."""
    _, _, tm = gpt
    e = _paged(tm, num_slots=3, max_len=64)
    g = np.random.default_rng(11)
    prefix = [int(t) for t in g.integers(0, V, 16)]
    slots = []
    for k in (3, 5, 7):
        s = e.alloc_slot()
        e.prefill(s, prefix + [int(t) for t in g.integers(0, V, k)])
        slots.append(s)
    for _ in range(4):
        e.decode()
    assert e.cache.pages_in_use > 0
    for s in slots:
        e.release(s)
    c = e.cache
    assert c.pages_in_use == c.reclaimable_pages
    while c._evict_one_entry():
        pass
    assert c.pages_in_use == 0 and c.prefix_entries == 0
    assert not np.any(c.ref_table) and not np.any(c.ref_index)
    assert sorted(c._free_pages) == list(range(1, c.num_pages))


def test_double_free_raises(gpt):
    e = _paged(gpt[2], num_slots=2, max_len=64)
    s = e.alloc_slot()
    e.release(s)
    with pytest.raises(ValueError, match="double-freed"):
        e.cache.free(s)


# ---- shapes, backpressure, the chunked path under the scheduler ----

def _varied(cls):
    g = np.random.default_rng(0)
    return [cls(prompt=[int(t) for t in g.integers(0, V, int(g.integers(
        1, 40)))], max_tokens=int(g.integers(2, 12))) for _ in range(24)]


def test_bounded_shapes_and_tokens_equal_the_reference(gpt):
    """Varied traffic under the scheduler: the port's tokens are the
    reference paged engine's, the step shapes stay within the bound, and
    both engines see the same set of them."""
    jm, jv, tm = gpt
    want, got = _varied(JaxRequest), _varied(Request)
    je = JaxPagedServeEngine(jm, jv, num_slots=4, max_len=64, page_size=8)
    JaxScheduler(je).run(want)
    engine = _paged(tm, num_slots=4, max_len=64)
    ContinuousBatchingScheduler(engine).run(got)
    assert [r.status for r in got] == [r.status for r in want]
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert engine.max_executables == je.max_executables
    assert engine.compiled_executables() == je.compiled_executables() \
        <= engine.max_executables
    assert flash_attention.launches == 0


def test_page_budget_backpressure_queues_not_fails(gpt):
    """A pool far smaller than the workload QUEUES admissions; every
    request completes."""
    e = _paged(gpt[2], num_slots=4, max_len=64, num_pages=17,
               prefix_sharing=False)
    g = np.random.default_rng(1)
    prompts = [[int(t) for t in g.integers(0, V, 20)] for _ in range(8)]
    assert all(len(t) == 8 for t in _run(e, prompts, 8))


def test_chunked_prefill_interleaves_with_decode(gpt):
    """While a long prompt prefills in chunks, a decoding request gains a
    token on every step."""
    engine = _paged(gpt[2], num_slots=3, max_len=64, prefill_chunk=8)
    sch = ContinuousBatchingScheduler(engine, prefill_chunks_per_step=1)
    short = Request(prompt=[1, 2, 3], max_tokens=30)
    sch.submit(short)
    sch.step()
    before = len(short.tokens)
    long_req = Request(prompt=_prompt(2, 40), max_tokens=4)
    sch.submit(long_req)
    for i in range(4):   # 40 tokens in chunks of 8: five steps
        sch.step()
        assert len(short.tokens) == before + i + 1
        assert len(long_req.tokens) == 0
    sch.step()
    assert len(long_req.tokens) >= 1
    while sch.has_work():
        sch.step()
    assert long_req.status == "ok" and short.status == "ok"


def test_requeue_mid_chunked_prefill_re_prefills(gpt):
    """A new engine while a chunked prefill is in flight: the request
    requeues and prefills again on it, token-exact."""
    _, _, tm = gpt
    prompt = _prompt(21, 30)
    want = _greedy(_paged(tm, num_slots=1, max_len=64), prompt, 6)
    sch = ContinuousBatchingScheduler(_paged(tm, num_slots=2, max_len=64,
                                             prefill_chunk=8))
    req = Request(prompt=list(prompt), max_tokens=6)
    sch.submit(req)
    sch.step()       # admitted; the first chunk ran, the prefill did not end
    assert len(req.tokens) == 0 and sch._prefilling
    sch.replace_engine(_paged(tm, num_slots=2, max_len=64, prefill_chunk=8))
    while sch.has_work():
        sch.step()
    assert req.tokens == want and req.status == "ok"


def test_cancel_mid_chunked_prefill_frees_pages(gpt):
    engine = _paged(gpt[2], num_slots=2, max_len=64, prefill_chunk=8,
                    prefix_sharing=False)
    sch = ContinuousBatchingScheduler(engine)
    req = Request(prompt=_prompt(22, 30), max_tokens=6)
    sch.submit(req)
    sch.step()
    assert engine.cache.pages_in_use > 0
    sch.cancel(req)
    assert req.status == "cancelled"
    assert engine.cache.pages_in_use == 0
    assert engine.cache.num_free == engine.cache.num_slots


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_full_dedup_near_max_len_no_clamp_corruption(request, name):
    """A prompt of 58 of max_len 64 resubmitted: the full prefix hit
    leaves one token to recompute at 57, its chunk padded to 16 runs past
    the slot's view, and the extended view keeps it from clamping (a
    clamped start smears pad rows over real history; on the RoPE path the
    pad positions also run past the tables)."""
    _, _, tm = request.getfixturevalue(name)
    prompt = _prompt(31 if name == "gpt" else 37, 58)
    want = _greedy(_slot(tm, num_slots=1, max_len=64), prompt, 4)
    paged = _paged(tm, num_slots=2, max_len=64)
    assert _greedy(paged, prompt, 4) == want
    assert _greedy(paged, prompt, 4) == want   # the full-dedup resubmit
    assert paged.cache.prefix_hit_tokens >= len(prompt) - 1
    c = paged.cache     # the boundary chunk ran on the extended view
    assert (16, c.pages_per_slot + paged.prefill_chunk // c.page_size) \
        in paged._seen_chunk_buckets


def test_prefill_timeout_resolves_behind_slower_prefills(gpt):
    """A mid-prefill request past its deadline resolves the same step even
    when older prefills take the chunk budget."""
    import time
    engine = _paged(gpt[2], num_slots=3, max_len=64, prefill_chunk=8)
    sch = ContinuousBatchingScheduler(engine, prefill_chunks_per_step=1)
    slow = Request(prompt=_prompt(33, 40), max_tokens=4)
    doomed = Request(prompt=_prompt(34, 40), max_tokens=4, timeout_s=0.01)
    sch.submit(slow)
    sch.submit(doomed)
    sch.step()
    time.sleep(0.02)
    sch.step()
    assert doomed.status == "timeout" and doomed.done.is_set()
    while sch.has_work():
        sch.step()
    assert slow.status == "ok"


# ---- host bookkeeping, step by step against the reference ----

def _book(cache):
    return dict(
        tables=[[int(p) for p in t] for t in cache.tables],
        lengths=[int(n) for n in cache.lengths],
        ref_table=[int(n) for n in cache.ref_table],
        ref_index=[int(n) for n in cache.ref_index],
        free_pages=[int(p) for p in cache._free_pages],
        free_slots=[int(s) for s in cache._free_slots],
        reserve=[int(n) for n in cache._reserve],
        table_array=np.asarray(cache.table_array(cache.pages_per_slot)
                               ).tolist(),
        prefix=[(k, tuple(int(p) for p in e.pages), e.n_tokens)
                for k, e in cache._prefix.items()],
        counters=(cache.cow_copies, cache.prefix_hit_tokens,
                  cache.prefix_evictions))


def _shared_traffic(cls):
    g = np.random.default_rng(12)
    prefix = [int(t) for t in g.integers(0, V, 16)]
    tail = [int(t) for t in g.integers(0, V, 5)]
    prompts = [prefix + tail, prefix + [int(t) for t in g.integers(0, V, 9)],
               prefix + tail,                             # identical
               [int(t) for t in g.integers(0, V, 40)],    # long, unshared
               prefix + [int(t) for t in g.integers(0, V, 3)],
               prefix + tail + [7], [int(t) for t in g.integers(0, V, 23)]]
    return [cls(prompt=p, max_tokens=m)
            for p, m in zip(prompts, (6, 9, 4, 5, 8, 3, 7))]


def test_host_bookkeeping_equals_the_reference(gpt):
    """The same traffic through both packages' schedulers, a step at a
    time, over a pool tight enough to evict index entries (20 pages, 6
    entries): after every step the page tables, refcounts, free lists,
    reservations, prefix keys and counters are the reference's."""
    jm, jv, tm = gpt
    kw = dict(num_slots=3, max_len=64, page_size=8, num_pages=20,
              prefill_chunk=16, max_prefix_entries=6)
    je = JaxPagedServeEngine(jm, jv, **kw)
    te = PagedServeEngine(tm, device="cpu", **kw)
    js, ts = JaxScheduler(je), ContinuousBatchingScheduler(te)
    want, got = _shared_traffic(JaxRequest), _shared_traffic(Request)
    for w, r in zip(want, got):
        js.submit(w)
        ts.submit(r)
    steps = 0
    while js.has_work() or ts.has_work():
        js.step()
        ts.step()
        steps += 1
        assert _book(te.cache) == _book(je.cache), f"step {steps}"
        assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.status for r in got] == ["ok"] * len(got)
    c = te.cache
    assert c.cow_copies and c.prefix_hit_tokens and c.prefix_evictions
    assert te.metrics.snapshot()["prefix_hits"] == \
        je.metrics.snapshot()["prefix_hits"] > 0


# ---- on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the engine runs there by default")


@pytest.mark.cuda
def test_paged_engine_on_the_card_gives_the_cpu_tokens(cuda, gpt):
    """GPT in f32: the paged engine on the card decodes the CPU's tokens
    under the scheduler, prefix sharing and copy-on-write included."""
    _, _, tm = gpt
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(num_slots=4, max_len=64, page_size=8)
    want, got = _varied(Request), _varied(Request)
    cpu = _paged(tm, **kw)
    ContinuousBatchingScheduler(cpu).run(want)
    card = PagedServeEngine(tm, device="cuda", **kw)
    assert card.cache.k.is_cuda
    ContinuousBatchingScheduler(card).run(got)
    assert [r.status for r in got] == ["ok"] * len(got)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert card.cache.cow_copies == cpu.cache.cow_copies
