"""The port's online CTR serving (``hetu_tpu_torch.serve.recsys``) against
hetu_tpu's on the CPU.

Mirrored one by one: the 25 tests of ``tests/test_recsys.py``, at its
sizes (``WideDeep(3, 8, 4, hidden=(16,))``, 64-row tables; DeepFM for the
two-cache engine).  The same numpy inputs go to both packages: the PS
tables of the two packages draw the same rows from the same seed (the
native init), the weights are the reference's ``model.init(PRNGKey(0))``
carried across by ``interop.params_from_jax``.  What is held:

* the serving cache: every looked-up row bitwise the reference's, and
  the ``stats()`` dicts equal after the same sequence of lookups, sets,
  pushes and clears;
* the engine: scores within 1e-6 of the reference's, bitwise between the
  port's cached and cache-less engines at ``pull_bound=0``, one counted
  shape a bucket;
* the batcher: the batch sizes ``step()`` forms on a fixed sequence equal
  the reference's;
* the freshness contract under a concurrent trainer (every served row at
  most ``pull_bound`` versions stale) and the degrade window's pairing
  with ``fault.kill_shard``.

Tests that spawn processes (the PS shard kill under serving traffic) are
slow and chaos, as the reference's are; the wire and pool tests, slow in
the reference, run here in a few seconds each and stay in the fast lane.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from hetu_tpu.embedding_compress import ServingRowCodec as JaxRowCodec
from hetu_tpu.models.ctr_zoo import DeepFM as JaxDeepFM
from hetu_tpu.models.wdl import WideDeep as JaxWideDeep
from hetu_tpu.ps.client import PSTable as JaxPSTable
from hetu_tpu.serve import recsys as jr
from hetu_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from hetu_tpu_torch import interop
from hetu_tpu_torch.embedding_compress import ServingRowCodec
from hetu_tpu_torch.models import DeepFM, WideDeep
from hetu_tpu_torch.ps.client import CacheSparseTable, PSTable
from hetu_tpu_torch.serve.recsys import (
    NOT_CACHED, STALENESS_BUCKETS, RecsysBatcher, RecsysClient,
    RecsysEngine, RecsysPool, RecsysRequest, RecsysServer,
    ServingEmbeddingCache,
)
from hetu_tpu_torch.telemetry import timeline, trace
from hetu_tpu_torch.telemetry.registry import MetricsRegistry

torch.set_num_threads(2)

pytestmark = pytest.mark.recsys

SCORE_TOL = 1e-6  # port score vs reference score


def _table(rows=64, dim=4, **kw):
    kw.setdefault("init", "zeros")
    kw.setdefault("optimizer", "sgd")
    kw.setdefault("lr", 1.0)
    return PSTable(rows, dim, **kw)


def _tables(rows=64, dim=4, **kw):
    """(reference table, port table) of the same arguments: the native
    init draws the same rows in both."""
    kw.setdefault("init", "zeros")
    kw.setdefault("optimizer", "sgd")
    kw.setdefault("lr", 1.0)
    return JaxPSTable(rows, dim, **kw), PSTable(rows, dim, **kw)


def _caches(tables, capacity, codecs=(None, None), **kw):
    (jt, tt), (jc, tc) = tables, codecs
    return (jr.ServingEmbeddingCache(jt, capacity, codec=jc,
                                     registry=JaxRegistry(), **kw),
            ServingEmbeddingCache(tt, capacity, codec=tc,
                                  registry=MetricsRegistry(), **kw))


def _both(pair, method, *args):
    """Call ``method`` on the reference's object and the port's; the
    results must be bitwise equal.  Returns the port's."""
    want = getattr(pair[0], method)(*args)
    got = getattr(pair[1], method)(*args)
    if isinstance(got, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    return got


def _same_stats(pair):
    want, got = pair[0].stats(), pair[1].stats()
    assert got == want
    return got


def test_constants_are_the_references():
    assert NOT_CACHED == jr.NOT_CACHED and NOT_CACHED.dtype == np.uint64
    assert STALENESS_BUCKETS == jr.STALENESS_BUCKETS


# ---------------------------------------------------------------------------
# staleness-bound semantics
# ---------------------------------------------------------------------------

def test_pull_bound_zero_sees_every_push():
    tables = _tables()
    c = _caches(tables, 16, pull_bound=0)
    np.testing.assert_array_equal(_both(c, "lookup", [3])[0], np.zeros(4))
    for t in tables:
        t.sparse_push([3], np.ones((1, 4), np.float32))  # row -> -1
    np.testing.assert_array_equal(_both(c, "lookup", [3])[0], -np.ones(4))
    for t in tables:
        t.sparse_set([3], np.full((1, 4), 7.0, np.float32))
    np.testing.assert_array_equal(_both(c, "lookup", [3])[0],
                                  np.full(4, 7.0))
    _same_stats(c)


def test_pull_bound_k_serves_stale_within_k_and_refreshes_past_k():
    tables = _tables()
    c = _caches(tables, 16, pull_bound=2)
    _both(c, "lookup", [5])  # cached at v0 (zeros)
    for i in range(2):
        for t in tables:
            t.sparse_set([5], np.full((1, 4), float(i + 1), np.float32))
        # lag i+1 <= bound: the cached (stale) copy is still served
        np.testing.assert_array_equal(_both(c, "lookup", [5])[0],
                                      np.zeros(4))
    for t in tables:
        t.sparse_set([5], np.full((1, 4), 3.0, np.float32))
    # lag 3 > bound 2: refreshed to the CURRENT row (not an intermediate)
    np.testing.assert_array_equal(_both(c, "lookup", [5])[0],
                                  np.full(4, 3.0))
    st = _same_stats(c)
    assert st["stale_refreshes"] == 1
    assert st["staleness"]["max"] == 3.0  # the observed version lag


def test_clear_version_bump_invalidates_cached_rows():
    """``clear()`` bumps every row version: a bound-0 cache re-pulls (and
    sees the zeroed table); a bound-1 cache tolerates exactly one bump."""
    tables = _tables()
    for t in tables:
        t.sparse_set([2], np.full((1, 4), 9.0, np.float32))
    c = _caches(tables, 16, pull_bound=0)
    np.testing.assert_array_equal(_both(c, "lookup", [2])[0],
                                  np.full(4, 9.0))
    for t in tables:
        t.clear()
    np.testing.assert_array_equal(_both(c, "lookup", [2])[0], np.zeros(4))
    _same_stats(c)
    tables2 = _tables()
    for t in tables2:
        t.sparse_set([2], np.full((1, 4), 9.0, np.float32))
    c2 = _caches(tables2, 16, pull_bound=1)
    _both(c2, "lookup", [2])
    for t in tables2:
        t.clear()
    np.testing.assert_array_equal(_both(c2, "lookup", [2])[0],
                                  np.full(4, 9.0))
    for t in tables2:
        t.clear()  # second bump exceeds the bound
    np.testing.assert_array_equal(_both(c2, "lookup", [2])[0], np.zeros(4))
    _same_stats(c2)


def test_concurrent_trainer_staleness_within_bound():
    """The freshness contract under a LIVE writer: rows encode their
    version (row r == v after the v-th set), a trainer thread keeps
    setting, the server keeps looking up — every served row is at most
    ``pull_bound`` versions behind the sets completed when its lookup
    started."""
    t = _table(rows=4, dim=4)
    published = [0]
    stop = threading.Event()

    def trainer():
        v = 0
        while not stop.is_set():
            v += 1
            t.sparse_set([1], np.full((1, 4), float(v), np.float32))
            published[0] = v  # AFTER the set

    for bound in (0, 3):
        c = ServingEmbeddingCache(t, capacity=8, pull_bound=bound,
                                  registry=MetricsRegistry())
        published[0] = 0
        stop.clear()
        th = threading.Thread(target=trainer, daemon=True)
        th.start()
        try:
            deadline = time.monotonic() + 1.5
            while time.monotonic() < deadline:
                c0 = published[0]
                row = c.lookup([1])[0]
                assert np.all(row == row[0])  # a torn row mixes versions
                assert c0 - int(row[0]) <= bound, (bound, c0, row[0])
        finally:
            stop.set()
            th.join(5)
        assert published[0] > 10  # the trainer actually raced us


def test_pull_bound_zero_bitwise_parity_with_cacheless():
    """Cached serving at bound 0 == cache-less PS pulls, bitwise, across
    interleaved trainer pushes; and row for row the reference's."""
    rng = np.random.default_rng(0)
    tables = _tables(rows=128, dim=8, init="normal", init_b=0.5, seed=3)
    c = _caches(tables, 32, pull_bound=0)
    for it in range(20):
        ids = rng.zipf(1.3, size=(16, 3)).astype(np.int64) % 128
        got = _both(c, "lookup", ids)
        ref = tables[1].sparse_pull(ids.reshape(-1)).reshape(16, 3, 8)
        assert np.array_equal(got, ref), it
        idx = rng.integers(0, 128, 8)
        g = rng.standard_normal((8, 8)).astype(np.float32)
        for t in tables:
            t.sparse_push(idx, g)
    assert _same_stats(c)["hits"] > 0  # the parity run actually hit


def test_negative_and_cold_row_policy():
    c = _caches(_tables(), 8)
    out = _both(c, "lookup", [-1, 2, 64, 9999])
    for i in (0, 2, 3):
        np.testing.assert_array_equal(out[i], np.zeros(4))
    assert _same_stats(c)["negative_rows"] == 3
    c_err = _caches(_tables(), 8, negative="error")
    for cache in c_err:
        with pytest.raises(KeyError):
            cache.lookup([0, -5])
    _same_stats(c_err)
    with pytest.raises(ValueError):
        ServingEmbeddingCache(_table(), 8, negative="clamp")


def test_compressed_eviction_tier():
    """Rows evicted from the hot tier live int8-compressed with their
    version: a re-access within the bound decompresses locally (l2_hits,
    bytes saved); a version bump past the bound refreshes exactly.  The
    lossy rows are bitwise the reference's."""
    tables = _tables(rows=16, dim=8, init="normal", init_b=1.0, seed=5)
    c = _caches(tables, 2, codecs=(JaxRowCodec(8), ServingRowCodec(8)),
                pull_bound=0)
    ref = {k: tables[1].sparse_pull([k])[0] for k in range(6)}
    for k in range(6):  # capacity 2: most rows spill to L2
        _both(c, "lookup", [k])
    st0 = _same_stats(c)
    assert st0["l2_size"] >= 3
    out = _both(c, "lookup", [0])[0]  # evicted; no version change since
    st = _same_stats(c)
    assert st["l2_hits"] >= 1
    assert st["ps_bytes_saved"] > st0["ps_bytes_saved"]
    np.testing.assert_allclose(out, ref[0], rtol=0.02, atol=0.02)  # lossy
    for t in tables:
        t.sparse_set([0], np.full((1, 8), 5.0, np.float32))
    np.testing.assert_array_equal(_both(c, "lookup", [0])[0],
                                  np.full(8, 5.0))
    _same_stats(c)


def test_capacity_zero_is_cacheless_baseline():
    c = _caches(_tables(), 0)
    for _ in range(3):
        _both(c, "lookup", [1, 2, 3])
    st = _same_stats(c)
    assert st["hits"] == 0 and st["size"] == 0
    assert st["cold_misses"] == 9


def test_wrapping_training_cache_shares_table():
    t = _table()
    train_tier = CacheSparseTable(t, 8)
    c = ServingEmbeddingCache(train_tier, capacity=8, pull_bound=0,
                              registry=MetricsRegistry())
    assert c.table is t
    np.testing.assert_array_equal(c.lookup([1])[0], np.zeros(4))
    with pytest.raises(TypeError):
        ServingEmbeddingCache(object(), 8)


def test_cache_sparse_table_counters_thread_safe_and_exported():
    """The training cache's counters under 8 threads, and the serving
    cache's ``ps.cache.*`` aggregate: both land in the caller's registry
    (the port's departure; the reference's go to its default)."""
    reg = MetricsRegistry()
    t = _table(rows=256, dim=4)
    c = CacheSparseTable(t, 64, registry=reg)
    N_THREADS, N_CALLS, B = 8, 50, 16

    def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(N_CALLS):
            c.embedding_lookup(rng.integers(0, 256, B))

    ts = [threading.Thread(target=worker, args=(i,))
          for i in range(N_THREADS)]
    for th in ts:
        th.start()
    for th in ts:
        th.join()
    assert c.lookups == N_THREADS * N_CALLS * B  # no lost increments
    assert 0.0 <= c.hit_rate <= 1.0
    assert reg.counter("ps.cache.lookups").value == N_THREADS * N_CALLS * B
    assert reg.gauge("ps.cache.size").value == c.size
    sreg = MetricsRegistry()
    sc = ServingEmbeddingCache(t, 8, registry=sreg)
    sc.lookup([1, 1, 2])
    sc.lookup([1, 3])
    assert sreg.counter("ps.cache.lookups").value == 5
    assert sreg.counter("ps.cache.misses").value == 4  # per position
    assert sreg.gauge("ps.cache.hit_rate").value == sc.hit_rate
    assert sreg.gauge("ps.cache.size").value == 3


# ---------------------------------------------------------------------------
# engine + micro-batching
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wdl():
    """(reference model, its variables, the port's model on the same
    weights)."""
    jm = JaxWideDeep(3, 8, 4, hidden=(16,))
    jv = jm.init(jax.random.PRNGKey(0))
    tm = WideDeep(3, 8, 4, hidden=(16,), device="cpu")
    tm.load_state_dict(interop.params_from_jax(jv["params"], tm))
    return jm, jv, tm


def _engine(tm, table, **kw):
    kw.setdefault("max_batch", 32)
    kw.setdefault("min_bucket", 4)
    cache = ServingEmbeddingCache(table, capacity=64, pull_bound=0,
                                  registry=MetricsRegistry())
    return RecsysEngine(tm, cache, device="cpu", **kw)


def _jax_engine(jm, jv, table, **kw):
    kw.setdefault("max_batch", 32)
    kw.setdefault("min_bucket", 4)
    cache = jr.ServingEmbeddingCache(table, capacity=64, pull_bound=0,
                                     registry=JaxRegistry())
    return jr.RecsysEngine(jm, jv, cache, **kw)


def test_engine_defaults_to_the_card_and_snapshots_the_weights(wdl):
    """``device="cuda"`` is the default and raises without CUDA; the
    engine scores with a copy of the weights, so an in-place update of
    the model (the port's optimizers) never reaches it."""
    jm, jv, tm = wdl
    t = _table(rows=100, dim=8, init="normal", seed=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            RecsysEngine(tm, ServingEmbeddingCache(
                t, 8, registry=MetricsRegistry()))
    eng = _engine(tm, t)
    dense = np.ones((2, 4), np.float32)
    ids = np.array([[1, 2, 3], [4, 5, 6]])
    before = eng.score(dense, ids)
    for (name, p), (_, q) in zip(tm.named_parameters(),
                                 eng.model.named_parameters()):
        assert p.data_ptr() != q.data_ptr(), name
        assert not q.requires_grad
    saved = {n: p.detach().clone() for n, p in tm.named_parameters()}
    try:
        with torch.no_grad():
            for p in tm.parameters():
                p.add_(1.0)
        assert np.array_equal(eng.score(dense, ids), before)
    finally:
        with torch.no_grad():
            for n, p in tm.named_parameters():
                p.copy_(saved[n])


def test_engine_bucketed_bounded_executables(wdl):
    """Sizes 1, 3, 4 -> bucket 4; 5, 9 -> 8, 16; 30 -> 32: four shapes
    (``compiled_executables`` counts the buckets served, the reference's
    count of jitted executables), scores within 1e-6 of the
    reference's."""
    jm, jv, tm = wdl
    jt, tt = _tables(rows=100, dim=8, init="normal", seed=1)
    eng, ref = _engine(tm, tt), _jax_engine(jm, jv, jt)
    rng = np.random.default_rng(0)
    for b in (1, 3, 4, 5, 9, 30):
        dense = rng.standard_normal((b, 4)).astype(np.float32)
        ids = rng.integers(0, 100, (b, 3))
        probs = eng.score(dense, ids)
        assert probs.shape == (b,) and probs.dtype == np.float32
        assert np.all((probs > 0) & (probs < 1))
        np.testing.assert_allclose(probs, ref.score(dense, ids), rtol=0,
                                   atol=SCORE_TOL)
    assert eng.compiled_executables() == ref.compiled_executables() == 4
    assert eng.compiled_executables() <= eng.max_executables == 4
    assert eng.metrics.count("recsys_compiles") == 4
    with pytest.raises(ValueError):
        eng.score(np.zeros((33, 4), np.float32), np.zeros((33, 3), np.int64))


def test_engine_cached_scores_bitwise_equal_cacheless(wdl):
    """Same model, one engine over a bound-0 cache, one over the
    cache-less baseline: identical traffic + interleaved pushes give
    bitwise-identical scores, within 1e-6 of the reference's."""
    jm, jv, tm = wdl
    jt, tt = _tables(rows=100, dim=8, init="normal", seed=2)
    cached = RecsysEngine(tm, ServingEmbeddingCache(
        tt, capacity=64, pull_bound=0, registry=MetricsRegistry()),
        max_batch=32, min_bucket=4, device="cpu")
    bare = RecsysEngine(tm, ServingEmbeddingCache(
        tt, capacity=0, registry=MetricsRegistry()),
        max_batch=32, min_bucket=4, device="cpu")
    ref = _jax_engine(jm, jv, jt)
    rng = np.random.default_rng(1)
    for _ in range(10):
        dense = rng.standard_normal((8, 4)).astype(np.float32)
        ids = (rng.zipf(1.5, size=(8, 3)) % 100).astype(np.int64)
        got = cached.score(dense, ids)
        assert np.array_equal(got, bare.score(dense, ids))
        np.testing.assert_allclose(got, ref.score(dense, ids), rtol=0,
                                   atol=SCORE_TOL)
        idx = rng.integers(0, 100, 4)
        g = rng.standard_normal((4, 8)).astype(np.float32)
        jt.sparse_push(idx, g)
        tt.sparse_push(idx, g)
    assert cached.caches[0].hit_rate > 0.5
    assert cached.caches[0].stats() == ref.caches[0].stats()


def test_engine_two_sparse_inputs_deepfm():
    jm = JaxDeepFM(3, 8, 4, hidden=(16,))
    jv = jm.init(jax.random.PRNGKey(0))
    tm = DeepFM(3, 8, 4, hidden=(16,), device="cpu")
    tm.load_state_dict(interop.params_from_jax(jv["params"], tm))
    emb = _tables(rows=100, dim=8, init="normal", seed=1)
    lin = _tables(rows=100, dim=1, init="normal", seed=2)
    ref = jr.RecsysEngine(jm, jv, tuple(
        jr.ServingEmbeddingCache(t[0], capacity=32, registry=JaxRegistry())
        for t in (emb, lin)), max_batch=16, min_bucket=4)
    eng = RecsysEngine(tm, tuple(
        ServingEmbeddingCache(t[1], capacity=32, registry=MetricsRegistry())
        for t in (emb, lin)), max_batch=16, min_bucket=4, device="cpu")
    assert len(eng.caches) == 2 and eng.fields == 3
    dense = np.zeros((5, 4), np.float32)
    ids = np.arange(15).reshape(5, 3) % 100
    probs = eng.score(dense, ids)
    assert probs.shape == (5,) and np.all((probs > 0) & (probs < 1))
    np.testing.assert_allclose(probs, ref.score(dense, ids), rtol=0,
                               atol=SCORE_TOL)
    for c, rc in zip(eng.caches, ref.caches):
        assert c.stats() == rc.stats()


def test_batcher_coalesces_single_requests(wdl):
    """Twelve single requests through ``run`` (``step()`` on a fixed
    sequence): the same batches as the reference's batcher, scores
    bitwise the engine's on the same batch and within 1e-6 of the
    reference's."""
    jm, jv, tm = wdl
    jt, tt = _tables(rows=100, dim=8, init="normal", seed=1)
    eng = _engine(tm, tt)
    jeng = _jax_engine(jm, jv, jt)
    b = RecsysBatcher(eng, max_delay_s=0.01)
    jb = jr.RecsysBatcher(jeng, max_delay_s=0.01)
    rng = np.random.default_rng(0)
    feats = [(rng.standard_normal(4).astype(np.float32),
              rng.integers(0, 100, 3)) for _ in range(12)]
    reqs = [RecsysRequest(dense=d, sparse=s) for d, s in feats]
    jreqs = [jr.RecsysRequest(dense=d, sparse=s) for d, s in feats]
    out = b.run(reqs)
    jout = jb.run(jreqs)
    assert all(r.status == "ok" for r in reqs)
    # one coalesced forward, not 12 single-row ones — as the reference's
    assert eng.metrics.count("recsys_batches") < len(reqs)
    assert eng.metrics.count("recsys_batches") == \
        jeng.metrics.count("recsys_batches")
    assert eng.metrics.count("recsys_scored") == \
        jeng.metrics.count("recsys_scored") == 12
    got = np.array([out[r.rid] for r in reqs], np.float32)
    ref = eng.score(np.stack([r.dense for r in reqs]),
                    np.stack([r.sparse for r in reqs]))
    np.testing.assert_array_equal(got, ref.astype(np.float32))
    np.testing.assert_allclose(
        got, np.array([jout[r.rid] for r in jreqs], np.float32), rtol=0,
        atol=SCORE_TOL)
    assert all(r.ttfr_s is not None and r.ttfr_s >= 0 for r in reqs)


def test_batcher_deadline_and_cancel(wdl):
    jm, jv, tm = wdl
    eng = _engine(tm, _table(rows=100, dim=8, init="normal", seed=1))
    b = RecsysBatcher(eng)
    expired = RecsysRequest(dense=np.zeros(4, np.float32),
                            sparse=np.zeros(3, np.int64), timeout_s=0.0)
    b.submit(expired)
    time.sleep(0.01)
    cancelled = RecsysRequest(dense=np.zeros(4, np.float32),
                              sparse=np.zeros(3, np.int64))
    b.submit(cancelled)
    b.cancel(cancelled)
    ok = RecsysRequest(dense=np.zeros(4, np.float32),
                       sparse=np.zeros(3, np.int64))
    b.submit(ok)
    while b.has_work():
        b.step()
    assert expired.status == "timeout"
    assert cancelled.status == "cancelled" and cancelled.score is None
    assert ok.status == "ok" and ok.score is not None


def test_batcher_resolve_failure_requeues_launched_batch():
    """A finish() blow-up lands AFTER the next batch already launched:
    both the in-flight batch AND the just-launched one requeue — neither
    strands outside queue+inflight with done never set."""
    from hetu_tpu_torch.serve.metrics import ServeMetrics

    class StubEngine:
        max_batch = 4
        metrics = ServeMetrics()

        def __init__(self):
            self.fail_next_finish = False

        def gather_launch(self, dense, sparse):
            return ("h", len(dense))

        def finish(self, handle):
            if self.fail_next_finish:
                self.fail_next_finish = False
                raise RuntimeError("boom")
            return np.full(handle[1], 0.5, np.float32)

    eng = StubEngine()
    b = RecsysBatcher(eng, max_batch=1, max_delay_s=0.0)
    r1 = RecsysRequest(dense=np.zeros(2, np.float32),
                       sparse=np.zeros(2, np.int64))
    r2 = RecsysRequest(dense=np.zeros(2, np.float32),
                       sparse=np.zeros(2, np.int64))
    b.submit(r1)
    b.submit(r2)
    b.step()                      # launches r1, nothing to resolve
    eng.fail_next_finish = True
    with pytest.raises(RuntimeError):
        b.step()                  # launches r2, r1's resolve blows up
    assert b.load == 2            # both requeued, neither stranded
    while b.has_work():
        b.step()
    assert r1.status == "ok" and r2.status == "ok"
    assert r1.requeues == 1 and r2.requeues == 1


def test_batcher_export_adopt_roundtrip(wdl):
    jm, jv, tm = wdl
    t = _table(rows=100, dim=8, init="normal", seed=1)
    b1 = RecsysBatcher(_engine(tm, t))
    b2 = RecsysBatcher(_engine(tm, t))
    reqs = [RecsysRequest(dense=np.zeros(4, np.float32),
                          sparse=np.array([1, 2, 3])) for _ in range(3)]
    for r in reqs:
        b1.submit(r)
    pairs = b1.export_inflight(fold=True)
    assert len(pairs) == 3 and all(s is None for _, s in pairs)
    _, n = b2.adopt_inflight(pairs, return_count=True)
    assert n == 3
    while b2.has_work():
        b2.step()
    assert all(r.status == "ok" for r in reqs)
    with pytest.raises(RuntimeError):
        b2.adopt_inflight([], snapshots=[object()])


# ---------------------------------------------------------------------------
# wire front end + pool
# ---------------------------------------------------------------------------

def test_server_wire_roundtrip(wdl):
    jm, jv, tm = wdl
    eng = _engine(tm, _table(rows=100, dim=8, init="normal", seed=1))
    srv = RecsysServer(RecsysBatcher(eng), max_clients=2,
                       request_timeout_s=30.0)
    cl = RecsysClient("127.0.0.1", srv.port, 0)
    try:
        dense, sp = np.ones(4, np.float32), np.array([1, 2, 3])
        resp = cl.score(dense, sp, timeout_s=30.0)
        assert resp["status"] == "ok"
        assert abs(resp["score"] - float(eng.score(dense[None],
                                                   sp[None])[0])) < 1e-6
        bad = cl.score(dense, [], timeout_s=30.0)
        assert bad["status"] == "bad_request" and bad["score"] is None
    finally:
        cl.close()
        srv.close()


def test_pool_routes_kills_fails_over_and_revives(wdl):
    """Two CTR members under the live health poll: the kill switch
    strikes a member's engine loop out under traffic, the poll fails it
    over while the request waits (every request ok), ``revive_member``
    brings it back through its ``fresh_engine`` and closes the dead
    engine's cache once."""
    jm, jv, tm = wdl
    t = _table(rows=100, dim=8, init="normal", seed=1)
    closed = []

    class Tracked(ServingEmbeddingCache):
        def close(self):
            closed.append(self)
            super().close()

    def factory():
        return RecsysEngine(
            tm, Tracked(t, capacity=64, pull_bound=1,
                        registry=MetricsRegistry()),
            max_batch=16, min_bucket=4, device="cpu")

    pool = RecsysPool({"a": factory, "b": factory}, failover_grace_s=10.0)
    dense, sp = np.ones(4, np.float32), np.array([1, 2, 3])
    try:
        ref = None
        for _ in range(4):
            r = pool.score(dense, sp, timeout_s=30.0)
            assert r["status"] == "ok"
            ref = r["score"] if ref is None else ref
            assert r["score"] == ref  # same weights + rows: same score
        dead = pool.members["a"].engine
        pool.kill_member("a")
        for _ in range(3):
            r = pool.score(dense, sp, timeout_s=30.0)
            assert r["status"] == "ok" and r["score"] == ref
        deadline = time.monotonic() + 10
        while pool.metrics.count("pool_failovers") == 0 and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        assert pool.metrics.count("pool_failovers") == 1
        assert not pool.members["a"].available
        pool.revive_member("a")
        assert pool.members["a"].available
        assert closed == list(dead.caches)  # the dead engine's, once
        assert pool.members["a"].engine is not dead
        assert type(pool.members["a"].engine) is type(dead)
        r = pool.score(dense, sp, timeout_s=30.0)
        assert r["status"] == "ok"
    finally:
        pool.close()


def test_wrong_shape_request_rejected_not_engine_killing(wdl):
    """A request with a wrong-length feature vector is rejected at intake
    ('overflow') — never admitted into a batch where its shape error
    would strike out the member's engine loop."""
    jm, jv, tm = wdl
    eng = _engine(tm, _table(rows=100, dim=8, init="normal", seed=1))
    assert eng.dense_dim == 4 and eng.fields == 3  # from model attrs
    b = RecsysBatcher(eng)
    bad = RecsysRequest(dense=np.zeros(7, np.float32),
                        sparse=np.zeros(3, np.int64))
    b.submit(bad)
    assert bad.status == "overflow" and bad.done.is_set()
    bad2 = RecsysRequest(dense=np.zeros(4, np.float32),
                         sparse=np.zeros(9, np.int64))
    b.submit(bad2)
    assert bad2.status == "overflow"
    ok = RecsysRequest(dense=np.zeros(4, np.float32),
                       sparse=np.zeros(3, np.int64))
    b.submit(ok)
    while b.has_work():
        b.step()
    assert ok.status == "ok" and ok.score is not None


def test_wire_wrong_shape_answers_bad_request(wdl):
    jm, jv, tm = wdl
    srv = RecsysServer(RecsysBatcher(_engine(
        tm, _table(rows=100, dim=8, init="normal", seed=1))),
        max_clients=1, request_timeout_s=30.0)
    cl = RecsysClient("127.0.0.1", srv.port, 0)
    try:
        resp = cl.score(np.zeros(9, np.float32), [1, 2, 3], timeout_s=30.0)
        assert resp["status"] == "bad_request", resp
        resp = cl.score(np.zeros(4, np.float32), [1, 2, 3], timeout_s=30.0)
        assert resp["status"] == "ok"
    finally:
        cl.close()
        srv.close()


def test_pool_frontend_serves_over_the_wire(wdl):
    jm, jv, tm = wdl
    t = _table(rows=100, dim=8, init="normal", seed=1)

    def factory():
        return RecsysEngine(
            tm, ServingEmbeddingCache(t, capacity=64,
                                      registry=MetricsRegistry()),
            max_batch=16, min_bucket=4, device="cpu")

    pool = RecsysPool([factory, factory], start_poll=False)
    front = pool.frontend(max_clients=2)
    cl = RecsysClient("127.0.0.1", pool.port, 0)
    try:
        resp = cl.score(np.ones(4, np.float32), [1, 2, 3], timeout_s=30.0)
        assert resp["status"] == "ok" and resp["score"] is not None
        assert pool.metrics.count("pool_requests") == 1
        direct = pool.score(np.ones(4, np.float32), [1, 2, 3],
                            timeout_s=30.0)
        assert abs(resp["score"] - direct["score"]) < 1e-6
    finally:
        cl.close()
        front.close()
        pool.close()


# ---------------------------------------------------------------------------
# degrade-and-recover + chaos pairing
# ---------------------------------------------------------------------------

def test_degrade_serves_stale_and_pairs_with_kill_shard_fault():
    """The PS becomes unreachable mid-serving: the cache keeps answering
    (hot rows at any staleness, zeros for unknown), and the outage is a
    ``serve.recsys_degrade`` span the timeline pairs with the injected
    ``fault.kill_shard`` instant.  Rows and stats as the reference's."""
    from hetu_tpu_torch.resilience.faults import (
        FaultEvent, FaultInjector, FaultSchedule,
    )
    tables = _tables(rows=16, dim=4, init="normal", seed=7)
    tracer = trace.enable()
    try:
        c = _caches(tables, 8, pull_bound=0, probe_interval_s=0.0)
        warm = _both(c, "lookup", [1, 2])  # hot rows to serve stale later
        inj = FaultInjector(FaultSchedule([FaultEvent(1, "kill_shard", 0)]),
                            shard_procs=[])
        inj.on_step(1)
        real = [t.sync_pull for t in tables]

        def dead(*a, **kw):
            raise ConnectionError("injected shard death")

        for t in tables:
            t.sync_pull = dead
        out = _both(c, "lookup", [1, 2, 9])
        np.testing.assert_array_equal(out[:2], warm)  # stale-but-served
        np.testing.assert_array_equal(out[2], np.zeros(4))  # never seen
        assert c[1].degraded
        assert _same_stats(c)["degraded_lookups"] == 3
        for t, f in zip(tables, real):
            t.sync_pull = f
        _both(c, "lookup", [1])  # first success closes the window
        assert not c[1].degraded
        _same_stats(c)
        pairs = timeline.correlate(tracer.events)
        ks = [p for p in pairs if p.kind == "kill_shard"]
        assert len(ks) == 1 and ks[0].paired
        assert ks[0].recovery_name == "serve.recsys_degrade"
        assert ks[0].recover_s >= 0
    finally:
        trace.disable()


def test_unrecovered_degrade_span_is_not_a_recovery():
    t = _table(rows=8, dim=4)
    tracer = trace.enable()
    try:
        c = ServingEmbeddingCache(t, capacity=8, registry=MetricsRegistry())
        c.lookup([1])
        t.sync_pull = lambda *a, **kw: (_ for _ in ()).throw(
            ConnectionError("down"))
        c.lookup([1])
        assert c.degraded
        c.close()  # still degraded: the span must record as FAILED
        evs = [e for e in tracer.events
               if e.get("name") == "serve.recsys_degrade"]
        assert len(evs) == 1 and evs[0]["args"].get("error") == "unrecovered"
        pairs = timeline.correlate(tracer.events)
        assert not any(p.paired for p in pairs)
    finally:
        trace.disable()


# ---------------------------------------------------------------------------
# PS-backed chaos: real shard SIGKILL under live serving traffic
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.chaos
def test_recsys_chaos_shard_kill_serves_degraded_then_recovers(
        tmp_path, wdl):
    """A 2-shard van PS group backs a 2-member CTR pool; a seeded
    ``kill_shard`` SIGKILLs one shard server mid-traffic.  The pool keeps
    answering (degraded-stale), the shard restart recovers the cache, and
    the fault instant pairs with the ``serve.recsys_degrade`` span."""
    from hetu_tpu_torch.ps import van
    from hetu_tpu_torch.resilience.faults import FaultInjector, FaultSchedule
    from hetu_tpu_torch.resilience.shardproc import (
        free_port, spawn_shard_server,
    )

    jm, jv, tm = wdl
    ports = [free_port(), free_port()]
    procs = [spawn_shard_server(tmp_path, p, f"rc{i}")
             for i, p in enumerate(ports)]
    tracer = trace.enable()
    table = None
    pool = None
    try:
        table = van.PartitionedPSTable(
            [("127.0.0.1", p) for p in ports], rows=64, dim=8,
            init="normal", seed=3, optimizer="sgd", lr=0.5,
            heartbeat_ms=50)
        caches = []

        def factory():
            c = ServingEmbeddingCache(table, capacity=32, pull_bound=1,
                                      registry=MetricsRegistry())
            caches.append(c)
            return RecsysEngine(tm, c, max_batch=16, min_bucket=4,
                                device="cpu")

        pool = RecsysPool({"a": factory, "b": factory},
                          failover_grace_s=5.0)
        schedule = FaultSchedule.generate(steps=8, seed=1234,
                                          kill_shards=1, n_shards=2)
        (kill_ev,) = schedule.events
        inj = FaultInjector(schedule, shard_procs=procs)
        rng = np.random.default_rng(0)
        statuses = []
        restarted = False
        for step in range(1, 12):
            inj.on_step(step)
            for _ in range(2):
                r = pool.score(
                    rng.standard_normal(4).astype(np.float32),
                    rng.integers(0, 64, 3), timeout_s=60.0)
                statuses.append(r["status"])
            if step > kill_ev.step and not restarted:
                victim = int(kill_ev.arg)
                procs[victim] = spawn_shard_server(
                    tmp_path, ports[victim], f"rc{victim}-re")
                restarted = True
                deadline = time.monotonic() + 30
                while not all(table.alive) and \
                        time.monotonic() < deadline:
                    time.sleep(0.1)
                assert all(table.alive), "shard never reconnected"
        # a degraded cache re-probes the PS at its first lookup past
        # probe_interval_s; the steps above can all land inside that
        # interval of the restart, so serve on (every answer still ok)
        # until the probes have run, within a deadline of their own
        deadline = time.monotonic() + 10.0
        while any(c.degraded for c in caches) and \
                time.monotonic() < deadline:
            time.sleep(0.05)
            r = pool.score(rng.standard_normal(4).astype(np.float32),
                           rng.integers(0, 64, 3), timeout_s=60.0)
            statuses.append(r["status"])
        assert inj.counters["shards_killed"] == 1
        assert statuses and all(s == "ok" for s in statuses), statuses
        assert any(c.stats()["degraded_lookups"] > 0 for c in caches)
        assert not any(c.degraded for c in caches), "never recovered"
        pairs = timeline.correlate(tracer.events)
        ks = [p for p in pairs if p.kind == "kill_shard"]
        assert len(ks) == 1 and ks[0].paired, ks
        assert ks[0].recovery_name == "serve.recsys_degrade"
    finally:
        trace.disable()
        if pool is not None:
            pool.close()
        if table is not None:
            table.close()
        for p in procs:
            p.kill()
            p.wait()
