"""The parameter server's in-process tier in hetu_tpu_torch against
hetu_tpu's, on the CPU.

Both packages build their library from the same ``csrc/hetu_ps.cpp``
(each into its own directory, loaded as its own copy), so a table's
initial rows, its server-side optimizer and the HET cache agree bit for
bit.  The hybrid Wide & Deep loop (prefetch, pull, step, push, as
``examples/ctr_wdl.py`` runs it) differs only where the two frameworks
compute the step: the loss within 1e-6 relative, the dense parameters and
the pulled rows within 1e-5 relative plus 1e-7.
"""

import jax
import numpy as np
import pytest
import torch

from hetu_tpu import optim as joptim
from hetu_tpu.models.wdl import WideDeep as JWideDeep
from hetu_tpu.ps import client as jclient
from hetu_tpu.ps import embedding as jembedding
from hetu_tpu_torch import interop, optim
from hetu_tpu_torch.models import WideDeep
from hetu_tpu_torch.ps import CacheSparseTable, PSEmbedding, PSTable, binding
from hetu_tpu_torch.telemetry import MetricsRegistry

torch.set_num_threads(2)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("init,dtype", [("normal", "f32"),
                                        ("uniform", "f32"),
                                        ("normal", "bf16")])
def test_initial_rows_are_bitwise_the_reference(init, dtype):
    kw = dict(init=init, init_a=-0.05, init_b=0.05, seed=7, dtype=dtype)
    mine, ref = PSTable(500, 8, **kw), jclient.PSTable(500, 8, **kw)
    idx = np.random.default_rng(0).integers(0, 500, 300)
    np.testing.assert_array_equal(_bits(mine.sparse_pull(idx)),
                                  _bits(ref.sparse_pull(idx)))
    np.testing.assert_array_equal(_bits(mine.dense_pull()),
                                  _bits(ref.dense_pull()))


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adagrad", "adam",
                                 "nesterov"])
def test_server_side_optimizer_is_bitwise_the_reference(opt):
    g = np.random.default_rng(1)
    mine, ref = (cls(200, 4, optimizer=opt, lr=0.05, seed=3)
                 for cls in (PSTable, jclient.PSTable))
    for _ in range(3):
        idx = g.integers(0, 50, 120)  # duplicates summed by the server
        grads = g.standard_normal((120, 4)).astype(np.float32)
        mine.sparse_push(idx, grads)
        ref.sparse_push(idx, grads)
    idx = np.arange(200)
    np.testing.assert_array_equal(_bits(mine.sparse_pull(idx)),
                                  _bits(ref.sparse_pull(idx)))
    for a, b in zip(mine.slots_get(idx), ref.slots_get(idx)):
        np.testing.assert_array_equal(a, b)
    # versions are opaque counters with a per-library base: the rows'
    # offsets from it agree
    rows, vers = mine.sparse_pull(idx[:5], with_versions=True)
    _, ref_vers = ref.sparse_pull(idx[:5], with_versions=True)
    np.testing.assert_array_equal(vers - vers.min(),
                                  ref_vers - ref_vers.min())
    sel, v, r = mine.sync_pull(idx[:5], np.zeros(5, np.uint64))
    rsel, rv, rr = ref.sync_pull(idx[:5], np.zeros(5, np.uint64))
    np.testing.assert_array_equal(sel, rsel)
    np.testing.assert_array_equal(r, rr)
    # the rest of the table's surface, in step with the reference's
    dense_grad = g.standard_normal((200, 4)).astype(np.float32)
    values = g.standard_normal((3, 4)).astype(np.float32)
    slots = [np.abs(g.standard_normal((3, 4))).astype(np.float32)
             for _ in range(2)] + [np.full(3, 5, np.uint64)]
    for t in (mine, ref):
        t.dense_push(dense_grad)
        t.sparse_set([1, 2, 3], values)
        t.slots_set([4, 5, 6], *slots)
    np.testing.assert_array_equal(_bits(mine.dense_pull()),
                                  _bits(ref.dense_pull()))
    for a, b in zip(mine.slots_get([4, 5, 6]), ref.slots_get([4, 5, 6])):
        np.testing.assert_array_equal(a, b)
    mine.clear()
    assert not mine.dense_pull().any()


def test_cache_is_bitwise_the_reference_and_exports_its_metrics():
    g = np.random.default_rng(2)
    reg = MetricsRegistry()
    tables = (PSTable(300, 6, optimizer="adagrad", lr=0.1, seed=1),
              jclient.PSTable(300, 6, optimizer="adagrad", lr=0.1, seed=1))
    mine = CacheSparseTable(tables[0], 64, "lfuopt", registry=reg)
    ref = jclient.CacheSparseTable(tables[1], 64, "lfuopt")
    for _ in range(6):
        idx = g.integers(0, 120, (16, 5))
        got, want = mine.embedding_lookup(idx), ref.embedding_lookup(idx)
        assert got.shape == (16, 5, 6)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        grads = g.standard_normal((80, 6)).astype(np.float32)
        mine.embedding_update(idx, grads)
        ref.embedding_update(idx, grads)
    assert mine.hit_rate == ref.hit_rate > 0
    assert mine.size == ref.size
    mine.flush()
    ref.flush()
    idx = np.arange(300)
    np.testing.assert_array_equal(_bits(tables[0].sparse_pull(idx)),
                                  _bits(tables[1].sparse_pull(idx)))
    m = reg.metrics()
    assert m["ps.cache.lookups"].value == 6 * 80
    assert m["ps.cache.misses"].value == mine.misses
    assert m["ps.cache.hit_rate"].value == pytest.approx(mine.hit_rate)
    mine.reset_stats()
    assert mine.hit_rate == 1.0 and mine.lookups == 0


def _hybrid_run(cache: bool, steps: int = 5):
    """``steps`` hybrid Wide & Deep steps of both packages over the same
    batches, through PSEmbedding's prefetch / pull / step / push: the
    losses, the dense parameters and the rows pulled at the end."""
    fields, dim, dense, vocab, b = 4, 8, 3, 60, 32
    g = np.random.default_rng(3)
    sparse = g.integers(0, vocab, (b * steps, fields)).astype(np.int64)
    dense_x = g.standard_normal((b * steps, dense)).astype(np.float32)
    y = ((sparse.sum(-1) % 2) ^ (dense_x[:, 0] > 0)).astype(np.float32)
    kw = dict(optimizer="adagrad", lr=0.1, seed=0,
              cache_capacity=24 if cache else None)
    embs = PSEmbedding(vocab, dim, **kw), jembedding.PSEmbedding(vocab, dim,
                                                                 **kw)
    jm = JWideDeep(fields, dim, dense, hidden=(16,))
    v = jm.init(jax.random.PRNGKey(0))
    pm = WideDeep(fields, dim, dense, hidden=(16,), device="cpu")
    pm.load_state_dict(interop.params_from_jax(
        jax.tree_util.tree_map(np.asarray, v["params"]), pm))
    jopt = joptim.AdamOptimizer(5e-3)
    jstep = jm.hybrid_step_fn(jopt)
    step = pm.hybrid_step_fn(optim.AdamOptimizer(5e-3))
    params, ostate, mstate = v["params"], jopt.init_state(v["params"]), \
        v["state"]
    losses = []
    for e in embs:
        e.prefetch(sparse[:b])
    for it in range(steps):
        sl = slice(it * b, (it + 1) * b)
        rows, jrows = (e.pull_prefetched() for e in embs)
        assert isinstance(rows, torch.Tensor) and rows.dtype == torch.float32
        assert rows.device.type == "cpu" and rows.shape == (b, fields, dim)
        np.testing.assert_allclose(rows.numpy(), jrows, rtol=1e-5, atol=1e-7)
        loss, logit, g_rows = step(dense_x[sl], rows, y[sl])
        params, ostate, mstate, jloss, jlogit, jg = jstep(
            params, ostate, mstate, dense_x[sl], jrows, y[sl])
        losses.append((float(loss), float(jloss)))
        embs[0].push(sparse[sl], g_rows)
        embs[1].push(sparse[sl], np.asarray(jg))
        if it + 1 < steps:
            for e in embs:
                e.prefetch(sparse[(it + 1) * b:(it + 2) * b])
    for e in embs:
        e.flush()
    idx = np.arange(vocab)
    final = [e.table.sparse_pull(idx) for e in embs]
    hits = [e.cache.hit_rate if e.cache else None for e in embs]
    embs[0].close()
    embs[1].close()
    return losses, pm, params, final, hits


@pytest.mark.parametrize("cache", [False, True])
def test_five_hybrid_steps_match_the_reference(cache):
    losses, pm, params, (rows, jrows), (hit, jhit) = _hybrid_run(cache)
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    got = interop.params_to_jax(pm.state_dict(), pm)
    for path, ref in jax.tree_util.tree_flatten_with_path(params)[0]:
        np.testing.assert_allclose(
            dict(jax.tree_util.tree_flatten_with_path(got)[0])[path],
            np.asarray(ref), rtol=1e-5, atol=1e-7,
            err_msg=jax.tree_util.keystr(path))
    np.testing.assert_allclose(rows, jrows, rtol=1e-5, atol=1e-7)
    assert hit == jhit
    if cache:
        assert hit > 0


def test_push_takes_tensors_and_arrays_alike():
    a, b = PSEmbedding(50, 4, seed=2), PSEmbedding(50, 4, seed=2)
    idx = np.array([[1, 2, 3], [3, 4, 1]])
    grads = np.random.default_rng(4).standard_normal((2, 3, 4)).astype(
        np.float32)
    a.push(torch.tensor(idx), torch.tensor(grads))
    b.push(idx, grads)
    np.testing.assert_array_equal(a.pull(idx).numpy(), b.pull(idx).numpy())


def test_pull_prefetch_and_checkpoint(tmp_path):
    e = PSEmbedding(40, 3, optimizer="sgd", lr=0.5, cache_capacity=8)
    with pytest.raises(RuntimeError, match="no prefetch"):
        e.pull_prefetched()
    e.prefetch([1, 2])
    with pytest.raises(RuntimeError, match="not collected"):
        e.prefetch([3])
    first = e.pull_prefetched()
    np.testing.assert_array_equal(first.numpy(), e.pull([1, 2]).numpy())
    e.push([1], torch.ones(1, 3))
    e.save(tmp_path / "t.bin")  # flushes the cache first
    before = e.table.sparse_pull([1])
    e.push([1], torch.ones(1, 3))
    e.flush()
    assert not np.array_equal(e.table.sparse_pull([1]), before)
    e.load(tmp_path / "t.bin")
    np.testing.assert_array_equal(e.table.sparse_pull([1]), before)
    assert e.cache.lookups == 0
    e.close()


@pytest.mark.parametrize("kw,error", [
    (dict(endpoints="localhost:1"), (ConnectionError, "PS group over")),
    (dict(scheduler=("localhost", 1, 2)), (ConnectionError, "scheduler")),
    (dict(table_id=3), (ValueError, "remote tiers only"))],
    ids=["kw0", "kw1", "kw2"])
def test_remote_tiers_are_not_ported_yet(kw, error):
    """The remote tiers are ported (``tests/test_torch_ps_remote.py``
    trains on them): an unreachable server or scheduler raises
    ``ConnectionError``, and a ``table_id`` without a remote tier is
    refused, as in the reference."""
    with pytest.raises(error[0], match=error[1]):
        PSEmbedding(10, 2, **kw)


def test_a_failed_build_raises_with_the_compilers_output(tmp_path,
                                                         monkeypatch):
    bad = tmp_path / "hetu_ps.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(binding, "_SRCS", (bad,))
    monkeypatch.setattr(binding, "_HDRS", ())
    monkeypatch.setattr(binding, "_BUILD", tmp_path / "_build")
    monkeypatch.setattr(binding, "_SO", tmp_path / "_build" / "lib.so")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        binding.build()
    assert not (tmp_path / "_build" / "lib.so").exists()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: pinned memory and the step on the "
                    "card need CUDA")


@pytest.mark.cuda
def test_pinned_pull_feeds_a_step_on_the_card(cuda):
    e = PSEmbedding(1000, 16, pin_memory=True, cache_capacity=256)
    rows = e.pull(np.arange(64).reshape(32, 2))
    assert rows.is_pinned() and rows.dtype == torch.float32
    m = WideDeep(2, 16, 3, hidden=(8,))
    loss, _, g_rows = m.hybrid_step_fn(optim.SGDOptimizer(0.1))(
        torch.randn(32, 3), rows, torch.ones(32))
    assert g_rows.is_cuda and np.isfinite(float(loss))
    e.push(np.arange(64).reshape(32, 2), g_rows)
    e.close()
