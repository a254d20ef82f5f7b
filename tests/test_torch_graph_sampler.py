"""The graph sampler of hetu_tpu_torch against hetu_tpu's, on the CPU
(``tests/test_graph_sampler.py`` mirrored): ``DistGraph.publish`` and the
neighbour pulls, layered sampling (every edge real, fan-in bounded by the
fanouts), ``SampledBatch.pad_to``, the GraphMix loop that trains the
port's GCN on a graph partitioned over two van servers, and two worker
processes sampling from that graph at once.

With the same tables and seed the port's tables and batches are bitwise
the reference's: in process (each package's ``PSTable``) and across the
tiers (the port's sampler over the partitioned tables against the
reference's over its in-process tables), downsampled neighbour lists
included.  Servers and workers are processes of their own, importing the
port and never ``jax``; each prints READY or OK within a deadline and is
killed at the end.
"""

import select
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hetu_tpu.data import graph_sampler as jgs
from hetu_tpu.ps import client as jclient
from hetu_tpu_torch import models, ops
from hetu_tpu_torch.data.graph_sampler import (
    DistGraph, NeighborSampler, SampledBatch,
)
from hetu_tpu_torch.ps import PSTable, binding, van

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
READY_S = 60.0
SERVER = ("import sys\nsys.path.insert(0, sys.argv[1])\n"
          "from hetu_tpu_torch.ps import van\n"
          "print('READY', van.serve(0), flush=True)\n"
          "sys.stdin.read()\n")


def _two_cluster_graph(n=40, seed=0):
    """``tests/test_graph_sampler.py``'s graph: two dense communities and
    sparse cross edges; the label is the community."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    half = n // 2
    for v in range(n):
        mates = [u for u in range(half) if u != v] if v < half else \
            [u for u in range(half, n) if u != v]
        for u in rng.choice(mates, 6, replace=False):
            src.append(v)
            dst.append(int(u))
        if rng.random() < 0.2:
            other = rng.integers(half, n) if v < half else \
                rng.integers(0, half)
            src.append(v)
            dst.append(int(other))
    labels = np.asarray([0] * half + [1] * (n - half))
    feats = rng.standard_normal((n, 8)).astype(np.float32) \
        + labels[:, None] * 2.0
    return np.asarray(src), np.asarray(dst), feats, labels


def _local_factory(rows, dim, tag):
    return PSTable(rows, dim, init="zeros")


def _ref_factory(rows, dim, tag):
    return jclient.PSTable(rows, dim, init="zeros")


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _same_batch(a, b):
    for k in ("nodes", "edge_src", "edge_dst", "labels"):
        got, ref = getattr(a, k), getattr(b, k)
        assert got.dtype == ref.dtype and np.array_equal(got, ref), k
    for k in ("features", "seed_mask"):
        np.testing.assert_array_equal(_bits(getattr(a, k)),
                                      _bits(getattr(b, k)))


def _skewed_graph(seed=5):
    """Hubs of degree 30-60 among nodes of degree 0-8, so ``max_degree``
    10 downsamples some lists (edges in a shuffled order)."""
    g = np.random.default_rng(seed)
    n = 60
    deg = g.integers(0, 9, n)
    deg[g.choice(n, 6, replace=False)] = g.integers(30, 61, 6)
    src = np.repeat(np.arange(n), deg)
    dst = g.integers(0, n, src.size)
    perm = g.permutation(src.size)
    feats = g.standard_normal((n, 5)).astype(np.float32)
    return src[perm], dst[perm], feats, g.integers(0, 3, n)


def _tables(graph):
    n = graph.num_nodes
    ids = np.arange(n)
    return [t.sparse_pull(ids) for t in (graph.adj, graph.feat,
                                         graph.label)]


@pytest.mark.parametrize("graph", ["two_cluster", "skewed"])
def test_tables_and_batches_are_bitwise_the_references(graph):
    src, dst, feats, labels = (_two_cluster_graph() if graph ==
                               "two_cluster" else _skewed_graph())
    mine = DistGraph.publish(src, dst, feats, labels, max_degree=10,
                             table_factory=_local_factory, seed=3)
    ref = jgs.DistGraph.publish(src, dst, feats, labels, max_degree=10,
                                table_factory=_ref_factory, seed=3)
    for a, b in zip(_tables(mine), _tables(ref)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    if graph == "skewed":
        assert (_tables(mine)[0][:, 0] == 10).any()
    s, r = NeighborSampler(mine, seed=1), jgs.NeighborSampler(ref, seed=1)
    g = np.random.default_rng(2)
    for fanouts in ([3, 2], [5], [4, 3, 2]):
        seeds = g.integers(0, len(feats), 6)  # duplicates too
        a, b = s.sample(seeds, fanouts), r.sample(seeds, fanouts)
        _same_batch(a, b)
        _same_batch(a.pad_to(len(feats) + 1, 200),
                    b.pad_to(len(feats) + 1, 200))


def test_publish_and_neighbor_pull():
    src, dst, feats, labels = _two_cluster_graph()
    g = DistGraph.publish(src, dst, feats, labels, max_degree=10,
                          table_factory=_local_factory)
    assert g.num_nodes == 40 and g.max_degree == 10
    deg, neigh = g.neighbors(np.asarray([0, 5]))
    true0 = set(dst[src == 0].tolist())
    got0 = set(neigh[0][:deg[0]].tolist())
    assert got0 <= true0 and len(got0) == min(len(true0), 10)
    assert deg.dtype == neigh.dtype == np.int64
    np.testing.assert_allclose(g.features(np.asarray([3])), feats[3:4])
    assert g.labels(np.asarray([25]))[0] == labels[25]


def test_publish_refuses_ids_a_float32_row_would_alias():
    big = np.broadcast_to(np.float32(0), (1 << 24, 1))
    with pytest.raises(ValueError, match="2\\^24"):
        DistGraph.publish(np.zeros(0, int), np.zeros(0, int), big,
                          np.zeros(1 << 24, np.int8), max_degree=4,
                          table_factory=_local_factory)


def _fan_in_bounded(batch, fanouts):
    """A seed takes at most the first hop's fanout plus the later ones';
    any other node at most the later hops' (it enters at hop 1 or
    later)."""
    indeg = np.bincount(batch.edge_dst, minlength=len(batch.nodes))
    n_seed = int(batch.seed_mask.sum())
    return indeg[:n_seed].max(initial=0) <= sum(fanouts) and \
        indeg[n_seed:].max(initial=0) <= sum(fanouts[1:])


def test_sampled_edges_are_real_and_fanout_bounded():
    src, dst, feats, labels = _two_cluster_graph()
    g = DistGraph.publish(src, dst, feats, labels, max_degree=10,
                          table_factory=_local_factory)
    batch = NeighborSampler(g, seed=1).sample([0, 1, 2, 3], fanouts=[3, 2])
    true_edges = {(int(a), int(b)) for a, b in zip(src, dst)}
    for u, v in zip(batch.edge_src, batch.edge_dst):
        # edge u -> v: v pulled u as a neighbour, so (v, u) is real
        assert (int(batch.nodes[v]), int(batch.nodes[u])) in true_edges
    assert _fan_in_bounded(batch, [3, 2])
    assert batch.seed_mask.sum() == 4 and batch.seed_mask[:4].all()
    np.testing.assert_array_equal(batch.nodes[:4], [0, 1, 2, 3])


def test_pad_to_static_shapes():
    src, dst, feats, labels = _two_cluster_graph()
    g = DistGraph.publish(src, dst, feats, labels, max_degree=10,
                          table_factory=_local_factory)
    s = NeighborSampler(g, seed=2)
    raw = s.sample([4, 5], fanouts=[3])
    b = raw.pad_to(32, 64)
    assert isinstance(b, SampledBatch)
    assert b.features.shape == (32, 8) and b.edge_src.shape == (64,)
    assert b.seed_mask.sum() == 2
    cn, ce = len(raw.nodes), len(raw.edge_src)
    assert (b.nodes[cn:] == -1).all() and (b.edge_src[ce:] == 31).all()
    assert (b.edge_dst[ce:] == 31).all() and not b.features[cn:].any()
    with pytest.raises(ValueError, match="exceeds"):
        s.sample(list(range(20)), fanouts=[5, 5]).pad_to(4, 4)
    with pytest.raises(ValueError, match="raise n_nodes"):
        raw.pad_to(cn, ce + 1)


class _Procs:
    """Processes started from ``sys.executable``, killed on exit."""

    def __init__(self):
        self.procs = []

    def start(self, *args, **kw):
        p = subprocess.Popen([sys.executable, *args], text=True, **kw)
        self.procs.append(p)
        return p

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)


def _servers(procs, n):
    """``n`` port van servers; their endpoints once each printed READY."""
    binding.load()  # built here first: the children only load it
    started = [procs.start("-c", SERVER, str(REPO), stdin=subprocess.PIPE,
                           stdout=subprocess.PIPE) for _ in range(n)]
    eps = []
    for p in started:
        ready = select.select([p.stdout], [], [], READY_S)[0]
        line = p.stdout.readline() if ready else ""
        assert line.startswith("READY"), f"server: {line!r}"
        eps.append(("127.0.0.1", int(line.split()[1])))
    return eps


def _partitioned(eps, base_id):
    tags = {}

    def factory(rows, dim, tag):
        tags[tag] = van.PartitionedPSTable(
            eps, rows, dim, init="zeros",
            table_id=base_id + ["adj", "feat", "label"].index(tag))
        return tags[tag]
    return factory, tags


def test_distributed_sampling_trains_gcn():
    """The GraphMix loop: the graph partitioned over two van server
    processes, the port's sampler bitwise the reference's in-process one,
    and the port's GCN trained on the sampled subgraphs separates the two
    communities."""
    with _Procs() as procs:
        eps = _servers(procs, 2)
        factory, tags = _partitioned(eps, 9100)
        src, dst, feats, labels = _two_cluster_graph(n=40)
        g = DistGraph.publish(src, dst, feats, labels, max_degree=10,
                              table_factory=factory)
        assert tags["adj"].n_servers == 2
        ref = jgs.DistGraph.publish(src, dst, feats, labels, max_degree=10,
                                    table_factory=_ref_factory)
        for a, b in zip(_tables(g), _tables(ref)):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        sampler = NeighborSampler(g, seed=3)
        ref_sampler = jgs.NeighborSampler(ref, seed=3)
        model = models.GCN(8, 16, 2, dropout_rate=0.0,
                           generator=torch.Generator().manual_seed(0),
                           device="cpu")
        params = list(model.parameters())
        rng = np.random.default_rng(0)
        losses = []
        for _ in range(30):
            seeds = rng.choice(40, 8, replace=False)
            raw = sampler.sample(seeds, fanouts=[4, 3])
            _same_batch(raw, ref_sampler.sample(seeds, fanouts=[4, 3]))
            b = raw.pad_to(64, 256)
            es, ed, ew = ops.gcn_norm(torch.tensor(b.edge_src),
                                      torch.tensor(b.edge_dst), 64)
            logits = model(torch.tensor(b.features), es, ed, ew)
            mask = torch.tensor(b.seed_mask)
            per = ops.softmax_cross_entropy_sparse(logits,
                                                   torch.tensor(b.labels))
            loss = (per * mask).sum() / mask.sum().clamp_min(1)
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                for p, gr in zip(params, grads):
                    p -= 0.3 * gr
            losses.append(float(loss.detach()))
        assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.7, losses


WORKER = """
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
from hetu_tpu_torch.data.graph_sampler import DistGraph, NeighborSampler
from hetu_tpu_torch.ps import van

wid, n, out = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
eps = [("127.0.0.1", int(p)) for p in sys.argv[5:]]
tables = [van.PartitionedPSTable(eps, n, dim, init="zeros",
                                 table_id=9200 + i)
          for i, dim in enumerate((11, 8, 1))]
sampler = NeighborSampler(DistGraph(*tables, max_degree=10), seed=10 + wid)
rng = np.random.default_rng(wid)
src, dst = [], []
for _ in range(5):
    batch = sampler.sample(rng.integers(0, n, 6), fanouts=(4, 3))
    assert batch.features.shape[1] == 8
    src.append(batch.nodes[batch.edge_src])
    dst.append(batch.nodes[batch.edge_dst])
np.savez(out, src=np.concatenate(src), dst=np.concatenate(dst))
print("OK", "jax" in sys.modules, flush=True)
"""


def test_two_workers_sample_same_distributed_graph(tmp_path):
    """Two worker processes sample at once from one graph partitioned
    over two server processes; every sampled edge (relabelled to global
    ids) is an edge of the published graph, and no worker imports
    ``jax``."""
    with _Procs() as procs:
        eps = _servers(procs, 2)
        factory, _ = _partitioned(eps, 9200)
        n = 40
        src, dst, feats, labels = _two_cluster_graph(n=n)
        DistGraph.publish(src, dst, feats, labels, max_degree=10,
                          table_factory=factory)
        outs = [str(tmp_path / f"w{i}.npz") for i in range(2)]
        workers = [procs.start(
            "-c", WORKER, str(REPO), str(i), str(n), outs[i],
            *(str(p) for _, p in eps), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE) for i in range(2)]
        for w in workers:
            so, se = w.communicate(timeout=120)
            assert w.returncode == 0 and "OK False" in so, se[-2000:]
        real = set(zip(src.tolist(), dst.tolist()))
        for o in outs:
            z = np.load(o)
            assert len(z["src"]) > 0
            for s_, d_ in zip(z["src"].tolist(), z["dst"].tolist()):
                assert (d_, s_) in real, (s_, d_)
