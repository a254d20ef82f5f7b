"""GraphMix-style graph sampling over the parameter-server plane
(counterpart of ``hetu_tpu/data/graph_sampler.py``).

The graph lives in PS tables: adjacency rows, features and labels, in any
tier (``ps.PSTable`` in process, ``ps.van.RemotePSTable`` on one van
server, ``ps.van.PartitionedPSTable`` key-range partitioned over many).  A
:class:`NeighborSampler` pulls frontier rows, samples ``fanout``
neighbours a hop (GraphSAGE-style), relabels them to a compact node set
and returns COO edges and features ready for
:func:`~hetu_tpu_torch.ops.graph_ops.gcn_norm` and ``gcn_conv``.
Sampling is host numpy; the batch is padded to static shapes.

With the same tables and seed the batches are bitwise the reference's:
the same draws from ``np.random.default_rng`` in the same order.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


class DistGraph:
    """A graph in three PS tables.

    Adjacency row v: ``[degree, n_0, ..., n_{K-1}]``, zero-padded to
    ``max_degree``; a node's neighbours are in edge order, and a node with
    more than ``max_degree`` is uniformly downsampled at publish time.
    Ids are stored in float32 rows, exact below 2^24.
    """

    def __init__(self, adj_table, feat_table, label_table,
                 max_degree: int):
        self.adj = adj_table
        self.feat = feat_table
        self.label = label_table
        self.max_degree = max_degree
        self.num_nodes = adj_table.rows

    @staticmethod
    def publish(edge_src, edge_dst, features, labels, *, max_degree: int,
                table_factory, seed: int = 0) -> "DistGraph":
        """Build the three tables from COO edges through
        ``table_factory(rows, dim, tag)`` (tag ``"adj"``, ``"feat"`` or
        ``"label"``), which returns a table of any tier.  Raises at 2^24
        nodes or more, whose ids a float32 row would alias."""
        features = np.asarray(features, np.float32)
        labels = np.asarray(labels)
        n, f = features.shape
        if n >= 1 << 24:
            raise ValueError(
                f"DistGraph.publish: {n} nodes exceeds the float32-exact "
                "id range (2^24); shard the graph into multiple DistGraphs")
        src = np.asarray(edge_src).astype(np.int64)
        dst = np.asarray(edge_dst).astype(np.int64)
        # each node's neighbours in edge order: a stable sort by source
        order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]
        deg = np.bincount(src, minlength=n)
        start = np.concatenate([[0], np.cumsum(deg)])
        adj_rows = np.zeros((n, max_degree + 1), np.float32)
        adj_rows[:, 0] = np.minimum(deg, max_degree)
        pos = np.arange(src.size) - start[src]
        fits = deg[src] <= max_degree
        adj_rows[src[fits], 1 + pos[fits]] = dst[fits]
        # the reference's downsampling: one draw a node, in node order
        rng = np.random.default_rng(seed)
        for v in np.flatnonzero(deg > max_degree):
            adj_rows[v, 1:] = rng.choice(dst[start[v]:start[v + 1]],
                                         max_degree, replace=False)
        adj = table_factory(n, max_degree + 1, "adj")
        feat = table_factory(n, f, "feat")
        lab = table_factory(n, 1, "label")
        ids = np.arange(n)
        adj.sparse_set(ids, adj_rows)
        feat.sparse_set(ids, features)
        lab.sparse_set(ids, labels.reshape(n, 1).astype(np.float32))
        return DistGraph(adj, feat, lab, max_degree)

    def neighbors(self, nodes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """``(degree [n], neighbours [n, max_degree])`` as int64."""
        rows = self.adj.sparse_pull(nodes)
        deg = rows[:, 0].astype(np.int64)
        return deg, rows[:, 1:].astype(np.int64)

    def features(self, nodes: np.ndarray) -> np.ndarray:
        return self.feat.sparse_pull(nodes)

    def labels(self, nodes: np.ndarray) -> np.ndarray:
        return self.label.sparse_pull(nodes)[:, 0].astype(np.int64)


class NeighborSampler:
    """Layered neighbour sampling from a :class:`DistGraph`.

    ``sample(seeds, fanouts)`` pulls ``len(fanouts)`` hops of neighbours,
    unions them into a compact node set (the seeds first, deduplicated in
    order) and returns the sampled edges relabelled to ``[0, n_sub)``,
    messages flowing neighbour → seed."""

    def __init__(self, graph: DistGraph, *, seed: int = 0):
        self.g = graph
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: Sequence[int], fanouts: Sequence[int],
               ) -> "SampledBatch":
        seeds = np.asarray(seeds, np.int64)
        nodes = list(dict.fromkeys(seeds.tolist()))  # ordered unique
        n_seed = len(nodes)
        index = {v: i for i, v in enumerate(nodes)}
        src_l: List[int] = []
        dst_l: List[int] = []
        frontier = seeds
        for fanout in fanouts:
            frontier = np.unique(frontier)
            deg, neigh = self.g.neighbors(frontier)
            nxt: List[int] = []
            for v, d, ns in zip(frontier.tolist(), deg.tolist(), neigh):
                if d == 0:
                    continue
                cand = ns[:d]
                take = cand if d <= fanout else \
                    self.rng.choice(cand, fanout, replace=False)
                iv = index[v]
                for u in take.tolist():
                    if u not in index:
                        index[u] = len(nodes)
                        nodes.append(u)
                    src_l.append(index[u])
                    dst_l.append(iv)
                    nxt.append(u)
            frontier = np.asarray(nxt, np.int64)
        nodes_arr = np.asarray(nodes, np.int64)
        seed_mask = np.zeros(len(nodes_arr), np.float32)
        seed_mask[:n_seed] = 1.0
        return SampledBatch(
            nodes=nodes_arr,
            edge_src=np.asarray(src_l, np.int64),
            edge_dst=np.asarray(dst_l, np.int64),
            features=self.g.features(nodes_arr),
            labels=self.g.labels(nodes_arr),
            seed_mask=seed_mask)


class SampledBatch:
    """A host-side GNN minibatch: compact node ids, COO edges, features,
    labels, and the seed mask (the loss runs on the seeds only)."""

    def __init__(self, nodes, edge_src, edge_dst, features, labels,
                 seed_mask):
        self.nodes = nodes
        self.edge_src = edge_src
        self.edge_dst = edge_dst
        self.features = features
        self.labels = labels
        self.seed_mask = seed_mask

    def pad_to(self, n_nodes: int, n_edges: int) -> "SampledBatch":
        """Pad to static shapes: the padding edges are self loops on the
        last node slot, a padding node (id -1, zero features, outside the
        seed mask)."""
        cn = len(self.nodes)
        ce = len(self.edge_src)
        if cn > n_nodes or ce > n_edges:
            raise ValueError(f"batch ({cn} nodes, {ce} edges) exceeds pad "
                             f"target ({n_nodes}, {n_edges})")
        if ce < n_edges and cn >= n_nodes:
            # a padding edge on a real node would change its degree and
            # its messages
            raise ValueError(
                f"batch fills all {n_nodes} node slots but needs padding "
                "edges; raise n_nodes by one")
        feats = np.zeros((n_nodes, self.features.shape[1]), np.float32)
        feats[:cn] = self.features
        labels = np.zeros((n_nodes,), np.int64)
        labels[:cn] = self.labels
        mask = np.zeros((n_nodes,), np.float32)
        mask[:cn] = self.seed_mask
        pad_node = n_nodes - 1
        src = np.full((n_edges,), pad_node, np.int64)
        dst = np.full((n_edges,), pad_node, np.int64)
        src[:ce] = self.edge_src
        dst[:ce] = self.edge_dst
        return SampledBatch(
            nodes=np.concatenate([self.nodes,
                                  np.full(n_nodes - cn, -1, np.int64)]),
            edge_src=src, edge_dst=dst, features=feats, labels=labels,
            seed_mask=mask)
