"""Distributed GCN aggregation, 1.5-D partitioning (counterpart of
``hetu_tpu/ops/distgcn.py``).

Nodes are row-sharded over the ``dp`` axis: each rank owns a contiguous
block of ``N / p`` destination rows and the edges POINTING AT them
(dst-sharded COO, the pull model; :func:`shard_edges_by_dst` lays them
out).  A layer's aggregation either all-gathers the source rows over dp
and runs the local segment sum on the owned destinations, or, for graphs
whose ``[N, F]`` features do not fit a rank, passes the source shards
round a ring of ``ppermute`` steps, consuming one shard at a time: the
same bytes on the wire, ``O(N / p)`` peak memory.

Each rank calls :func:`dist_gcn_aggregate` with its own pieces (the
reference's ``shard_map`` blocks): its ``[N / p, F]`` rows and its slice
of the edge arrays.  The result is differentiable in ``h``: the
collectives are autograd Functions whose backward is their transpose.
Every id the gather and the segment sum see is in range (the ring clips
and masks the sources of other shards), so the port's ``IndexError`` on
an id out of range never fires on a well-formed layout.
"""

from __future__ import annotations

import numpy as np
import torch

from hetu_tpu_torch.ops.graph_ops import coo_spmm
from hetu_tpu_torch.parallel import collectives
from hetu_tpu_torch.parallel.pipeline import stage_index


def dist_gcn_aggregate(h, edge_src, edge_dst, edge_weight, mesh, *,
                       axis: str = "dp", ring: bool = False):
    """``A_norm @ H`` with nodes sharded over ``axis``, on this rank.

    ``h``: this rank's ``[N / p, F]`` rows (rank ``i`` holds rows ``i·N/p``
    to ``(i+1)·N/p``).  ``edge_src``/``edge_dst``/``edge_weight``: this
    rank's ``[E / p]`` slice of :func:`shard_edges_by_dst`'s arrays, every
    edge's destination owned here; ids are GLOBAL.  ``edge_weight`` None
    weighs every edge 1.  Returns this rank's ``[N / p, F]`` rows of the
    aggregation.  ``ring=True`` rotates the source shards (``p - 1``
    rotations: the one after the last shard would go unused) instead of
    gathering them."""
    p = collectives.axis_size(axis, mesh)
    group = collectives.axis_group(axis, mesh) if p > 1 else None
    i = stage_index(group)
    n_loc = h.shape[0]
    src = torch.as_tensor(edge_src).to(device=h.device, dtype=torch.long)
    dst = torch.as_tensor(edge_dst).to(device=h.device, dtype=torch.long)
    w = None if edge_weight is None else torch.as_tensor(edge_weight).to(
        device=h.device, dtype=h.dtype)
    local_dst = dst - i * n_loc
    if not ring:
        h_all = h if group is None else collectives.all_gather(
            h, group, tiled_dim=0)
        return coo_spmm(src, local_dst, w, h_all, n_loc)
    if local_dst.numel():
        lo, hi = (int(v) for v in torch.aminmax(local_dst))
        if lo < 0 or hi >= n_loc:
            raise IndexError(f"destination ids span [{lo + i * n_loc}, "
                             f"{hi + i * n_loc}], outside rank {i}'s rows "
                             f"[{i * n_loc}, {(i + 1) * n_loc})")
    out = torch.zeros_like(h)
    h_cur = h
    for k in range(p):
        # h_cur holds shard (i - k) mod p's rows
        owner = (i - k) % p
        rel = src - owner * n_loc
        in_shard = ((rel >= 0) & (rel < n_loc))[:, None]
        msgs = h_cur.index_select(0, rel.clamp(0, n_loc - 1))
        if w is not None:
            msgs = msgs * w[:, None]
        msgs = torch.where(in_shard, msgs, torch.zeros_like(msgs))
        out = out + torch.zeros_like(h).index_add(0, local_dst, msgs)
        if k < p - 1:
            h_cur = collectives.ppermute_shift(h_cur, group, 1)
    return out


def shard_edges_by_dst(edge_src, edge_dst, edge_weight, n_nodes: int,
                       n_shards: int):
    """Host-side edge partitioner: edges sorted by owning dst shard, each
    shard padded to equal length.  Returns ``(src, dst, w)`` of shape
    ``[n_shards * max_per_shard]``, shard-major: rank ``s`` takes the
    ``s``-th equal slice.  Padding edges point at the shard's first node
    with weight 0; without weights every real edge weighs 1.  Raises
    ``ValueError`` when ``n_nodes`` does not divide by ``n_shards``."""
    if n_nodes % n_shards:
        raise ValueError(
            f"{n_nodes} nodes not divisible by {n_shards} shards: edges "
            "owned by the remainder would be silently dropped")
    src = np.asarray(edge_src)
    dst = np.asarray(edge_dst)
    w = np.asarray(edge_weight) if edge_weight is not None else None
    n_loc = n_nodes // n_shards
    owner = dst // n_loc
    buckets = [np.where(owner == s)[0] for s in range(n_shards)]
    cap = max(len(b) for b in buckets)
    S, D, W = [], [], []
    for s, b in enumerate(buckets):
        pad = cap - len(b)
        S.append(np.concatenate([src[b], np.zeros(pad, src.dtype)]))
        # padding edges point at the shard's first node with weight 0
        D.append(np.concatenate([dst[b],
                                 np.full(pad, s * n_loc, dst.dtype)]))
        if w is not None:
            W.append(np.concatenate([w[b], np.zeros(pad, w.dtype)]))
        else:
            W.append(np.concatenate([np.ones(len(b), np.float32),
                                     np.zeros(pad, np.float32)]))
    return (np.concatenate(S), np.concatenate(D),
            np.concatenate(W).astype(np.float32))
