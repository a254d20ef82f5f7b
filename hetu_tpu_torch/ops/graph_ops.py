"""Graph neural-network ops: COO message passing (counterpart of
``hetu_tpu/ops/graph_ops.py``).

The adjacency is a COO edge list (``edge_src``, ``edge_dst``), and a
product ``A @ H`` is a gather of the source rows and a segment sum over
the destinations: ``index_select`` and ``index_add`` here, as the
reference's gather and ``jax.ops.segment_sum`` run outside any Pallas
kernel.  On the card ``index_add`` sums float32 with atomics, so two runs
are not bitwise equal.

Ids outside ``[0, num_nodes)`` raise ``IndexError`` (one check, and on the
card one synchronisation, per call), where the reference clamps a source
id and drops a destination id.
"""

from __future__ import annotations

import torch


def _ids(ids, num_nodes: int, device, what: str):
    """``ids`` as int64 on ``device``, all in ``[0, num_nodes)``."""
    ids = torch.as_tensor(ids).to(device=device, dtype=torch.long)
    if ids.numel():
        lo, hi = (int(v) for v in torch.aminmax(ids))
        if lo < 0 or hi >= num_nodes:
            raise IndexError(f"{what} ids span [{lo}, {hi}], outside "
                             f"[0, {num_nodes})")
    return ids


def coo_spmm(edge_src, edge_dst, edge_weight, h, num_nodes: int):
    """``A @ H`` for a COO adjacency: ``out[d] = sum over edges (s, d) of
    w · h[s]``, ``[num_nodes, F]`` in ``h``'s type; ``edge_weight`` None
    weighs every edge 1."""
    src = _ids(edge_src, h.shape[0], h.device, "source")
    dst = _ids(edge_dst, num_nodes, h.device, "destination")
    msgs = h.index_select(0, src)
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None]
    return msgs.new_zeros((num_nodes, *h.shape[1:])).index_add(0, dst, msgs)


def in_degree(edge_dst, num_nodes: int):
    """float32 ``[num_nodes]``: the edges into each node, a segment sum of
    ones over ``edge_dst`` (in-range int64 ids)."""
    return torch.zeros(num_nodes, device=edge_dst.device).index_add(
        0, edge_dst, torch.ones(edge_dst.shape, device=edge_dst.device))


def gcn_norm(edge_src, edge_dst, num_nodes: int, *,
             add_self_loops: bool = True):
    """The symmetric GCN normalisation ``D^-1/2 (A + I) D^-1/2`` as edge
    weights: ``(src, dst, weight)``, int64 ids (the self loops appended)
    and float32 weights ``rsqrt(max(deg, 1))`` of both ends, the degree
    counted over the destinations."""
    device = torch.as_tensor(edge_dst).device
    src = _ids(edge_src, num_nodes, device, "source")
    dst = _ids(edge_dst, num_nodes, device, "destination")
    if add_self_loops:
        loops = torch.arange(num_nodes, device=device)
        src = torch.cat([src, loops])
        dst = torch.cat([dst, loops])
    dinv = torch.rsqrt(in_degree(dst, num_nodes).clamp_min(1.0))
    return src, dst, dinv[src] * dinv[dst]


def gcn_conv(h, w_param, edge_src, edge_dst, edge_weight, num_nodes: int):
    """One GCN layer: ``A_norm @ (H W)``, the product first."""
    return coo_spmm(edge_src, edge_dst, edge_weight, h @ w_param, num_nodes)
