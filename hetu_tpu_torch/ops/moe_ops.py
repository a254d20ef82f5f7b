"""MoE dispatch and combine (counterpart of ``hetu_tpu/ops/moe_ops.py``).

Two ways to move tokens to their experts and back, computing the same
function:

* the index routing (:func:`make_slot_routing`, :func:`gather_dispatch`,
  :func:`gather_combine`): O(T·k) indices and row gathers through the
  ``routed_gather`` kernels, the path ``MoELayer(dispatch_impl="gather")``
  takes.  The layer builds the routing with :func:`make_slot_routes`, whose
  ``slot_route`` and ``token_slot`` are inverse maps of each other, and
  hands each gather the inverse of its ids, so that the gradients (the
  scatter-adds) need no sort;
* the dense ``[T, E, C]`` masks (:func:`make_dispatch_combine`,
  :func:`layout_transform`, :func:`reverse_layout_transform`): two
  einsums (O(T·E·C·D) work), kept, as in the reference, for
  cross-checking.

Both place (token, choice) routes in an expert's queue in the same order
(:func:`_capacity_positions`) and drop the routes past the capacity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hetu_tpu_torch.ops.cuda_kernels.embedding import (
    routed_gather, topk_select,
)


def top_k_idx_gate(logits, k: int):
    """Top-k expert selection in plain PyTorch: ``(gates [T, k]`` softmaxed
    over the chosen k in the logits' type, ``idx [T, k]`` int32), ties to
    the lowest index as ``lax.top_k`` gives them."""
    idx = topk_select(logits, k)
    gates = torch.softmax(logits.gather(-1, idx), dim=-1)
    return gates, idx.to(torch.int32)


def _capacity_positions(expert_idx, num_experts: int, capacity: int):
    """Each (token, choice)'s position in its expert's queue: earlier tokens
    first, then the lower choice index (a cumsum over the token-major
    ``[T·k, E]`` one-hot).  Returns ``(one_hot [T, k, E], pos [T, k],
    within_capacity [T, k])``."""
    t, k = expert_idx.shape
    oh = F.one_hot(expert_idx.long(), num_experts)
    flat = oh.reshape(t * k, num_experts)
    # the running count along the routes, taken over a contiguous expert-
    # major copy: PyTorch's scan along the outer axis of [T·k, E] took
    # 6.1 ms for [32768, 8] int64 on an H100
    pos_in_expert = flat.t().contiguous().cumsum(dim=1).t() - flat
    pos = (pos_in_expert.reshape(t, k, num_experts) * oh).sum(dim=-1)
    return oh, pos, pos < capacity


def make_dispatch_combine(gates, expert_idx, num_experts: int,
                          capacity: int):
    """The dense routing masks: ``dispatch [T, E, C]`` (1 where token t
    fills slot c of expert e) and ``combine [T, E, C]`` (the same, weighted
    by the gate), both in the gates' type."""
    oh, pos, within = _capacity_positions(expert_idx, num_experts, capacity)
    slot_oh = F.one_hot(torch.where(within, pos, capacity),
                        capacity + 1)[..., :capacity].to(gates.dtype)
    oh = oh.to(gates.dtype)
    disp = torch.einsum("tke,tkc->tec", oh, slot_oh)
    comb = torch.einsum("tk,tke,tkc->tec", gates, oh, slot_oh)
    return disp, comb


def make_slot_routes(gates, expert_idx, num_experts: int, capacity: int):
    """The index routing as two maps inverse to each other (a port-internal
    form of :func:`make_slot_routing`):

    * ``slot_route [E·C]`` int32: the flat route ``t·k + j`` in each expert
      slot, -1 if empty (``slot_route // k`` is ``slot_token``);
    * ``token_slot [T, k]`` int32: each route's flat slot, -1 if dropped;
    * ``n_dropped``: how many routes overflowed their expert's capacity.
    """
    t, k = gates.shape
    _, pos, within = _capacity_positions(expert_idx, num_experts, capacity)
    token_slot = torch.where(within, expert_idx.long() * capacity + pos, -1)
    return (slot_route_of(token_slot, within, num_experts * capacity),
            token_slot.to(torch.int32), t * k - within.sum())


def slot_route_of(token_slot, within, slots: int):
    """``slot_route [slots]`` int32 from ``token_slot [T, k]`` (int64) and
    its ``within`` mask: the route ``t·k + j`` whose slot each is, -1 for a
    slot no route fills.  The same ``index_put`` that built the reference's
    ``slot_token``, with route ids in place of token ids."""
    t, k = token_slot.shape
    routes = torch.arange(t * k, dtype=torch.int32,
                          device=token_slot.device).reshape(t, k)
    # a dropped route writes to the extra slot E·C, cut off after
    slot_route = torch.full((slots + 1,), -1, dtype=torch.int32,
                            device=token_slot.device)
    slot_route[torch.where(within, token_slot, slots)] = routes
    return slot_route[:slots]


def make_slot_routing(gates, expert_idx, num_experts: int, capacity: int):
    """The index routing (O(T·k), where the masks are O(T·E·C)):

    * ``slot_token [E·C]`` int32: the token in each expert slot, -1 if empty;
    * ``token_slot [T, k]`` int32: each route's flat slot, -1 if dropped;
    * ``n_dropped``: how many routes overflowed their expert's capacity.
    """
    slot_route, token_slot, n_dropped = make_slot_routes(
        gates, expert_idx, num_experts, capacity)
    return slot_route // gates.shape[1], token_slot, n_dropped


def gather_dispatch(tokens, slot_token, num_experts: int, capacity: int, *,
                    inverse=None):
    """tokens ``[T, D]`` → expert-major ``[E, C, D]`` by row gather (empty
    slots zero), through the ``routed_gather`` kernels.  ``inverse``:
    ``token_slot [T, k]``, each token's slots, for a gradient with no
    sort."""
    rows = routed_gather(tokens, slot_token, inverse=inverse)
    return rows.reshape(num_experts, capacity, tokens.shape[-1])


def gather_combine(expert_out, token_slot, gates, *, inverse=None):
    """Expert outputs ``[E, C, D]`` → token outputs ``[T, D]``, weighted by
    the gates; a dropped route contributes zero.  ``inverse``:
    ``slot_route [E·C, 1]``, each slot's route, for a gradient with no
    sort."""
    e, c, d = expert_out.shape
    t, k = token_slot.shape
    picked = routed_gather(expert_out.reshape(e * c, d),
                           token_slot.reshape(-1),
                           inverse=inverse).reshape(t, k, d)
    return (gates[..., None].to(picked.dtype) * picked).sum(dim=1)


def balance_log_plan(scores, *, iters: int = 20):
    """The Sinkhorn iterate of :func:`balance_assignment`, ``[T, E]`` f32:
    the scores less their row max, then ``iters`` rounds of column and
    then row log-normalisation (``logsumexp`` over each axis).  No
    gradient: the assignment is an argmax of it."""
    with torch.no_grad():
        lp = scores.detach().float()
        lp = lp - lp.amax(dim=-1, keepdim=True)
        for _ in range(iters):
            lp = lp - torch.logsumexp(lp, dim=0, keepdim=True)
            lp = lp - torch.logsumexp(lp, dim=1, keepdim=True)
    return lp


def balance_assignment(scores, *, iters: int = 20):
    """Balanced token → expert assignment by Sinkhorn iteration, the
    reference's reformulation of the BASE layer's auction: the row argmax
    (the first maximum on ties) of :func:`balance_log_plan`.  ``scores
    [T, E]`` → expert index per token ``[T]`` int64."""
    return balance_log_plan(scores, iters=iters).argmax(dim=-1)


def layout_transform(tokens, dispatch):
    """Pack tokens into the ``[E, C, D]`` expert-major layout (the types
    promote as the reference's einsum promotes them)."""
    dt = torch.promote_types(tokens.dtype, dispatch.dtype)
    return torch.einsum("td,tec->ecd", tokens.to(dt), dispatch.to(dt))


def reverse_layout_transform(expert_out, combine):
    """Unpack expert outputs back to token order, weighted by the gates."""
    dt = torch.promote_types(expert_out.dtype, combine.dtype)
    return torch.einsum("ecd,tec->td", expert_out.to(dt), combine.to(dt))
