"""Mixture-of-Experts layer and its gates (counterpart of
``hetu_tpu/layers/moe.py``).

gate → dispatch → ``Expert`` → combine, on one device.  Five gates, the
reference's: ``TopKGate`` (the fused top-k kernel, ``impl="auto"``/
``"pallas"``, or plain PyTorch, ``"xla"``), ``HashGate`` (id mod E),
``KTop1Gate`` (one winner in each of k expert groups),
``BalanceAssignmentGate`` (Sinkhorn-balanced) and ``SAMGate`` (nearest
centroid, rescored by the group sum).  Each returns ``(gates [T, k], idx
[T, k], aux)``.  The dispatch and the combine move rows with the
``routed_gather`` kernels (``dispatch_impl="gather"``) or with the dense
einsum masks (``"einsum"``), whatever the gate.  A gate's parameters sit
where the reference keeps them (``gate_w [D, E]``, ``centroids [E, D]``);
the expert weights are stacked ``[E, ...]``.

Under an expert-parallel ``mesh`` the expert weights are DTensors split
on the expert dim over ``ep`` (``Shard(0)``) and the tokens stay whole on
every rank, as in the reference.  Each rank routes its tokens, then on
local tensors (:func:`expert_parallel`): the gather dispatch to ``[E, C,
D]``, an all-to-all over ``ep`` (the expert dim split, the capacity dim
concatenated), its own experts, the reverse all-to-all and the gather
combine.  The reference leaves the all-to-all pair to XLA's partitioner
and keeps the gate and the gathers out of Pallas there (SPMD cannot split
a ``pallas_call``); here the gate's top-k kernel and the gather kernels
run on each rank's local tensors, computing the same function.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from hetu_tpu_torch import init as initializers
from hetu_tpu_torch import ops
from hetu_tpu_torch.layers.base import Module
from hetu_tpu_torch.ops.cuda_kernels.embedding import topk_gating
from hetu_tpu_torch.ops.moe_ops import balance_assignment
from hetu_tpu_torch.ops.reduce import sam_group_sum
from hetu_tpu_torch.parallel import collectives


class TopKGate(Module):
    """Top-k softmax gate with the GShard load-balancing loss.

    ``gate_w`` ``[D, E]`` (the reference's ``[in, out]``) is f32 and the
    logits are f32 whatever the tokens' type.  ``forward(tokens [T, D])`` →
    ``(gates [T, k]`` in f32, ``idx [T, k]`` int32, ``aux)``.

    ``impl``: ``"auto"`` (or ``"pallas"``, the reference's other name for
    it) runs the top-k kernel, which takes any T; ``"xla"`` runs
    :func:`ops.top_k_idx_gate`.  The reference's kernel tiles T into
    power-of-two blocks, so there "auto" leaves it for other T and "pallas"
    raises; the port's kernel has no such rule.  On CPU tensors the
    kernel's wrapper computes its plain version."""

    def __init__(self, hidden_size: int, num_experts: int, k: int = 2, *,
                 generator: torch.Generator, aux_weight: float = 1e-2,
                 impl: str = "auto"):
        super().__init__()
        if impl not in ("auto", "xla", "pallas"):
            raise ValueError(f"impl {impl!r}: 'auto', 'xla' or 'pallas'")
        self.hidden_size, self.num_experts, self.k = (hidden_size,
                                                      num_experts, k)
        self.aux_weight = aux_weight
        self.impl = impl
        self.gate_w = nn.Parameter(initializers.xavier_uniform()(
            generator, (hidden_size, num_experts)))

    @property
    def uses_kernel(self) -> bool:
        """Whether the gate runs the top-k kernel (every impl but "xla")."""
        return self.impl != "xla"

    def forward(self, tokens):
        logits = ops.linear(tokens.float(), self.gate_w)
        probs = torch.softmax(logits, dim=-1)
        if self.uses_kernel:
            gates, idx = topk_gating(logits, self.k)
        else:
            gates, idx = ops.top_k_idx_gate(logits, self.k)
        # GShard aux: E * sum_e (mean gate prob_e * mean dispatch frac_e)
        me = probs.mean(dim=0)
        ce = F.one_hot(idx[:, 0].long(), self.num_experts).float().mean(dim=0)
        aux = self.aux_weight * self.num_experts * (me * ce).sum()
        return gates, idx, aux


def _no_aux(like):
    """The zero load-balancing loss of the gates that have none."""
    return torch.zeros((), dtype=torch.float32, device=like.device)


class HashGate(Module):
    """Deterministic hash routing: expert = token id mod E, gate 1.
    ``forward(token_ids)`` (any integer shape; the ids, not the tokens'
    features: ``MoELayer(..., gate_input=ids)``) → ``(gates [T, 1]`` f32,
    ``idx [T, 1]`` int32, ``aux = 0)``.  The mod floors, as the
    reference's ``%`` does (a negative id maps into ``[0, E)``)."""

    def __init__(self, num_experts: int):
        super().__init__()
        self.num_experts = num_experts

    def forward(self, token_ids):
        ids = token_ids.reshape(-1)
        idx = torch.remainder(ids, self.num_experts).to(torch.int32)
        gates = torch.ones((idx.shape[0], 1), dtype=torch.float32,
                           device=idx.device)
        return gates, idx[:, None], _no_aux(idx)


class KTop1Gate(Module):
    """k groups of E / k experts, one winner in each: a token takes the
    argmax of its logits in every group (the first maximum on ties), and
    its gates are the softmax over the k winners' logits.
    ``forward(tokens [T, D])`` → ``(gates [T, k]`` f32, ``idx [T, k]``
    int32, ``aux = 0)``."""

    def __init__(self, hidden_size: int, num_experts: int, k: int = 2, *,
                 generator: torch.Generator):
        super().__init__()
        if num_experts % k:
            raise ValueError(f"num_experts {num_experts} is not a multiple "
                             f"of k {k}")
        self.hidden_size, self.num_experts, self.k = (hidden_size,
                                                      num_experts, k)
        self.gate_w = nn.Parameter(initializers.xavier_uniform()(
            generator, (hidden_size, num_experts)))

    def forward(self, tokens):
        logits = ops.linear(tokens.float(), self.gate_w)
        t, per = logits.shape[0], self.num_experts // self.k
        grouped = logits.reshape(t, self.k, per)
        offset = torch.arange(self.k, dtype=torch.int32,
                              device=logits.device) * per
        idx = grouped.argmax(dim=-1).to(torch.int32) + offset
        # amax, not max(dim): its gradient splits over tied maxima as
        # jnp.max's does
        gates = torch.softmax(grouped.amax(dim=-1), dim=-1)
        return gates, idx, _no_aux(logits)


class BalanceAssignmentGate(Module):
    """The BASE layer's balanced assignment, by Sinkhorn iteration
    (:func:`ops.balance_assignment`, ``iters`` rounds): one expert a
    token, gated by the sigmoid of the token's score there.
    ``forward(tokens [T, D])`` → ``(gates [T, 1]`` f32, ``idx [T, 1]``
    int32, ``aux = 0)``."""

    def __init__(self, hidden_size: int, num_experts: int, iters: int = 20,
                 *, generator: torch.Generator):
        super().__init__()
        self.hidden_size, self.num_experts, self.iters = (
            hidden_size, num_experts, iters)
        self.gate_w = nn.Parameter(initializers.xavier_uniform()(
            generator, (hidden_size, num_experts)))

    def forward(self, tokens):
        scores = ops.linear(tokens.float(), self.gate_w)
        idx = balance_assignment(scores, iters=self.iters)[:, None]
        gates = torch.sigmoid(scores).gather(-1, idx)
        return gates, idx.to(torch.int32), _no_aux(scores)


class SAMGate(Module):
    """The switch-and-mix gate: a token goes to the centroid of highest
    dot-product affinity (the first on ties), and its gate is the sigmoid
    of its group's score, the group sum of its tokens
    (:func:`ops.sam_group_sum`) dotted with the centroid.  The gradient
    reaches ``centroids`` and the tokens through the group sum.
    ``forward(tokens [T, D])`` → ``(gates [T, 1]`` f32, ``idx [T, 1]``
    int32, ``aux = 0)``."""

    def __init__(self, hidden_size: int, num_experts: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.hidden_size, self.num_experts = hidden_size, num_experts
        self.centroids = nn.Parameter(initializers.xavier_uniform()(
            generator, (num_experts, hidden_size)))

    def forward(self, tokens):
        c = self.centroids
        t = tokens.float()
        idx = (t @ c.t()).argmax(dim=-1)
        gscore = (sam_group_sum(t, idx, self.num_experts) * c).sum(dim=-1)
        gates = torch.sigmoid(gscore[idx])[:, None]
        return gates, idx.to(torch.int32)[:, None], _no_aux(t)


class _F32Bmm(torch.autograd.Function):
    """``a [E, M, K] @ b [E, K, N]`` in a narrower type with an f32 result.
    Forward: bf16 tensor-core products with f32 output on the card
    (``torch.bmm(..., out_dtype=torch.float32)``, which has no autograd
    formula), f32 products of the up-cast operands on the CPU (where that
    overload has no kernel); both exact products summed in f32.  Backward:
    the f32 cotangent times the other operand up-cast to f32, rounded to
    the operand's type, as JAX differentiates a dot with
    ``preferred_element_type=float32``."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.device.type == "cuda":
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.float(), b.float())

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
        gb = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
        return ga, gb


def expert_matmul(a, b):
    """``a [E, M, K] @ b [E, K, N]`` with an f32 result: the reference's
    ``einsum(..., preferred_element_type=float32)``, whose bf16 products
    are not rounded to bf16 before the bias."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    return _F32Bmm.apply(a, b)


class Expert(Module):
    """Stacked FFN experts: ``w1 [E, D, F]``, ``b1 [E, F]``, ``w2 [E, F, D]``,
    ``b2 [E, D]`` (f32 master weights, He-normal weights and zero biases),
    computing in ``dtype`` with f32 products:
    ``xe [E, C, D]`` → ``[E, C, D]`` in f32."""

    def __init__(self, num_experts: int, hidden_size: int, ffn_size: int, *,
                 generator: torch.Generator, activation=ops.gelu,
                 dtype=torch.float32):
        super().__init__()
        self.num_experts, self.hidden_size, self.ffn_size = (
            num_experts, hidden_size, ffn_size)
        self.activation = activation
        self.dtype = dtype
        he = initializers.he_normal()
        e, d, f = num_experts, hidden_size, ffn_size
        self.w1 = nn.Parameter(he(generator, (e, d, f)))
        self.b1 = nn.Parameter(initializers.zeros()(generator, (e, f)))
        self.w2 = nn.Parameter(he(generator, (e, f, d)))
        self.b2 = nn.Parameter(initializers.zeros()(generator, (e, d)))

    def forward(self, xe):
        """``xe [E, C, D]`` → ``[E, C, D]`` in f32; under an expert-parallel
        mesh, this rank's experts (``[E/ep, C', D]``)."""
        dt = self.dtype
        w1, b1, w2, b2 = (_local(p) for p in (self.w1, self.b1, self.w2,
                                              self.b2))
        h = expert_matmul(xe.to(dt), w1.to(dt)) + b1[:, None]
        h = self.activation(h)
        return expert_matmul(h.to(dt), w2.to(dt)) + b2[:, None]


def _local(p):
    """A DTensor parameter's local piece (differentiable); a plain tensor
    as it is."""
    return p.to_local() if hasattr(p, "to_local") else p


def expert_parallel(tokens, gates, idx, num_experts: int, capacity: int,
                    experts_fn, group=None):
    """Route ``tokens [T, D]`` to their experts and back by index: the
    gather dispatch to ``[E, C, D]``; over ``group`` (the ``ep`` axis'
    process group; None: one rank) an all-to-all that sends each rank its
    experts' slots (``[E/ep, ep*C, D]``); ``experts_fn``; the reverse
    all-to-all; the gate-weighted gather combine.  Returns ``(out [T, D]``
    f32, the count of routes dropped past ``capacity``).  Differentiable;
    the all-to-all's gradient is the reverse all-to-all."""
    k = gates.shape[1]
    slot_route, token_slot, n_dropped = ops.make_slot_routes(
        gates, idx, num_experts, capacity)
    # each gather gets its ids' inverse map, so that its gradient (the
    # scatter-add) reads every row's sources with no sort
    xe = ops.gather_dispatch(tokens, slot_route // k, num_experts, capacity,
                             inverse=token_slot)
    if group is not None:
        xe = collectives.all_to_all(xe, group, split_dim=0, concat_dim=1)
    ye = experts_fn(xe)
    if group is not None:
        ye = collectives.all_to_all(ye, group, split_dim=1, concat_dim=0)
    out = ops.gather_combine(ye, token_slot, gates,
                             inverse=slot_route[:, None])
    return out, n_dropped


class MoELayer(Module):
    """gate → dispatch → experts → combine, with any of the five gates.

    ``capacity_factor`` bounds the tokens an expert takes:
    ``C = max(1, int(cf * T * k / E))`` with the gate's ``k`` (1 for a gate
    without one, as the reference reads it); routes past it are dropped,
    as in the reference.  ``forward(x [B, S, D] or [T, D], gate_input=None)``
    → ``(out, aux)`` with ``out`` in f32 and shaped like ``x``; the gate
    routes by ``gate_input`` where it is given (``HashGate``'s token ids),
    else by the tokens; with ``return_metrics``,
    ``(out, aux, {"dropped_frac": ...})``, the share of (token, choice)
    routes dropped.

    ``mesh`` (a ``make_mesh`` mesh with an ``ep_axis`` axis) makes the
    layer expert-parallel: ``experts``' weights become DTensors split over
    ``ep_axis`` on their expert dim, in place; every rank gives the layer
    the same ``x`` and gets the same ``out`` (the gather route only).  A
    loss every rank computes from ``out`` gives each rank the gradient of
    its experts and the whole gradient of ``x`` and the gate."""

    def __init__(self, gate: Module, experts: Expert, *,
                 capacity_factor: float = 1.25, mesh=None,
                 ep_axis: str = "ep", dispatch_impl: str = "gather"):
        super().__init__()
        if dispatch_impl not in ("gather", "einsum"):
            raise ValueError(f"dispatch_impl {dispatch_impl!r}: "
                             "'gather' or 'einsum'")
        self.gate = gate
        self.experts = experts
        self.capacity_factor = capacity_factor
        self.dispatch_impl = dispatch_impl
        self.mesh = mesh
        self.ep_axis = ep_axis
        if mesh is not None:
            self._shard_experts()

    def _shard_experts(self):
        from hetu_tpu_torch.parallel.mesh import host_to_device
        from hetu_tpu_torch.parallel.spec import placements
        if self.dispatch_impl != "gather":
            raise ValueError("an expert-parallel MoELayer takes "
                             "dispatch_impl='gather'")
        n = collectives.axis_size(self.ep_axis, self.mesh)
        if self.experts.num_experts % n:
            raise ValueError(f"{self.experts.num_experts} experts do not "
                             f"split over {self.ep_axis}={n}")
        pl = placements(self.mesh, (self.ep_axis,))
        for name in ("w1", "b1", "w2", "b2"):
            p = getattr(self.experts, name).detach()
            whole = p.full_tensor() if hasattr(p, "full_tensor") else p
            setattr(self.experts, name, nn.Parameter(
                host_to_device(whole, self.mesh, pl)))

    def forward(self, x, *, gate_input=None, return_metrics: bool = False):
        d = x.shape[-1]
        tokens = x.reshape(-1, d)
        t = tokens.shape[0]
        e, k = self.experts.num_experts, getattr(self.gate, "k", 1)
        capacity = max(1, int(self.capacity_factor * t * k / e))
        gates, idx, aux = self.gate(
            tokens if gate_input is None else gate_input.reshape(-1))
        if self.mesh is not None:
            out, n_dropped = self._expert_parallel(tokens, gates, idx,
                                                   capacity)
        elif self.dispatch_impl == "gather":
            out, n_dropped = expert_parallel(tokens, gates, idx, e, capacity,
                                             self.experts)
        else:
            disp, comb = ops.make_dispatch_combine(gates, idx, e, capacity)
            n_dropped = t * k - disp.sum().long()
            out = ops.reverse_layout_transform(
                self.experts(ops.layout_transform(tokens, disp)), comb)
        out = out.reshape(x.shape)
        if return_metrics:
            return out, aux, {"dropped_frac": n_dropped.float() / (t * k)}
        return out, aux

    def _expert_parallel(self, tokens, gates, idx, capacity):
        """The routing under the mesh, as ``shard_map`` bounds it: the
        tokens and gates enter whole on every rank (their gradients summed
        over ``ep``), the output leaves whole (its cotangent shared over
        ``ep``), so the experts' gradient counts each token once."""
        mesh, axis = self.mesh, self.ep_axis
        e = self.experts.num_experts
        if collectives.axis_size(axis, mesh) == 1:
            return expert_parallel(tokens, gates, idx, e, capacity,
                                   self.experts)
        group = collectives.axis_group(axis, mesh)
        out, n_dropped = expert_parallel(
            collectives.shard_map_input(tokens, group),
            collectives.shard_map_input(gates, group), idx, e, capacity,
            self.experts, group)
        return collectives.shard_map_output(out, group), n_dropped
