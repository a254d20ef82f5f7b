"""Mixture-of-Experts layer and its top-k gate (counterpart of
``hetu_tpu/layers/moe.py``).

``TopKGate`` → dispatch → ``Expert`` → combine, on one device.  The gate
picks each token's k experts with the fused top-k kernel
(``impl="auto"``/``"pallas"``, the reference's names) or in plain PyTorch
(``"xla"``); the dispatch and the combine move rows with the
``routed_gather`` kernels (``dispatch_impl="gather"``) or with the dense
einsum masks (``"einsum"``).  The expert weights are stacked ``[E, ...]``
in the reference's layout.  The reference's expert-parallel ``mesh`` is the
multi-GPU slice's and is refused here; its other gates (hash, k-top-1,
balanced assignment, SAM) are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from hetu_tpu_torch import init as initializers
from hetu_tpu_torch import ops
from hetu_tpu_torch.layers.base import Module
from hetu_tpu_torch.ops.cuda_kernels.embedding import topk_gating


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
        dt = self.dtype
        h = expert_matmul(xe.to(dt), self.w1.to(dt)) + self.b1[:, None]
        h = self.activation(h)
        return expert_matmul(h.to(dt), self.w2.to(dt)) + self.b2[:, None]


class MoELayer(Module):
    """gate → dispatch → experts → combine.

    ``capacity_factor`` bounds the tokens an expert takes:
    ``C = max(1, int(cf * T * k / E))``; routes past it are dropped, as in
    the reference.  ``forward(x [B, S, D] or [T, D])`` → ``(out, aux)``
    with ``out`` in f32 and shaped like ``x``; with ``return_metrics``,
    ``(out, aux, {"dropped_frac": ...})``, the share of (token, choice)
    routes dropped."""

    def __init__(self, gate: TopKGate, experts: Expert, *,
                 capacity_factor: float = 1.25, mesh=None,
                 dispatch_impl: str = "gather"):
        super().__init__()
        if mesh is not None:
            raise NotImplementedError(
                "an expert-parallel mesh belongs to the multi-GPU slice of "
                "hetu_tpu_torch, which is not ported yet; the MoE layer runs "
                "on one device")
        if dispatch_impl not in ("gather", "einsum"):
            raise ValueError(f"dispatch_impl {dispatch_impl!r}: "
                             "'gather' or 'einsum'")
        self.gate = gate
        self.experts = experts
        self.capacity_factor = capacity_factor
        self.dispatch_impl = dispatch_impl

    def forward(self, x, *, return_metrics: bool = False):
        d = x.shape[-1]
        tokens = x.reshape(-1, d)
        t = tokens.shape[0]
        e, k = self.experts.num_experts, self.gate.k
        capacity = max(1, int(self.capacity_factor * t * k / e))
        gates, idx, aux = self.gate(tokens)
        if self.dispatch_impl == "gather":
            # each gather gets its ids' inverse map, so that its gradient
            # (the scatter-add) reads every row's sources with no sort
            slot_route, token_slot, n_dropped = ops.make_slot_routes(
                gates, idx, e, capacity)
            xe = ops.gather_dispatch(tokens, slot_route // k, e, capacity,
                                     inverse=token_slot)
        else:
            disp, comb = ops.make_dispatch_combine(gates, idx, e, capacity)
            n_dropped = t * k - disp.sum().long()
            xe = ops.layout_transform(tokens, disp)
        ye = self.experts(xe)
        if self.dispatch_impl == "gather":
            out = ops.gather_combine(ye, token_slot, gates,
                                     inverse=slot_route[:, None])
        else:
            out = ops.reverse_layout_transform(ye, comb)
        out = out.reshape(x.shape)
        if return_metrics:
            return out, aux, {"dropped_frac": n_dropped.float() / (t * k)}
        return out, aux
