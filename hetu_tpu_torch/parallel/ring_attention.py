"""Ring attention over the ``sp`` mesh axis (counterpart of
``hetu_tpu/parallel/ring_attention.py``).

q, k and v are ``[B, H, S/n, D]`` on each of the ``n`` ranks of the axis,
rank ``i`` holding the ``i``-th block of the sequence.  K and V rotate one
rank a step; a rank meets every key block once and accumulates its output
online, so the sequence scales with the ranks at ``O(S/n)`` memory a rank.

Two versions of one function:

* :func:`ring_attention` runs on the flash kernels (``flash_attention.cu``
  and ``flash_attention_bwd.cu``, the ports of the TPU kernels
  ``_flash_fwd_kernel``, ``_flash_bwd_dkdv_kernel`` and
  ``_flash_bwd_dq_kernel``) through :class:`_RingFlash`, an
  ``autograd.Function``.  Its forward visits the key blocks by their source
  rank ``src``: an earlier block is one non-causal launch, the rank's own
  (the square diagonal block) one causal launch, and a later block under
  the causal mask is fully masked and launches nothing.  The rotation
  still runs at every step on every rank, so every rank issues the same
  collectives.  The blocks' outputs merge by their log-sum-exps in f32
  (each block's O, bf16 on the bf16 route, is up-cast first).  The
  backward is FlashAttention-2's ring: each block's dQ, dK and dV come
  from the merged O and the global LSE (``flash_attention_bwd``), the dK
  and dV sums (f32) travel with their K and V block, and one more rotation
  brings them home.  On CPU tensors the same function runs the kernels'
  plain versions.
* :func:`ring_attention_plain` is the reference's blockwise einsum
  (``_block_attn``, an online softmax in f32) with the rotation's
  ``ppermute`` of :mod:`~hetu_tpu_torch.parallel.collectives`,
  differentiated by autograd: the version the kernel ring is held
  against.

A row that sees no key gives 0 (only the plain version can meet one: the
kernel ring's first block is always the diagonal).  The result has q's
type.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from hetu_tpu_torch.ops.cuda_kernels.flash_attention import (
    bwd_delta, flash_attention_bwd, flash_attention_fwd,
)
from hetu_tpu_torch.parallel import collectives

NEG_INF = -1e30


def _rank_of(group):
    """``(n, my)``: the ring's size and this rank's place in it (a lone
    rank for no group)."""
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_group_rank(
        group, dist.get_rank())


def _rotate(x, group, n):
    """``x`` from the previous rank of the ring (no autograd)."""
    return x if n == 1 else collectives._ppermute(x, group, 1)


# ------------------------------------------------------------ plain version

def _block_attn(q, k, v, keep, scale, o, m, l):
    """One blockwise online-softmax step (the reference's ``_block_attn``):
    q ``[B, H, Sq, D]``, k and v ``[B, H, Sk, D]``, ``keep [Sq, Sk]``
    (True = attend); o, m, l the running output, max and normaliser
    (f32)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k.float()) * scale
    s = s.masked_fill(~keep, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # a fully masked row keeps m_new = NEG_INF, where exp(s - m_new) = 1
    # would pollute l: masked entries are zeroed instead
    p = torch.exp(s - m_new[..., None]).masked_fill(~keep, 0.0)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                               v.float())
    return o_new, m_new, l_new


def ring_attention_plain(q, k, v, mesh=None, *, axis: str = "sp",
                         causal: bool = False, scale=None):
    """The reference's ring (its ``_ring_attention_local``) on this rank's
    ``[B, H, S/n, D]`` blocks: the plain version of :func:`ring_attention`.
    Differentiable by autograd; K and V rotate with the differentiable
    ``ppermute``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n = collectives.axis_size(axis, mesh)
    group = collectives.axis_group(axis, mesh) if n > 1 else None
    _, my = _rank_of(group)
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    qf = q.float()
    o = q.new_zeros((b, h, s_q, d), dtype=torch.float32)
    m = q.new_full((b, h, s_q), NEG_INF, dtype=torch.float32)
    l = q.new_zeros((b, h, s_q), dtype=torch.float32)
    q_pos = my * s_q + torch.arange(s_q, device=q.device)
    for i in range(n):
        src = (my - i) % n  # the rank whose block this rank holds
        if causal:
            k_pos = src * s_k + torch.arange(s_k, device=q.device)
            keep = q_pos[:, None] >= k_pos[None, :]
        else:
            keep = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device)
        o, m, l = _block_attn(qf, k, v, keep, scale, o, m, l)
        if i < n - 1:
            k = collectives.ppermute_shift(k, group, 1)
            v = collectives.ppermute_shift(v, group, 1)
    l = l.clamp_min(1e-20)  # fully masked rows give 0
    return (o / l[..., None]).to(q.dtype)


# ------------------------------------------------------- the kernels' ring

def _visits(src: int, my: int, causal: bool):
    """Whether the block of rank ``src`` has a key this rank's queries
    see, and whether it is the diagonal block (the causal launch)."""
    return (not causal) or src <= my, causal and src == my


def _merge(o, lse, o_b, lse_b):
    """Two partial attentions merged by their log-sum-exps, in f32: ``o``
    ``[B*H, S, D]`` f32 (None before the first block), ``lse`` ``[B*H, S,
    1]``."""
    o_b = o_b.float().reshape(lse_b.shape[0], lse_b.shape[1], -1)
    if o is None:
        return o_b, lse_b
    new = torch.logaddexp(lse, lse_b)
    return o * torch.exp(lse - new) + o_b * torch.exp(lse_b - new), new


class _RingFlash(torch.autograd.Function):
    """Forward: one flash-kernel launch a visited block, merged by LSE.
    Backward: the kernels' dQ/dK/dV a visited block against the merged O
    and global LSE, the dK/dV sums riding the ring home."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        n, my = _rank_of(group)
        kv = torch.stack([k, v])
        o = lse = None
        for i in range(n):
            src = (my - i) % n
            visit, diag = _visits(src, my, causal)
            if visit:
                o_b, lse_b = flash_attention_fwd(q, kv[0], kv[1],
                                                 causal=diag, scale=scale)
                o, lse = _merge(o, lse, o_b, lse_b)
            if i < n - 1:
                kv = _rotate(kv, group, n)
        out = o.reshape(q.shape).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        n, my = _rank_of(group)
        d_out = d_out.contiguous()
        delta = bwd_delta(d_out, out)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kv = torch.stack([k, v])
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        for i in range(n):
            src = (my - i) % n
            visit, diag = _visits(src, my, causal)
            if visit:
                dq_b, dk_b, dv_b = flash_attention_bwd(
                    q, kv[0], kv[1], out, lse, d_out, causal=diag,
                    scale=scale, delta=delta)
                dq += dq_b.float()
                dkv[0] += dk_b.float()
                dkv[1] += dv_b.float()
            if i < n - 1:
                kv = _rotate(kv, group, n)
            # n rotations of the sums: each arrives at its block's owner
            dkv = _rotate(dkv, group, n)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None)


def ring_flash(q, k, v, group, *, causal: bool, scale: float):
    """:func:`ring_attention` over an explicit process group (``None``:
    one rank, one block)."""
    return _RingFlash.apply(q, k, v, group, bool(causal), float(scale))


def ring_attention(q, k, v, mesh=None, *, axis: str = "sp",
                   causal: bool = False, scale=None):
    """Ring attention on the flash kernels: this rank's ``[B, H, S/n, D]``
    blocks of q, k and v, sequence-split over mesh axis ``axis`` (the
    reference's ``ring_attention`` inside its ``shard_map``), → this
    rank's block of O.  Differentiable in q, k and v."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n = collectives.axis_size(axis, mesh)
    group = collectives.axis_group(axis, mesh) if n > 1 else None
    return ring_flash(q, k, v, group, causal=causal, scale=scale)
