"""Losses (counterpart of ``hetu_tpu/ops/losses.py``): what the GPT, CTR
and CNN training steps run.

Per-row losses unless reduced, with the reduction in float32 whatever the
logits' type, as in the reference.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from hetu_tpu_torch.parallel.spec import (
    gather_dim, is_dtensor, local_call, unpartial,
)


def binary_cross_entropy(pred, label, eps: float = 1e-12):
    """``-(y log p + (1 - y) log(1 - p))`` per element, ``p`` clipped into
    ``[eps, 1 - eps]``."""
    pred = pred.clamp(eps, 1 - eps)
    return -(label * torch.log(pred) + (1 - label) * torch.log(1 - pred))


def binary_cross_entropy_with_logits(logits, label):
    """Per-element BCE on logits by the reference's formula,
    ``max(x, 0) - x y + log1p(exp(-|x|))``, which rounds differently from
    ``F.binary_cross_entropy_with_logits``.  At x = 0 the derivatives are
    the reference's: 1/2 for the tie of ``max`` (``torch.maximum``), 1 for
    ``|x|`` (``torch.abs``'s is 0)."""
    abs_x = torch.where(logits >= 0, logits, -logits)
    return torch.maximum(logits, logits.new_zeros(())) - logits * label \
        + torch.log1p(torch.exp(-abs_x))


def cross_entropy(pred, label, eps: float = 1e-12):
    """``-sum(y log p)`` over the last axis; ``pred`` is a distribution,
    clipped below at ``eps``."""
    return -(label * torch.log(pred.clamp_min(eps))).sum(dim=-1)


def cross_entropy_sparse(pred, label, ignored_index: int = -1,
                         eps: float = 1e-12):
    """``-log p[label]`` per row of a distribution ``pred`` (clipped below
    at ``eps``); rows labelled ``ignored_index`` give 0."""
    p = pred.gather(-1, label.long().clamp_min(0)[..., None])[..., 0]
    loss = -torch.log(p.clamp_min(eps))
    return torch.where(label == ignored_index, 0.0, loss)


def softmax_cross_entropy(logits, label):
    """Fused softmax + CE on one-hot or soft labels, per row."""
    return -(label * torch.log_softmax(logits, dim=-1)).sum(dim=-1)


def nll_loss(logp, label):
    """``-logp[label]`` per row of log-probabilities."""
    return -logp.gather(-1, label.long()[..., None])[..., 0]


def softmax_cross_entropy_sparse(logits, label, ignored_index: int = -1):
    """Fused softmax + CE on integer labels, per row; rows labelled
    ``ignored_index`` give 0."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = logp.gather(-1, label.long().clamp_min(0)[..., None])[..., 0]
    return torch.where(label == ignored_index, 0.0, -picked)


def _chunk_loss(h_c, w_t, y_c, ignored_index):
    """Summed CE of one row chunk: its ``[C, V]`` logits exist only here."""
    logits = torch.matmul(h_c, w_t).float()
    m = logits.amax(dim=-1)
    lse = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=-1))
    picked = logits.gather(-1, y_c.clamp_min(0)[:, None])[:, 0]
    return torch.where(y_c != ignored_index, lse - picked, 0.0).sum()


def lm_head_cross_entropy(h, w_emb, labels, *, ignored_index: int = -1,
                          row_chunk: int = 2048):
    """Fused LM head + softmax CE that never holds the whole ``[N, V]``
    logits: the mean CE of ``h @ w_emb.T`` over the rows whose label is not
    ``ignored_index``.

    Rows are padded to a multiple of ``row_chunk`` with ignored labels; each
    chunk forms its logits in ``h``'s type, reduces them to (LSE, picked
    logit) in float32, and recomputes them in the backward pass
    (``torch.utils.checkpoint``) instead of saving them.

    h ``[..., H]``; w_emb ``[V, H]``; labels ``[...]`` int.  Returns the f32
    scalar loss.

    DTensor operands (the batch split over dp, the table over tp): each
    rank sums the CE of its own rows, and the mean divides the global sum
    by the global count, the loss of the whole batch whatever each shard's
    count of valid labels.  A table whose vocabulary rows are split over a
    mesh axis that does not split the rows (MegatronLM's ``tok_emb`` over
    tp) stays split: each rank forms the logits of its own vocabulary
    rows, and the ranks of that axis combine their per-row log-sum-exps
    and picked logits (Megatron's vocab-parallel CE), so the table is
    never gathered and its gradient stays split as the table is.
    """
    if is_dtensor(h):
        return _lm_head_ce_dtensor(h, w_emb, labels,
                                   ignored_index=ignored_index,
                                   row_chunk=row_chunk)
    total, count = _lm_head_ce_sum(h, w_emb, labels,
                                   ignored_index=ignored_index,
                                   row_chunk=row_chunk)
    return total / count.clamp_min(1)


def _lm_head_ce_dtensor(h, w_emb, labels, *, ignored_index, row_chunk):
    from torch.distributed.tensor import Partial, Replicate
    h, labels, w_emb = unpartial(h), unpartial(labels), unpartial(w_emb)
    w_emb = gather_dim(w_emb, 1)
    mesh = h.device_mesh
    # the vocabulary stays split over (at most) one axis that leaves the
    # rows whole; any other split of it is gathered
    vocab = [i for i, (pw, ph) in enumerate(zip(w_emb.placements,
                                               h.placements))
             if pw.is_shard(0) and ph.is_replicate()][:1]
    pl = [p if i in vocab or not p.is_shard(0) else Replicate()
          for i, p in enumerate(w_emb.placements)]
    if pl != list(w_emb.placements):
        w_emb = w_emb.redistribute(mesh, pl)
    # the rows split over a mesh axis sum to partial sums there; so does
    # the table's gradient, which keeps the table's split of the vocabulary
    part = [Partial() if p.is_shard() else Replicate() for p in h.placements]
    w_grad = [Partial() if ph.is_shard() else pw
              for ph, pw in zip(h.placements, w_emb.placements)]
    kw = dict(ignored_index=ignored_index, row_chunk=row_chunk)
    fn = _lm_head_ce_sum
    if vocab:
        i = vocab[0]
        n = mesh.size(i)
        kw.update(group=mesh.get_group(i),
                  vstart=mesh.get_local_rank(i) * (-(-w_emb.shape[0] // n)))
        fn = _vocab_parallel_ce_sum
    total, count = local_call(
        fn, lambda *_: (part, part), h, w_emb, labels,
        in_grad_placements=(list(h.placements), w_grad,
                            list(labels.placements)), **kw)
    return total / count.clamp_min(1)


def _padded_rows(h, labels, ignored_index, row_chunk):
    """``h`` as ``[N, H]`` rows and ``labels`` as ``[N]``, padded to a
    multiple of ``row_chunk`` with ignored labels."""
    hs = h.reshape(-1, h.shape[-1])
    ys = labels.reshape(-1).long()
    pad = (-hs.shape[0]) % row_chunk
    if pad:
        hs = torch.cat([hs, hs.new_zeros(pad, hs.shape[1])])
        ys = torch.cat([ys, ys.new_full((pad,), ignored_index)])
    return hs, ys


def _lm_head_ce_sum(h, w_emb, labels, *, ignored_index, row_chunk):
    """The summed CE of :func:`lm_head_cross_entropy` and its count of
    valid labels."""
    hs, ys = _padded_rows(h, labels, ignored_index, row_chunk)
    w_t = w_emb.t().to(h.dtype)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for h_c, y_c in zip(hs.split(row_chunk), ys.split(row_chunk)):
        # deterministic: no RNG state to stash and replay
        total = total + checkpoint(_chunk_loss, h_c, w_t, y_c, ignored_index,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
    return total, (ys != ignored_index).sum()


def _vocab_parallel_ce_sum(h, w_emb, labels, *, ignored_index, row_chunk,
                           group, vstart):
    """:func:`_lm_head_ce_sum` on this rank's rows ``vstart:`` of the
    vocabulary (``w_emb`` ``[V_local, H]``), the other rows on the other
    ranks of ``group``; every rank gets the sum and the count."""
    total = _VocabParallelCE.apply(h, w_emb, labels, ignored_index,
                                   row_chunk, group, vstart)
    return total, (labels != ignored_index).sum()


class _VocabParallelCE(torch.autograd.Function):
    """Summed CE over a vocabulary split across the ranks of ``group``.

    Each row chunk forms its logits against this rank's vocabulary rows
    only, reduces them to (local log-sum-exp, the label's logit if this
    rank holds it, else 0), and gathers both from every rank: the row's
    log-sum-exp is the log-sum-exp of the ranks' and its picked logit
    their sum.  The backward pass recomputes each chunk's logits, forms
    ``softmax - onehot`` on this rank's rows, and sums the rows'
    gradient over the ranks; the table's gradient is this rank's rows
    only."""

    @staticmethod
    def forward(ctx, h, w, labels, ignored_index, row_chunk, group, vstart):
        from hetu_tpu_torch.parallel.collectives import _all_gather
        hs, ys = _padded_rows(h, labels, ignored_index, row_chunk)
        valid = ys != ignored_index
        yl = ys - vstart
        mine = valid & (yl >= 0) & (yl < w.shape[0])
        yl = torch.where(mine, yl, 0)
        w_t = w.t().to(h.dtype)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        lses = []
        for h_c, y_c, m_c, v_c in zip(hs.split(row_chunk),
                                      yl.split(row_chunk),
                                      mine.split(row_chunk),
                                      valid.split(row_chunk)):
            logits = torch.matmul(h_c, w_t).float()
            m = logits.amax(dim=-1)
            lse = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=-1))
            picked = torch.where(m_c, logits.gather(-1, y_c[:, None])[:, 0],
                                 0.0)
            both = _all_gather(torch.stack([lse, picked])[None], group, 0)
            lse = torch.logsumexp(both[:, 0], dim=0)
            total = total + torch.where(v_c, lse - both[:, 1].sum(0),
                                        0.0).sum()
            lses.append(lse)
        ctx.save_for_backward(hs, w, yl, mine, valid, torch.cat(lses))
        ctx.shape, ctx.row_chunk, ctx.group = h.shape, row_chunk, group
        return total

    @staticmethod
    def backward(ctx, g):
        from hetu_tpu_torch.parallel.collectives import _all_reduce
        hs, w, yl, mine, valid, lse = ctx.saved_tensors
        rc = ctx.row_chunk
        w_t = w.t().to(hs.dtype)
        gh = torch.empty_like(hs)
        gw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for i, h_c in enumerate(hs.split(rc)):
            rows = slice(i * rc, (i + 1) * rc)
            logits = torch.matmul(h_c, w_t).float()
            d = torch.exp(logits - lse[rows, None])
            d.scatter_add_(-1, yl[rows, None], -mine[rows, None].float())
            d = (d * (valid[rows, None] * g)).to(hs.dtype)
            gh[rows] = d @ w_t.t()
            gw += (d.t() @ h_c).float()
        gh = _all_reduce(gh, ctx.group)[:ctx.shape[:-1].numel()]
        return (gh.reshape(ctx.shape), gw.to(w.dtype), None, None, None,
                None, None)
