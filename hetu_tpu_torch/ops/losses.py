"""Losses (counterpart of ``hetu_tpu/ops/losses.py``): what the GPT
training step runs.

Per-row losses unless reduced, with the reduction in float32 whatever the
logits' type, as in the reference.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


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
    """
    hs = h.reshape(-1, h.shape[-1])
    ys = labels.reshape(-1).long()
    pad = (-hs.shape[0]) % row_chunk
    if pad:
        hs = torch.cat([hs, hs.new_zeros(pad, hs.shape[1])])
        ys = torch.cat([ys, ys.new_full((pad,), ignored_index)])
    w_t = w_emb.t().to(h.dtype)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for h_c, y_c in zip(hs.split(row_chunk), ys.split(row_chunk)):
        # deterministic: no RNG state to stash and replay
        total = total + checkpoint(_chunk_loss, h_c, w_t, y_c, ignored_index,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
    count = (ys != ignored_index).sum()
    return total / count.clamp_min(1)
