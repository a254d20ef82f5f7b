"""Scaled-dot-product attention cores (counterpart of
``hetu_tpu/ops/attention.py``).

Plain PyTorch, because the reference's versions are plain XLA.  The fused
causal prefill core is the flash kernel in
``hetu_tpu_torch/ops/cuda_kernels/flash_attention.py``.

Scores are formed in float32 from the inputs (each bf16 product is exact in
float32 and the sums accumulate in float32), which is the reference's
``preferred_element_type=float32`` contract; the probabilities are cast to
``v.dtype`` before the second product, as in the reference.
"""

from __future__ import annotations

import torch


def _scores(q, k, scale):
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale


def _softmax_pv(scores, v):
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def attention(q, k, v, *, mask=None, scale=None):
    """q, k, v: ``[..., heads, seq, head_dim]``.

    mask: broadcastable to ``[..., heads, q_len, kv_len]``; True/1 = keep.
    Masked scores become float32's lowest value (not -inf), so a row that
    keeps no key averages uniformly instead of giving NaN, as in the
    reference.
    """
    scores = _scores(q, k, scale)
    if mask is not None:
        scores = scores.masked_fill(~mask.bool(),
                                    torch.finfo(scores.dtype).min)
    return _softmax_pv(scores, v)


def causal_attention(q, k, v, *, scale=None):
    """Bottom-right aligned causal attention: query ``i`` sees keys
    ``<= i + (S_k - S_q)``."""
    s_q, s_k = q.shape[-2], k.shape[-2]
    mask = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device).tril(
        s_k - s_q)
    return attention(q, k, v, mask=mask, scale=scale)


# ---- serving decode: attention over a preallocated slot cache ----
# The cache is TIME-major ([B, T, kv_heads, D]) because every write is a
# per-sequence update at one time index; attention transposes to
# head-major internally.

def cache_update(k_cache, v_cache, k_new, v_new, lengths):
    """Write each sequence's new K/V rows into its cache slot IN PLACE.

    k_cache/v_cache: ``[B, T, kv_heads, D]``; k_new/v_new:
    ``[B, S, kv_heads, D]`` (S = 1 for decode); lengths: ``[B]`` int —
    tokens already cached per sequence, i.e. where the new rows land.

    The reference returns updated copies (XLA updates donated buffers);
    here the tensors are written directly and returned for the same call
    shape.  Like ``lax.dynamic_update_slice``, a start that would run past
    the end is clamped to ``T - S``.
    """
    b, s = k_new.shape[:2]
    t = k_cache.shape[1]
    start = lengths.long().clamp(0, t - s)
    pos = start[:, None] + torch.arange(s, device=k_cache.device)
    rows = torch.arange(b, device=k_cache.device)[:, None]
    k_cache[rows, pos] = k_new.to(k_cache.dtype)
    v_cache[rows, pos] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def _head_major(cache, num_heads):
    """``[B, T, kv_heads, D]`` → ``[B, heads, T, D]``, repeating each kv
    head ``heads / kv_heads`` times (GQA)."""
    x = cache.transpose(1, 2)
    if x.shape[1] != num_heads:
        x = x.repeat_interleave(num_heads // x.shape[1], dim=1)
    return x


def decode_attention(q, k_cache, v_cache, lengths, *, scale=None):
    """Single-token attention against a slot cache (GQA-aware).

    q: ``[B, heads, 1, D]`` — the newest token's query, at index
    ``lengths[b]`` of its sequence (its K/V already written by
    :func:`cache_update`).  k_cache/v_cache: ``[B, T, kv_heads, D]``.
    Positions ``> lengths[b]`` (unwritten, or stale from a previous slot
    occupant) are masked out.
    """
    if q.shape[-2] != 1:
        raise ValueError(
            f"decode_attention takes one query token, got {q.shape[-2]} "
            "(prefill goes through causal_attention over the chunk)")
    nh = q.shape[1]
    k = _head_major(k_cache, nh)
    v = _head_major(v_cache, nh)
    scores = _scores(q, k, scale)
    t = k_cache.shape[1]
    valid = torch.arange(t, device=q.device)[None, :] <= \
        lengths.to(q.device).long()[:, None]                   # [B, T]
    scores = scores.masked_fill(~valid[:, None, None, :],
                                torch.finfo(scores.dtype).min)
    return _softmax_pv(scores, v)
