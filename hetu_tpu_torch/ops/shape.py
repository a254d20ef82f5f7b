"""Shape, indexing and layout ops (counterpart of
``hetu_tpu/ops/shape.py``), under the reference's names and with numpy's
semantics.

Ids: a negative id counts from the end, as in the reference; an id out of
range raises ``IndexError`` (one check, and on the card one
synchronisation, per call), where the reference fills with NaN (``gather``,
``gather_elements``), clamps (``indexing``, ``slice_by_matrix``) or drops
the write (``scatter``, ``scatter1d``).  ``interpolate`` is the
reference's ``jax.image.resize``: half-pixel centres, ``align_corners``
ignored, and a bilinear shrink antialiased.
"""

from __future__ import annotations

import numpy as np
import torch


def _ids(indices, size: int, device):
    """``indices`` as int64 on ``device``, negatives wrapped; raises
    ``IndexError`` for one outside ``[-size, size)``."""
    idx = torch.as_tensor(indices).to(device=device, dtype=torch.long)
    if idx.numel():
        lo, hi = (int(v) for v in torch.aminmax(idx))
        if lo < -size or hi >= size:
            raise IndexError(f"ids span [{lo}, {hi}], outside [{-size}, "
                             f"{size})")
    return torch.where(idx < 0, idx + size, idx)


def reshape(x, shape):
    return torch.reshape(x, (shape,) if isinstance(shape, int) else shape)


def transpose(x, perm=None):
    """Axes permuted by ``perm``; reversed when None."""
    return x.permute(*(perm if perm is not None else range(x.ndim)[::-1]))


def concat(a, b, axis: int = 0):
    """Two-input concat."""
    return torch.cat([a, b], dim=axis)


def concatenate(arrays, axis: int = 0):
    """N-input concat."""
    return torch.cat(list(arrays), dim=axis)


def split(x, n_or_indices, axis: int = 0):
    """``n`` equal parts (raises unless ``n`` divides the axis), or the
    parts between the given split points, as ``np.split``."""
    if isinstance(n_or_indices, int) and x.shape[axis] % n_or_indices:
        raise ValueError(f"array split does not result in an equal "
                         f"division: {x.shape[axis]} by {n_or_indices}")
    if not isinstance(n_or_indices, int):
        n_or_indices = [int(i) for i in n_or_indices]
    return list(torch.tensor_split(x, n_or_indices, dim=axis))


def slice_(x, begin, size):
    """The static slice ``x[begin : begin + size]`` on every axis; raises
    when it leaves ``x``."""
    for d, (b, s) in enumerate(zip(begin, size)):
        x = x.narrow(d, b, s)
    return x


def slice_assign(x, y, begin):
    """A copy of ``x`` with ``y`` written at offset ``begin``; each offset
    is clamped so that ``y`` fits, as ``lax.dynamic_update_slice``
    does."""
    out = x.clone()
    index = tuple(slice(o, o + s) for o, s in (
        (min(max(int(b), 0), n - s), s)
        for b, n, s in zip(begin, x.shape, y.shape)))
    out[index] = y.to(x.dtype)
    return out


def slice_by_matrix(x, idx_a, idx_b):
    """``x[idx_a, idx_b]``, the pairwise gather."""
    return x[_ids(idx_a, x.shape[0], x.device),
             _ids(idx_b, x.shape[1], x.device)]


def _pad_index(n: int, lo: int, hi: int, mode: str, device):
    """The source index of each position of an axis of ``n`` padded by
    ``lo`` and ``hi`` in numpy's ``mode``."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i % n
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        i = i % (2 * n - 2)
        return torch.where(i < n, i, 2 * n - 2 - i)
    if mode == "symmetric":
        i = i % (2 * n)
        return torch.where(i < n, i, 2 * n - 1 - i)
    raise ValueError(f"pad mode {mode!r}: 'constant', 'edge', 'reflect', "
                     f"'symmetric' or 'wrap'")


def pad(x, paddings, mode: str = "constant", constant_values=0):
    """``np.pad`` of ``x``: ``paddings`` an int, a ``(before, after)`` pair
    or one pair an axis; modes ``constant``, ``edge``, ``reflect``,
    ``symmetric`` and ``wrap``."""
    pads = np.broadcast_to(np.asarray(paddings, np.int64), (x.ndim, 2))
    if mode == "constant":
        flat = [int(p) for lo, hi in pads[::-1] for p in (lo, hi)]
        return torch.nn.functional.pad(x, flat, value=constant_values)
    for d, (lo, hi) in enumerate(pads):
        if lo or hi:
            x = x.index_select(d, _pad_index(x.shape[d], int(lo), int(hi),
                                             mode, x.device))
    return x


def tile(x, reps):
    return torch.tile(x, (reps,) if isinstance(reps, int) else tuple(reps))


def repeat(x, repeats, axis=None):
    """Each element repeated along ``axis`` (the flattened ``x`` when
    None); ``repeats`` an int or one count an element."""
    if not isinstance(repeats, int):
        repeats = torch.as_tensor(repeats, device=x.device)
    return torch.repeat_interleave(x, repeats, dim=axis)


def roll(x, shift, axis=None):
    return torch.roll(x, shift, dims=axis)


def broadcast_shape(x, shape):
    """Broadcast to the target shape."""
    return torch.broadcast_to(x, shape)


def broadcast_to(x, shape):
    return torch.broadcast_to(x, shape)


def gather(x, indices, axis: int = 0):
    """Index-select along ``axis``: ``x.shape[:axis] + indices.shape +
    x.shape[axis + 1:]``."""
    axis = axis % x.ndim
    idx = _ids(indices, x.shape[axis], x.device)
    out = x.index_select(axis, idx.reshape(-1))
    return out.reshape(*x.shape[:axis], *idx.shape, *x.shape[axis + 1:])


def gather_elements(x, indices, axis: int = -1):
    """``np.take_along_axis``: the element of ``x`` at each index along
    ``axis``."""
    return torch.take_along_dim(
        x, _ids(indices, x.shape[axis], x.device), dim=axis)


def scatter(x, indices, updates, axis: int = -1):
    """The inverse of :func:`gather_elements`: a copy of ``x`` with
    ``updates`` (broadcast to ``indices``' shape) written at ``indices``
    along ``axis``.  Which of two writes to one element lands is
    unspecified, as in the reference."""
    idx = _ids(indices, x.shape[axis], x.device)
    src = torch.as_tensor(updates, device=x.device).to(x.dtype)
    return x.scatter(axis, idx, src.expand(idx.shape))


def scatter1d(x, indices, updates):
    """A copy of ``x`` with the rows at ``indices`` set to ``updates``."""
    out = x.clone()
    out[_ids(indices, x.shape[0], x.device)] = torch.as_tensor(
        updates, device=x.device).to(x.dtype)
    return out


def indexing(x, indices):
    """Row indexing ``x[indices]``."""
    return gather(x, indices, axis=0)


def one_hot(x, num_classes: int, dtype=torch.float32):
    """``[..., num_classes]``; an id outside ``[0, num_classes)`` gives a
    row of zeros, as ``jax.nn.one_hot``."""
    classes = torch.arange(num_classes, device=x.device)
    return (x[..., None] == classes).to(dtype)


def arange(start, stop=None, step=1, dtype=None, device="cuda"):
    if stop is None:
        start, stop = 0, start
    return torch.arange(start, stop, step, dtype=dtype, device=device)


def full(shape, fill_value, dtype=None, device="cuda"):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return torch.full(shape, fill_value, dtype=dtype, device=device)


def full_like(x, fill_value):
    return torch.full_like(x, fill_value)


def ones_like(x):
    return torch.ones_like(x)


def zeros_like(x):
    return torch.zeros_like(x)


def cumsum(x, axis: int = -1):
    """The running sum along ``axis``, in ``x``'s type (a bool ``x`` sums
    as int64)."""
    return torch.cumsum(x, dim=axis,
                        dtype=None if x.dtype == torch.bool else x.dtype)


def flip(x, axis):
    dims = range(x.ndim) if axis is None else \
        (axis,) if isinstance(axis, int) else axis
    return torch.flip(x, tuple(dims))


def _linear_weights(n_in: int, n_out: int, device):
    """``[n_in, n_out]`` float32: ``jax.image.resize``'s linear weights of
    one axis (``compute_weight_mat`` with the triangle kernel, antialiased:
    widened by ``n_in / n_out`` when shrinking)."""
    inv_scale = 1.0 / (n_out / n_in)  # a double, rounded at each use
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(
        n_in, dtype=torch.float32, device=device)[:, None]).abs() \
        / max(inv_scale, 1.0)
    w = (1 - dist).clamp_min(0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _nearest_index(n_in: int, n_out: int, device):
    """``jax.image.resize``'s nearest source index of each output
    position: ``floor((i + 0.5) · n_in / n_out)`` in float32."""
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * n_in / n_out
    return torch.floor(pos).long()


def interpolate(x, size=None, scale_factor=None, mode: str = "bilinear",
                align_corners: bool = False):
    """NCHW spatial resize to ``size`` (or ``int(h · scale_factor)`` by
    ``int(w · scale_factor)``), ``mode`` ``"bilinear"`` or
    ``"nearest"``."""
    n, c, h, w = x.shape
    if size is None:
        size = (int(h * scale_factor), int(w * scale_factor))
    if mode not in ("bilinear", "nearest"):
        raise KeyError(mode)
    if mode == "nearest":
        if size[0] != h:
            x = x.index_select(2, _nearest_index(h, size[0], x.device))
        if size[1] != w:
            x = x.index_select(3, _nearest_index(w, size[1], x.device))
        return x
    if not x.is_floating_point():
        x = x.float()
    if size[0] != h:
        wh = _linear_weights(h, size[0], x.device).to(x.dtype)
        x = torch.einsum("nchw,hH->ncHw", x, wh)
    if size[1] != w:
        ww = _linear_weights(w, size[1], x.device).to(x.dtype)
        x = torch.einsum("nchw,wW->nchW", x, ww)
    return x


def tril_lookup(x, offset: int = 0):
    """The lower triangle of the last two axes, packed row by row into a
    vector."""
    rows, cols = torch.tril_indices(x.shape[-2], x.shape[-1], offset,
                                    device=x.device)
    return x[..., rows, cols]


def tril(x, k: int = 0):
    return torch.tril(x, k)


def triu(x, k: int = 0):
    return torch.triu(x, k)
