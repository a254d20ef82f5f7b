"""The wire-dtype conventions (counterpart of ``hetu_tpu/quantwire.py``):
the int8 codecs of KV migration payloads and of quantized collectives, and
wire-byte accounting.

* :func:`q8_encode_axes` / :func:`q8_decode_axes` — symmetric int8 with one
  f32 scale per block, as torch ops on the tensor's own device.  Bit for
  bit the reference's numpy codec: the scale is amax/127 over the block's
  FINITE magnitudes, the inverse 1/scale where the scale is positive (else
  0), ``rint`` (half to even, as ``torch.round``) and a clip to ±127; NaN
  quantizes to 0, +Inf to 127, -Inf to -127, and an all-zero (or
  all-nonfinite) block keeps scale 0 and decodes to zeros.  Every
  division is tensor by tensor: a division by a Python scalar may run as a
  product with its reciprocal on the card, one bit off the reference.
* :func:`block_encode` / :func:`block_decode` — the block codec of the
  quantized collectives (:func:`~hetu_tpu_torch.parallel.collectives.
  quantized_psum`): flatten, pad to whole blocks, one f32 scale a block,
  the same clamp rules; bitwise the reference's ``jnp_block_encode``
  codes and scales.  :func:`block_wire_bytes` prices it and
  :func:`check_wire` names the wire dtypes.
* :func:`record_wire_bytes` — the ``<path>.bytes_logical`` /
  ``bytes_wire`` / ``bytes_saved`` counters, in a
  :class:`~hetu_tpu_torch.telemetry.MetricsRegistry` the caller passes.
* ``WIRE_CODES`` and :func:`row_wire_bytes` — the PS gradient wire's
  dtypes (the numbering of ``WireDtype`` in ``csrc/hetu_ps_dtype.h``) and
  the bytes ``n`` rows take on it.

``torch`` is imported inside the codecs' functions only: the van's client (:mod:`hetu_tpu_torch.ps.van`) imports this module,
and a van server process must not pay for ``import torch``.
"""

from __future__ import annotations

WIRE_DTYPES = ("f32", "bf16", "int8")

# the PS gradient wire's dtypes, numbered as csrc's WireDtype; "f32" means
# the legacy ops
WIRE_CODES = {"f32": 0, "bf16": 1, "int8": 2}


def check_wire(wire: str) -> str:
    if wire not in WIRE_DTYPES:
        raise ValueError(f"unknown wire dtype {wire!r}; "
                         f"expected one of {WIRE_DTYPES}")
    return wire


def block_wire_bytes(n_elems: int, wire: str, block: int) -> int:
    """Wire bytes of ``n_elems`` flat elements in block-scaled ``wire``
    encoding (one f32 scale per ``block`` elements, int8 only)."""
    if wire == "bf16":
        return n_elems * 2
    if wire == "int8":
        nblk = -(-max(n_elems, 1) // block)
        return n_elems + nblk * 4
    return n_elems * 4


def row_wire_bytes(wire: str, n: int, dim: int) -> int:
    """Wire bytes of ``n`` rows of ``dim`` elements in ``wire`` encoding
    (csrc's ``wire_row_bytes``: int8 carries one f32 scale a row)."""
    if wire == "bf16":
        return n * dim * 2
    if wire == "int8":
        return n * (dim + 4)
    return n * dim * 4


def q8_encode_axes(a: torch.Tensor, reduce_axes) -> tuple:
    """Quantize ``a`` to int8 with one scale per block, where a block is
    the set of elements that share the coordinates outside
    ``reduce_axes`` (K/V ``[layers, tokens, heads, head_dim]`` with
    ``reduce_axes=(1, 3)``: one scale per (layer, head)).

    Returns ``(q int8 of a's shape, scales f32 keepdims-shaped)`` on
    ``a``'s device."""
    import torch

    a32 = a.to(torch.float32)
    finite = torch.isfinite(a32)
    # the masks below change nothing where every element is finite: skip
    # their passes then (the common case of K/V rows)
    all_finite = bool(finite.all())
    zero = torch.zeros((), dtype=torch.float32, device=a.device)
    mag = a32.abs() if all_finite else torch.where(finite, a32, zero).abs()
    amax = mag.amax(dim=tuple(reduce_axes), keepdim=True)
    scale = amax / torch.full_like(amax, 127.0)
    pos = scale > 0
    inv = torch.where(
        pos, torch.ones_like(scale) / torch.where(pos, scale,
                                                  torch.ones_like(scale)),
        zero)
    q = (a32 * inv).round_().clamp_(-127.0, 127.0)
    if not all_finite:
        q = torch.where(torch.isnan(a32), zero, q)
        q = torch.where(torch.isposinf(a32), zero + 127.0, q)
        q = torch.where(torch.isneginf(a32), zero - 127.0, q)
    return q.to(torch.int8), scale


def q8_decode_axes(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`q8_encode_axes`: f32 (cast at the caller when the
    logical dtype differs)."""
    import torch

    return q.to(torch.float32) * scales.to(torch.float32)


def block_encode(x, block: int):
    """Flatten ``x``, pad it with zeros to a multiple of ``block`` and
    quantize each block to int8 with a symmetric f32 scale: ``(q [nblk,
    block] int8, scales [nblk, 1] f32)`` on ``x``'s device.  The scale is
    amax/127 over the block's FINITE magnitudes; NaN quantizes to 0, +Inf
    to 127 and -Inf to -127 (:func:`q8_encode_axes`'s rules).  Gradients
    reach ``x`` through the scales only, as through the reference's
    rounding."""
    import torch

    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, block)
    finite = torch.isfinite(blocks)
    zero = blocks.new_zeros(())
    amax = torch.where(finite, blocks, zero).abs().amax(dim=1, keepdim=True)
    scale = amax / torch.full_like(amax, 127.0)
    pos = scale > 0
    inv = torch.where(pos, torch.ones_like(scale)
                      / torch.where(pos, scale, torch.ones_like(scale)),
                      zero)
    q = torch.clamp(torch.round(blocks * inv), -127.0, 127.0)
    q = torch.where(torch.isnan(blocks), zero, q)
    q = torch.where(torch.isposinf(blocks), zero + 127.0, q)
    q = torch.where(torch.isneginf(blocks), zero - 127.0, q)
    return q.to(torch.int8), scale


def block_decode(q, scales, size: int, shape):
    """Inverse of :func:`block_encode` back to ``shape`` (f32)."""
    import torch

    out = q.to(torch.float32) * scales
    return out.reshape(-1)[:size].reshape(shape)


def record_wire_bytes(registry, path: str, logical: int, wire: int) -> None:
    """Fold one transfer into ``registry``'s counters
    ``<path>.bytes_logical`` / ``<path>.bytes_wire`` and
    ``<path>.bytes_saved`` (the nonnegative difference)."""
    logical, wire = int(logical), int(wire)
    registry.counter(f"{path}.bytes_logical",
                     help="uncompressed (logical) payload bytes").inc(logical)
    registry.counter(f"{path}.bytes_wire",
                     help="bytes actually crossing the wire").inc(wire)
    saved = registry.counter(f"{path}.bytes_saved",
                             help="bytes the wire encoding avoided moving")
    if logical > wire:
        saved.inc(logical - wire)
