"""The int8 block codec and wire-byte accounting of KV migration payloads
(counterpart of the parts of ``hetu_tpu/quantwire.py`` that
``serve/migrate.py`` uses).

* :func:`q8_encode_axes` / :func:`q8_decode_axes` — symmetric int8 with one
  f32 scale per block, as torch ops on the tensor's own device.  Bit for
  bit the reference's numpy codec: the scale is amax/127 over the block's
  FINITE magnitudes, the inverse 1/scale where the scale is positive (else
  0), ``rint`` (half to even, as ``torch.round``) and a clip to ±127; NaN
  quantizes to 0, +Inf to 127, -Inf to -127, and an all-zero (or
  all-nonfinite) block keeps scale 0 and decodes to zeros.  Every
  division is tensor by tensor: a division by a Python scalar may run as a
  product with its reciprocal on the card, one bit off the reference.
* :func:`record_wire_bytes` — the ``<path>.bytes_logical`` /
  ``bytes_wire`` / ``bytes_saved`` counters, in a
  :class:`~hetu_tpu_torch.telemetry.MetricsRegistry` the caller passes.
* ``WIRE_CODES`` and :func:`row_wire_bytes` — the PS gradient wire's
  dtypes (the numbering of ``WireDtype`` in ``csrc/hetu_ps_dtype.h``) and
  the bytes ``n`` rows take on it.

The reference's jax block codec (quantized collectives) waits for the
multi-GPU slice.  ``torch`` is imported by the codec's two functions
only: the van's client (:mod:`hetu_tpu_torch.ps.van`) imports this module,
and a van server process must not pay for ``import torch``.
"""

from __future__ import annotations

# the PS gradient wire's dtypes, numbered as csrc's WireDtype; "f32" means
# the legacy ops
WIRE_CODES = {"f32": 0, "bf16": 1, "int8": 2}


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
