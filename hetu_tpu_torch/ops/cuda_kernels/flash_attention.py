"""Flash attention, forward and backward: the hand-written CUDA kernels and
their plain PyTorch versions.

Counterpart of ``hetu_tpu/ops/pallas_kernels/flash_attention.py``:

* the forward ``_flash_fwd_kernel`` is ``hetu_tpu_torch/csrc/flash_attention.cu``;
* the backward ``_flash_bwd_dkdv_kernel`` and ``_flash_bwd_dq_kernel`` are
  ``hetu_tpu_torch/csrc/flash_attention_bwd.cu``;
* the ``custom_vjp`` that joins them is :class:`_FlashAttention`, a
  ``torch.autograd.Function``.

Each source's header says what bounds it on an H100 and what the design
does about that; they are built with nvcc on first use and bound with
ctypes.  Forward and backward take the same two routes (:func:`route`):
bf16 runs on tensor cores (wgmma on TMA-fed, swizzled
bf16 tiles, p and dS kept in registers); f32 keeps the scalar f32-FMA
kernels, since a tensor-core product of f32 inputs runs in TF32.  Both
read bf16 views such as the attention layer's transposed ones in place
(TMA maps take strides), and :func:`flash_attention_bwd` prepares q, k, v
and dO once for both backward kernels (:func:`_operands`).

Every wrapper computes its plain version for CPU tensors and launches its
kernel for CUDA tensors — there is no fallback from one to the other.  Each
kernel's wrapper counts its launches (``flash_attention.launches``,
``flash_attention_bwd_dkdv.launches``, ``flash_attention_bwd_dq.launches``).
All compute the same function as the TPU kernels:

* O ``[B, H, S_q, D]`` in the input type and an f32 LSE ``[B*H, S_q, 1]``;
  the backward recomputes p from that LSE;
* the causal mask is bottom-right aligned (query ``i`` sees keys
  ``<= i + S_k - S_q``);
* a query row that sees no key (only possible when ``S_q > S_k``) gives
  O = 0 and dQ = 0, and adds nothing to dK or dV — not the XLA
  composition's uniform average;
* scores accumulate in f32 and the scale applies to the f32 scores; p is
  rounded to the value type before ``P @ V`` and ``P^T @ dO``, dS to the
  input type before ``dS^T @ q`` and ``dS @ k``.

Unlike the TPU kernels' ``_fit_block``, any sequence length works: the
kernels mask ragged tails.
"""

from __future__ import annotations

import ctypes

import torch

from hetu_tpu_torch.ops.cuda_kernels import build

NEG_INF = -1e30  # the TPU kernel's mask value
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FWD = "flash_attention"
_BWD = "flash_attention_bwd"


# ------------------------------------------------------------ plain versions

def _causal_keep(s_q, s_k, device):
    return torch.ones(s_q, s_k, dtype=torch.bool, device=device).tril(
        s_k - s_q)


def flash_attention_plain(q, k, v, *, causal: bool, scale=None):
    """The plain PyTorch version: ``(O, LSE)`` as the kernel computes them,
    with the whole ``[S_q, S_k]`` score matrix in memory."""
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        keep = _causal_keep(s_q, s_k, q.device)
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)  # NEG_INF where a row sees no key
    p = torch.exp(s - m)
    if causal:
        p = p.masked_fill(~keep, 0.0)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l_safe
    lse = (m + torch.log(l_safe)).reshape(b * h, s_q, 1)
    return o.to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, do, lse, delta, *, causal: bool,
                              scale=None):
    """The plain PyTorch version of both backward kernels: ``(dQ, dK, dV)``
    from q, k, v, dO ``[B, H, S, D]``, the forward's LSE and
    ``delta = rowsum(dO * O)`` (both ``[B*H, S_q, 1]`` f32), with the whole
    ``[S_q, S_k]`` matrix in memory and the kernels' rounding points."""
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(s_q, s_k, q.device), NEG_INF)
    p = torch.exp(s - lse.reshape(b, h, s_q, 1))
    if causal:
        # a masked score gives p = 0, also on rows that see no key, whose
        # LSE is about NEG_INF and would overflow the exp above
        p = torch.where(s <= NEG_INF / 2, 0.0, p)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta.reshape(b, h, s_q, 1)) * scale).to(q.dtype).float()
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dq = torch.matmul(ds, k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------- checks

def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q, k, v as [B, H, S, D]")
    if k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16 "
                        f"q, k, v of one type, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.shape[3] > 128:
        raise ValueError(f"head_dim {q.shape[3]} > 128 is not supported")
    if min(q.shape) < 1 or k.shape[2] < 1:
        raise ValueError("flash_attention needs non-empty q, k, v")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, "
                         f"got {q.device}")


def _check_bwd(q, k, v, do, lse, delta):
    _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dO must match q: got {tuple(do.shape)} "
                         f"{do.dtype} on {do.device}, q {tuple(q.shape)} "
                         f"{q.dtype} on {q.device}")
    rows = (q.shape[0] * q.shape[1], q.shape[2], 1)
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != rows or t.dtype != torch.float32 \
                or t.device != q.device:
            raise ValueError(f"{name} must be float32 {rows} on {q.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


# ----------------------------------------------------------------- launches

def _library(name, *functions):
    """The built library of ``csrc/<name>.cu`` with its launchers typed:
    each takes ``n_ptr`` pointers, then the ints ``bh, s_q, s_k, d``, the
    float scale, the ints ``causal, dtype, device`` and the stream."""
    lib = build.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn_name, n_ptr in functions:
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:
            fn.argtypes = [p] * n_ptr + [i, i, i, i, ctypes.c_float, i, i, i,
                                         p]
            fn.restype = ctypes.c_int
    lib.hetu_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hetu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _call(lib, fn_name, what, dims, ref, pointers, causal, scale):
    """Launch ``fn_name`` on the current stream with ``pointers`` (tensors
    and ctypes arrays, in the launcher's order) and ``dims = (B*H, S_q,
    S_k, D)``, for inputs of ``ref``'s type and device; raise, naming the
    cudaError and the dims, if it refused or failed."""
    dev = ref.device.index if ref.device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(ref.device).cuda_stream
    err = getattr(lib, fn_name)(
        *(t.data_ptr() if isinstance(t, torch.Tensor) else ctypes.addressof(t)
          for t in pointers), *dims, scale, int(causal), _DTYPES[ref.dtype],
        dev, stream)
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: cudaError {err} "
            f"({lib.hetu_cuda_error_string(err).decode()}) for (B*H, S_q, "
            f"S_k, D) {tuple(dims)} {ref.dtype}")


def _fwd_library():
    return _library(_FWD, ("hetu_flash_attention_fwd", 6))


def fwd_design():
    """The bf16 forward kernel's CTA as built (builds the library on first
    use): its warpgroups, the queries it owns and the depth of its K/V
    ring."""
    out = (ctypes.c_int * 3)()
    _fwd_library().hetu_flash_attention_fwd_design(out)
    return dict(zip(("warpgroups", "queries", "stages"), out))


def _bwd_library():
    return _library(_BWD, ("hetu_flash_attention_bwd_dkdv", 9),
                    ("hetu_flash_attention_bwd_dq", 8))


def route(dtype, head_dim: int):
    """Which kernels a CUDA call takes, forward and backward alike, and the
    head dim they run at: ``("wgmma", D rounded up to 8)`` for bf16 --
    tensor cores on TMA-fed tiles, whose tensor maps need rows of a
    multiple of 16 bytes, so other head dims are padded with zero columns
    -- and ``("scalar", D)`` for f32 -- f32 FMAs on CUDA cores, since a
    tensor-core product of f32 inputs would run in TF32 and break the
    reference's f32 semantics."""
    if dtype == torch.bfloat16:
        return "wgmma", -(-head_dim // 8) * 8
    return "scalar", head_dim



def _outer_strides(t):
    """The batch, head and row strides of ``[B, H, S, D]`` ``t`` (unit
    inner stride), with the dense value for a dimension of size 1, whose
    stride is never used."""
    out, inner = [], t.shape[3]
    for i in (2, 1, 0):
        st = t.stride(i) if t.shape[i] > 1 else inner
        out.insert(0, st)
        inner = st * t.shape[i]
    return out


def _tma_ready(t):
    """True when TMA can read bf16 ``t`` in place: unit inner stride, the
    other strides multiples of 8 elements (16 bytes), 16-byte aligned."""
    return t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(
        s % 8 == 0 for s in _outer_strides(t))


def _operands(*tensors):
    """The ``[B, H, S, D]`` inputs as the kernels of :func:`route` read
    them, and the head dim D of the outputs.  bf16 views are read in place
    where TMA can (the attention layer's transposed views can); other bf16
    inputs become contiguous copies zero-padded to the route's head dim,
    and f32 inputs contiguous copies.  So each input is copied at most once
    a call."""
    d = tensors[0].shape[-1]
    kind, d_run = route(tensors[0].dtype, d)
    ops = []
    for t in tensors:
        if d_run != d:
            t = torch.nn.functional.pad(t, (0, d_run - d))
        elif kind == "scalar":
            t = t.contiguous()
        elif not _tma_ready(t):  # a fresh allocation is aligned
            t = t.clone(memory_format=torch.contiguous_format)
        ops.append(t)
    return ops, d


def _layout(*tensors):
    """The launchers' ``layout``: the heads, then each tensor's batch, head
    and row strides (:func:`_outer_strides`), as a ctypes array."""
    strides = [s for t in tensors for s in _outer_strides(t)]
    return (ctypes.c_longlong * (1 + len(strides)))(tensors[0].shape[1],
                                                   *strides)


def _out(ref, rows, d):
    """A kernel output, contiguous ``[B, H, rows, D']`` with ``ref``'s
    batch, heads, head dim and type, and its view without the padding
    columns, ``[..., :d]``."""
    t = torch.empty(*ref.shape[:2], rows, ref.shape[3], dtype=ref.dtype,
                    device=ref.device)
    return t, t[..., :d]


def _dims(q, k):
    return q.shape[0] * q.shape[1], q.shape[2], k.shape[2], q.shape[3]


def _launch_fwd(q, k, v, *, causal: bool, scale: float):
    """O (a view without the padding columns where the route pads D) and
    the LSE from one launch of the forward kernel of :func:`route`."""
    (q, k, v), d = _operands(q, k, v)
    out, out_view = _out(q, q.shape[2], d)
    lse = torch.empty(q.shape[0] * q.shape[1], q.shape[2], 1,
                      dtype=torch.float32, device=q.device)
    _call(_fwd_library(), "hetu_flash_attention_fwd", "flash_attention",
          _dims(q, k), q, (q, k, v, out, lse, _layout(q, k, v, out)),
          causal, scale)
    flash_attention.launches += 1
    return out_view, lse


def _launch_dkdv(operands, lse, delta, *, causal, scale):
    (q, k, v, do), d = operands
    dk, dk_view = _out(k, k.shape[2], d)
    dv, dv_view = _out(k, k.shape[2], d)
    _call(_bwd_library(), "hetu_flash_attention_bwd_dkdv",
          "flash_attention_bwd_dkdv", _dims(q, k), q,
          (q, k, v, do, lse.contiguous(), delta.contiguous(), dk, dv,
           _layout(q, k, v, do)), causal, float(scale))
    flash_attention_bwd_dkdv.launches += 1
    return dk_view, dv_view


def _launch_dq(operands, lse, delta, *, causal, scale):
    (q, k, v, do), d = operands
    dq, dq_view = _out(q, q.shape[2], d)
    _call(_bwd_library(), "hetu_flash_attention_bwd_dq",
          "flash_attention_bwd_dq", _dims(q, k), q,
          (q, k, v, do, lse.contiguous(), delta.contiguous(), dq,
           _layout(q, k, v, do)), causal, float(scale))
    flash_attention_bwd_dq.launches += 1
    return dq_view


def flash_attention_bwd_dkdv(q, k, v, do, lse, delta, *, causal: bool,
                             scale=None):
    """dK and dV ``[B, H, S_k, D]`` (the ``_flash_bwd_dkdv_kernel``): the
    plain version for CPU tensors, the kernel of :func:`route` for
    CUDA tensors."""
    _check_bwd(q, k, v, do, lse, delta)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        _, dk, dv = flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                              causal=causal, scale=scale)
        return dk, dv
    return _launch_dkdv(_operands(q, k, v, do), lse, delta,
                        causal=causal, scale=scale)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool,
                           scale=None):
    """dQ ``[B, H, S_q, D]`` (the ``_flash_bwd_dq_kernel``): the plain
    version for CPU tensors, the kernel of :func:`route` for CUDA
    tensors."""
    _check_bwd(q, k, v, do, lse, delta)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        dq, _, _ = flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                             causal=causal, scale=scale)
        return dq
    return _launch_dq(_operands(q, k, v, do), lse, delta, causal=causal,
                      scale=scale)


def _launch_bwd(q, k, v, do, lse, delta, *, causal, scale):
    """Both backward kernels over one set of operands: each input is
    prepared (read in place, or copied) once, not once a kernel."""
    operands = _operands(q, k, v, do)
    dk, dv = _launch_dkdv(operands, lse, delta, causal=causal, scale=scale)
    dq = _launch_dq(operands, lse, delta, causal=causal, scale=scale)
    return dq, dk, dv


def bwd_delta(do, out):
    """``delta = rowsum(dO * O)`` in f32, laid out like the LSE
    ``[B*H, S_q, 1]``: each product of the two up-cast values and the sum
    in f32, with one f32 temporary (``out`` is up-cast on the fly)."""
    b, h, s_q, _ = do.shape
    return (do.float() * out).sum(-1).reshape(b * h, s_q, 1)


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool, scale=None):
    """The backward pass of :func:`flash_attention`: ``(dQ, dK, dV)``.

    ``delta = rowsum(dO * O)`` is one f32 reduction in plain PyTorch (the
    JAX package computes it outside Pallas too), laid out like the LSE;
    then the dK/dV kernel and the dQ kernel over the same operands (for
    CPU tensors, their plain version once)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    delta = bwd_delta(do, out)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                         causal=causal, scale=scale)
    _check_bwd(q, k, v, do, lse, delta)
    return _launch_bwd(q, k, v, do, lse, delta, causal=causal, scale=scale)


# --------------------------------------------------------------- public op

class _FlashAttention(torch.autograd.Function):
    """Forward: the forward kernel, saving q, k, v, O and the LSE.
    Backward: :func:`flash_attention_bwd`.  Under recomputation
    (``torch.utils.checkpoint``) the forward runs again in the backward
    pass, and the backward reads the recomputed O and LSE."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, causal=causal,
                                             scale=scale)
        else:
            out, lse = _launch_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out, d_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, d_out,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool, scale=None,
                    return_lse: bool = False):
    """Fused attention: q ``[B, H, S_q, D]``, k and v ``[B, H, S_k, D]``
    → O ``[B, H, S_q, D]`` (and the f32 LSE ``[B*H, S_q, 1]`` with
    ``return_lse``), differentiable in q, k and v.

    CPU tensors run the plain versions; CUDA tensors launch the kernels or
    raise.  ``flash_attention.launches`` counts forward launches.
    """
    _check(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    out, lse = _FlashAttention.apply(q, k, v, bool(causal), float(scale))
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention_bwd_dkdv.launches = 0
flash_attention_bwd_dq.launches = 0
