"""Flash attention forward: the hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of ``hetu_tpu/ops/pallas_kernels/flash_attention.py``
(``_flash_fwd_kernel`` / ``_flash_fwd``).  The kernel is
``hetu_tpu_torch/csrc/flash_attention.cu`` (its header says what bounds it
on an H100 and what the design does about that), built with nvcc on first
use and bound with ctypes.

:func:`flash_attention` computes the plain version for CPU tensors and
launches the kernel for CUDA tensors — there is no fallback from one to the
other.  Both compute the same function as the TPU kernel:

* O ``[B, H, S_q, D]`` in the input type and an f32 LSE ``[B*H, S_q, 1]``;
* the causal mask is bottom-right aligned (query ``i`` sees keys
  ``<= i + S_k - S_q``);
* a query row that sees no key (only possible when ``S_q > S_k``) gives
  O = 0, not the XLA composition's uniform average;
* scores accumulate in f32 and the scale applies to the f32 scores; the
  probabilities are rounded to the value type before ``P @ V``.

Unlike the TPU kernel's ``_fit_block``, any sequence length works: the
kernel masks ragged tails.  Only the forward pass exists; the backward
kernels come with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from hetu_tpu_torch.ops.cuda_kernels import build

NEG_INF = -1e30  # the TPU kernel's mask value
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NAME = "flash_attention"


def flash_attention_plain(q, k, v, *, causal: bool, scale=None):
    """The plain PyTorch version: ``(O, LSE)`` as the kernel computes them,
    with the whole ``[S_q, S_k]`` score matrix in memory."""
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device).tril(
            s_k - s_q)
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)  # NEG_INF where a row sees no key
    p = torch.exp(s - m)
    if causal:
        p = p.masked_fill(~keep, 0.0)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l_safe
    lse = (m + torch.log(l_safe)).reshape(b * h, s_q, 1)
    return o.to(q.dtype), lse


def _check(q, k, v):
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward pass yet: its backward kernels "
            "and autograd.Function come with the training slice; run "
            "under torch.inference_mode() or torch.no_grad()")
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


def _library():
    lib = build.load(_NAME)
    fn = lib.hetu_flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_float, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.hetu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.hetu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, k, v, *, causal: bool, scale: float):
    lib = _library()
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    qf = q.reshape(b * h, s_q, d).contiguous()
    kf = k.reshape(b * h, s_k, d).contiguous()
    vf = v.reshape(b * h, s_k, d).contiguous()
    out = torch.empty_like(qf)
    lse = torch.empty(b * h, s_q, 1, dtype=torch.float32, device=q.device)
    dev = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.hetu_flash_attention_fwd(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b * h, s_q, s_k, d, scale, int(causal),
        _DTYPES[q.dtype], dev, stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: cudaError {err} "
            f"({lib.hetu_cuda_error_string(err).decode()}) for q "
            f"{tuple(q.shape)} {q.dtype}, S_k {s_k}")
    flash_attention.launches += 1
    return out.reshape(b, h, s_q, d), lse


def flash_attention(q, k, v, *, causal: bool, scale=None,
                    return_lse: bool = False):
    """Fused attention: q ``[B, H, S_q, D]``, k and v ``[B, H, S_k, D]``
    → O ``[B, H, S_q, D]`` (and the f32 LSE ``[B*H, S_q, 1]`` with
    ``return_lse``).

    CPU tensors run :func:`flash_attention_plain`; CUDA tensors launch the
    kernel or raise.  ``flash_attention.launches`` counts kernel launches.
    """
    _check(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        out, lse = flash_attention_plain(q, k, v, causal=causal, scale=scale)
    else:
        out, lse = _launch(q, k, v, causal=causal, scale=float(scale))
    return (out, lse) if return_lse else out


flash_attention.launches = 0
