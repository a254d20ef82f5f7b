"""Row gather, its scatter-add gradient and the fused top-k gate: the
hand-written CUDA kernels and their plain PyTorch versions.

Counterpart of ``hetu_tpu/ops/pallas_kernels/embedding.py``:

* ``_gather_kernel`` (op ``embedding_gather``) and ``_scatter_kernel`` (op
  ``embedding_scatter_add``) are ``hetu_tpu_torch/csrc/embedding.cu``;
* ``_topk_kernel`` (op ``topk_gating``) is
  ``hetu_tpu_torch/csrc/topk_gating.cu``;
* the ``custom_vjp``s that join them are :class:`_RoutedGather` and
  :class:`_TopKGating`, ``torch.autograd.Function``s.

Each source's header says what bounds it on an H100 and what the design
does about that; they are built with nvcc on first use and bound with
ctypes.

Every wrapper computes its plain version for CPU tensors and launches its
kernel for CUDA tensors — there is no fallback from one to the other.
The kernels take int32 ids; an int64 id outside int32's range raises
rather than wrap onto another row.
Each kernel's wrapper counts its launches (``embedding_gather.launches``,
``embedding_scatter_add.launches``, ``topk_gating.launches``).  The
functions are the TPU kernels':

* the gather copies ``table[ids]``; an id < 0 or >= V gives a zero row;
* the scatter-add sums, into a zeroed ``[num_rows, D]``, each gradient row
  onto the row its id names, dropping invalid ids.  Duplicates are summed
  in f32 in ascending order of position (the order of a stable sort of the
  ids) and rounded once to the gradient's type, with no atomics, so the
  result does not change from run to run.  A caller that holds the
  routing's inverse map (``inverse [num_rows, m]``: row r's positions,
  padded with -1, as the MoE routing builds it) passes it, and the kernel
  reads each row's sources from it; without it the wrapper sorts the ids
  first;
* the gate takes k passes of max, lowest index among equal values, mask;
  then the softmax over the k values in f32, cast to the logits' type;
  the indices are int32.
"""

from __future__ import annotations

import ctypes

import torch

from hetu_tpu_torch.ops.cuda_kernels import build
from hetu_tpu_torch.ops.embedding import embedding_lookup, int32_ids

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_EMBEDDING = "embedding"
_TOPK = "topk_gating"
# the most sources a row of an inverse map may list: the kernel sorts them
# in registers
INVERSE_MAX_WIDTH = 32


# ------------------------------------------------------------ plain versions

# ``table[ids]`` with zero rows for ids outside ``[0, V)``: the embedding
# lookup's own function
embedding_gather_plain = embedding_lookup


def embedding_scatter_add_plain(grads, ids, num_rows: int):
    """The gather's gradient ``[num_rows, D]``: each valid row of ``grads``
    added in f32 onto row ``ids[i]``, in the order the ids come in, then
    rounded once to ``grads``' type.  (On the CPU ``index_add_`` adds
    sequentially; on the card it uses atomics, whose order may change
    between runs when an id repeats more than twice.)"""
    ids = ids.long()
    valid = (ids >= 0) & (ids < num_rows)
    out = torch.zeros(num_rows, grads.shape[1], dtype=torch.float32,
                      device=grads.device)
    out.index_add_(0, ids[valid], grads[valid].float())
    return out.to(grads.dtype)


def embedding_scatter_add_inverse_plain(grads, inverse):
    """The same gradient ``[num_rows, D]`` read through the inverse map
    ``inverse [num_rows, m]`` (row r's positions in ``grads``, padded with
    -1; entries outside ``[0, N)`` are skipped): each row the f32 sum of its
    source rows in ascending order of position, rounded once to ``grads``'
    type, as the inverse route's kernel computes it."""
    n, d = grads.shape
    pos = inverse.long()
    pos = torch.where((pos >= 0) & (pos < n), pos, n).sort(dim=1).values
    # row n is the padding's: zeros, which leave a sum's bits as they are
    src = torch.cat([grads.float(), grads.new_zeros(1, d,
                                                    dtype=torch.float32)])
    out = torch.zeros(pos.shape[0], d, dtype=torch.float32,
                      device=grads.device)
    for j in range(pos.shape[1]):
        out += src[pos[:, j]]
    return out.to(grads.dtype)


def _topk_passes(logits, k: int):
    """``(values [T, k]`` f32, ``indices [T, k]`` int64) of k passes of max
    and mask over ``logits [T, E]``: each pass's maximum, where a masked
    entry counts as -inf, and the lowest index attaining it
    (``torch.argmax`` returns the first maximum; ``torch.topk`` promises no
    order among equal values).  Once every value left is -inf, a pass picks
    the lowest index again, masked or not, as the reference's kernel
    does."""
    x = logits.detach().float().clone()
    vals, picked = [], []
    for _ in range(k):
        pos = x.argmax(dim=-1, keepdim=True)
        picked.append(pos)
        vals.append(x.gather(-1, pos))
        x.scatter_(-1, pos, float("-inf"))
    return torch.cat(vals, dim=-1), torch.cat(picked, dim=-1)


def topk_select(logits, k: int):
    """The k indices ``[T, k]`` (int64) of ``logits`` ``[T, E]`` by k passes
    of max and mask, ties to the lowest index."""
    return _topk_passes(logits, k)[1]


def _softmax_f32(vals):
    """exp(v - max) / sum over the last axis, in f32."""
    e = torch.exp(vals - vals.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def topk_gating_plain(logits, k: int):
    """``(gates [T, k] in the logits' type, idx [T, k] int32)``, as the
    kernel computes them."""
    vals, idx = _topk_passes(logits, k)
    return _softmax_f32(vals).to(logits.dtype), idx.to(torch.int32)


# ------------------------------------------------------------------- checks

def _check_device(what, *tensors):
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: tensors on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {dev}")


def _check_rows(what, rows, ids):
    if rows.dim() != 2 or ids.dim() != 1:
        raise ValueError(f"{what} takes rows [N, D] and ids [N'], got "
                         f"{tuple(rows.shape)} and {tuple(ids.shape)}")
    if rows.dtype not in _DTYPES:
        raise TypeError(f"{what} takes float32 or bfloat16 rows, got "
                        f"{rows.dtype}")
    if ids.is_floating_point() or ids.is_complex():
        raise TypeError(f"{what} takes integer ids, got {ids.dtype}")
    _check_device(what, rows, ids)


def _check_inverse(what, inverse, num_rows, rows):
    if inverse.dim() != 2 or inverse.shape[0] != num_rows:
        raise ValueError(f"{what} takes an inverse map [{num_rows}, m], got "
                         f"{tuple(inverse.shape)}")
    if inverse.is_floating_point() or inverse.is_complex():
        raise TypeError(f"{what} takes an integer inverse map, got "
                        f"{inverse.dtype}")
    if inverse.shape[1] > INVERSE_MAX_WIDTH:
        raise ValueError(f"{what}: an inverse map of {inverse.shape[1]} "
                         f"columns; the kernel takes at most "
                         f"{INVERSE_MAX_WIDTH} (call without it to sort)")
    _check_device(what, rows, inverse)


# ----------------------------------------------------------------- launches

def _library(name, functions):
    """The built library of ``csrc/<name>.cu`` with its launchers typed
    (``functions``: name → argument types; each returns a cudaError_t)."""
    lib = build.load(name)
    for fn_name, argtypes in functions.items():
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.hetu_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hetu_cuda_error_string.restype = ctypes.c_char_p
    return lib


_P, _I = ctypes.c_void_p, ctypes.c_int


def _embedding_library():
    return _library(_EMBEDDING, {
        "hetu_embedding_gather": [_P, _P, _P, _I, _I, _I, _I, _P],
        "hetu_embedding_scatter_add": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
        "hetu_embedding_scatter_add_inverse": [_P, _P, _P, _I, _I, _I, _I,
                                               _I, _I, _P]})


def _topk_library():
    lib = _library(_TOPK, {"hetu_topk_gating": [_P, _P, _P, _P, _I, _I, _I,
                                                _I, _I, _P]})
    work = lib.hetu_topk_gating_work  # scratch floats a token; not an error
    if work.argtypes is None:
        work.argtypes = [_I, _I, _I]
        work.restype = ctypes.c_longlong
    return lib


def _launch(lib, fn_name, what, device, *args):
    """Call ``fn_name(*args, device, stream)`` on the current stream and
    raise, naming the cudaError, if the launch was refused or failed."""
    dev = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, fn_name)(*args, dev, stream)
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: cudaError {err} "
            f"({lib.hetu_cuda_error_string(err).decode()})")


def embedding_gather(table, ids):
    """``table [V, D]``, ``ids [N]`` → ``[N, D]`` in the table's type; ids
    outside ``[0, V)`` give zero rows.  The plain version for CPU tensors,
    the kernel for CUDA tensors; ``embedding_gather.launches`` counts
    kernel launches."""
    _check_rows("embedding_gather", table, ids)
    ids = int32_ids(ids, "embedding_gather")
    if table.device.type == "cpu":
        return embedding_gather_plain(table, ids)
    table = table.contiguous()
    ids = ids.contiguous()
    out = torch.empty(ids.shape[0], table.shape[1], dtype=table.dtype,
                      device=table.device)
    if out.numel() == 0:
        return out
    _launch(_embedding_library(), "hetu_embedding_gather",
            f"embedding_gather (table {tuple(table.shape)} {table.dtype}, "
            f"{ids.shape[0]} ids)", table.device,
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), ids.shape[0],
            table.shape[0], table.shape[1] * table.element_size())
    embedding_gather.launches += 1
    return out


def scatter_segments(ids, num_rows: int):
    """``(perm, offsets)`` for the scatter kernel: ``perm`` [N] int32 is the
    stable sort order of ``ids`` and row ``r``'s gradient rows are
    ``perm[offsets[r]:offsets[r + 1]]`` (``offsets`` [num_rows + 1] int32).
    Invalid ids fall outside every segment: negatives sort before
    ``offsets[0]``, ids >= num_rows after ``offsets[num_rows]``."""
    sids, perm = torch.sort(int32_ids(ids, "embedding_scatter_add"),
                            stable=True)
    bounds = torch.arange(num_rows + 1, dtype=torch.int32, device=ids.device)
    offsets = torch.searchsorted(sids, bounds, out_int32=True)
    return perm.to(torch.int32), offsets


def embedding_scatter_add(grads, ids, num_rows: int, *, inverse=None):
    """``grads [N, D]``, ``ids [N]`` → ``[num_rows, D]`` in ``grads``' type:
    the gradient of :func:`embedding_gather`.  ``inverse [num_rows, m]``
    int32, where the caller has it, lists row r's positions (the i with
    ``ids[i] == r``), padded with -1, and no sort runs; without it the
    stable sort and the row segments (:func:`scatter_segments`) come first,
    in PyTorch.  The plain versions for CPU tensors, the kernel for CUDA
    tensors; ``embedding_scatter_add.launches`` counts kernel launches."""
    _check_rows("embedding_scatter_add", grads, ids)
    if grads.shape[0] != ids.shape[0]:
        raise ValueError(f"embedding_scatter_add: {grads.shape[0]} gradient "
                         f"rows for {ids.shape[0]} ids")
    if inverse is not None:
        _check_inverse("embedding_scatter_add", inverse, num_rows, grads)
    ids = int32_ids(ids, "embedding_scatter_add")
    if grads.device.type == "cpu":
        if inverse is not None:
            return embedding_scatter_add_inverse_plain(grads, inverse)
        return embedding_scatter_add_plain(grads, ids, num_rows)
    grads = grads.contiguous()
    out = torch.empty(num_rows, grads.shape[1], dtype=grads.dtype,
                      device=grads.device)
    if out.numel() == 0:
        return out
    if inverse is not None:
        inverse = int32_ids(inverse, "embedding_scatter_add").contiguous()
        return _scatter_inverse(grads, inverse, out)
    perm, offsets = scatter_segments(ids, num_rows)
    return _scatter_sorted(grads, perm, offsets, out)


def _scatter_sorted(grads, perm, offsets, out):
    """Launch the scatter-add kernel's sorted route on precomputed
    segments."""
    num_rows = out.shape[0]
    _launch(_embedding_library(), "hetu_embedding_scatter_add",
            f"embedding_scatter_add (grads {tuple(grads.shape)} "
            f"{grads.dtype}, {num_rows} rows)", grads.device,
            grads.data_ptr(), perm.data_ptr(), offsets.data_ptr(),
            out.data_ptr(), num_rows, grads.shape[1], _DTYPES[grads.dtype])
    embedding_scatter_add.launches += 1
    return out


def _scatter_inverse(grads, inverse, out):
    """Launch the scatter-add kernel's inverse route (``inverse`` int32,
    contiguous)."""
    num_rows, m = inverse.shape
    _launch(_embedding_library(), "hetu_embedding_scatter_add_inverse",
            f"embedding_scatter_add (grads {tuple(grads.shape)} "
            f"{grads.dtype}, inverse {tuple(inverse.shape)})", grads.device,
            grads.data_ptr(), inverse.data_ptr(), out.data_ptr(), num_rows,
            m, grads.shape[0], grads.shape[1], _DTYPES[grads.dtype])
    embedding_scatter_add.launches += 1
    return out


def _launch_topk(logits, k: int):
    t, e = logits.shape
    logits = logits.contiguous()
    gates = torch.empty(t, k, dtype=logits.dtype, device=logits.device)
    idx = torch.empty(t, k, dtype=torch.int32, device=logits.device)
    if t == 0:
        return gates, idx
    lib = _topk_library()
    dev = logits.device.index if logits.device.index is not None \
        else torch.cuda.current_device()
    # a row too long for one block's shared memory lives in a scratch row
    per_token = lib.hetu_topk_gating_work(e, k, dev)
    work = torch.empty(t * per_token, dtype=torch.float32,
                       device=logits.device) if per_token else None
    _launch(lib, "hetu_topk_gating",
            f"topk_gating (logits {tuple(logits.shape)} {logits.dtype}, "
            f"k {k})", logits.device, logits.data_ptr(), gates.data_ptr(),
            idx.data_ptr(), None if work is None else work.data_ptr(), t, e,
            k, _DTYPES[logits.dtype])
    topk_gating.launches += 1
    return gates, idx


# --------------------------------------------------------------- public ops

class _RoutedGather(torch.autograd.Function):
    """Forward: :func:`embedding_gather`.  Backward: the cotangent rows
    scatter-added back by :func:`embedding_scatter_add` (duplicates
    accumulate, invalid ids drop)."""

    @staticmethod
    def forward(ctx, table, ids, inverse):
        ctx.save_for_backward(ids, inverse)
        ctx.num_rows = table.shape[0]
        return embedding_gather(table, ids)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        ids, inverse = ctx.saved_tensors
        return embedding_scatter_add(g, ids, ctx.num_rows,
                                     inverse=inverse), None, None


def routed_gather(table, ids, *, inverse=None):
    """Differentiable row gather: ``table [V, D]``, ``ids [N]`` → ``[N, D]``
    with zero rows for invalid ids, whose gradient is the scatter-add.
    ``inverse [V, m]``, where the caller has it (row v's positions i with
    ``ids[i] == v``, padded with -1), lets the gradient skip the sort.
    The building block of the MoE gather dispatch and combine."""
    _check_rows("routed_gather", table, ids)
    if inverse is not None:
        _check_inverse("routed_gather", inverse, table.shape[0], table)
    return _RoutedGather.apply(table, ids, inverse)


class _TopKGating(torch.autograd.Function):
    """Forward: the gate kernel (its plain version on the CPU).  Backward:
    the softmax-over-the-k vjp scattered back into ``[T, E]`` (the
    reference's ``_topk_gating_bwd``); the indices get no gradient."""

    @staticmethod
    def forward(ctx, logits, k):
        if logits.device.type == "cpu":
            gates, idx = topk_gating_plain(logits, k)
        else:
            gates, idx = _launch_topk(logits, k)
        ctx.save_for_backward(gates, idx)
        ctx.num_experts = logits.shape[1]
        ctx.mark_non_differentiable(idx)
        return gates, idx

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_gates, g_idx):
        gates, idx = ctx.saved_tensors
        inner = (g_gates * gates).sum(dim=-1, keepdim=True)
        dvals = (gates * (g_gates - inner)).to(gates.dtype)
        dlogits = torch.zeros(gates.shape[0], ctx.num_experts,
                              dtype=dvals.dtype, device=dvals.device)
        return dlogits.scatter_add_(1, idx.long(), dvals), None


def topk_gating(logits, k: int):
    """``logits [T, E]`` → ``(gates [T, k]`` softmaxed over the k in f32 and
    cast to the logits' type, ``idx [T, k]`` int32), ties to the lowest
    index, differentiable in the logits.  CPU tensors run the plain version;
    CUDA tensors launch the kernel (any E) or raise.
    ``topk_gating.launches`` counts kernel launches."""
    if logits.dim() != 2:
        raise ValueError(f"topk_gating takes logits [T, E], got "
                         f"{tuple(logits.shape)}")
    if logits.dtype not in _DTYPES:
        raise TypeError(f"topk_gating takes float32 or bfloat16 logits, got "
                        f"{logits.dtype}")
    _check_device("topk_gating", logits)
    t, e = logits.shape
    k = int(k)
    if not 1 <= k <= e:
        raise ValueError(f"top-{k} of only {e} experts")
    return _TopKGating.apply(logits, k)


embedding_gather.launches = 0
embedding_scatter_add.launches = 0
topk_gating.launches = 0
