"""Explicit collectives over mesh axes (counterpart of
``hetu_tpu/parallel/collectives.py``).

The reference's helpers run inside ``shard_map`` and name a mesh axis; here
each is a per-rank function over the process group of one mesh axis, or of
an axis tuple (the ranks of those axes flattened, the first axis major, as
``shard_map`` orders a tuple).  Each takes the mesh as ``mesh=`` (default:
the last one :func:`~hetu_tpu_torch.parallel.mesh.make_mesh` built) and is
differentiable with the gradient the reference's collective has under
``shard_map``: the transpose of the global function, so ``psum``'s
backward is a ``psum``, ``all_gather``'s a ``reduce_scatter`` and back.

``gloo`` fails some collectives on CUDA tensors (PyTorch 2.11 on an
H100: point-to-point sends abort with "Bad address", and the functional
all-gather DTensor uses never returns).  Under ``gloo`` only, such a call
copies its operands to pinned host memory, runs the collective there, and
copies the result back; :data:`STAGED` counts those calls by collective.
:func:`stage_gloo_all_gather` routes DTensor's all-gathers this way on a
``gloo`` mesh of CUDA tensors.  Under ``nccl`` nothing is staged, and
nothing is ever computed on the host.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

# collectives gloo does not run on CUDA tensors (staged through the host)
_GLOO_HOST_ONLY = frozenset({"ppermute", "all_gather_functional"})

#: calls staged through pinned host memory, by collective
STAGED: Counter = Counter()


def _mesh(mesh):
    if mesh is None:
        from hetu_tpu_torch.parallel.mesh import current_mesh
        return current_mesh()
    return mesh


def _axes(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_group(axis, mesh=None):
    """The process group of mesh axis ``axis`` (a name or a tuple of names
    in the mesh's order) that holds this rank; a process group is its own
    group."""
    if isinstance(axis, dist.ProcessGroup):
        return axis
    mesh = _mesh(mesh)
    axes = _axes(axis)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    names = mesh.mesh_dim_names
    if list(axes) != sorted(axes, key=names.index):
        raise ValueError(f"axes {axes} must follow the mesh's order {names}")
    return mesh[axes]._flatten("_".join(axes)).get_group()


def axis_size(axis, mesh=None) -> int:
    if isinstance(axis, dist.ProcessGroup):
        return dist.get_world_size(axis)
    mesh = _mesh(mesh)
    n = 1
    for a in _axes(axis):
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def _staged(name: str, x: torch.Tensor, group) -> bool:
    return (x.is_cuda and name in _GLOO_HOST_ONLY
            and dist.get_backend(group) == "gloo")


def _host(x):
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return h.copy_(x)


# ---- the collectives on plain tensors (no autograd) ----

def _all_reduce(x, group):
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y


def _all_gather(x, group, dim):
    n = dist.get_world_size(group)
    x0 = x.movedim(dim, 0).contiguous()
    out = x0.new_empty((n * x0.shape[0],) + tuple(x0.shape[1:]))
    dist.all_gather_into_tensor(out, x0, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x, group, dim):
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of size {x.shape[dim]} "
                         f"does not split over {n} ranks")
    x0 = x.movedim(dim, 0).contiguous()
    out = x0.new_empty((x0.shape[0] // n,) + tuple(x0.shape[1:]))
    dist.reduce_scatter_tensor(out, x0, group=group)
    return out.movedim(0, dim)


def _all_to_all(x, group, split_dim, concat_dim):
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of size "
                         f"{x.shape[split_dim]} does not split over {n} "
                         f"ranks")
    send = torch.stack(x.chunk(n, split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


def _ppermute(x, group, shift):
    if _staged("ppermute", x, group):
        STAGED["ppermute"] += 1
        return _ppermute(_host(x), group, shift).to(x.device)
    n = dist.get_world_size(group)
    me = dist.get_group_rank(group, dist.get_rank())
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    x = x.contiguous()
    y = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dst, group),
           dist.P2POp(dist.irecv, y, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return y


def stage_gloo_all_gather() -> None:
    """Route the functional all-gather (DTensor's Shard -> Replicate)
    through pinned host memory where its group runs ``gloo`` and its
    tensor lies on the card, counted in ``STAGED["all_gather_functional"]``;
    every other call, and every call under ``nccl``, goes through
    unchanged.  Idempotent; :func:`~hetu_tpu_torch.parallel.mesh.make_mesh`
    installs it for a ``gloo`` mesh on ``cuda``."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.distributed_c10d import _resolve_process_group

    for name in ("all_gather_tensor", "all_gather_single"):
        orig = getattr(funcol, name, None)
        if orig is None or getattr(orig, "_hetu_staged", False):
            continue

        def staged(self, gather_dim, group, tag="", _orig=orig):
            pg = _resolve_process_group(funcol._resolve_group_name(group))
            if not _staged("all_gather_functional", self, pg):
                return _orig(self, gather_dim, group, tag)
            STAGED["all_gather_functional"] += 1
            return _all_gather(_host(self), pg, gather_dim).to(self.device)
        staged._hetu_staged = True
        setattr(funcol, name, staged)


# ---- autograd: each backward is the transpose of its forward ----

class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return _all_to_all(g, group, concat_dim, split_dim), None, None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _ppermute(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.group, -ctx.shift), None, None


class _ShardMapInput(torch.autograd.Function):
    """A value every rank of ``group`` holds whole, entering per-rank
    code: the identity forward, a ``psum`` of the ranks' cotangents
    backward (the transpose of a broadcast)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ShardMapOutput(torch.autograd.Function):
    """A value every one of ``n`` ranks computes whole, leaving per-rank
    code: the identity forward, the cotangent divided by ``n`` backward."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


# ---- the reference's API ----

def psum(x, axis, *, mesh=None):
    """AllReduce(sum) over a mesh axis."""
    return _Psum.apply(x, axis_group(axis, mesh))


def pmean(x, axis, *, mesh=None):
    """AllReduce(mean) over a mesh axis (the sum divided by the axis
    size, as ``lax.pmean``)."""
    return psum(x, axis, mesh=mesh) / axis_size(axis, mesh)


def all_gather(x, axis, *, tiled_dim: int = 0, mesh=None):
    """AllGather along a mesh axis, concatenating on ``tiled_dim``."""
    return _AllGather.apply(x, axis_group(axis, mesh), tiled_dim)


def reduce_scatter(x, axis, *, scatter_dim: int = 0, mesh=None):
    """ReduceScatter(sum) along a mesh axis: rank ``i`` of the axis keeps
    the ``i``-th piece of ``scatter_dim`` of the sum."""
    return _ReduceScatter.apply(x, axis_group(axis, mesh), scatter_dim)


def all_to_all(x, axis, *, split_dim: int = 0, concat_dim: int = 0,
               mesh=None):
    """AllToAll: split ``split_dim`` over the axis (piece ``j`` to rank
    ``j``), concatenate the received pieces on ``concat_dim`` in source
    order (``lax.all_to_all(..., tiled=True)``)."""
    return _AllToAll.apply(x, axis_group(axis, mesh), split_dim, concat_dim)


def hierarchical_all_to_all(x, outer_axis: str, inner_axis: str, *,
                            split_dim: int = 0, concat_dim: int = 0,
                            mesh=None):
    """Two-level AllToAll: within ``inner_axis``, then across
    ``outer_axis``.  Delivers in the order of a flat :func:`all_to_all`
    over the composite ``(outer, inner)`` axis: the send pieces (outer-
    major destinations) are first permuted to inner-major, as the
    reference does."""
    n_o = axis_size(outer_axis, mesh)
    n_i = axis_size(inner_axis, mesh)
    L = x.shape[split_dim]
    if L % (n_o * n_i):
        raise ValueError(f"dim {split_dim} of size {L} does not split over "
                         f"{n_o} x {n_i} ranks")
    rest = L // (n_o * n_i)
    pre, post = x.shape[:split_dim], x.shape[split_dim + 1:]
    xr = x.reshape(*pre, n_o, n_i, rest, *post).transpose(split_dim,
                                                          split_dim + 1)
    x = xr.reshape(*pre, L, *post)
    y = all_to_all(x, inner_axis, split_dim=split_dim,
                   concat_dim=concat_dim, mesh=mesh)
    return all_to_all(y, outer_axis, split_dim=split_dim,
                      concat_dim=concat_dim, mesh=mesh)


def quantized_psum(x, axis, *, wire: str = "int8", block: int = 256,
                   mesh=None):
    """Block-scaled quantized AllReduce(sum) (the reference's EQuARX
    scheme): flatten, blocks of ``block`` elements, symmetric int8 with
    one f32 scale a block (:func:`~hetu_tpu_torch.quantwire.block_encode`,
    bitwise the reference's codes and scales), an all-gather of codes and
    scales, then dequantize and sum in f32.  ``wire="bf16"`` gathers bf16
    values and sums them in f32; ``"f32"``/``"exact"``/``None`` is
    :func:`psum`.  Per replica the error is at most half a quantum,
    ``max|block| / 254`` an element."""
    if wire in (None, "f32", "exact"):
        return psum(x, axis, mesh=mesh)
    if wire not in ("bf16", "int8"):
        raise ValueError(f"unknown wire dtype {wire!r}; expected "
                         f"'f32'/'bf16'/'int8'")
    group = axis_group(axis, mesh)
    if wire == "bf16":
        g = _AllGather.apply(x.to(torch.bfloat16)[None], group, 0)
        return g.float().sum(0).to(x.dtype)
    from hetu_tpu_torch.quantwire import block_encode
    q, scale = block_encode(x, block)
    qg = _all_gather(q[None], group, 0)             # [n, nblk, block] int8
    sg = _AllGather.apply(scale[None], group, 0)    # [n, nblk, 1] f32
    out = (qg.float() * sg).sum(0)
    return out.reshape(-1)[:x.numel()].reshape(x.shape).to(x.dtype)


def quantized_pmean(x, axis, *, wire: str = "int8", block: int = 256,
                    mesh=None):
    """AllReduce(mean) counterpart of :func:`quantized_psum`."""
    if wire in (None, "f32", "exact"):
        return pmean(x, axis, mesh=mesh)
    return quantized_psum(x, axis, wire=wire, block=block, mesh=mesh) / \
        axis_size(axis, mesh)


def ppermute_shift(x, axis, shift: int = 1, *, mesh=None):
    """Ring shift over a mesh axis: rank ``i`` sends to ``i + shift``."""
    return _Ppermute.apply(x, axis_group(axis, mesh), int(shift))


def shard_map_input(x, axis, *, mesh=None):
    """``x``, held whole by every rank of ``axis``, as per-rank code takes
    it: ``shard_map``'s boundary for an input its spec does not split over
    ``axis``.  Forward the identity; backward the sum of the ranks'
    cotangents, so a value every rank uses gets the gradient of all its
    uses."""
    if axis_size(axis, mesh) == 1:
        return x
    return _ShardMapInput.apply(x, axis_group(axis, mesh))


def shard_map_output(x, axis, *, mesh=None):
    """``x``, which every rank of ``axis`` computes whole, as a value of
    the global program: ``shard_map``'s boundary for an output its spec
    does not split over ``axis`` (``check_vma=False``).  Forward the
    identity; backward the cotangent divided by the axis size, so a loss
    every rank computes counts once, and not once a rank, under the
    collectives' transposed gradients."""
    n = axis_size(axis, mesh)
    if n == 1:
        return x
    return _ShardMapOutput.apply(x, n)


def grouped_allreduce(mesh, axis, fn=None):
    """An allreduce over one mesh axis (the reference's per-parameter
    grouped communicators): ``f(x) -> psum(x, axis)``."""
    def _ar(x):
        return psum(x, axis, mesh=mesh)
    return _ar
