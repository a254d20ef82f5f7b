"""Sharding specs (counterpart of ``hetu_tpu/parallel/spec.py``): the
reference's ``ShardSpec`` algebra (its ``NodeStatus``) over DTensor
placements.

A spec names, per tensor dimension, the mesh axes it is split over
(``None``: whole), plus the axes over which the value is a pending partial
sum.  On a ``DeviceMesh`` that is one placement per mesh dimension: the
dimension an axis splits becomes ``Shard(d)`` on that axis, an axis the
spec does not name ``Replicate()``, a partial axis ``Partial()``.  The
pattern checks are the reference's; :func:`predict_collective` names the
collective a ``src -> dst`` redistribution needs, and DTensor's
``redistribute`` issues exactly that one (``tests/test_torch_parallel_spec.py``
counts them under ``CommDebugMode``).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Optional, Tuple, Union

AxisName = str
DimSpec = Union[None, AxisName, Tuple[AxisName, ...]]


class P(tuple):
    """A partition spec, one entry a tensor dimension (``None``, an axis
    name, or a tuple of axis names, the first major): the reference's
    ``PartitionSpec``.  Trailing dimensions left out are whole."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self):
        return f"P{tuple(self)!r}"


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh, dims, partial: tuple = ()) -> list:
    """The DTensor placements, on ``mesh``'s
    :func:`~hetu_tpu_torch.parallel.mesh.active_mesh` (its axes of size >
    1), of per-dimension mesh axes ``dims`` and pending-sum axes
    ``partial``; an axis of size 1 splits nothing.  A dimension split over
    several axes must list them in the mesh's order."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from hetu_tpu_torch.parallel.mesh import active_mesh
    full = list(mesh.mesh_dim_names)
    names = list(active_mesh(mesh).mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(dims):
        axes = _entry_axes(entry)
        if list(axes) != sorted(axes, key=full.index):
            raise ValueError(f"dim {d} splits over {axes}: list them in the "
                             f"mesh's order {tuple(full)}")
        for a in axes:
            if a in names:
                out[names.index(a)] = Shard(d)
    for a in partial:
        if a in names:
            out[names.index(a)] = Partial()
    return out


@dataclass(frozen=True)
class ShardSpec:
    """Sharding of one array: per-dim mesh axes + partial-sum axes."""

    dims: Tuple[DimSpec, ...]
    partial: Tuple[AxisName, ...] = ()

    # ---- constructors ----
    @staticmethod
    def replicated(ndim: int) -> "ShardSpec":
        return ShardSpec(dims=(None,) * ndim)

    @staticmethod
    def split(ndim: int, dim: int, axis: AxisName) -> "ShardSpec":
        dims = [None] * ndim
        dims[dim] = axis
        return ShardSpec(dims=tuple(dims))

    # ---- conversions ----
    def pspec(self) -> P:
        return P(*self.dims)

    def placements(self, mesh) -> list:
        """DTensor placements on ``mesh``, the partial axes as
        ``Partial()``."""
        return placements(mesh, self.dims, self.partial)

    def named(self, mesh) -> list:
        """The placements of a materialised value; a partial spec has none
        (reduce it first), as in the reference."""
        if self.partial:
            raise ValueError(
                "partial spec has no NamedSharding; reduce it first "
                "(reference analog: partial→allreduce in cross_receive)")
        return self.placements(mesh)

    # ---- the NodeStatus pattern checks ----
    def check_allreduce(self, tgt: "ShardSpec") -> Optional[Tuple[AxisName, ...]]:
        """partial here, replicated there → psum over partial axes."""
        if self.partial and tgt.partial == () and tgt.dims == self.dims:
            return self.partial
        return None

    def check_reducescatter(self, tgt: "ShardSpec") -> Optional[Tuple[AxisName, int]]:
        """partial here, extra split there on some dim → reduce_scatter."""
        if not self.partial or tgt.partial:
            return None
        diff = [(i, a) for i, (a, b) in enumerate(zip(self.dims, tgt.dims))
                if a != b]
        if len(diff) == 1:
            i, _ = diff[0]
            if self.dims[i] is None and tgt.dims[i] in self.partial:
                return (tgt.dims[i], i)
        return None

    def check_allgather(self, tgt: "ShardSpec") -> Optional[Tuple[AxisName, int]]:
        """split here, replicated there on some dim → all_gather."""
        if self.partial or tgt.partial:
            return None
        diff = [(i, a, b) for i, (a, b) in enumerate(zip(self.dims, tgt.dims))
                if a != b]
        if len(diff) == 1:
            i, a, b = diff[0]
            if a is not None and b is None:
                return (a, i)
        return None

    def check_alltoall(self, tgt: "ShardSpec") -> Optional[Tuple[AxisName, int, int]]:
        """Split-dim migration — the SAME axis leaves dim i and lands on dim
        j (``('tp', None)`` → ``(None, 'tp')``) → all_to_all; returns
        ``(axis, src_dim, dst_dim)``."""
        if self.partial or tgt.partial:
            return None
        diff = [(i, a, b) for i, (a, b) in enumerate(zip(self.dims, tgt.dims))
                if a != b]
        if len(diff) != 2:
            return None
        (i, a, b), (j, c, d) = diff
        if a is not None and b is None and c is None and d is not None \
                and a == d:
            return (a, i, j)   # axis migrates dim i → dim j
        if a is None and b is not None and c is not None and d is None \
                and b == c:
            return (b, j, i)   # axis migrates dim j → dim i
        return None

    def reduce_partial(self, x, mesh=None):
        """Apply the pending psum over the partial axes (per rank, with
        :func:`~hetu_tpu_torch.parallel.collectives.psum`)."""
        from hetu_tpu_torch.parallel.collectives import psum
        y = x
        for ax in self.partial:
            y = psum(y, ax, mesh=mesh)
        return y


# Name-parity alias: the reference calls this NodeStatus.
NodeStatus = ShardSpec


def predict_collective(src: ShardSpec, dst: ShardSpec):
    """Which collective a src→dst transition needs, by the pattern checks:
    ``(kind, detail)`` with kind in {'all-reduce', 'reduce-scatter',
    'all-gather', 'all-to-all'}, or ``None`` when the transition is local
    (a slice or nothing)."""
    ar = src.check_allreduce(dst)
    if ar is not None:
        return ("all-reduce", ar)
    rs = src.check_reducescatter(dst)
    if rs is not None:
        return ("reduce-scatter", rs)
    ag = src.check_allgather(dst)
    if ag is not None:
        return ("all-gather", ag)
    a2a = src.check_alltoall(dst)
    if a2a is not None:
        return ("all-to-all", a2a)
    return None


def constrain(x, mesh, spec: ShardSpec):
    """``x`` laid out as ``spec`` on ``mesh`` (the reference's
    ``with_sharding_constraint``): a DTensor is redistributed; a plain
    tensor, which every rank holds whole, is cut to this rank's piece
    with no communication."""
    from torch.distributed.tensor import DTensor

    from hetu_tpu_torch.parallel.mesh import active_mesh, host_to_device
    target = spec.named(mesh)
    if isinstance(x, DTensor):
        return x.redistribute(active_mesh(mesh), target)
    return host_to_device(x, mesh, target)


# ---- placement helpers of the layers (identity on plain tensors) ----

def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor's module when
    no DTensor can exist yet)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def gather_dim(x, dim: int):
    """``x`` with dimension ``dim`` whole on every rank (an all-gather
    over the mesh axes that split it); a plain tensor as it is.  The
    layers call it where the reference lets XLA reshard: MegatronLM's
    fused QKV output is split over tp at a point that is not a head
    boundary, so it is gathered before the head split."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dim %= x.ndim
    pl = [Replicate() if p.is_shard(dim) else p for p in x.placements]
    return x.redistribute(x.device_mesh, pl) if pl != list(x.placements) \
        else x


def shard_heads(x, dim: int, axis: str = "tp"):
    """``x`` split over mesh axis ``axis`` on its head dimension ``dim``
    when the heads divide the axis (each rank keeps its own heads; no
    communication, once a pending partial sum is reduced), else as it is;
    a plain tensor as it is."""
    if not is_dtensor(x) or axis not in x.device_mesh.mesh_dim_names:
        return x
    from torch.distributed.tensor import Shard
    x = unpartial(x)
    i = x.device_mesh.mesh_dim_names.index(axis)
    n = x.device_mesh.size(i)
    if n == 1 or x.shape[dim] % n or not x.placements[i].is_replicate():
        return x
    pl = list(x.placements)
    pl[i] = Shard(dim % x.ndim)
    return x.redistribute(x.device_mesh, pl)


def unpartial(x):
    """``x`` with its pending partial sums reduced (an all-reduce over
    those axes); anything else as it is."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def local_call(fn, out_placements_of, *args, in_grad_placements=None,
               **kwargs):
    """``fn(*args, **kwargs)`` on the local pieces of its DTensor
    arguments, through ``torch.distributed.tensor.experimental.local_map``
    with each argument's own placements declared as its in-placements;
    the outputs are DTensors of ``out_placements_of(*dtensor_args)`` (a
    list of placements for a single output; for several, a tuple with one
    such list, or ``None`` for a non-tensor, an output).  A pending partial sum among the arguments is reduced first;
    ``in_grad_placements`` (one entry an argument) declares the placements
    of the arguments' gradients where they are not the arguments' own.
    With no DTensor argument it is the plain call.  This is how
    a hand-written kernel (an ``autograd.Function`` that takes plain
    tensors) runs on sharded operands: on each rank's local tensors,
    never replaced by another version."""
    dts = [a for a in args if is_dtensor(a)]
    if not dts:
        return fn(*args, **kwargs)
    from torch.distributed.tensor.experimental import local_map
    args = tuple(unpartial(a) for a in args)
    dts = [a for a in args if is_dtensor(a)]
    mesh = dts[0].device_mesh
    in_pl = tuple(tuple(a.placements) if is_dtensor(a) else None
                  for a in args)
    out_pl = out_placements_of(*dts)
    return local_map(lambda *a: fn(*a, **kwargs), out_placements=out_pl,
                     in_placements=in_pl,
                     in_grad_placements=in_grad_placements,
                     device_mesh=mesh, redistribute_inputs=False)(*args)


def heads_for_cache(x, dim: int, local_heads: int):
    """``x`` laid out for a KV cache holding ``local_heads`` heads on this
    rank: split over tp on ``dim`` when the cache holds this rank's share
    of the heads, whole when it holds them all (the replicated cache of a
    tp the kv heads do not divide)."""
    if not is_dtensor(x):
        return x
    if local_heads == x.shape[dim]:
        return gather_dim(x, dim)
    return shard_heads(x, dim)


def moved_heads(src: int, dst: int):
    """An ``out_placements_of`` for :func:`local_call`: the first
    argument's placements with a split of dim ``src`` moved to ``dst``
    (attention's ``[B, S, nh, hd]`` in, ``[B, nh, S, hd]`` out)."""
    def of(first, *_):
        from torch.distributed.tensor import Shard
        return [Shard(dst) if p.is_shard(src) else p
                for p in first.placements]
    return of


def mesh_context(mesh):
    """Under a mesh, the plain tensors a step makes (masks, tables,
    positions) count as replicated on it (DTensor's
    ``implicit_replication``); without one, nothing."""
    import contextlib
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()
