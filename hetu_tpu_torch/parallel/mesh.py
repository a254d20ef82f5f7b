"""Device mesh construction (counterpart of ``hetu_tpu/parallel/mesh.py``).

The reference is one process that drives a ``jax.sharding.Mesh`` of
devices; here every rank is a process of its own in a
``torch.distributed`` group (started by :mod:`hetu_tpu_torch.parallel.ranks`
or any launcher), and :func:`make_mesh` lays the group out as a
``DeviceMesh`` with the reference's axis names in the reference's order
(``pp, dp, sp, ep, tp``: ``tp`` innermost, so a tensor-parallel group is
ranks next to each other).  Axes of size 1 are kept, so a placement can
always name every axis.

The backend is the caller's: ``nccl`` on ``cuda`` by default, ``gloo`` on
``cpu``.  NCCL refuses two ranks on one GPU, so a ``cuda`` mesh with more
ranks than cards raises and names ``backend="gloo"`` as the explicit
choice; the backend is never swapped behind the caller's back.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch
import torch.distributed as dist

AXIS_DP = "dp"  # data parallel
AXIS_TP = "tp"  # tensor/model parallel
AXIS_PP = "pp"  # pipeline stages
AXIS_EP = "ep"  # expert parallel
AXIS_SP = "sp"  # sequence/context parallel

# outermost-to-innermost default ordering (innermost = nearest ranks)
DEFAULT_AXIS_ORDER = (AXIS_PP, AXIS_DP, AXIS_SP, AXIS_EP, AXIS_TP)

_DEFAULT_BACKEND = {"cuda": "nccl", "cpu": "gloo"}

_CURRENT = []  # the last mesh make_mesh built in this process


def current_mesh():
    """The mesh :func:`make_mesh` built last in this process (the one the
    collectives act on when they are given none)."""
    if not _CURRENT:
        raise RuntimeError("no mesh: call make_mesh first")
    return _CURRENT[-1]


@dataclass
class MeshConfig:
    """Named-axis sizes; unspecified axes default to 1 (the reference's
    ``MeshConfig``: ``MeshConfig(dp=2, tp=2)`` is 2-way DP of 2-way MP)."""

    dp: int = 1
    tp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    axis_order: Sequence[str] = field(default=DEFAULT_AXIS_ORDER)

    def sizes(self):
        return {AXIS_DP: self.dp, AXIS_TP: self.tp, AXIS_PP: self.pp,
                AXIS_EP: self.ep, AXIS_SP: self.sp}

    @property
    def num_devices(self) -> int:
        return self.dp * self.tp * self.pp * self.ep * self.sp


def _ensure_group(n: int, device: str, backend: str) -> None:
    """Join or check the default process group: a world of one is made
    here (an in-process store), a larger one must exist already."""
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                f"mesh needs {n} ranks and no process group is "
                f"initialised: run each rank under "
                f"hetu_tpu_torch.parallel.ranks.run (or "
                f"torch.distributed.init_process_group) first")
        kw = {"device_id": torch.device("cuda", torch.cuda.current_device())} \
            if backend == "nccl" else {}
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
        return
    have = dist.get_backend()
    if have != backend:
        raise ValueError(
            f"the process group runs {have!r}, the mesh asks for "
            f"{backend!r}; pass backend={have!r} to use it")
    if dist.get_world_size() != n:
        raise ValueError(f"mesh needs {n} ranks, the process group has "
                         f"{dist.get_world_size()}")


def make_mesh(config: Optional[MeshConfig] = None, *, device: str = "cuda",
              backend: Optional[str] = None, **axis_sizes):
    """A ``DeviceMesh`` over this process group from a :class:`MeshConfig`
    or axis sizes (``make_mesh(dp=2, tp=4)``), in the config's axis order.

    ``device`` is ``"cuda"`` (default) or ``"cpu"``; ``backend`` defaults
    to ``nccl`` on ``cuda`` and ``gloo`` on ``cpu``.  Raises when the
    world does not hold ``config.num_devices`` ranks, and when ``nccl``
    would put two ranks on one GPU.  A cuda rank takes card ``rank %
    device_count``."""
    from torch.distributed.device_mesh import init_device_mesh

    if config is None:
        config = MeshConfig(**axis_sizes)
    elif axis_sizes:
        raise TypeError("pass a MeshConfig or axis sizes, not both")
    if device not in _DEFAULT_BACKEND:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    backend = backend or _DEFAULT_BACKEND[device]
    n = config.num_devices
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device='cuda') needs CUDA; pass "
                               "device='cpu' for a CPU mesh")
        cards = torch.cuda.device_count()
        if backend == "nccl" and n > cards:
            raise ValueError(
                f"nccl cannot run {n} ranks on {cards} GPU(s): two ranks "
                f"would share a GPU; pass backend='gloo' to run them over "
                f"gloo on the shared card")
        rank = dist.get_rank() if dist.is_initialized() else 0
        torch.cuda.set_device(rank % cards)
        if backend == "gloo":
            from hetu_tpu_torch.parallel.collectives import (
                stage_gloo_all_gather,
            )
            stage_gloo_all_gather()
    elif backend == "nccl":
        raise ValueError("nccl needs device='cuda'")
    _ensure_group(n, device, backend)
    order = tuple(config.axis_order)
    sizes = config.sizes()
    mesh = init_device_mesh(device, tuple(sizes[a] for a in order),
                            mesh_dim_names=order)
    _CURRENT[:] = [mesh]
    return mesh


def active_mesh(mesh):
    """The sub-mesh of ``mesh``'s axes of size > 1 (``dp`` alone when
    every axis is 1): where DTensors live.  A placement on an axis of size
    1 changes nothing, and DTensor's sharding propagation enumerates the
    placements of every mesh dimension, so the kept size-1 axes are left
    out of the tensors' own mesh."""
    names = mesh.mesh_dim_names
    keep = tuple(n for n, k in zip(names, mesh.shape) if k > 1)
    if keep == tuple(names):
        return mesh
    if not keep:
        keep = (AXIS_DP,) if AXIS_DP in names else names[:1]
    return mesh[keep if len(keep) > 1 else keep[0]]


def elastic_mesh(config: MeshConfig, alive: Sequence[int], *,
                 device: str = "cuda", backend: Optional[str] = None):
    """The mesh of the ``alive`` data-parallel workers of ``config``'s
    nominal layout (sorted indices, each < ``config.dp``): a worker keeps
    its own ranks (one contiguous group of ``tp*pp*ep*sp`` of them) across
    resizes.  Every rank of the nominal world calls it; only the
    survivors' ranks form the returned mesh (``None`` on the others)."""
    from torch.distributed.device_mesh import DeviceMesh

    alive = sorted(int(i) for i in alive)
    if not alive:
        raise ValueError("elastic mesh needs at least one alive worker")
    if alive[0] < 0 or alive[-1] >= config.dp:
        raise ValueError(
            f"alive indices {alive} out of range for nominal dp={config.dp}")
    if len(set(alive)) != len(alive):
        raise ValueError(f"duplicate alive indices {alive}")
    nominal = make_mesh(config, device=device, backend=backend)
    dp_dim = nominal.mesh_dim_names.index(AXIS_DP)
    ranks = nominal.mesh.index_select(dp_dim, torch.tensor(alive))
    # every rank builds it (its groups are made collectively)
    mesh = DeviceMesh(nominal.device_type, ranks,
                      mesh_dim_names=nominal.mesh_dim_names)
    return mesh if dist.get_rank() in ranks.flatten().tolist() else None


def local_mesh(axis: str = AXIS_DP, *, device: str = "cuda",
               backend: Optional[str] = None):
    """Every rank of the group on one axis (the default DP mesh)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(MeshConfig(**{axis: n}), device=device, backend=backend)


def replicated(mesh) -> list:
    """The placements (on :func:`active_mesh`) of a value every rank holds
    whole."""
    from torch.distributed.tensor import Replicate
    return [Replicate()] * active_mesh(mesh).ndim


def batch_sharding(mesh, axis: str = AXIS_DP) -> list:
    """The placements (on :func:`active_mesh`) of a batch split on dim 0
    over ``axis``."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(0) if name == axis else Replicate()
            for name in active_mesh(mesh).mesh_dim_names]


def host_to_device(arr, mesh, placements):
    """A whole value every rank holds (a numpy array or a tensor) placed on
    ``mesh`` (its :func:`active_mesh`): each rank keeps its own piece,
    with no communication (the reference's ``host_to_device``; the
    counterpart of its CPU adoption guard is the copy ``torch.as_tensor``
    of a numpy array makes)."""
    from torch.distributed.tensor import distribute_tensor
    mesh = active_mesh(mesh)
    t = torch.as_tensor(arr)
    if mesh.device_type == "cuda":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    return distribute_tensor(t, mesh, placements, src_data_rank=None)
