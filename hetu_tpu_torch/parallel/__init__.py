"""Data- and tensor-parallel plane (counterpart of ``hetu_tpu/parallel``):
the mesh, its collectives, the sharding specs and the strategies, over
``torch.distributed`` rank processes (:mod:`.ranks`) and DTensor.  The
pipeline, ring/Ulysses attention, MPMD and planner modules come in later
slices."""

from hetu_tpu_torch.parallel.mesh import (
    AXIS_DP, AXIS_EP, AXIS_PP, AXIS_SP, AXIS_TP, DEFAULT_AXIS_ORDER,
    MeshConfig, batch_sharding, elastic_mesh, host_to_device, local_mesh,
    make_mesh, replicated,
)
from hetu_tpu_torch.parallel.spec import NodeStatus, P, ShardSpec

__all__ = ["AXIS_DP", "AXIS_EP", "AXIS_PP", "AXIS_SP", "AXIS_TP",
           "DEFAULT_AXIS_ORDER", "MeshConfig", "batch_sharding",
           "elastic_mesh", "host_to_device", "local_mesh", "make_mesh",
           "replicated", "NodeStatus", "P", "ShardSpec"]
