"""The parallel plane (counterpart of ``hetu_tpu/parallel``): the mesh,
its collectives, the sharding specs and the strategies, over
``torch.distributed`` rank processes (:mod:`.ranks`) and DTensor; ring and
Ulysses sequence parallelism on the flash kernels, the GPipe and 1F1B
pipelines, HetPipe's PS-synced virtual workers and the partial-reduce
data-parallel step.  The MPMD and planner modules come in later
slices."""

from hetu_tpu_torch.parallel.mesh import (
    AXIS_DP, AXIS_EP, AXIS_PP, AXIS_SP, AXIS_TP, DEFAULT_AXIS_ORDER,
    MeshConfig, batch_sharding, elastic_mesh, host_to_device, local_mesh,
    make_mesh, replicated,
)
from hetu_tpu_torch.parallel.spec import NodeStatus, P, ShardSpec

# the sequence and pipeline modules import the kernels' wrappers, which
# import the ops that import parallel.spec: loaded on first use
_LAZY = {"GPipe": "pipeline", "pipedream_schedule": "pipeline",
         "stack_stage_params": "pipeline", "ring_attention": "ring_attention",
         "ring_attention_plain": "ring_attention",
         "ulysses_attention": "ulysses", "preduce_step_fn": "preduce",
         "PipeDream1F1B": "pipedream", "HetPipeWorker": "hetpipe",
         "make_weight_table": "hetpipe"}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(
        f"hetu_tpu_torch.parallel.{_LAZY[name]}"), name)

__all__ = ["AXIS_DP", "AXIS_EP", "AXIS_PP", "AXIS_SP", "AXIS_TP",
           "DEFAULT_AXIS_ORDER", "MeshConfig", "batch_sharding",
           "elastic_mesh", "host_to_device", "local_mesh", "make_mesh",
           "replicated", "NodeStatus", "P", "ShardSpec", "GPipe",
           "pipedream_schedule", "stack_stage_params", "ring_attention",
           "ring_attention_plain", "ulysses_attention", "preduce_step_fn",
           "PipeDream1F1B", "HetPipeWorker", "make_weight_table"]
