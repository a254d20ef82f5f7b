"""The parallel plane (counterpart of ``hetu_tpu/parallel``): the mesh,
its collectives, the sharding specs and the strategies, over
``torch.distributed`` rank processes (:mod:`.ranks`) and DTensor; ring and
Ulysses sequence parallelism on the flash kernels, the GPipe and 1F1B
pipelines, HetPipe's PS-synced virtual workers, the partial-reduce
data-parallel step, and the MPMD pipeline plane over separate processes
(:mod:`.mpmd`, :mod:`.mpmd_elastic`).  The planner module comes in a
later slice.

Every name loads its module on first use: the MPMD pipeline's stage
processes import :mod:`.mpmd` and must not pay for ``torch`` (the mesh
imports ``torch.distributed``)."""

_LAZY = {**{name: "mesh" for name in (
    "AXIS_DP", "AXIS_EP", "AXIS_PP", "AXIS_SP", "AXIS_TP",
    "DEFAULT_AXIS_ORDER", "MeshConfig", "batch_sharding", "elastic_mesh",
    "host_to_device", "local_mesh", "make_mesh", "replicated")},
    "NodeStatus": "spec", "P": "spec", "ShardSpec": "spec",
    "GPipe": "pipeline", "pipedream_schedule": "pipeline",
    "stack_stage_params": "pipeline", "ring_attention": "ring_attention",
    "ring_attention_plain": "ring_attention",
    "ulysses_attention": "ulysses", "preduce_step_fn": "preduce",
    "PipeDream1F1B": "pipedream", "HetPipeWorker": "hetpipe",
    "make_weight_table": "hetpipe", "MPMDStageRunner": "mpmd",
    "VanMailbox": "mpmd", "round_robin_assignments": "mpmd",
    "schedule_ops": "mpmd", "MPMDPipelineSupervisor": "mpmd_elastic"}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(
        f"hetu_tpu_torch.parallel.{_LAZY[name]}"), name)


__all__ = sorted(_LAZY)
