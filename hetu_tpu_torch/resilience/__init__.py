"""Fault tolerance (counterpart of ``hetu_tpu/resilience``): the
deterministic chaos harness (seeded, replayable fault schedules and the
injector that drives them against a run: van hooks, data and NaN faults,
process signals, and the serving-pool events that
``serve.ServingPool.run_fault_events`` applies) and the training
supervisor (keep-K checkpoints with CRC fallback, retries, the nonfinite
guard, PS shard repair, cooperative preemption with step-exact resume).

:mod:`~hetu_tpu_torch.resilience.straggler` holds the shared straggler
detection; :mod:`~hetu_tpu_torch.resilience.standby` the self-promoting
standby controller (serving and elastic planes);
:mod:`~hetu_tpu_torch.resilience.shardproc` spawns van, member, worker and
standby processes; :mod:`~hetu_tpu_torch.resilience.multicontroller` is
the multi-controller elastic training plane (worker processes over the
van, membership epochs, the consumed-batch cover) and
:mod:`~hetu_tpu_torch.resilience.memberproc` its member protocol, both
imported on use.  :mod:`~hetu_tpu_torch.resilience.elastic` reshapes the
data-parallel mesh of a supervised run when a worker is lost or
rejoins; its names load on first use.
"""

from hetu_tpu_torch.resilience.faults import (
    KINDS, FaultEvent, FaultInjector, FaultSchedule, SequentialFaultCampaign,
    TransientDataError, TransientFault,
)
from hetu_tpu_torch.resilience.supervisor import (
    CheckpointManager, NonFiniteAbort, PSShardGuard, Supervisor,
    SupervisorReport, default_is_transient,
)

# the elastic supervisor imports the mesh (torch.distributed): on first use
_LAZY = ("ElasticReshardError", "ElasticSupervisor", "MembershipMonitor",
         "ResizeEvent")


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    from hetu_tpu_torch.resilience import elastic
    return getattr(elastic, name)


__all__ = [
    "KINDS", "FaultEvent", "FaultInjector", "FaultSchedule",
    "SequentialFaultCampaign", "TransientDataError", "TransientFault",
    "CheckpointManager", "NonFiniteAbort", "PSShardGuard", "Supervisor",
    "SupervisorReport", "default_is_transient", *_LAZY,
]
