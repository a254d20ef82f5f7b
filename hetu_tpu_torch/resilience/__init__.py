"""Fault tolerance (counterpart of ``hetu_tpu/resilience``): the
deterministic chaos harness (seeded, replayable fault schedules and the
injector that drives them against a run: van hooks, data and NaN faults,
process signals, and the serving-pool events that
``serve.ServingPool.run_fault_events`` applies) and the training
supervisor (keep-K checkpoints with CRC fallback, retries, the nonfinite
guard, PS shard repair, cooperative preemption with step-exact resume).

:mod:`~hetu_tpu_torch.resilience.straggler` holds the shared straggler
detection; :mod:`~hetu_tpu_torch.resilience.standby` the self-promoting
standby controller (serving plane);
:mod:`~hetu_tpu_torch.resilience.shardproc` spawns van, member and standby
processes.  The elastic mesh (``elastic.py``) and the multi-controller
training fleet wait for later slices.
"""

from hetu_tpu_torch.resilience.faults import (
    KINDS, FaultEvent, FaultInjector, FaultSchedule, SequentialFaultCampaign,
    TransientDataError, TransientFault,
)
from hetu_tpu_torch.resilience.supervisor import (
    CheckpointManager, NonFiniteAbort, PSShardGuard, Supervisor,
    SupervisorReport, default_is_transient,
)

__all__ = [
    "KINDS", "FaultEvent", "FaultInjector", "FaultSchedule",
    "SequentialFaultCampaign", "TransientDataError", "TransientFault",
    "CheckpointManager", "NonFiniteAbort", "PSShardGuard", "Supervisor",
    "SupervisorReport", "default_is_transient",
]
