"""Fault tolerance (counterpart of ``hetu_tpu/resilience``): the
deterministic chaos harness — seeded, replayable fault schedules and the
injector that drives them against a run (van hooks, data and NaN faults,
process signals, and the serving-pool events that
``serve.ServingPool.run_fault_events`` applies).

:mod:`~hetu_tpu_torch.resilience.standby` holds the self-promoting standby
controller (serving plane); :mod:`~hetu_tpu_torch.resilience.shardproc`
spawns van, member and standby processes.  The training supervisor and the
elastic mesh (``supervisor.py``, ``elastic.py``) wait for a later slice.
"""

from hetu_tpu_torch.resilience.faults import (
    KINDS, FaultEvent, FaultInjector, FaultSchedule, SequentialFaultCampaign,
    TransientDataError, TransientFault,
)

__all__ = [
    "KINDS", "FaultEvent", "FaultInjector", "FaultSchedule",
    "SequentialFaultCampaign", "TransientDataError", "TransientFault",
]
