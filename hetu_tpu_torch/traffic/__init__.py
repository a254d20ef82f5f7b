"""Traffic plane (counterpart of ``hetu_tpu/traffic``): trace-driven load
generation + measured-load autoscaling over the serving pools.

Three cooperating parts:

* :mod:`loadgen`   — seeded open-loop workload synthesis (diurnal rate
  curves, bursty multi-tenant arrivals, Zipfian prompt/key popularity,
  per-tenant deadlines) with a byte-stable JSON trace format (the same
  spec gives the reference's bytes), and replay adapters for the LLM
  (:class:`~hetu_tpu_torch.serve.crosshost.CrossProcessServingPool`) and
  CTR (``RecsysPool``, not ported yet) pools;
* :mod:`autoscale` — a control loop on the controller that reads
  MEASURED load from ``fleet_metrics()`` (queue depth, shed rate,
  windowed per-tenant TTFT p99 vs SLO, or a health monitor's burn-rate
  alerts) and scales the member fleet: scale-up revives a parked slot
  through the spawn harness, scale-down hands the victim's live KV to a
  peer via the zero-re-prefill ``drain_member`` — with hysteresis,
  cooldowns, min/max bounds, and its state journaled in the pool's
  ledger so a controller takeover resumes it warm;
* per-tenant SLO classes live in ``serve/scheduler.py`` (priority
  admission + weighted fair queueing) and ride the submit wire through
  ``serve/crosshost.py`` — the traffic plane only names them.
"""

from hetu_tpu_torch.traffic.autoscale import Autoscaler, AutoscalePolicy
from hetu_tpu_torch.traffic.loadgen import (
    TenantSpec, TraceSpec, ctr_submitter, diurnal_multiplier, dumps_trace,
    llm_submitter, load_trace, replay, save_trace, synthesize,
)

__all__ = [
    "Autoscaler", "AutoscalePolicy", "TenantSpec", "TraceSpec",
    "ctr_submitter", "diurnal_multiplier", "dumps_trace", "llm_submitter",
    "load_trace", "replay", "save_trace", "synthesize",
]
