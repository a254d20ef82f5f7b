"""Shared straggler detection (counterpart of
``hetu_tpu/resilience/straggler.py``): the slow-versus-dead split the
lease machine cannot make.

A straggler's beats flow while its reported work time grows: the lease
state machine never fires, yet lockstep barriers pace the whole fleet at
its speed.  The cross-process training planes (the data-parallel
multi-controller fleet and the MPMD pipeline) detect it the same way: a
member whose reported work time exceeds ``factor`` x the median of its
peers' opens a retroactive ``train.straggler`` span, closed when it
recovers, departs, or the policy acts.  This module is the one copy of
that episode machinery; the policy (wait, evict and reshard, probation
re-admission) stays with each supervisor, since a pipeline stage is not
redundant and only the data-parallel plane can evict.
"""

from __future__ import annotations

import time

import numpy as np

from hetu_tpu_torch.telemetry import trace


class StragglerDetector:
    """Median-of-peers slow-member detection with per-episode
    ``train.straggler`` spans.

    ``observe(loads, present=..., committed=...)`` runs one sweep:
    ``loads`` maps candidate slot -> reported work ms (callers exclude
    members whose loads must not count — evicted, suspect);
    ``present`` lists slots still around (an open episode whose slot
    left both closes as ``departed``); ``committed`` (optional) maps
    slot -> committed step for evict-threshold accounting.  Returns the
    slots whose episode crossed ``evict_after`` slow committed steps
    this sweep (empty when ``evict_after`` is 0) — the CALLER decides
    what crossing means.
    """

    def __init__(self, *, factor: float, subject: str = "worker",
                 policy: str = "wait", evict_after: int = 0):
        self.factor = float(factor)
        self.subject = subject
        self.policy = policy
        self.evict_after = int(evict_after)
        self.records: list = []   # closed episodes, span args verbatim
        self._open: dict = {}     # slot -> episode state

    def observe(self, loads: dict, *, present=(),
                committed=None) -> list:
        present = set(present)
        for slot in list(self._open):
            if slot not in loads and slot not in present:
                self.close(slot, resolution="departed")
        if len(loads) < 2:
            return []
        crossed = []
        for slot, work_ms in loads.items():
            others = [v for s, v in loads.items() if s != slot]
            med = float(np.median(others))
            slow = work_ms > self.factor * max(med, 1e-3)
            st = self._open.get(slot)
            c = int(committed.get(slot, 0)) if committed else 0
            if slow and st is None:
                self._open[slot] = {
                    "t0_us": trace.now_us(),
                    "detected_at_step": c,
                    "last_step": c, "slow_steps": 0,
                    "ratio": work_ms / max(med, 1e-3)}
            elif slow and st is not None:
                st["ratio"] = max(st["ratio"], work_ms / max(med, 1e-3))
                if c > st["last_step"]:
                    st["slow_steps"] += c - st["last_step"]
                    st["last_step"] = c
                if self.evict_after and \
                        st["slow_steps"] >= self.evict_after:
                    crossed.append(slot)
            elif not slow and st is not None:
                # back under the bar: the episode closes as tolerated
                self.close(slot, resolution="recovered")
        return crossed

    def close(self, slot, *, resolution: str) -> None:
        st = self._open.pop(slot, None)
        if st is None:
            return
        rec = {self.subject: int(slot), "policy": self.policy,
               "resolution": resolution,
               "ratio": round(float(st["ratio"]), 2),
               "slow_steps": int(st["slow_steps"])}
        trace.complete("train.straggler", st["t0_us"], rec, cat="train")
        self.records.append(rec)

    def close_all(self, *, resolution: str = "run_end") -> None:
        """Flush every still-open episode (run end: an unclosed span
        would silently drop the episode from the trace)."""
        for slot in list(self._open):
            self.close(slot, resolution=resolution)

    def open_slots(self) -> list:
        return list(self._open)


class SupervisorStragglerPlane:
    """Supervisor-side straggler glue, shared by the cross-process
    training planes (the dp multi-controller fleet and the MPMD
    pipeline) so the two copies cannot drift: slow-link INJECTION via
    the control row's ``C_SLOW_*`` fields with a scheduled self-heal,
    and the per-sweep load/committed extraction feeding the shared
    :class:`StragglerDetector`.

    The heal is applied by :meth:`maybe_heal` from the supervisor's
    ``poll()`` — NOT by a timer thread — so every control-row write
    stays serialized with the two-phase epoch publishes (a concurrent
    ``set_slow`` could republish a stale snapshot — e.g. re-expose a
    mid-PREPARE ``phase=1`` row after the supervisor already committed
    ``phase=0`` — and stall the whole fleet on an epoch that will
    never commit).  The POLICY on a crossed threshold stays with each
    supervisor: only the dp plane has a redundant member to evict.
    """

    def __init__(self, svc, *, factor: float, subject: str,
                 policy: str = "wait", evict_after: int = 0,
                 slow_ms: int = 120):
        self.svc = svc
        self.slow_ms = int(slow_ms)
        self.detector = StragglerDetector(
            factor=float(factor), subject=subject, policy=policy,
            evict_after=int(evict_after))
        self._heal_at = None

    def inject(self, slot: int, duration_s: float,
               slow_ms=None) -> None:
        """Apply the slow-link chaos fault: publish the control row's
        slow fields (no epoch bump — a slow link is not a membership
        change) and schedule the heal for the next poll past its due
        time."""
        ms = self.slow_ms if slow_ms is None else int(slow_ms)
        self.svc.set_slow(int(slot), ms)
        self._heal_at = time.monotonic() + float(duration_s)

    def maybe_heal(self) -> None:
        if self._heal_at is not None and \
                time.monotonic() >= self._heal_at:
            self._heal_at = None
            self.svc.set_slow(-1, 0)

    def observe(self, candidate_slots) -> list:
        """One sweep over the supervisors' candidate slots (callers
        pass alive, non-excluded membership): loads are the reported
        WORK-only ms from the heartbeat load field (zero = no evidence,
        excluded), committed feeds the evict-threshold accounting.
        Returns the slots whose episode crossed the evict bar."""
        loads = {s: self.svc.state_of(s).load for s in candidate_slots
                 if self.svc.state_of(s).load > 0.0}
        committed = {s: self.svc.state_of(s).committed
                     for s in candidate_slots}
        return self.detector.observe(loads, present=candidate_slots,
                                     committed=committed)

    @property
    def records(self) -> list:
        return self.detector.records

    def close(self, slot, *, resolution: str) -> None:
        self.detector.close(slot, resolution=resolution)

    def close_all(self, *, resolution: str = "run_end") -> None:
        self.detector.close_all(resolution=resolution)
