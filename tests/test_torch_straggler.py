"""The port's straggler detection (``hetu_tpu_torch.resilience.
straggler``) against hetu_tpu's, on the CPU: ``StragglerDetector`` fed the
same sweeps gives equal ``records``, equal crossed slots a sweep and
equal ``train.straggler`` span arguments; ``SupervisorStragglerPlane``
as ``tests/test_ctrlchaos.py`` drives it (injection, the heal applied at
a poll past its due time, detection from the heartbeat loads).
"""

import time

import numpy as np
import pytest

from hetu_tpu.resilience import straggler as jstraggler
from hetu_tpu.telemetry import trace as jtrace
from hetu_tpu_torch.resilience.straggler import (
    StragglerDetector, SupervisorStragglerPlane,
)
from hetu_tpu_torch.telemetry import trace


def _sweeps(seed, n=40, slots=4):
    """Seeded sweeps: loads around 10 ms, a slot turning slow for a
    stretch, one slot leaving half way, committed steps growing."""
    g = np.random.default_rng(seed)
    out = []
    slow = int(g.integers(0, slots))
    for k in range(n):
        loads = {s: float(10 + g.standard_normal()) for s in range(slots)}
        if 5 <= k < 25:
            loads[slow] *= float(3 + 10 * g.random())
        if k >= n // 2:
            loads.pop(slots - 1, None)
        present = list(loads)
        committed = {s: k + int(g.integers(0, 2)) for s in present}
        out.append((loads, present, committed))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("evict_after", [0, 3])
def test_detector_records_equal_the_references(seed, evict_after):
    kw = dict(factor=2.5, subject="stage", policy="wait",
              evict_after=evict_after)
    det, ref = StragglerDetector(**kw), jstraggler.StragglerDetector(**kw)
    t, jt = trace.enable(), jtrace.enable()
    try:
        for loads, present, committed in _sweeps(seed):
            assert det.observe(loads, present=present,
                               committed=committed) == \
                ref.observe(loads, present=present, committed=committed)
            assert det.open_slots() == ref.open_slots()
        det.close_all()
        ref.close_all()
    finally:
        trace.disable()
        jtrace.disable()
    assert det.records == ref.records and det.records
    spans = [[e["args"] for e in tr.events if e["name"] == "train.straggler"]
             for tr in (t, jt)]
    assert spans[0] == spans[1] == det.records


def test_detector_needs_two_members_and_closes_departed():
    det = StragglerDetector(factor=2.0)
    assert det.observe({0: 100.0}) == []
    det.observe({0: 10.0, 1: 10.0, 2: 80.0})
    assert det.open_slots() == [2]
    det.observe({0: 10.0, 1: 10.0}, present=[0, 1])
    assert det.records == [{"worker": 2, "policy": "wait",
                            "resolution": "departed", "ratio": 8.0,
                            "slow_steps": 0}]


class FakeSvc:
    def __init__(self):
        self.slow_calls = []
        self.loads = {0: 10.0, 1: 11.0, 2: 120.0}
        self.committed = {0: 5, 1: 5, 2: 5}

    def set_slow(self, slot, ms):
        self.slow_calls.append((slot, ms))

    def state_of(self, slot):
        class _S:
            pass
        s = _S()
        s.load = self.loads[slot]
        s.committed = self.committed[slot]
        return s


@pytest.mark.parametrize("cls", [SupervisorStragglerPlane,
                                 jstraggler.SupervisorStragglerPlane])
def test_supervisor_straggler_plane_inject_heal_observe(cls):
    svc = FakeSvc()
    plane = cls(svc, factor=4.0, subject="worker", policy="evict",
                evict_after=1, slow_ms=120)
    plane.inject(2, duration_s=0.05)
    assert svc.slow_calls == [(2, 120)]
    plane.inject(1, duration_s=0.05, slow_ms=40)
    assert svc.slow_calls[-1] == (1, 40)
    plane.maybe_heal()
    assert len(svc.slow_calls) == 2  # not due yet
    time.sleep(0.07)
    plane.maybe_heal()
    assert svc.slow_calls[-1] == (-1, 0)  # healed, once
    plane.maybe_heal()
    assert len(svc.slow_calls) == 3
    assert plane.observe([0, 1, 2]) == []  # opens the episode
    svc.committed[2] = 7
    assert plane.observe([0, 1, 2]) == [2]
    plane.close(2, resolution="evicted")
    assert plane.records[-1] == {"worker": 2, "policy": "evict",
                                 "resolution": "evicted", "ratio": 11.43,
                                 "slow_steps": 2}
    svc.loads[0] = 0.0  # no evidence: excluded from the loads
    plane.observe([0, 1, 2])
    plane.close_all()
    assert [r["resolution"] for r in plane.records] == ["evicted", "run_end"]
