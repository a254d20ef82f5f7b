"""Overload shedding in the port's scheduler, on the CPU.

Mirrored: the three shed tests of ``tests/test_netchaos.py`` (a doomed
submit shed at once, the projection that scales with the queue, no shed
without a deadline), on the same slow stand-in engine (its step time is
the knob that stands for a saturated device).
"""

import time

import numpy as np

from hetu_tpu_torch.serve import ContinuousBatchingScheduler, Request
from hetu_tpu_torch.serve.metrics import ServeMetrics
from hetu_tpu_torch.telemetry import trace


class _Cache:
    def __init__(self, num_slots, max_len=64):
        self.num_slots, self.max_len = num_slots, max_len
        self.lengths = np.zeros(num_slots, np.int32)
        self.free = list(range(num_slots))

    @property
    def num_free(self):
        return len(self.free)

    @property
    def active_tokens(self):
        return int(self.lengths.sum())

    @property
    def occupancy(self):
        return 1.0 - len(self.free) / self.num_slots


class SlowEngine:
    """Engine whose per-step latency is a knob — the deterministic
    stand-in for 'the device is saturated'."""

    def __init__(self, step_s=0.02, num_slots=2):
        self.cache = _Cache(num_slots)
        self.step_s = step_s
        self.metrics = ServeMetrics()

    def alloc_slot(self):
        return self.cache.free.pop()

    def release(self, slot):
        self.cache.lengths[slot] = 0
        if slot not in self.cache.free:
            self.cache.free.append(slot)

    def prefill(self, slot, prompt):
        self.cache.lengths[slot] = len(prompt) + 1
        time.sleep(self.step_s)
        return 1

    def decode(self):
        time.sleep(self.step_s)
        out = {}
        for s in range(self.cache.num_slots):
            if s not in self.cache.free and self.cache.lengths[s] > 0:
                self.cache.lengths[s] += 1
                out[s] = 1
        return out


def _drain_all(sched, max_steps=10_000):
    for _ in range(max_steps):
        if not sched.has_work():
            return
        sched.step()
    raise AssertionError("scheduler never drained")


# ---------------------------------------------------------------- mirrors

def test_shed_rejects_doomed_submits_instantly():
    eng = SlowEngine(step_s=0.02, num_slots=2)
    sched = ContinuousBatchingScheduler(eng, shed=True)
    # no service-time evidence yet: nothing sheds (projection is 0)
    assert sched.projected_wait_s() == 0.0
    seed = Request(prompt=[1, 2], max_tokens=4, timeout_s=30.0)
    sched.submit(seed)
    _drain_all(sched)
    assert seed.status == "ok"
    ewma = sched._ewma_service_s
    assert ewma is not None and ewma > 0.01
    ok = Request(prompt=[1], max_tokens=2, timeout_s=30.0)
    tracer = trace.Tracer()
    trace.enable(tracer=tracer)
    try:
        sched.submit(ok)
        assert not ok.done.is_set()
        # an infeasible deadline is shed INSTANTLY: waiter resolved, no
        # queue entry, counter charged, instant in the trace
        doomed = Request(prompt=[1], max_tokens=2, timeout_s=ewma / 10)
        t0 = time.perf_counter()
        sched.submit(doomed)
        assert time.perf_counter() - t0 < 0.01
        assert doomed.done.is_set() and doomed.status == "shed"
        assert sched.metrics.count("requests_shed") == 1
        assert not sched.owns(doomed)
    finally:
        trace.disable()
    assert "serve.shed" in [e.get("name") for e in tracer.events]
    _drain_all(sched)
    assert ok.status == "ok"


def test_shed_projection_scales_with_queue_depth():
    eng = SlowEngine(step_s=0.02, num_slots=1)
    sched = ContinuousBatchingScheduler(eng, shed=True)
    seed = Request(prompt=[1], max_tokens=3, timeout_s=30.0)
    sched.submit(seed)
    _drain_all(sched)
    deadline = 3.0 * sched._ewma_service_s
    # idle: projection = 1 service time < deadline -> accepted
    r1 = Request(prompt=[1], max_tokens=3, timeout_s=deadline)
    sched.submit(r1)
    assert not r1.done.is_set()
    # pile up a queue; the same deadline now projects past itself
    backlog = [Request(prompt=[1], max_tokens=3, timeout_s=60.0)
               for _ in range(8)]
    for r in backlog:
        sched.submit(r)
    r2 = Request(prompt=[1], max_tokens=3, timeout_s=deadline)
    sched.submit(r2)
    assert r2.done.is_set() and r2.status == "shed"
    _drain_all(sched)
    assert r1.status == "ok" and all(r.status == "ok" for r in backlog)


def test_no_deadline_never_sheds():
    eng = SlowEngine(step_s=0.01, num_slots=1)
    sched = ContinuousBatchingScheduler(eng, shed=True)
    seed = Request(prompt=[1], max_tokens=2, timeout_s=10.0)
    sched.submit(seed)
    _drain_all(sched)
    for _ in range(6):
        sched.submit(Request(prompt=[1], max_tokens=2))  # no deadline
    assert sched.metrics.count("requests_shed") == 0
    _drain_all(sched)
