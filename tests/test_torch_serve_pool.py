"""The port's serving pool (``hetu_tpu_torch.serve.pool``) against
hetu_tpu's on the CPU.

The reference's tiny GPT (V 97, H 64, 2 layers, f32), its parameters drawn
with numpy from a seed and loaded into the port through ``interop``,
behind ``ServingPool`` members of 4 slots x 48.  Mirrored here: the 16
tests of ``tests/test_serve_pool.py`` that are not slow (routing, fail
fast with no member, the planned drain with zero re-prefill, the per-drain
codec, the unplanned kill's failover, revive, request identity, intake
closed by a failover, the two backstop cancels that a wedged member must
not block, distinct migration channels for two pools on one van, the soft
reject, the single-winner finish, no re-route of an accepted request, a
failover that leaves a draining member alone, and the drain's sweep of a
racing submit).  Every answer is held to the reference's greedy oracle,
token for token.

Added: the same prompts through a port pool and a reference pool on the
same weights give the same tokens; the seeded chaos run (a preemption and
an engine kill from one ``FaultSchedule``) with its faults fired at counts
of decode rounds, every ``fault.serve_*`` instant paired with its
recovery span; and the engine loop's lock hand-off, which lets a drain
land between two decode steps.

No sleep decides an outcome.  A drain or a kill that must land mid-decode
holds the member's engine at a count of decode rounds (``_HeldEngine``:
its decode waits on an event), starts the drain, waits until the drain is
waiting for the scheduler lock, and releases the engine; the loop then
hands the lock over before its next step.  Every other wait is a join, an
event or a deadline of its own.
"""

import threading
import time

import pytest
import torch

from hetu_tpu.resilience.faults import FaultSchedule as JaxFaultSchedule
from hetu_tpu.serve import ServingPool as JaxServingPool
from hetu_tpu_torch.resilience import FaultInjector, FaultSchedule
from hetu_tpu_torch.serve import (
    ContinuousBatchingScheduler, InferenceServer, Request, ServeEngine,
    ServingPool,
)
from hetu_tpu_torch.serve import migrate as mg
from hetu_tpu_torch.serve.metrics import ServeMetrics
from hetu_tpu_torch.serve.scheduler import finish_request
from hetu_tpu_torch.telemetry import timeline, trace
from test_torch_gpt_serve import _jax_model as _jax_gpt
from test_torch_gpt_serve import _torch_model as _torch_gpt
from test_torch_migrate import _jax_engine, _ref_greedy

torch.set_num_threads(2)

WAIT_S = 60.0  # a deadline of its own for every wait


@pytest.fixture(scope="module")
def gpt():
    """(JAX model, JAX variables, the port's model), f32, plain path."""
    jm, jv = _jax_gpt("xla")
    return jm, jv, _torch_gpt("xla")


def _engine(tm):
    return ServeEngine(tm, device="cpu", num_slots=4, max_len=48,
                       min_bucket=8)


def _factory(tm):
    return lambda: _engine(tm)


class _HeldEngine:
    """Proxy over a ServeEngine that counts its decode rounds, records
    every prompt it prefills, and with ``hold_at`` waits on ``release`` at
    the start of that decode round (0-based), after setting ``reached``.
    ``rounds``, when given, is a shared ``[count, Condition]`` that every
    decode advances."""

    def __init__(self, inner, *, hold_at=None, release=None, rounds=None):
        self.inner = inner
        self.hold_at = hold_at
        self.reached = threading.Event()
        self.release_evt = release if release is not None \
            else threading.Event()
        self.decodes = 0
        self.prefilled = []
        self.rounds = rounds

    @property
    def cache(self):
        return self.inner.cache

    @property
    def metrics(self):
        return self.inner.metrics

    def alloc_slot(self):
        return self.inner.alloc_slot()

    def release(self, slot):
        self.inner.release(slot)

    def prefill(self, slot, prompt):
        self.prefilled.append([int(t) for t in prompt])
        return self.inner.prefill(slot, prompt)

    def decode(self):
        if self.decodes == self.hold_at:
            self.reached.set()
            assert self.release_evt.wait(WAIT_S), "the hold never ended"
        out = self.inner.decode()
        self.decodes += 1
        if self.rounds is not None:
            with self.rounds[1]:
                self.rounds[0] += 1
                self.rounds[1].notify_all()
        return out

    def export_slots(self, slot_ids):
        return self.inner.export_slots(slot_ids)

    def adopt_slots(self, snapshots):
        return self.inner.adopt_slots(snapshots)

    def resume_slots(self, slot_ids):
        self.inner.resume_slots(slot_ids)


def _held_factory(tm, made, **kw):
    """A factory of held engines; each one made is appended to ``made``."""
    def make():
        e = _HeldEngine(_engine(tm), **kw)
        made.append(e)
        return e
    return make


def _until(cond, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def _serve_all(pool, prompts, *, max_tokens):
    """Generate every prompt through the pool, one thread each; returns
    the threads and ``{i: resp}`` (filled as they finish)."""
    results = {}

    def worker(i):
        results[i] = pool.generate(prompts[i], max_tokens=max_tokens,
                                   timeout_s=90.0)

    ts = [threading.Thread(target=worker, args=(i,), daemon=True)
          for i in range(len(prompts))]
    for t in ts:
        t.start()
    return ts, results


def _join(ts, results, n):
    for t in ts:
        t.join(180)
    assert not any(t.is_alive() for t in ts), "a generate hung"
    assert len(results) == n


def _drain_held(pool, name, release, **kw):
    """Drain ``name`` while its engine is held: start the drain, wait
    until it waits for the member's scheduler lock, release the engines,
    and return the drain's slot map."""
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "map", pool.drain_member(name, **kw)), daemon=True)
    t.start()
    sched = pool.members[name].scheduler
    _until(lambda: sched.control_waiting > 0 or not t.is_alive(),
           "the drain never reached the scheduler lock")
    release.set()
    t.join(WAIT_S)
    assert not t.is_alive() and "map" in out, "the drain failed"
    return out["map"]


# ---------------------------------------------------------------- mirrors

def test_pool_routes_and_serves_parity(gpt):
    jm, jv, tm = gpt
    f = _factory(tm)
    pool = ServingPool({"a": f, "b": f}, start_poll=False)
    prompts = [[1, 2, 3], [9, 8, 7, 6], [42, 5], [3, 14, 15, 9]]
    try:
        ts, results = _serve_all(pool, prompts, max_tokens=6)
        _join(ts, results, len(prompts))
        for i, resp in results.items():
            assert resp["status"] == "ok", (i, resp)
            assert resp["tokens"] == _ref_greedy(jm, jv, prompts[i], 6)
        assert pool.metrics.count("pool_requests") == len(prompts)
    finally:
        pool.close()


def test_no_member_available_fails_fast(gpt):
    pool = ServingPool({"a": _factory(gpt[2])}, start_poll=False)
    try:
        pool.kill_member("a")
        # fail-fast routing needs only `available` to drop, which tracks
        # server.healthy: mark the member dead directly
        pool.members["a"].dead = True
        t0 = time.monotonic()
        resp = pool.generate([1, 2], max_tokens=4)
        assert resp["status"] == "error"
        assert time.monotonic() - t0 < 1.0
        assert pool.metrics.count("requests_rejected_no_member") == 1
    finally:
        pool.close()


def test_planned_drain_migrates_zero_prefill(gpt):
    """Drain a member held at its third decode round: both requests move
    mid-decode, finish on the peer with the oracle's tokens, and the PEER
    prefills nothing (``prefill_tokens`` stays 0)."""
    jm, jv, tm = gpt
    made, release = [], threading.Event()
    f = _factory(tm)
    pool = ServingPool({"a": _held_factory(tm, made, hold_at=2,
                                           release=release), "b": f},
                       start_poll=False)
    prompts = [[1, 2, 3], [9, 8, 7, 6]]
    try:
        a, b = pool.members["a"], pool.members["b"]
        reqs = [Request(prompt=p, max_tokens=12, timeout_s=90.0)
                for p in prompts]
        for r in reqs:  # straight to 'a' so the drain has work
            a.scheduler.submit(r)
        assert made[0].reached.wait(WAIT_S)
        running = a.scheduler.running_count
        slot_map = _drain_held(pool, "a", release)
        assert running == len(slot_map) == 2
        assert a.server._stop.is_set()  # migrate-then-exit
        for r in reqs:
            assert r.done.wait(WAIT_S)
            assert r.status == "ok"
        for r, p in zip(reqs, prompts):
            assert r.tokens == _ref_greedy(jm, jv, p, 12)
        assert b.engine.metrics.count("prefill_tokens") == 0
        assert pool.metrics.count("slots_migrated") == len(slot_map)
        assert pool.metrics.count("pool_migrations") == 1
        # the drained member is out of the rotation; the pool still serves
        resp = pool.generate([5, 5], max_tokens=4)
        assert resp["status"] == "ok"
        assert resp["tokens"] == _ref_greedy(jm, jv, [5, 5], 4)
    finally:
        release.set()
        pool.close()


def test_drain_codec_override_per_drain(gpt):
    """``drain_member(codec=)`` overrides the pool's ``migrate_codec`` for
    one drain, and the bf16 body moves exactly half the logical bytes
    (the source scheduler's ``serve.migrate.bytes_*`` counters)."""
    tm = gpt[2]
    made, release = [], threading.Event()
    pool = ServingPool({"a": _held_factory(tm, made, hold_at=2,
                                           release=release),
                        "b": _factory(tm)}, start_poll=False)
    try:
        with pytest.raises(ValueError, match="codec"):
            pool.drain_member("a", codec="zstd")
        a = pool.members["a"]
        reg = a.scheduler.metrics.registry
        reqs = [Request(prompt=p, max_tokens=12, timeout_s=90.0)
                for p in ([1, 2, 3], [9, 8, 7, 6])]
        for r in reqs:
            a.scheduler.submit(r)
        assert made[0].reached.wait(WAIT_S)
        slot_map = _drain_held(pool, "a", release, codec="bf16")
        assert len(slot_map) == 2
        # the pool-level default is untouched by the per-drain override
        assert pool.migrate_codec == "none"
        logical = reg.counter("serve.migrate.bytes_logical").value
        wire = reg.counter("serve.migrate.bytes_wire").value
        assert logical > 0
        assert wire * 2 == logical  # bf16 body: exactly half the bytes
        for r in reqs:
            assert r.done.wait(WAIT_S)
            assert r.status == "ok"
    finally:
        release.set()
        pool.close()


def test_unplanned_kill_fails_over_with_parity(gpt):
    """Both members held at their third decode round; the busier one is
    killed, then released: its queue fails over by re-prefill and every
    answer is the oracle's."""
    jm, jv, tm = gpt
    made, release = [], threading.Event()
    f = _held_factory(tm, made, hold_at=2, release=release)
    pool = ServingPool({"a": f, "b": f}, health_poll_s=0.05,
                       max_loop_errors=2)
    prompts = [[1, 2, 3], [9, 8, 7, 6], [42, 5], [7, 7], [2, 4, 6]]
    try:
        ts, results = _serve_all(pool, prompts, max_tokens=12)
        for e in made:
            assert e.reached.wait(WAIT_S)
        loaded = max(pool.members.values(), key=lambda m: m.scheduler.load)
        pool.kill_member(loaded.name)
        release.set()
        _join(ts, results, len(prompts))
        for i, resp in results.items():
            assert resp["status"] == "ok", (i, resp)
            assert resp["tokens"] == _ref_greedy(jm, jv, prompts[i], 12)
        assert pool.metrics.count("pool_failovers") == 1
        assert pool.metrics.count("members_killed") == 1
        assert pool.metrics.count("requests_failed_over") >= 1
    finally:
        release.set()
        pool.close()


def test_revive_after_kill_rejoins_routing(gpt):
    jm, jv, tm = gpt
    f = _factory(tm)
    pool = ServingPool({"a": f, "b": f}, health_poll_s=0.05,
                       max_loop_errors=2)
    try:
        pool.kill_member("a")
        # a kill is only NOTICED under load (the engine loop must strike
        # out): route a request straight at the dead member
        victim = Request(prompt=[1, 2], max_tokens=6, timeout_s=60.0)
        pool.members["a"].scheduler.submit(victim)
        _until(lambda: pool.members["a"].dead, "failover never happened")
        assert victim.done.wait(WAIT_S)  # failed over, served by 'b'
        assert victim.status == "ok"
        assert victim.tokens == _ref_greedy(jm, jv, [1, 2], 6)
        pool.revive_member("a")
        assert pool.members["a"].available
        # two submits in a row: the least-loaded route sends one to each
        reqs = [Request(prompt=p, max_tokens=3, timeout_s=60.0)
                for p in ([3, 1], [4, 1])]
        for r in reqs:
            pool.submit(r)
        for r, p in zip(reqs, ([3, 1], [4, 1])):
            assert r.done.wait(WAIT_S) and r.status == "ok"
            assert r.tokens == _ref_greedy(jm, jv, p, 3)
        assert pool.members["a"].engine.metrics.count("prefill_tokens") > 0
        assert pool.metrics.count("members_revived") == 1
    finally:
        pool.close()


def test_request_compares_by_identity():
    """Queue-membership scans mean "this object": field-wise __eq__ would
    deep-compare prompt and token lists against every queued request."""
    a = Request(prompt=[1, 2], max_tokens=4)
    b = Request(prompt=[1, 2], max_tokens=4)
    b.rid = a.rid  # field-identical, still a different request
    assert a == a and a != b
    import collections
    assert b not in collections.deque([a])


def test_failover_closes_intake_and_rejects_without_phantom_counters(gpt):
    """A submit that raced the pick-vs-failover window is REJECTED (so
    pool.submit re-routes it), never admitted into the dead queue, and
    the reject charges no requests_<status> counter."""
    f = _factory(gpt[2])
    pool = ServingPool({"a": f, "b": f}, start_poll=False)
    try:
        a = pool.members["a"]
        pool.failover("a")
        req = Request(prompt=[1, 2], max_tokens=4, timeout_s=30.0)
        a.scheduler.submit(req)  # the racing submit, post-failover
        assert req.done.is_set() and not req.tokens
        assert req.status == "error"
        assert a.scheduler.metrics.count("requests_rejected") == 1
        assert a.scheduler.metrics.count("requests_error") == 0
        # the pool itself routes new work away from the dead member
        assert pool.generate([1, 2], max_tokens=4)["status"] == "ok"
    finally:
        pool.close()


def test_cancel_does_not_block_on_an_unrelated_wedged_member(gpt):
    """The backstop cancel goes straight to the request's stamped owner:
    one wedged member must not block cancelling a peer's request."""
    f = _factory(gpt[2])
    pool = ServingPool({"a": f, "b": f}, start_poll=False)
    try:
        req = Request(prompt=[1, 2], max_tokens=4, timeout_s=30.0)
        pool.members["b"].scheduler.submit(req)
        assert req.owner is pool.members["b"].scheduler
        # member 'a' wedges: its scheduler lock is held while we cancel
        assert pool.members["a"].scheduler._lock.acquire(timeout=5)
        try:
            t0 = time.monotonic()
            pool._cancel(req, "timeout")
            assert time.monotonic() - t0 < 2.0
            assert req.done.is_set() and req.status == "timeout"
        finally:
            pool.members["a"].scheduler._lock.release()
    finally:
        pool.close()


def test_cancel_does_not_block_on_the_wedged_owner_itself(gpt):
    """The OWNER may be the wedged member: the backstop resolves the
    waiter without its lock and detaches the dequeue/slot cleanup."""
    f = _factory(gpt[2])
    pool = ServingPool({"a": f, "b": f}, start_poll=False)
    try:
        req = Request(prompt=[1, 2], max_tokens=40, timeout_s=30.0)
        owner = pool.members["b"].scheduler
        owner.submit(req)
        assert req.owner is owner
        assert owner._lock.acquire(timeout=5)
        try:
            t0 = time.monotonic()
            pool._cancel(req, "timeout")
            assert time.monotonic() - t0 < 2.0
            assert req.done.is_set() and req.status == "timeout"
        finally:
            owner._lock.release()
        # once the wedge clears, the detached cleanup dequeues it
        _until(lambda: not owner.owns(req), "detached cleanup never ran",
               timeout=10)
    finally:
        pool.close()


class _RecordingVan:
    """Pass-through to the port's van module that records every
    BlobChannel id opened through it."""

    def __init__(self, van, ids):
        self._van = van
        self._ids = ids

    def BlobChannel(self, host, port, ch_id, *a, **kw):
        self._ids.append(ch_id)
        return self._van.BlobChannel(host, port, ch_id, *a, **kw)

    def __getattr__(self, name):
        return getattr(self._van, name)


def test_two_pools_sharing_one_van_draw_distinct_migration_channels(gpt):
    """Migration channel ids are drawn process-globally: two pools on one
    van, draining at once, never share a channel id."""
    jm, jv, tm = gpt
    made, release = [], threading.Event()
    held = _held_factory(tm, made, hold_at=2, release=release)
    f = _factory(tm)
    pool_a = ServingPool({"a": held, "b": f}, start_poll=False)
    pool_b = ServingPool({"a": held, "b": f}, start_poll=False,
                         own_van=False, port=pool_a.port)
    ids_a, ids_b = [], []
    pool_a._van = _RecordingVan(pool_a._van, ids_a)
    pool_b._van = _RecordingVan(pool_b._van, ids_b)
    try:
        reqs = []
        for pool in (pool_a, pool_b):
            r = Request(prompt=[1, 2, 3], max_tokens=30, timeout_s=90.0)
            pool.members["a"].scheduler.submit(r)
            reqs.append(r)
        for e in made:
            assert e.reached.wait(WAIT_S)
        # drain CONCURRENTLY: the interleaving where same-id transfers
        # would cross-consume each other's chunks
        maps = {}
        ts = [threading.Thread(
            target=lambda p=p, k=k: maps.setdefault(k, p.drain_member("a")),
            daemon=True) for k, p in (("a", pool_a), ("b", pool_b))]
        for t in ts:
            t.start()
        _until(lambda: all(p.members["a"].scheduler.control_waiting
                           for p in (pool_a, pool_b)),
               "the drains never reached the scheduler locks")
        release.set()
        for t in ts:
            t.join(WAIT_S)
        assert len(maps.get("a", {})) == len(maps.get("b", {})) == 1, maps
        want = _ref_greedy(jm, jv, [1, 2, 3], 30)
        for r in reqs:
            assert r.done.wait(WAIT_S)
            assert r.status == "ok" and r.tokens == want
        assert ids_a and ids_b
        assert not set(ids_a) & set(ids_b), (ids_a, ids_b)
    finally:
        release.set()
        pool_b.close()
        pool_a.close()


def test_soft_reject_leaves_parked_waiter_unresolved(gpt):
    """The pool's routing retry uses resolve_on_reject=False: a waiter
    parked on request.done sleeps through the re-route."""
    jm, jv, tm = gpt
    f = _factory(tm)
    pool = ServingPool({"a": f, "b": f}, start_poll=False)
    a = pool.members["a"]
    real = a.scheduler.submit

    def drain_then_submit(req, **kw):
        # the member drains INSIDE the pick-vs-submit window
        a.draining = True
        a.scheduler.stop_intake("shutdown")
        return real(req, **kw)

    try:
        a.scheduler.submit = drain_then_submit
        req = Request(prompt=[1, 2], max_tokens=3, timeout_s=60.0)
        seen = {}

        def park():
            seen["woke"] = req.done.wait(90)
            seen["status"] = req.status
            seen["tokens"] = list(req.tokens)

        t = threading.Thread(target=park, daemon=True)
        t.start()
        pool.submit(req)  # 'a' soft-rejects mid-window, 'b' serves
        t.join(120)
        assert seen["woke"] and seen["status"] == "ok"
        assert seen["tokens"] == _ref_greedy(jm, jv, [1, 2], 3)
        probe = Request(prompt=[5], max_tokens=2)
        a.scheduler.submit(probe, resolve_on_reject=False)
        assert probe.rejected
        assert not probe.done.is_set() and probe.status == ""
    finally:
        a.scheduler.submit = real
        pool.close()


def test_finish_request_single_winner():
    """Racing finishers resolve a request exactly once."""
    m = ServeMetrics()
    req = Request(prompt=[1], max_tokens=1)
    assert finish_request(req, "ok", m) is True
    assert finish_request(req, "timeout", m) is False
    assert req.status == "ok"
    assert m.count("requests_ok") == 1
    assert m.count("requests_timeout") == 0


def test_pool_submit_does_not_reroute_accepted_then_failed(gpt):
    """Only the scheduler's explicit intake reject re-routes: an accepted
    request that failed with zero tokens inside the submit window stays
    failed."""
    f = _factory(gpt[2])
    pool = ServingPool({"a": f, "b": f}, start_poll=False)
    a = pool.members["a"]
    real = a.scheduler.submit

    def accept_then_fail(req, **kw):
        real(req, **kw)
        with a.scheduler._lock:
            a.scheduler._queue.remove(req)
        finish_request(req, "error", a.scheduler.metrics)
        return req

    try:
        a.scheduler.submit = accept_then_fail
        req = Request(prompt=[1, 2], max_tokens=4, timeout_s=30.0)
        pool.submit(req)  # routes to 'a' (insertion-order tie-break)
        assert req.done.is_set() and req.status == "error"
        assert not req.tokens
        assert a.scheduler.metrics.count("requests_error") == 1
        b = pool.members["b"]
        assert b.scheduler.metrics.count("requests_submitted") == 0
        assert pool.metrics.count("requests_rejected_no_member") == 0
    finally:
        a.scheduler.submit = real
        pool.close()


def test_failover_skips_member_mid_drain(gpt):
    f = _factory(gpt[2])
    pool = ServingPool({"a": f, "b": f}, start_poll=False)
    try:
        a = pool.members["a"]
        a.draining = True  # drain_member holds the member here mid-flight
        assert pool.failover("a") == 0
        assert not a.dead
        assert a.scheduler._accepting  # intake untouched — rollback works
        a.draining = False  # drain failed: next sweep may now claim it
        pool.failover("a")
        assert a.dead
    finally:
        pool.close()


def test_drain_close_sweeps_submit_admitted_during_migration(gpt):
    """A request admitted to the source AFTER its export is swept onto a
    peer before the drained member closes."""
    jm, jv, tm = gpt
    f = _factory(tm)
    pool = ServingPool({"a": f, "b": f}, start_poll=False)
    straggler = Request(prompt=[4, 2], max_tokens=6, timeout_s=60.0)
    real = mg.migrate_inflight
    injected = []

    def migrate_then_lose_the_race(src, dst, **kw):
        out = real(src, dst, **kw)
        pool.members["a"].scheduler.submit(straggler)
        injected.append(not straggler.done.is_set())
        return out

    try:
        mg.migrate_inflight = migrate_then_lose_the_race
        pool.drain_member("a")
    finally:
        mg.migrate_inflight = real
    assert injected == [True]  # it really was ADMITTED, not rejected
    try:
        assert straggler.done.wait(WAIT_S)
        assert straggler.status == "ok"
        assert straggler.tokens == _ref_greedy(jm, jv, [4, 2], 6)
        assert pool.members["a"].scheduler.metrics.count(
            "requests_shutdown") == 0
        assert pool.metrics.count("requests_swept_on_drain") == 1
    finally:
        pool.close()


# ---------------------------------------------------------------- added

def test_engine_loop_hands_the_lock_to_a_waiting_export(gpt):
    """The departure from the reference, pinned: an export that waits for
    the scheduler lock while the engine is held in its third decode round
    lands right after that round (4 tokens a request: the prefill's and 3
    decodes), not after the burst; re-adopted, the requests finish with
    the oracle's tokens."""
    jm, jv, tm = gpt
    held = _HeldEngine(_engine(tm), hold_at=2)
    sched = ContinuousBatchingScheduler(held)
    prompts = [[1, 2, 3], [9, 8, 7, 6]]
    reqs = [Request(prompt=p, max_tokens=30, timeout_s=90.0)
            for p in prompts]
    for r in reqs:
        sched.submit(r)
    srv = InferenceServer(sched, max_clients=0, poll_s=0.05)
    try:
        assert held.reached.wait(WAIT_S)
        out = {}
        t = threading.Thread(target=lambda: out.setdefault(
            "x", sched.export_inflight_with_slots()), daemon=True)
        t.start()
        _until(lambda: sched.control_waiting > 0, "the export never waited")
        held.release_evt.set()
        t.join(WAIT_S)
        pairs, snaps = out["x"]
        assert [len(r.tokens) for r, _ in pairs] == [4, 4]
        assert len(snaps) == 2
        assert held.decodes == 3
        sched.adopt_inflight(pairs)  # back home: the exported slots resume
        for r, p in zip(reqs, prompts):
            assert r.done.wait(WAIT_S) and r.status == "ok"
            assert r.tokens == _ref_greedy(jm, jv, p, 30)
    finally:
        held.release_evt.set()
        srv.close()


def test_between_steps_waits_for_the_step_and_is_bounded(gpt):
    """``between_steps``, in which a member process takes its final
    black-box record: while a decode round is held it gives up after its
    timeout and yields False; waiting longer, it gets the lock right after
    the held round, and no round runs while it holds it."""
    jm, jv, tm = gpt
    held = _HeldEngine(_engine(tm), hold_at=2)
    sched = ContinuousBatchingScheduler(held)
    req = Request(prompt=[1, 2, 3], max_tokens=30, timeout_s=90.0)
    sched.submit(req)
    srv = InferenceServer(sched, max_clients=0, poll_s=0.05)
    out = {}

    def take():
        with sched.between_steps(WAIT_S) as got:
            n = held.decodes
            time.sleep(0.1)
            out["x"] = (got, n, held.decodes)

    try:
        assert held.reached.wait(WAIT_S)
        with sched.between_steps(0.05) as got:
            assert not got
        assert sched.control_waiting == 0
        t = threading.Thread(target=take, daemon=True)
        t.start()
        _until(lambda: sched.control_waiting > 0, "the take never waited")
        held.release_evt.set()
        t.join(WAIT_S)
        assert out["x"] == (True, 3, 3)
        assert req.done.wait(WAIT_S) and req.status == "ok"
        assert req.tokens == _ref_greedy(jm, jv, [1, 2, 3], 30)
    finally:
        held.release_evt.set()
        srv.close()


def test_port_pool_and_reference_pool_give_the_same_tokens(gpt):
    """The same prompts through a port pool and a reference pool (the
    JAX engines on the same weights), each of two members: the same
    tokens, and the reference's greedy oracle."""
    jm, jv, tm = gpt
    prompts = [[1, 2, 3], [9, 8, 7, 6], [42, 5], [3, 14, 15, 9], [7, 7],
               [2, 4, 6, 8]]
    f = _factory(tm)

    def jf():
        return _jax_engine(jm, jv, num_slots=4)

    answers = {}
    for name, pool in (("port", ServingPool({"a": f, "b": f},
                                            start_poll=False)),
                       ("jax", JaxServingPool({"a": jf, "b": jf},
                                              start_poll=False))):
        try:
            ts, results = _serve_all(pool, prompts, max_tokens=8)
            _join(ts, results, len(prompts))
            assert all(r["status"] == "ok" for r in results.values())
            answers[name] = [results[i]["tokens"] for i in range(len(prompts))]
            assert pool.metrics.count("pool_requests") == len(prompts)
        finally:
            pool.close()
    assert answers["port"] == answers["jax"]
    assert answers["port"] == [_ref_greedy(jm, jv, p, 8) for p in prompts]


def _chaos_schedule(module):
    """The first seed whose two victims differ (a preempt aimed at an
    already-killed member has no recovery to pair), as the reference's
    chaos test draws it."""
    def victims(sched):
        return {e.kind: int(e.arg) for e in sched.events}

    return next(
        (s, sc) for s, sc in
        ((s, module.generate(steps=6, seed=s, serve_preempts=1,
                             serve_engine_kills=1, n_members=3))
         for s in range(64))
        if len(sc) == 2 and
        victims(sc)["serve_preempt"] != victims(sc)["serve_engine_kill"])


def test_chaos_seeded_preempt_plus_kill_at_decode_round_counts(gpt):
    """The reference's slow chaos run, deterministic: a seeded schedule
    (byte-identical to the reference's) preempts one of three members
    (live migration) and kills another (re-prefill failover) under
    continuous traffic from three workers, its steps fired at counts of
    the pool's decode rounds.  Every request completes 'ok' with the
    oracle's tokens, and ``timeline`` pairs each ``fault.serve_*`` instant
    with a ``serve.migrate`` or ``serve.failover`` span."""
    jm, jv, tm = gpt
    seed, sched = _chaos_schedule(FaultSchedule)
    ref_seed, ref_sched = _chaos_schedule(JaxFaultSchedule)
    assert (seed, sched.to_json()) == (ref_seed, ref_sched.to_json())
    assert sched.to_json() == FaultSchedule.generate(
        steps=6, seed=seed, serve_preempts=1, serve_engine_kills=1,
        n_members=3).to_json()

    rounds = [0, threading.Condition()]
    made = []
    f = _held_factory(tm, made, rounds=rounds)
    inj = FaultInjector(sched)
    tracer = trace.enable()
    pool = ServingPool({"m0": f, "m1": f, "m2": f}, health_poll_s=0.05,
                       max_loop_errors=2)
    prompts = [[1, 2, 3], [9, 8, 7, 6], [42, 5], [3, 14], [7, 7, 7],
               [2, 4, 6, 8]]
    served, errors = [], []
    stop = threading.Event()

    def traffic(wid):
        k = 0
        while not stop.is_set():
            p = prompts[(wid + 3 * k) % len(prompts)]
            try:
                served.append((p, pool.generate(p, max_tokens=16,
                                                timeout_s=90.0)))
            except Exception as e:  # reported after the join
                errors.append(repr(e))
            k += 1

    workers = [threading.Thread(target=traffic, args=(w,), daemon=True)
               for w in range(3)]
    try:
        for w in workers:
            w.start()
        for step in range(1, 6):
            with rounds[1]:  # every 4 decode rounds of the pool, a step
                assert rounds[1].wait_for(lambda: rounds[0] >= 4 * step,
                                          WAIT_S), "traffic stalled"
            inj.on_step(step)
            pool.run_fault_events(inj.pop_serve_events())
        _until(lambda: pool.metrics.count("pool_failovers") >= 1,
               "failover never happened")
        stop.set()
        for w in workers:
            w.join(120)
        assert not any(w.is_alive() for w in workers)
    finally:
        stop.set()
        pool.close()
        trace.disable()
    assert not errors, errors
    assert served
    refs = {}
    for p, resp in served:
        assert resp["status"] == "ok", resp
        key = tuple(p)
        if key not in refs:
            refs[key] = _ref_greedy(jm, jv, p, 16)
        assert resp["tokens"] == refs[key]
    assert inj.counters["serve_preempts_injected"] == 1
    assert inj.counters["serve_engine_kills_injected"] == 1
    assert pool.metrics.count("pool_migrations") == 1
    pairs = timeline.correlate(tracer.events)
    serve_pairs = [p for p in pairs if p.kind.startswith("serve_")]
    assert len(serve_pairs) == 2
    for p in serve_pairs:
        assert p.paired, f"fault.{p.kind} has no recovery span"
        assert p.recovery_name == timeline.RECOVERY_FOR[p.kind][0]
        assert p.recover_s >= p.detect_s >= 0.0
        assert p.args["schedule"] == sched.schedule_id
    rep = timeline.report(pairs)
    assert rep["serve_preempt"]["paired"] == 1
    assert rep["serve_engine_kill"]["paired"] == 1
    assert "recover_s" in rep["serve_preempt"]


# ---------------------------------------------------------------- hooks

def test_member_factory_builds_the_members(gpt):
    """``member_factory(pool, name, factory)`` builds every member (the
    hook the CTR members ride) and is called again for a member rebuilt
    after a drain-and-close."""
    from hetu_tpu_torch.serve.pool import PoolMember, _GuardedEngine

    jm, jv, tm = gpt
    calls = []

    def member_factory(pool, name, factory):
        calls.append((pool, name, factory))
        sched = ContinuousBatchingScheduler(_GuardedEngine(factory()))
        srv = InferenceServer(sched, port=pool.port, own_van=False,
                              max_clients=0)
        return PoolMember(name, factory, sched, srv)

    f = _factory(tm)
    pool = ServingPool({"a": f, "b": f}, start_poll=False,
                       member_factory=member_factory)
    try:
        assert [(c[0], c[1], c[2]) for c in calls] == \
            [(pool, "a", f), (pool, "b", f)]
        assert [pool.members[n].scheduler for n in "ab"] == \
            [pool.members[n].scheduler for n in "ab"]
        r = pool.generate([1, 2, 3], max_tokens=4, timeout_s=60.0)
        assert r["status"] == "ok"
        assert r["tokens"] == _ref_greedy(jm, jv, [1, 2, 3], 4)
        pool.drain_member("a")
        pool.revive_member("a")  # closed: rebuilt whole, by the hook
        assert [c[1] for c in calls] == ["a", "b", "a"]
        assert pool.members["a"].available
    finally:
        pool.close()


def test_revive_goes_through_fresh_engine_and_closes_the_dead_one(gpt):
    """``revive_member`` takes the member's ``fresh_engine`` (not the LLM
    guard over the factory) and closes the dead engine once; the pool's
    close closes the live one, and a drain's close its member's."""
    from hetu_tpu_torch.serve.pool import PoolMember, _GuardedEngine

    jm, jv, tm = gpt
    closed, fresh = [], []

    class ClosingGuard(_GuardedEngine):
        def close(self):
            closed.append(self)

    def make_fresh(factory):
        def fresh_engine():
            e = ClosingGuard(factory())
            fresh.append(e)
            return e
        return fresh_engine

    def member_factory(pool, name, factory):
        sched = ContinuousBatchingScheduler(ClosingGuard(factory()))
        srv = InferenceServer(sched, port=pool.port, own_van=False,
                              max_clients=0)
        return PoolMember(name, factory, sched, srv,
                          fresh_engine=make_fresh(factory))

    f = _factory(tm)
    pool = ServingPool({"a": f, "b": f}, start_poll=False,
                       member_factory=member_factory)
    try:
        dead = pool.members["a"].engine
        pool.kill_member("a")
        pool.revive_member("a")
        assert fresh == [pool.members["a"].engine] and fresh[0] is not dead
        assert closed == [dead]
        r = pool.generate([2, 5], max_tokens=3, timeout_s=60.0)
        assert r["status"] == "ok"
        assert r["tokens"] == _ref_greedy(jm, jv, [2, 5], 3)
        b = pool.members["b"].engine
        pool.drain_member("b")
        assert closed == [dead, b]
    finally:
        pool.close()
    # the pool's close closes every member's engine, a drained one's too
    assert closed[2:] == [fresh[0], b] and closed.count(dead) == 1
    # the LLM member's default: a fresh guard over its factory
    m = PoolMember("x", f, None, None)
    e = m.fresh_engine()
    assert type(e) is _GuardedEngine and isinstance(e.inner, ServeEngine)


@pytest.mark.parametrize("option, value", [
    ("token_budget", 96), ("shed", True), ("shed_headroom", 0.5),
    ("migrate_channel_base", 0x20000000)])
def test_pool_takes_no_option_without_a_caller(option, value):
    """The reference's ``ServingPool`` also takes these four; no caller
    of the port sets them yet, so the port's pool refuses each rather
    than carry it (a ``RecsysPool`` passes its keywords through and
    refuses them too, before any member is built)."""
    from hetu_tpu_torch.serve.recsys import RecsysPool

    built = []
    for cls in (ServingPool, RecsysPool):
        with pytest.raises(TypeError, match=option):
            cls({"a": lambda: built.append(1)}, start_poll=False,
                **{option: value})
    assert built == []
