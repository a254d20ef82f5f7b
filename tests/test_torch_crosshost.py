"""The port's cross-process serving pool (``hetu_tpu_torch.serve.
crosshost``) with real member processes on the CPU, against hetu_tpu's
scheduler.

Members are OS processes of the reference's ``TINY`` GPT (V 89, H 48, 2
layers, 4 slots x 48), their weights drawn by the port's ``build_engine``
from the spec's seed; the oracle is the reference's
``ContinuousBatchingScheduler`` over its own engine on those weights
(``interop`` layout), and every stream is held to it token for token,
through:

* a plain burst over two members;
* a planned drain while both members are held at a decode round: live
  slots move, the target prefills nothing for them, the drained process
  exits 0 and is never grieved;
* a SIGKILL of a held member: the lease declares it lost, ``failover``
  re-prefills its requests on the survivor, and ``revive_member`` spawns
  a fresh process that serves again;
* a SIGSTOP shorter than lease + grace: suspected once, cleared once, no
  failover;
* a controller process SIGKILLed while its members are held mid-decode,
  and a ``takeover`` that adopts the live members and finishes their
  requests;
* ``tests/test_ctrlchaos.py``'s deaf-ack plumb through the pool.

No sleep decides an outcome: a fault lands while the members are held at
a decode round (the member hold, a departure of the port), and every wait
is a join, an event or a poll with a deadline of its own.  Only the lease
runs on wall time, as it is defined on it, with margins of 3x or more.
"""

import json
import signal
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import pytest

from hetu_tpu.models.gpt import GPTConfig as JaxGPTConfig
from hetu_tpu.models.gpt import GPTModel as JaxGPTModel
from hetu_tpu.serve import ContinuousBatchingScheduler as JaxScheduler
from hetu_tpu.serve import Request as JaxRequest
from hetu_tpu.serve import ServeEngine as JaxServeEngine
from hetu_tpu_torch.resilience.shardproc import (
    free_port, spawn_module, spawn_shard_server,
)
from hetu_tpu_torch.serve.crosshost import (
    CrossProcessServingPool, build_engine, seeded_prompts,
)

WAIT_S = 60.0
TINY = {"vocab_size": 89, "hidden_size": 48, "num_layers": 2,
        "num_heads": 4, "ffn_size": 96, "max_position": 64,
        "num_slots": 4, "max_len": 48, "min_bucket": 8, "seed": 1,
        "device": "cpu"}
# one thread a member: the test workers share the host's cores
MEMBER_ENV = {"OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def oracle():
    """``ref(prompt, n)``: the reference's scheduler, over its own engine
    on the weights the port's members draw, memoized."""
    _, variables, _ = build_engine(TINY, device="cpu")
    cfg = JaxGPTConfig(vocab_size=89, hidden_size=48, num_layers=2,
                       num_heads=4, ffn_size=96, max_position=64,
                       dropout_rate=0.0)
    jv = {"params": _tree(jnp.asarray, variables["params"]), "state": {}}
    engine = JaxServeEngine(JaxGPTModel(cfg), jv, num_slots=4, max_len=48,
                            min_bucket=8)
    sched = JaxScheduler(engine)
    memo = {}

    def ref(prompt, n):
        key = (tuple(prompt), n)
        if key not in memo:
            r = JaxRequest(prompt=list(prompt), max_tokens=n,
                           timeout_s=300.0)
            sched.submit(r)
            while not r.done.is_set():
                sched.step()
            assert r.status == "ok"
            memo[key] = list(r.tokens)
        return memo[key]
    return ref


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _pool(tmp_path, n=2, **kw):
    kw.setdefault("lease_s", 1.0)
    kw.setdefault("suspect_grace_s", 1.0)
    kw.setdefault("scrape_s", 0.0)
    return CrossProcessServingPool(n, workdir=tmp_path, model=kw.pop(
        "model", TINY), member_env=MEMBER_ENV, request_timeout_s=120.0,
        **kw)


def _until(cond, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def _submit_all(pool, prompts, n):
    """Submit every prompt in order (the router spreads them over the
    members, least loaded first); returns the controller's records."""
    return [pool.submit(p, max_tokens=n, timeout_s=120.0) for p in prompts]


def _held_wave(pool, prompts, n, slots=(0, 1)):
    """Hold each member of ``slots`` at its next decode round, submit
    ``prompts``, then move each hold one round on: every request submitted
    is admitted by the round the member parks at last, and no member ran
    ahead meanwhile.  Returns the requests once every member that took
    one has parked there."""
    for s in slots:
        pool.hold_member(s)
    reqs = _submit_all(pool, prompts, n)
    for s in slots:
        pool.hold_member(s, after=1)
    for s in sorted({r.member for r in reqs}):
        assert pool.wait_held([s], timeout_s=WAIT_S), \
            f"member {s} never parked"
    return reqs


def _finish(reqs):
    for r in reqs:
        assert r.done.wait(WAIT_S), f"request {r.rid} never resolved"
    return [(r.status, list(r.tokens)) for r in reqs]


def _counter(dump, name):
    return int((dump.get(name) or {}).get("value", 0))


# ---------------------------------------------------------------- tests

def test_cross_process_pool_serves_token_exact(tmp_path, oracle):
    pool = _pool(tmp_path)
    prompts = [[1, 2, 3], [9, 8, 7, 6], [42, 5], [3, 14, 15, 9]]
    try:
        results = {}

        def worker(i):
            results[i] = pool.generate(prompts[i], max_tokens=6,
                                       timeout_s=120.0)

        ts = [threading.Thread(target=worker, args=(i,), daemon=True)
              for i in range(len(prompts))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(WAIT_S)
        assert len(results) == len(prompts)
        for i, resp in results.items():
            assert resp["status"] == "ok", (i, resp)
            assert resp["tokens"] == oracle(prompts[i], 6), i
        assert pool.metrics.count("pool_requests") == len(prompts)
        # two distinct OS processes, neither with jax loaded
        assert len({p.pid for p in pool.procs}) == 2
        fleet = pool.fleet_metrics().dump()
        assert fleet["fleet.members_reporting"]["value"] == 2
        assert _counter(fleet, "prefills") == len(prompts)
        for s in (0, 1):
            assert fleet[f"m{s}.member.jax_loaded"]["value"] == 0
        # the CPU launches no kernel: the plain version ran
        assert _counter(fleet, "kernels.flash_fwd.launches") == 0
    finally:
        pool.close()
    assert all(p.poll() is not None for p in pool.procs)


def test_held_drain_migrates_live_slots_with_zero_reprefill(tmp_path,
                                                            oracle):
    """Both members park at a decode round; the busiest is drained over
    the wire (codec none) while parked: its live slots move
    mid-decode, the target prefills nothing for them, the source exits 0
    after a planned leave (never grieved), and every stream matches the
    oracle."""
    pool = _pool(tmp_path)
    prompts = [[i + 1, i + 2, (i % 5) + 1] for i in range(4)]
    try:
        reqs = _held_wave(pool, prompts, 30)
        before = pool.scrape()
        src = max((0, 1), key=lambda s: pool._inflight.get(s, 0))
        dst = 1 - src
        n = pool.drain_member(src, close=True, codec="none")
        drain = pool.last_drain
        assert drain["slots"] >= 1, drain
        assert n == drain["requests"] == drain["slots"] + len(
            drain["queued"])
        assert drain["target"] == dst and drain["codec"] == "none"
        for status, tokens in _finish(reqs):
            assert status == "ok"
        assert [r.tokens for r in reqs] == [oracle(p, 30) for p in prompts]
        # the target prefilled nothing for the slots it adopted (only a
        # record that moved without one, if a submit was still queued)
        after = pool.scrape()
        queued = sum(len(r.msg["prompt"]) for r in reqs
                     if r.rid in drain["queued"])
        assert _counter(after[dst], "prefill_tokens") - \
            _counter(before[dst], "prefill_tokens") == queued
        assert _counter(after[dst], "slots_adopted") == drain["slots"]
        assert pool.procs[src].wait(WAIT_S) == 0
        assert pool.metrics.count("pool_migrations") == 1
        assert pool.metrics.count("pool_failovers") == 0
        # the emptied slot is out of routing; the survivor serves on
        resp = pool.generate([5, 6], max_tokens=4, timeout_s=120.0)
        assert resp["status"] == "ok" and resp["tokens"] == oracle([5, 6],
                                                                   4)
    finally:
        pool.close()


def test_drain_waits_for_a_submit_being_routed_to_its_member(tmp_path,
                                                             oracle):
    """A submit routed to a member whose put is still under way when the
    member's drain starts: the drain sends nothing to the source until the
    put is done, so the member reads the submit before the drain command
    and the export carries it; the request is served token-exact.  (Put
    after the drain had exported, the request was read by no one: the
    autoscaler's drains lost one so, ``accepted requests unresolved``.)"""
    pool = _pool(tmp_path)
    gate, entered = threading.Event(), threading.Event()
    picked, sent = [], []
    real = pool._send

    def send(slot, msg, **kw):
        if msg.get("cmd") == "submit" and not entered.is_set():
            picked.append(slot)
            entered.set()
            assert gate.wait(WAIT_S), "the held submit was never let go"
        elif not gate.is_set():
            sent.append((slot, msg.get("cmd")))
        return real(slot, msg, **kw)

    out = {}
    try:
        pool._send = send
        t = threading.Thread(target=lambda: out.setdefault(
            "req", pool.submit([7, 3, 5], max_tokens=8, timeout_s=120.0)),
            daemon=True)
        t.start()
        assert entered.wait(WAIT_S), "the submit never reached a send"
        src = picked[0]
        d = threading.Thread(target=lambda: out.setdefault(
            "n", pool.drain_member(src, close=True, codec="none")),
            daemon=True)
        d.start()
        _until(lambda: src in pool._draining, "the drain never started")
        deadline = time.monotonic() + 1.0
        while time.monotonic() < deadline:
            assert (src, "drain") not in sent, \
                "the drain command went out with a submit to it in flight"
            time.sleep(0.01)
        gate.set()
        t.join(WAIT_S)
        d.join(WAIT_S)
        assert not t.is_alive() and not d.is_alive()
        req = out["req"]
        assert out["n"] == pool.last_drain["requests"] == 1
        assert req.done.wait(WAIT_S), "the routed request was lost"
        assert req.status == "ok" and req.tokens == oracle([7, 3, 5], 8)
        assert pool.procs[src].wait(WAIT_S) == 0
    finally:
        gate.set()
        pool.close()


def test_revived_member_is_not_routed_before_its_channel_is_bound(
        tmp_path, oracle):
    """A drained slot revived: the fresh process joins the blackboard
    before the controller binds its control channel.  In that window the
    slot is not routable, so a submit goes to the other member and is
    served; once bound, the revived member serves.  (Routed there, the
    submit went down the dead incarnation's channel and was read by no
    one: the autoscaler's scale-ups lost one so.)"""
    pool = _pool(tmp_path)
    seen = {}
    real = pool._bind_member

    def bind(slot, spec):
        _until(lambda: slot in pool.svc.alive_slots(),
               "the revived member never joined")
        seen["routable"] = pool._routable()
        seen["req"] = pool.submit([2, 7, 1], max_tokens=6, timeout_s=120.0)
        return real(slot, spec)

    try:
        pool.drain_member(1, close=True, codec="none")
        assert pool.procs[1].wait(WAIT_S) == 0
        _until(lambda: 1 not in pool.svc.alive_slots(),
               "the drained member never left")
        pool._bind_member = bind
        pool.revive_member(1)
        assert seen["routable"] == [0]
        req = seen["req"]
        assert req.member == 0
        assert req.done.wait(WAIT_S), "the request was lost"
        assert req.status == "ok" and req.tokens == oracle([2, 7, 1], 6)
        assert 1 in pool._routable()
        reqs = _submit_all(pool, [[5, 6], [6, 5]], 4)
        assert {r.member for r in reqs} == {0, 1}
        assert _finish(reqs) == [("ok", oracle([5, 6], 4)),
                                 ("ok", oracle([6, 5], 4))]
    finally:
        pool.close()


def test_held_kill_fails_over_then_revive_serves(tmp_path, oracle):
    """SIGKILL of a member parked at a decode round: the lease
    declares it lost and ``failover`` re-prefills its requests on the
    survivor, token-exact; ``revive_member`` spawns a fresh process on the
    slot, which takes a new request."""
    from hetu_tpu_torch.resilience import FaultInjector, FaultSchedule
    pool = _pool(tmp_path)
    prompts = [[i + 2, i + 1, 4] for i in range(4)]
    try:
        reqs = _held_wave(pool, prompts, 24)
        victim = max((0, 1), key=lambda s: pool._inflight.get(s, 0))
        owned = sum(r.member == victim for r in reqs)
        sched = FaultSchedule.generate(steps=2, seed=0, member_kills=1,
                                       n_members=2)
        step, ev = next((e.step, e) for e in sched.events)
        assert ev.kind == "member_kill"
        procs = pool.procs if int(ev.arg) % 2 == victim else \
            list(reversed(pool.procs))
        inj = FaultInjector(sched, member_procs=procs)
        inj.on_step(step)
        assert inj.counters["member_procs_killed"] == 1
        assert pool.procs[victim].poll() is not None
        pool.release_member(1 - victim)
        _until(lambda: pool.metrics.count("pool_failovers") >= 1,
               "the killed member was never failed over")
        assert pool.metrics.count("requests_failed_over") == owned >= 1
        for status, _ in _finish(reqs):
            assert status == "ok"
        assert [r.tokens for r in reqs] == [oracle(p, 24) for p in prompts]
        assert pool.metrics.count("pool_failovers") == 1
        pool.revive_member(victim)
        assert pool.procs[victim].poll() is None
        # two submits in a row: the fresh process (least loaded, its
        # link unpriced) takes at least the first
        fresh = [pool.submit([7, 8, 9], max_tokens=30, timeout_s=120.0),
                 pool.submit([7, 8, 9], max_tokens=30, timeout_s=120.0)]
        took = sum(r.member == victim for r in fresh)
        assert took >= 1, [r.member for r in fresh]
        _finish(fresh)
        assert all(r.status == "ok" and r.tokens == oracle([7, 8, 9], 30)
                   for r in fresh)
        dumps = pool.scrape()
        assert _counter(dumps[victim], "prefills") == took
        assert pool.metrics.count("members_revived") == 1
    finally:
        pool.close()


def test_suspend_shorter_than_the_lease_is_cleared_not_grieved(
        tmp_path, oracle):
    """SIGSTOP of a member for 1.5 s, against lease 0.5 s + grace 4.5 s
    (3x on either side): suspected once, cleared once, never lost or
    rejoined, and its request finishes token-exact where it was."""
    from hetu_tpu_torch.resilience import FaultInjector, FaultSchedule
    pool = _pool(tmp_path, lease_s=0.5, suspect_grace_s=4.5)
    prompts = [[3, 1, 4], [1, 5, 9]]
    try:
        reqs = _held_wave(pool, prompts, 12)
        sched = FaultSchedule.generate(steps=2, seed=1, member_suspends=1,
                                       member_suspend_s=1.5, n_members=2)
        step, ev = next((e.step, e) for e in sched.events)
        assert ev.kind == "member_suspend"
        victim = int(ev.arg) % 2
        inj = FaultInjector(sched, member_procs=pool.procs)
        inj.on_step(step)
        _until(lambda: pool.metrics.count("members_suspect_cleared") >= 1,
               "the suspended member was never suspected and cleared")
        assert pool.svc.state_of(victim).state == "alive"
        for s in (0, 1):
            pool.release_member(s)
        for status, _ in _finish(reqs):
            assert status == "ok"
        assert [r.tokens for r in reqs] == [oracle(p, 12) for p in prompts]
        assert pool.metrics.count("members_suspected") == 1
        assert pool.metrics.count("members_suspect_cleared") == 1
        assert pool.metrics.count("pool_failovers") == 0
        assert pool.metrics.count("members_rejoined") == 0
    finally:
        pool.close()


def test_controller_takeover_adopts_held_members_token_exact(tmp_path,
                                                             oracle):
    """A controller PROCESS (``--controller``) over a van process of its
    own submits a seeded stream to two members, which park mid-decode;
    the controller is SIGKILLed; ``takeover`` claims a higher
    incarnation, adopts the live members and every accepted request, and
    each finishes with the oracle's tokens."""
    van = spawn_shard_server(tmp_path, free_port(), "van")
    port = int(van.ready[0])
    cfg = {"workdir": str(tmp_path), "port": port, "n_members": 2,
           "model": {**TINY, "hold_at": 2}, "n_requests": 4,
           "prompt_seed": 3, "max_tokens": 20, "submit_gap_s": 0.0,
           "wait_held": True, "deadline_s": WAIT_S, "hold_s": 600.0,
           "lease_s": 1.0, "suspect_grace_s": 1.0,
           "member_env": MEMBER_ENV}
    path = Path(tmp_path) / "controller.json"
    path.write_text(json.dumps(cfg))
    ctrl = spawn_module(tmp_path, "controller",
                        "hetu_tpu_torch.serve.crosshost",
                        ["--controller", str(path)], extra_env=MEMBER_ENV,
                        timeout_s=WAIT_S)
    pool = None
    try:
        _until(lambda: "ALLHELD" in ctrl.log_path.read_text(),
               "the controller's members never parked")
        ctrl.send_signal(signal.SIGKILL)
        ctrl.wait(WAIT_S)
        pool = CrossProcessServingPool.takeover(
            workdir=tmp_path, port=port, lease_s=1.0, suspect_grace_s=1.0,
            spawn_timeout_s=WAIT_S)
        rep = pool.takeover_report
        assert rep["incarnation"] == 2
        assert rep["adopted_requests"] == 4
        assert rep["members_present"] == [0, 1]
        for s in (0, 1):
            pool.release_member(s)
        got = pool.wait_adopted(timeout_s=WAIT_S)
        prompts = seeded_prompts(4, 3, vocab=89)
        assert [got[rid]["status"] for rid in sorted(got)] == ["ok"] * 4
        assert [got[rid]["tokens"] for rid in sorted(got)] == \
            [oracle(p, 20) for p in prompts]
        assert pool.metrics.count("controller_takeovers") == 1
    finally:
        if pool is not None:
            pool.close()
        if ctrl.poll() is None:
            ctrl.kill()
            ctrl.wait()
        van.kill()
        van.wait()


def test_deaf_ack_plumbs_through_serving_pool(tmp_path, monkeypatch):
    """The serving pool can enable deaf-member detection (spawns patched
    out: this pins the constructor plumb, not member behavior)."""
    from hetu_tpu_torch.serve.crosshost import CrossProcessServingPool
    monkeypatch.setattr(CrossProcessServingPool, "_spawn",
                        lambda self, slots: None)
    monkeypatch.setattr(CrossProcessServingPool, "_wait_joined",
                        lambda self, slots, timeout_s=None: None)
    pool = CrossProcessServingPool(2, workdir=tmp_path, deaf_ack_s=1.5,
                                   start_poll=False)
    try:
        assert pool.svc.deaf_ack_s == 1.5
    finally:
        pool.close()


def test_replicated_tier_is_refused_by_name(tmp_path, monkeypatch):
    """``van_spec`` and ``MemberSpec.van`` do what the reference's do.  A
    malformed spec fails in the pool and in the member with the exception
    the reference's ``ReplicaSpec`` raises; ``own_van=True`` with a spec
    is refused; a well-formed spec over two van processes builds a pool
    whose blackboard and ledger are replicated (member spawns patched
    out), and an in-process member that binds its membership and its
    channels through the same pair."""
    from hetu_tpu.ps import replica as jrep
    from hetu_tpu_torch.ps import membership as mb
    from hetu_tpu_torch.ps import replica as rep
    from hetu_tpu_torch.ps import van
    from hetu_tpu_torch.serve.crosshost import MemberHarness, MemberSpec
    for bad in ({"endpoints": []}, {"x": 1}):
        with pytest.raises(Exception) as want:
            jrep.VanReplica.from_spec(bad)
        with pytest.raises(type(want.value)):
            CrossProcessServingPool(2, workdir=tmp_path, own_van=False,
                                    port=1, van_spec=bad)
        with pytest.raises(type(want.value)):
            MemberHarness(MemberSpec(port=1, slot=0, n_slots=1, submit_ch=1,
                                     event_ch=2, van=bad))
    ports = [free_port(), free_port()]
    vans = [spawn_shard_server(tmp_path, p, f"v{i}")
            for i, p in enumerate(ports)]
    spec = {"endpoints": [["127.0.0.1", p] for p in ports],
            "epoch_table": van.fresh_table_id(), "promote_after_s": 0.3,
            "rcv_timeout_s": 1.5}
    with pytest.raises(ValueError, match="own_van=False"):
        CrossProcessServingPool(2, workdir=tmp_path, van_spec=spec)
    monkeypatch.setattr(CrossProcessServingPool, "_spawn",
                        lambda self, slots: None)
    monkeypatch.setattr(CrossProcessServingPool, "_wait_joined",
                        lambda self, slots, timeout_s=None: None)
    pool = member = None
    try:
        pool = CrossProcessServingPool(1, workdir=tmp_path, own_van=False,
                                       port=ports[0], van_spec=spec,
                                       start_poll=False)
        r = pool._replica
        assert (r.incarnation, r.primary_idx) == (1, 0)
        assert isinstance(pool._bb, rep.ReplicatedPSTable)
        assert isinstance(pool._ledger._table, rep.ReplicatedPSTable)
        assert pool._van_spec["rendezvous"].endswith("van_pair.json")
        member = MemberHarness(MemberSpec(
            port=ports[0], slot=0, n_slots=1, submit_ch=11, event_ch=12,
            membership_table=pool._membership_table, model=TINY,
            van=r.current_spec()))
        assert member.replica is r  # one view of the pair a process
        assert member._gen() == (pool.svc.ctrl_incarnation, 1)
        assert type(member._in) is rep._replica_channel_cls()
        _until(lambda: pool.svc.poll() is not None and
               pool.svc.state_of(0).state == "alive",
               "the member never joined over the pair")
        rows = [van.RemotePSTable("127.0.0.1", p, 3, mb.MEMBER_DIM,
                                  table_id=pool._membership_table,
                                  create=False).dense_pull()
                for p in ports]
        assert rows[0][0].any()  # the member's row, on both vans
        assert rows[0][0].tobytes() == rows[1][0].tobytes()
    finally:
        if member is not None:
            member.close()
        if pool is not None:
            pool.close()
        for v in vans:
            v.kill()
            v.wait()


@pytest.mark.parametrize("err,served", [
    ("transport", True),   # a stop outlasted the get: poll on
    ("refused", False),    # the van refused the op: the member leaves
])
def test_member_command_loop_outlives_a_broken_get(err, served):
    """A member resumed from a stop finds its command get broken past the
    deadline (``BlobTransportError``): its command loop polls on and
    dispatches the next command.  Any other failed get ends the loop, as
    in the reference."""
    from hetu_tpu_torch.ps import van
    from hetu_tpu_torch.serve.crosshost import MemberHarness, MemberSpec

    class Chan:
        calls = []

        def get(self, seq, *, timeout_s):
            self.calls.append(seq)
            if len(self.calls) == 1:
                raise van.BlobTransportError("blob get failed (rc=-101)") \
                    if err == "transport" else \
                    RuntimeError("blob get failed (rc=-3)")
            return json.dumps({"cmd": "shutdown"}).encode()

    h = MemberHarness.__new__(MemberHarness)
    h.spec = MemberSpec(port=1, slot=0, n_slots=1, submit_ch=1, event_ch=2)
    h._van, h._stop, h._in = van, threading.Event(), Chan()
    # the generation is (controller incarnation, van incarnation); no
    # replicated tier here
    h.replica, h._ctrl_gen, h._van_gen = None, 1, 0
    h._in_gen = (1, 0)
    seen = []
    h._dispatch = lambda msg, allow_stale=False: seen.append(msg) or False
    h.close = h._stop.set
    h.run()
    assert h._stop.is_set()
    assert seen == ([{"cmd": "shutdown"}] if served else [])
    assert h._in.calls == ([1, 1] if served else [1])
