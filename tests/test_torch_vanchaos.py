"""The port's durable tier under van death, with real van processes on
the CPU (``hetu_tpu_torch.ps.replica``, ``serve.crosshost``'s replicated
branches, ``resilience.standby``), against hetu_tpu.

Members are OS processes of the reference's ``TINY`` GPT (V 89, H 48, 2
layers, 4 slots x 48, ``tests/test_vanchaos.py``), their weights drawn by
the port's ``build_engine`` from the spec's seed; the oracle is the
reference's ``ContinuousBatchingScheduler`` over its own engine on those
weights.  Mirrored from ``tests/test_vanchaos.py``:

* a seeded ``van_kill`` of the PRIMARY van while both members are held
  at a decode round: the backup is promoted (incarnation 2), the pool
  and its members rebind, every accepted request resolves ``ok`` and
  token-exact, and ``fault.van_kill`` pairs with ``van.promote``;
* a SIGSTOPped primary: promoted past it; after SIGCONT a stale handle
  idle through the outage raises ``VanFenced`` and its retry lands on
  the backup;
* a controller process SIGKILLed with a standby process watching: the
  standby self-promotes with no operator call and resolves every
  accepted request;
* two standby processes: exactly one promotes.

Added: a resilver, then a second kill of the promoted primary, at zero
loss (two rounds of ``tests/test_soak.py``'s campaign) with the pair
bitwise equal after each resilver; the delta ledger's compaction racing
the failover (``tests/test_delta_ledger.py``), read back by a port and a
reference takeover reader; ordered pushes through a synchronous
``ReplicatedPSTable`` leaving the backup bitwise equal to the primary
(the table-layer stand-in of the reference's elastic dual-write test);
and the promotion after a primary SIGKILL landing within
``promote_after_s + rcv_timeout_s`` plus 1.5 s, far under the 10 s
connect deadline a reconnecting handle would wait.

No sleep decides an outcome: a van kill lands while the members are
held at a decode round, and every wait is a join, an event or a poll
with a deadline of its own.  Only the lease, promotion and fence run on
wall time, as they are defined on it, with margins of 3x or more.
"""

import json
import signal
import subprocess
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from hetu_tpu.models.gpt import GPTConfig as JaxGPTConfig
from hetu_tpu.models.gpt import GPTModel as JaxGPTModel
from hetu_tpu.serve import ContinuousBatchingScheduler as JaxScheduler
from hetu_tpu.serve import Request as JaxRequest
from hetu_tpu.serve import ServeEngine as JaxServeEngine
from hetu_tpu_torch.ps import membership as mb
from hetu_tpu_torch.ps import replica as rep
from hetu_tpu_torch.ps.van import RemotePSTable
from hetu_tpu_torch.resilience import FaultEvent, FaultInjector, FaultSchedule
from hetu_tpu_torch.resilience.shardproc import (
    free_port, spawn_module, spawn_shard_server,
)
from hetu_tpu_torch.serve.crosshost import (
    CrossProcessServingPool, build_engine, seeded_prompts,
)
from hetu_tpu_torch.telemetry import timeline, trace

WAIT_S = 60.0
TINY = {"vocab_size": 89, "hidden_size": 48, "num_layers": 2,
        "num_heads": 4, "ffn_size": 96, "max_position": 64,
        "num_slots": 4, "max_len": 48, "min_bucket": 8, "seed": 1,
        "device": "cpu"}
MEMBER_ENV = {"OMP_NUM_THREADS": "1"}
PROMOTE_AFTER_S, RCV_TIMEOUT_S = 0.3, 1.5
PROMOTE_MARGIN_S = 1.5


@pytest.fixture(scope="module")
def oracle():
    """``ref(prompt, n)``: the reference's scheduler, over its own engine
    on the weights the port's members draw, memoized."""
    _, variables, _ = build_engine(TINY, device="cpu")
    cfg = JaxGPTConfig(vocab_size=89, hidden_size=48, num_layers=2,
                       num_heads=4, ffn_size=96, max_position=64,
                       dropout_rate=0.0)
    jv = {"params": _tree(jnp.asarray, variables["params"]), "state": {}}
    sched = JaxScheduler(JaxServeEngine(JaxGPTModel(cfg), jv, num_slots=4,
                                        max_len=48, min_bucket=8))
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


def _until(cond, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def _van_pair(tmp_path, **extra):
    ports = [free_port(), free_port()]
    vans = [spawn_shard_server(tmp_path, p, tag)
            for p, tag in zip(ports, ("prim", "back"))]
    spec = {"endpoints": [["127.0.0.1", p] for p in ports],
            "epoch_table": mb.fresh_table_id(),
            "promote_after_s": PROMOTE_AFTER_S,
            "rcv_timeout_s": RCV_TIMEOUT_S, **extra}
    return vans, ports, spec


def _reap(procs, workdir):
    for p in procs:
        if p is not None and p.poll() is None:
            try:
                p.send_signal(signal.SIGCONT)
            except Exception:
                pass
            p.kill()
            p.wait()
    subprocess.run(["pkill", "-9", "-f", str(workdir)],
                   capture_output=True, timeout=10)


def _stopped(pid):
    """Whether every thread of process ``pid`` is stopped (state T): a
    SIGSTOP is delivered asynchronously, and a van thread can still answer
    a request after ``kill`` returns."""
    import glob

    try:
        states = [open(path).read().rsplit(")", 1)[1].split()[0]
                  for path in glob.glob(f"/proc/{int(pid)}/task/*/stat")]
    except OSError:
        return False
    return bool(states) and all(st == "T" for st in states)


def _pool(tmp_path, port, spec, **kw):
    return CrossProcessServingPool(
        2, workdir=tmp_path, model=TINY, own_van=False, port=port,
        van_spec=spec, lease_s=1.0, suspect_grace_s=1.0, scrape_s=0.0,
        member_env=MEMBER_ENV, request_timeout_s=120.0, **kw)


def _held_van_kill(pool, fire, prompts, n, rebinds):
    """Park both members at their next decode round with ``prompts`` in
    flight, ``fire()`` the van kill while they are parked, wait for the
    promotion and the pool's rebind, then release; returns the resolved
    requests."""
    for s in (0, 1):
        pool.hold_member(s)
    reqs = [pool.submit(p, max_tokens=n, timeout_s=120.0) for p in prompts]
    for s in (0, 1):
        pool.hold_member(s, after=1)
    for s in sorted({r.member for r in reqs}):
        assert pool.wait_held([s], timeout_s=WAIT_S), f"member {s} unparked"
    inc = pool._replica.incarnation
    fire()
    _until(lambda: pool._replica.incarnation == inc + 1,
           "the backup was never promoted")
    _until(lambda: pool.metrics.count("van_rebinds") >= rebinds,
           "the pool never rebound its channels")
    for s in (0, 1):
        pool.release_member(s)
    for r in reqs:
        assert r.done.wait(WAIT_S), f"request {r.rid} never resolved"
    return reqs


def _pair_equal(replica, timeout=10.0):
    """Every table this process opened over the pair holds bitwise equal
    rows and optimizer slots on the primary and the backup.  Members and
    the controller beat every few tens of ms, and a beat can land between
    the two reads: each table is read again until one read of both vans
    agrees, within ``timeout``; a lasting difference fails.  Returns the
    tables compared."""
    tables = [t for t in list(replica._tables) if t.replicate]

    def snapshot(t, idx):
        h = RemotePSTable(*replica.endpoints[idx], t.rows, t.dim,
                          table_id=t.id, create=False)
        try:
            return (h.dense_pull().tobytes(),
                    *(a.tobytes() for a in h.slots_get(np.arange(t.rows))))
        finally:
            h.close()

    for t in tables:
        _until(lambda: snapshot(t, replica.backup_idx) ==
               snapshot(t, replica.primary_idx),
               f"table {t.id:#x} differs between the vans", timeout)
    return len(tables)


def _fire(schedule, victim):
    """The kill through the injector: every step of ``schedule`` up to
    its van_kill's; the victim is dead when it returns."""
    def fire():
        inj = FaultInjector(schedule, van_procs=[victim])
        step = next(e.step for e in schedule.events if e.kind == "van_kill")
        for s in range(1, step + 1):
            inj.on_step(s)
        assert inj.counters["van_procs_killed"] == 1
        victim.wait(WAIT_S)
    return fire


def test_vankill_serving_promotes_zero_loss_token_exact(tmp_path, oracle):
    """A seeded primary-van SIGKILL while both members are parked mid-
    decode: the backup is promoted (incarnation 2, primary 1), every
    accepted request resolves 'ok' token-exact, the unresolved submits
    were re-sent after the rebind, and fault.van_kill pairs with
    van.promote on the controller's timeline."""
    vans, ports, spec = _van_pair(tmp_path)
    sched = FaultSchedule.generate(steps=8, seed=5, van_kills=1, n_vans=1)
    assert [e.kind for e in sched.events] == ["van_kill"]
    tracer = trace.Tracer()
    trace.enable(tracer=tracer)
    pool = None
    prompts = [[1, 2, 3], [9, 8, 7, 6], [42, 5], [3, 14, 15, 9],
               [7, 7, 7], [2, 30, 4], [11, 12], [5, 6, 7, 8]]
    try:
        pool = _pool(tmp_path, ports[0], spec)
        assert pool._replica.incarnation == 1
        reqs = _held_van_kill(pool, _fire(sched, vans[0]), prompts, 8,
                              rebinds=1)
        assert [r.status for r in reqs] == ["ok"] * len(prompts)
        assert (pool._replica.incarnation, pool._replica.primary_idx) == \
            (2, 1)
        assert pool.port == ports[1]
        assert pool.metrics.count("van_rebind_resent") >= 1
        for p, r in zip(prompts, reqs):
            assert list(r.tokens) == oracle(p, 8), r.rid
        # the pool serves on after the failover
        resp = pool.generate([5, 6, 7], max_tokens=5, timeout_s=WAIT_S)
        assert resp["status"] == "ok" and resp["tokens"] == \
            oracle([5, 6, 7], 5)
        dump = pool.fleet_metrics(timeout_s=WAIT_S).dump()
        assert "ctrl.van.replica.incarnation" in dump
    finally:
        trace.disable()
        if pool is not None:
            pool.close()
        _reap(vans, tmp_path)
    pairs = [p for p in timeline.correlate(tracer.events)
             if p.kind == "van_kill"]
    assert len(pairs) == 1 and pairs[0].paired, pairs
    assert pairs[0].recovery_name == "van.promote"


def test_resilver_then_second_kill_zero_loss(tmp_path, oracle):
    """Two rounds of the sequential campaign: each kills the CURRENT
    primary (from round 2 on, the van round 1 promoted) while the members
    are parked; every request resolves 'ok' token-exact, the automatic
    resilver restores a redundant pair (not degraded, lag 0, every open
    table bitwise equal on both vans) before the next round."""
    vans, ports, spec = _van_pair(tmp_path, revalidate_s=0.05,
                                  resilver_settle_s=0.2)
    procs = list(vans)
    by_port = dict(zip(ports, vans))

    def fresh_backup(_rep):
        port = free_port()
        proc = spawn_shard_server(tmp_path, port, f"rsv{port}")
        procs.append(proc)
        by_port[port] = proc
        return ("127.0.0.1", port)

    tracer = trace.Tracer()
    trace.enable(tracer=tracer)
    pool = None
    rng = np.random.default_rng(23)
    try:
        pool = _pool(tmp_path, ports[0], spec,
                     van_backup_factory=fresh_backup)
        r = pool._replica
        for rnd in (1, 2):
            victim_port = r.primary[1]
            prompts = [list(map(int, rng.integers(1, 89, rng.integers(2, 5))))
                       for _ in range(4)]
            kill = FaultSchedule([FaultEvent(1, "van_kill", 0.0)])
            reqs = _held_van_kill(pool, _fire(kill, by_port[victim_port]),
                                  prompts, 8, rebinds=rnd)
            assert [q.status for q in reqs] == ["ok"] * 4, rnd
            for p, q in zip(prompts, reqs):
                assert list(q.tokens) == oracle(p, 8), (rnd, q.rid)
            _until(lambda: not r.degraded, f"round {rnd}: never re-silvered")
            assert r.incarnation == rnd + 1 and r.primary[1] != victim_port
            assert r.export_lag() == 0
            assert len(procs) == 2 + rnd  # one fresh backup a round
            assert _pair_equal(r) == 2, rnd  # the blackboard, the ledger
        resp = pool.generate([5, 6, 7], max_tokens=5, timeout_s=WAIT_S)
        assert resp["status"] == "ok" and resp["tokens"] == \
            oracle([5, 6, 7], 5)
    finally:
        trace.disable()
        if pool is not None:
            pool.close()
        _reap(procs, tmp_path)
    resilvers = [e for e in tracer.events if e.get("name") == "van.resilver"
                 and e.get("args", {}).get("ok")]
    assert len(resilvers) >= 2, len(resilvers)


def test_vansuspend_resumed_primary_is_fenced(tmp_path):
    """SIGSTOP the primary: receive timeouts surface the hang and the
    backup promotes; after SIGCONT the resumed old primary carries the
    fence row, a stale handle idle through the outage raises VanFenced
    on its next write, and its retry lands on the backup."""
    vans, ports, spec = _van_pair(tmp_path, rcv_timeout_s=1.0)
    try:
        rspec = rep.ReplicaSpec.from_dict(spec)
        r1 = rep.VanReplica(rspec)
        r1.bootstrap()
        tid = mb.fresh_table_id()
        t = r1.table(4, 8, table_id=tid, create=True, sync=True,
                     init="zeros", optimizer="sgd", lr=0.0)
        row = np.arange(8, dtype=np.float32).reshape(1, -1)
        t.sparse_set([0], row)
        # an independent view bound to the old primary, idle throughout
        r2 = rep.VanReplica(rspec)
        r2.incarnation, r2.primary_idx = 1, 0
        t2 = r2.table(4, 8, table_id=tid, create=False, sync=True)
        vans[0].send_signal(signal.SIGSTOP)
        _until(lambda: _stopped(vans[0].pid), "the primary never stopped")
        deadline = time.monotonic() + WAIT_S
        while True:
            try:
                t.sparse_set([1], row * 3)
                break
            except (ConnectionError, TimeoutError, RuntimeError):
                assert time.monotonic() < deadline, "never promoted"
                time.sleep(0.05)
        assert (r1.incarnation, r1.primary_idx) == (2, 1)
        vans[0].send_signal(signal.SIGCONT)

        def fenced():
            # the resumed van may take a while to answer: "not yet"
            try:
                h = RemotePSTable("127.0.0.1", ports[0], 1, rep.EPOCH_DIM,
                                  table_id=rspec.epoch_table, create=False,
                                  connect_timeout_s=1.0, rcv_timeout_s=1.0,
                                  reconnect=False)
            except ConnectionError:
                return False
            try:
                return int(h.sparse_pull([0])[0][rep.E_INC]) >= 2
            except RuntimeError:
                return False
            finally:
                h.close()
        _until(fenced, "the fence never reached the resumed primary")
        with pytest.raises(rep.VanFenced):
            t2.sparse_set([2], row * 9)
        assert r2.primary_idx == 1  # re-targeted by the fence
        t2.sparse_set([2], row * 9)
        assert t.sparse_pull([2])[0].tobytes() == (row[0] * 9).tobytes()
        for h in (t, t2):
            h.close()
    finally:
        _reap(vans, tmp_path)


def test_promotion_after_a_primary_kill_is_bounded(tmp_path):
    """A write retried through a replicated table after a primary SIGKILL
    is promoted onto the backup within ``promote_after_s +
    rcv_timeout_s`` plus 1.5 s: the replica's handles fail fast instead of
    waiting out the 10 s connect deadline of a reconnecting handle."""
    vans, ports, spec = _van_pair(tmp_path)
    try:
        r = rep.VanReplica(rep.ReplicaSpec.from_dict(spec))
        r.bootstrap()
        t = r.table(4, 8, table_id=mb.fresh_table_id(), create=True,
                    sync=True, init="zeros", optimizer="sgd", lr=0.0)
        row = np.ones((1, 8), np.float32)
        t.sparse_set([0], row)
        vans[0].kill()
        vans[0].wait(WAIT_S)
        t0 = time.monotonic()
        while True:
            try:
                t.sparse_set([1], row)
                break
            except (ConnectionError, RuntimeError):
                assert time.monotonic() - t0 < WAIT_S
                time.sleep(0.01)
        took = time.monotonic() - t0
        assert r.incarnation == 2
        assert took < PROMOTE_AFTER_S + RCV_TIMEOUT_S + PROMOTE_MARGIN_S, took
        assert t.sparse_pull([0, 1]).tobytes() == \
            np.ones((2, 8), np.float32).tobytes()
        t.close()
    finally:
        _reap(vans, tmp_path)


def test_a_write_after_the_resilver_reaches_the_fresh_backup(tmp_path):
    """A write whose backup half failed (the backup van died, or a write
    raced the resilver's endpoint swap) arms the table's 1 s negative
    cache; a resilver onto a fresh van inside that second ends it at the
    cutover, so the next write — a row written once, as the ledger's
    appends are — lands on both vans."""
    vans, ports, spec = _van_pair(tmp_path)
    fresh = free_port()
    vans.append(spawn_shard_server(tmp_path, fresh, "fresh"))
    try:
        r = rep.VanReplica(rep.ReplicaSpec.from_dict(spec))
        r.bootstrap()
        t = r.table(8, 4, table_id=mb.fresh_table_id(), create=True,
                    sync=True, init="zeros", optimizer="sgd", lr=0.0)
        row = np.ones((1, 4), np.float32)
        t.sparse_set([0], row)
        vans[1].kill()
        vans[1].wait(WAIT_S)
        t.sparse_set([1], row * 2)  # the backup half fails: cache armed
        assert time.monotonic() < t._backup_down_until
        begin = t._begin_catchup

        def begin_rearmed():
            # a write that raced the endpoint swap re-arms the cache
            # after the resilver dropped the old handles
            t._backup_down_until = time.monotonic() + 1.0
            begin()
        t._begin_catchup = begin_rearmed
        assert r.resilver(("127.0.0.1", fresh), settle_s=0.0)
        t.sparse_set([2], row * 3)  # once, inside the armed second
        h = RemotePSTable("127.0.0.1", fresh, 8, 4, table_id=t.id,
                          create=False)
        got = h.dense_pull()
        h.close()
        assert got.tobytes() == t.dense_pull().tobytes()
        assert got[2].tobytes() == (row[0] * 3).tobytes()
        t.close()
    finally:
        _reap(vans, tmp_path)


_ACCEPT_SRC = """\
import signal, sys, time
sys.path.insert(0, {repo!r})
# a handler interrupts a blocking call (no SA_RESTART); every thread but
# the van's accept thread blocks the signal, so it lands there
signal.signal(signal.SIGUSR1, lambda *a: None)
signal.pthread_sigmask(signal.SIG_BLOCK, {{signal.SIGUSR1}})
from hetu_tpu_torch.ps import binding, van
binding.load()
signal.pthread_sigmask(signal.SIG_UNBLOCK, {{signal.SIGUSR1}})
port = van.serve({port})
signal.pthread_sigmask(signal.SIG_BLOCK, {{signal.SIGUSR1}})
print("READY", port, flush=True)
time.sleep(600)
"""


def test_a_van_accepts_after_an_interrupted_accept(tmp_path):
    """The van's accept loop survives an ``accept()`` a signal interrupts
    (EINTR, as some kernels return after a SIGSTOP and SIGCONT): signals
    land in the accept thread of a van process, and a fresh client is
    still served.  The root source's loop ended at the first failed
    accept, and the van then answered nobody (seen on the card)."""
    import os

    from hetu_tpu_torch.resilience.shardproc import spawn_ready
    port = free_port()
    proc = spawn_ready(tmp_path, "accept", _ACCEPT_SRC, port=port)
    try:
        for _ in range(3):
            os.kill(proc.pid, signal.SIGUSR1)
            time.sleep(0.05)
        t = RemotePSTable("127.0.0.1", port, 2, 4, init="zeros",
                          connect_timeout_s=5.0, rcv_timeout_s=5.0)
        assert t.ping()
        t.sparse_set([1], np.ones((1, 4), np.float32))
        assert t.sparse_pull([1]).tobytes() == \
            np.ones((1, 4), np.float32).tobytes()
        t.close()
        assert proc.poll() is None
    finally:
        _reap([proc], tmp_path)


def test_ordered_pushes_keep_the_backup_bitwise(tmp_path):
    """The table-layer durability claim: one writer's ordered optimizer
    pushes (sparse and dense, Adam) through a synchronous
    ``ReplicatedPSTable`` leave the backup's rows and slots bitwise the
    primary's — the state a promotion would serve is the state that was
    lost."""
    vans, ports, spec = _van_pair(tmp_path)
    try:
        r = rep.VanReplica(rep.ReplicaSpec.from_dict(spec))
        r.bootstrap()
        rows, dim = 32, 8
        t = r.table(rows, dim, table_id=mb.fresh_table_id(), create=True,
                    sync=True, init="normal", init_b=0.1, seed=7,
                    optimizer="adam", lr=0.01)
        g = np.random.default_rng(0)
        for step in range(12):
            ids = g.integers(0, rows, 10)
            t.sparse_push(ids, g.standard_normal((10, dim),
                                                 dtype=np.float32))
            if step % 4 == 3:
                t.dense_push(g.standard_normal((rows, dim),
                                               dtype=np.float32))
        ids = np.arange(rows)
        got = []
        for p in ports:
            h = RemotePSTable("127.0.0.1", p, rows, dim, table_id=t.id,
                              create=False)
            got.append((h.dense_pull(), *h.slots_get(ids)))
            h.close()
        for a, b in zip(*got):
            assert a.tobytes() == b.tobytes()
        assert np.asarray(got[0][3]).max() > 0  # Adam's steps moved
        t.close()
    finally:
        _reap(vans, tmp_path)


class _WireFault:
    """A backup handle whose next write fails as a broken transport."""

    fd = 1

    def sparse_set(self, *a, **k):
        raise RuntimeError("hetu_ps van_sparse_set failed with rc=-101")


def test_a_backup_write_that_failed_is_replayed_in_order(tmp_path):
    """A write whose backup half fails while the backup is live (a
    transient fault, not a dead van: the write and its one retry both
    fail) is owed, not dropped.  Writes inside the 1 s negative cache
    queue behind it, and with no later write to carry them the table's
    flusher replays them in order: the backup ends bitwise the primary,
    header row and append-only rows alike, as a delta ledger's are."""
    vans, ports, spec = _van_pair(tmp_path)
    reg = rep._reg()
    try:
        r = rep.VanReplica(rep.ReplicaSpec.from_dict(spec))
        r.bootstrap()
        t = r.table(8, 4, table_id=mb.fresh_table_id(), create=True,
                    sync=True, init="zeros", optimizer="sgd", lr=0.0)
        row = np.ones((1, 4), np.float32)
        t.sparse_set([0], row)
        owed0 = reg.counter("van.replica.owed_writes").value
        replayed0 = reg.counter("van.replica.owed_replayed").value
        build = t._build_handle
        t._handles[r.backup_idx] = _WireFault()
        t._build_handle = lambda *a, **k: None  # the retry's rebuild fails
        t.sparse_set([0, 1], np.concatenate([row * 2, row * 3]))
        t._build_handle = build
        t.sparse_set([0, 2], np.concatenate([row * 4, row * 5]))
        t.sparse_set([0, 3], np.concatenate([row * 6, row * 7]))

        def backup():
            h = RemotePSTable("127.0.0.1", ports[r.backup_idx], 8, 4,
                              table_id=t.id, create=False)
            try:
                return h.dense_pull()
            finally:
                h.close()
        assert backup()[1:4].tobytes() == bytes(48)  # owed, not there yet
        assert reg.counter("van.replica.owed_writes").value - owed0 == 3
        _until(lambda: backup().tobytes() == t.dense_pull().tobytes(),
               "the owed writes never reached the backup", 10.0)
        assert backup()[0].tobytes() == (row[0] * 6).tobytes()
        assert reg.counter("van.replica.owed_replayed").value - \
            replayed0 == 3
        t.close()
    finally:
        _reap(vans, tmp_path)


def _replay(got):
    """Base requests + accept/resolve deltas -> the final request set
    (``tests/test_delta_ledger.py``'s replay)."""
    reqs = dict((got["state"].get("requests") or {}))
    resolved = dict((got["state"].get("resolved") or {}))
    for d in got["deltas"]:
        if "a" in d:
            reqs[str(int(d["a"][0]))] = {"msg": d["a"][1]}
        elif "r" in d:
            reqs.pop(str(int(d["r"][0])), None)
            resolved[str(int(d["r"][0]))] = d["r"][1]
    return reqs, resolved


def test_compaction_racing_van_failover_restores_exact_request_set(
        tmp_path):
    """A compaction issued while the primary van is already dead rides
    the promotion (the append path's retry ladder drives the CAS) and
    lands atomically on the promoted backup; takeover readers of both
    packages, built directly (the per-process cache would share this
    writer's view), replay the exact request set before and after
    post-compaction appends."""
    from hetu_tpu.ps import membership as jmb
    from hetu_tpu.ps import replica as jrep
    vans, ports, spec = _van_pair(tmp_path, promote_after_s=0.1,
                                  revalidate_s=0.05)
    try:
        r = rep.VanReplica.from_spec(spec, bootstrap=True)
        tid = mb.fresh_table_id()
        led = mb.DeltaLedger(replica=r, table_id=tid, rows=64, dim=16)
        inflight = {}
        for i in range(1, 9):
            inflight[str(i)] = {"prompt": [i]}
            led.append({"a": [i, {"prompt": [i]}]}, ctrl_inc=1)
        led.append({"r": [3, "ok"]}, ctrl_inc=1)
        del inflight["3"]
        want = set(inflight)
        vans[0].kill()
        vans[0].wait(WAIT_S)
        led.compact({"requests": dict(inflight)}, ctrl_inc=1)
        assert r.incarnation == 2 and r.primary[1] == ports[1]

        def takeover_read(module, mbmod):
            r2 = module.VanReplica(module.ReplicaSpec.from_dict(spec))
            r2.refresh()
            l2 = mbmod.DeltaLedger(replica=r2, table_id=tid, rows=64,
                                   dim=16, create=False)
            try:
                return l2.read()
            finally:
                l2.close()

        for module, mbmod in ((rep, mb), (jrep, jmb)):
            got = takeover_read(module, mbmod)
            assert got["compactions"] == 1 and got["deltas"] == []
            assert set(_replay(got)[0]) == want
        led.append({"a": [9, {"prompt": [9]}]}, ctrl_inc=1)
        led.append({"r": [5, "ok"]}, ctrl_inc=1)
        want = (want - {"5"}) | {"9"}
        reads = [takeover_read(m, b) for m, b in ((rep, mb), (jrep, jmb))]
        assert reads[0] == reads[1]
        final, resolved = _replay(reads[0])
        assert set(final) == want and "5" in resolved
        led.close()
    finally:
        _reap(vans, tmp_path)


# ---------------------------------------------------------------------------
# standby processes
# ---------------------------------------------------------------------------

def _controller(tmp_path, port, spec=None, n_requests=6):
    cfg = {"workdir": str(tmp_path), "port": port, "n_members": 2,
           "model": TINY, "n_requests": n_requests, "prompt_seed": 2,
           "max_tokens": 10, "submit_gap_s": 0.15, "hold_s": 600.0,
           "lease_s": 0.5, "suspect_grace_s": 0.4,
           "member_env": MEMBER_ENV, "van": spec}
    path = Path(tmp_path) / "ctrl.json"
    path.write_text(json.dumps(cfg))
    return spawn_module(tmp_path, "ctrl", "hetu_tpu_torch.serve.crosshost",
                        ["--controller", str(path)], extra_env=MEMBER_ENV,
                        timeout_s=WAIT_S)


def _standby(tmp_path, port, tag, **extra):
    path = Path(tmp_path) / f"{tag}.json"
    path.write_text(json.dumps({
        "workdir": str(tmp_path), "port": port, "plane": "serving",
        "lease_bound_s": 1.2, "poll_s": 0.05, "hold_s": 30.0,
        "takeover_kwargs": {"lease_s": 0.5, "suspect_grace_s": 0.4},
        **extra}))
    return spawn_module(tmp_path, tag, "hetu_tpu_torch.resilience.standby",
                        [str(path)], extra_env=MEMBER_ENV, timeout_s=WAIT_S)


def _log(proc):
    return Path(proc.log_path).read_text(errors="replace")


def test_standby_self_promotes_on_controller_kill(tmp_path, oracle):
    """A controller process over a replicated van pair is SIGKILLed after
    at least 3 accepts, a standby process watching: it self-promotes (no
    operator call), adopts the fleet and resolves every accepted request
    'ok'; the standby and the members load no jax."""
    vans, ports, spec = _van_pair(tmp_path)
    ctrl = standby = None
    try:
        ctrl = _controller(tmp_path, ports[0], spec)
        _until(lambda: _log(ctrl).count("ACCEPTED") >= 3,
               "the controller accepted fewer than 3 requests")
        standby = _standby(tmp_path, ports[0], "standby")
        _until(lambda: "WATCHING" in _log(standby), "the standby never "
                                                    "watched")
        ctrl.kill()
        ctrl.wait(WAIT_S)
        accepted = _log(ctrl).count("ACCEPTED")
        assert accepted >= 3
        _until(lambda: "ALLDONE" in _log(standby) or "FENCED" in
               _log(standby) or standby.poll() is not None,
               "the standby never finished", 2 * WAIT_S)
        log = _log(standby)
        assert "READY jax=0" in log
        assert "PROMOTED" in log and "ALLDONE" in log, log[-2000:]
        line = next(ln for ln in log.splitlines()
                    if ln.startswith("RESOLVED"))
        statuses = json.loads(line.split(" ", 1)[1])
        for rid in range(1, accepted + 1):
            assert statuses.get(str(rid)) == "ok", (rid, statuses)
        for m in Path(tmp_path).glob("member_*.log"):
            assert "jax=0" in m.read_text()
    finally:
        _reap([*vans, ctrl, standby], tmp_path)


def test_two_standby_processes_exactly_one_wins(tmp_path):
    """Two standby processes watch one dying controller: exactly one
    promotes and finishes the adoption; the other either loses the CAS
    (exits FENCED, rc 3) or watches the winner's beats and never claims
    (its watch budget lapses: TIMEOUT, rc 2)."""
    port = free_port()
    van = spawn_shard_server(tmp_path, port, "v")
    ctrl = None
    standbys = []
    try:
        ctrl = _controller(tmp_path, port, n_requests=4)
        _until(lambda: "ACCEPTED" in _log(ctrl), "nothing accepted")
        standbys = [_standby(tmp_path, port, f"standby{i}", hold_s=60.0,
                             watch_timeout_s=8.0) for i in range(2)]
        _until(lambda: all("WATCHING" in _log(s) for s in standbys),
               "a standby never watched")
        ctrl.kill()
        ctrl.wait(WAIT_S)
        _until(lambda: any("ALLDONE" in _log(s) for s in standbys),
               "no standby finished", 2 * WAIT_S)
        winner = next(s for s in standbys if "ALLDONE" in _log(s))
        loser = next(s for s in standbys if s is not winner)
        _until(lambda: loser.poll() is not None,
               "the losing standby never stood down", 2 * WAIT_S)
        logs = [_log(s) for s in standbys]
        assert sum("PROMOTED" in lg for lg in logs) == 1, \
            [lg[-800:] for lg in logs]
        if "FENCED" in _log(loser):
            assert loser.returncode == 3
        else:
            assert "TIMEOUT" in _log(loser) and loser.returncode == 2
    finally:
        _reap([van, ctrl, *standbys], tmp_path)
