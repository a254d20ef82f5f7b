"""The port's replicated durable tier (``hetu_tpu_torch.ps.replica``) and
its standby controller (``hetu_tpu_torch.resilience.standby``) against
hetu_tpu's, on one van server in this process (the dead primary is an
unused port).

Mirrored from ``tests/test_van_replica.py``: the promotion CAS race (two
claimants, exactly one swap a round, x50), the counted race of four
claimants, two standbys racing the controller row's single-shot claim
(x50), the standby's watch loop (a beating controller holds it off,
silence promotes once), and the unknown plane refused.

Added: a port ``VanReplica`` and a reference one racing the promotion on
one van x50 (exactly one winner each round, counted in the two
packages' registries, and the epoch row bitwise the one either package
writes); ``ReplicaSpec.to_json`` byte-identical across the packages; the
wire-error classification of every failure the port's van raises; the
replica channel's ``VanFailover`` on a superseded incarnation (a fake
replica whose incarnation moves); ``tests/test_health.py``'s retired-
handle gauge; the ``mpmd`` plane invoking the pipeline supervisor's
takeover (a stub); ``run_once`` joining the claim's bridge thread before it returns (a
departure from the reference, whose bridge outlives the call).

Waits are joins with deadlines; the watch test runs on wall time (the
lease is defined on it) with margins of 3x or more.
"""

import os
import signal
import threading
import time

import numpy as np
import pytest

from hetu_tpu.ps import membership as jmb
from hetu_tpu.ps import replica as jrep
from hetu_tpu_torch import telemetry
from hetu_tpu_torch.ps import membership as mb
from hetu_tpu_torch.ps import replica as rep
from hetu_tpu_torch.ps import van
from hetu_tpu_torch.resilience.standby import StandbyController

JOIN_S = 30.0


@pytest.fixture(scope="module")
def inproc_van():
    port = van.serve(0)
    yield port
    van.stop()


def _replica_spec(port, *, dead_port=1, module=rep):
    """A spec whose PRIMARY endpoint is dead (an unused port) and whose
    backup is the live van — the post-mortem moment a promotion race
    starts from."""
    return module.ReplicaSpec(
        endpoints=[["127.0.0.1", int(dead_port)], ["127.0.0.1", port]],
        epoch_table=mb.fresh_table_id(), promote_after_s=0.05,
        rcv_timeout_s=1.0)


def _seed_epoch(port, spec, inc=1, primary=0):
    t = van.RemotePSTable("127.0.0.1", port, 1, rep.EPOCH_DIM,
                          table_id=spec.epoch_table, create=True,
                          init="zeros", optimizer="sgd", lr=0.0)
    row = np.zeros((1, rep.EPOCH_DIM), np.float32)
    row[0, rep.E_INC] = inc
    row[0, rep.E_PRIMARY] = primary
    t.sparse_set([0], row)
    t.close()


def _epoch_row(port, spec):
    t = van.RemotePSTable("127.0.0.1", port, 1, rep.EPOCH_DIM,
                          table_id=spec.epoch_table, create=False)
    try:
        return t.sparse_pull([0])[0]
    finally:
        t.close()


def _race(claimants, fn):
    """Run ``fn(c)`` for every claimant at one barrier; returns the
    results in finishing order."""
    barrier = threading.Barrier(len(claimants))
    out = []

    def run(c):
        barrier.wait()
        out.append(fn(c))

    ts = [threading.Thread(target=run, args=(c,)) for c in claimants]
    for t in ts:
        t.start()
    for t in ts:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in ts), "a claimant hung"
    return out


def test_promotion_race_exactly_one_winner_x50(inproc_van):
    """Two claimants race the promotion CAS x50: the loser ADOPTS the
    winner's incarnation from the same round trip, and both end on the
    same (incarnation, primary)."""
    for rnd in range(50):
        spec = _replica_spec(inproc_van)
        _seed_epoch(inproc_van, spec, inc=1, primary=0)
        reps = []
        for _ in range(2):
            r = rep.VanReplica(spec)  # direct: each claimant its own view
            r.incarnation, r.primary_idx = 1, 0
            reps.append(r)

        def claim(r):
            changed = r.promote()
            return changed, r.incarnation, r.primary_idx

        wins = _race(reps, claim)
        assert len(wins) == 2, rnd
        assert all(w == (True, 2, 1) for w in wins), (rnd, wins)
        assert int(_epoch_row(inproc_van, spec)[rep.E_INC]) == 2, rnd


def test_promotion_race_single_winner_counted(inproc_van):
    """Four claimants, one round: the van-side row advanced exactly one
    step (7 -> 8) despite four claims — a lost CAS never re-claims."""
    spec = _replica_spec(inproc_van)
    _seed_epoch(inproc_van, spec, inc=7, primary=0)
    reps = []
    for _ in range(4):
        r = rep.VanReplica(spec)
        r.incarnation, r.primary_idx = 7, 0
        reps.append(r)
    _race(reps, lambda r: r.promote())
    assert int(_epoch_row(inproc_van, spec)[rep.E_INC]) == 8
    assert all(r.incarnation == 8 and r.primary_idx == 1 for r in reps)


def _counts(registry):
    return (registry.counter("van.replica.promotions").value,
            registry.counter("van.replica.promotions_adopted").value)


def test_port_and_reference_replicas_race_one_winner_x50(inproc_van):
    """A port ``VanReplica`` and a reference one race the promotion on
    one van, x50: each round exactly one of the two swaps lands (the
    two packages' ``promotions`` counters move by one in all, the
    ``promotions_adopted`` counters by one), both adopt incarnation 2 at
    the backup, and the row on the van is bitwise the row either
    package writes (this process's pid, the dead primary's port as the
    new backup's)."""
    from hetu_tpu.telemetry import default_registry as jreg
    preg = telemetry.default_registry
    for rnd in range(50):
        spec = _replica_spec(inproc_van)
        _seed_epoch(inproc_van, spec, inc=1, primary=0)
        pr = rep.VanReplica(spec)
        jr = jrep.VanReplica(jrep.ReplicaSpec(**vars(spec)))
        for r in (pr, jr):
            r.incarnation, r.primary_idx = 1, 0
        before = [_counts(preg), _counts(jreg)]
        out = _race([pr, jr], lambda r: r.promote())
        after = [_counts(preg), _counts(jreg)]
        won = [a[0] - b[0] for a, b in zip(after, before)]
        adopted = [a[1] - b[1] for a, b in zip(after, before)]
        assert out == [True, True], rnd
        assert sorted(won) == [0, 1] and sorted(adopted) == [0, 1], \
            (rnd, won, adopted)
        assert won[0] + adopted[0] == 1 and won[1] + adopted[1] == 1, rnd
        assert (pr.incarnation, pr.primary_idx) == \
            (jr.incarnation, jr.primary_idx) == (2, 1), rnd
        want = np.zeros(rep.EPOCH_DIM, np.float32)
        want[rep.E_INC], want[rep.E_PRIMARY] = 2, 1
        want[rep.E_PID] = os.getpid() % (1 << 24)
        want[rep.E_BPORT] = 1
        assert _epoch_row(inproc_van, spec).tobytes() == want.tobytes(), rnd


def test_replica_spec_json_matches_the_reference():
    kw = {"endpoints": [["127.0.0.1", 4101], ["127.0.0.1", 4102]],
          "epoch_table": 0x1234567, "promote_after_s": 0.3,
          "rcv_timeout_s": 1.5, "revalidate_s": 0.05,
          "rendezvous": "/tmp/pair.json"}
    assert rep.ReplicaSpec(**kw).to_json() == jrep.ReplicaSpec(**kw).to_json()
    assert rep.ReplicaSpec().to_json() == jrep.ReplicaSpec().to_json()
    s = rep.ReplicaSpec(**kw).to_json()
    assert rep.ReplicaSpec.from_json(s) == rep.ReplicaSpec(**kw)
    assert rep.ReplicaSpec.from_dict(None) is None
    assert rep.ReplicaSpec.from_dict(kw) == rep.ReplicaSpec(**kw)
    assert (rep.E_INC, rep.E_PRIMARY, rep.E_PID, rep.E_BPORT,
            rep.EPOCH_DIM, rep.VAN_EPOCH_TABLE) == (
        jrep.E_INC, jrep.E_PRIMARY, jrep.E_PID, jrep.E_BPORT,
        jrep.EPOCH_DIM, jrep.VAN_EPOCH_TABLE)
    with pytest.raises(ValueError, match="2 endpoints"):
        rep.VanReplica(rep.ReplicaSpec(endpoints=[["127.0.0.1", 1]]))


_WIRE_CASES = [
    (ConnectionError("refused"), True),
    (ConnectionRefusedError(111, "refused"), True),
    (rep.VanFailover("promoted"), True),
    (rep.VanFenced("superseded"), True),
    (TimeoutError("blob get: seq 3 not delivered within 1s"), True),
    (RuntimeError("hetu_ps van_sparse_pull failed with rc=-101"), True),
    (van.BlobTransportError("blob get failed (rc=-101)"), True),
    (RuntimeError("blob put failed (rc=-3)"), False),
    (ValueError("desired row has 3 fields"), False),
    (NotImplementedError("van server does not speak OP_ROW_CAS"), False),
    (KeyError("x"), False),
]


@pytest.mark.parametrize("err,wire", _WIRE_CASES,
                         ids=[type(e).__name__ + ":" + str(e)[:24]
                              for e, _ in _WIRE_CASES])
def test_wire_error_classification(err, wire):
    """Each failure and its class; where the reference knows the
    exception, it classifies it alike (the port's blob transport error,
    whose text names no library, is the port's own)."""
    assert rep._is_wire_error(err) is wire
    if not isinstance(err, van.BlobTransportError):
        assert jrep._is_wire_error(err) is wire


def test_real_van_failures_are_wire_errors(tmp_path):
    """The failures the port's van really raises against a SIGKILLed
    server are all wire errors: a fail-fast table op (and the op after
    it, on the closed connection), a blob get, a fresh connect."""
    from hetu_tpu_torch.resilience.shardproc import (
        free_port, spawn_shard_server,
    )
    port = free_port()
    proc = spawn_shard_server(tmp_path, port, "victim")
    errs = []
    try:
        t = van.RemotePSTable("127.0.0.1", port, 4, 8, init="zeros",
                              rcv_timeout_s=1.0, reconnect=False)
        ch = van.BlobChannel("127.0.0.1", port, mb.fresh_table_id(),
                             connect_timeout_s=0.5, rcv_timeout_s=1.0)
        t.sparse_set([0], np.ones((1, 8), np.float32))
        proc.send_signal(signal.SIGKILL)
        proc.wait(JOIN_S)
        t0 = time.monotonic()
        for op in (lambda: t.sparse_pull([0]), lambda: t.sparse_pull([0]),
                   lambda: t.sparse_set([1], np.ones((1, 8), np.float32)),
                   lambda: ch.get(1, timeout_s=0.3),
                   lambda: van.RemotePSTable("127.0.0.1", port, 4, 8,
                                             connect_timeout_s=0.3)):
            with pytest.raises(Exception) as ei:
                op()
            errs.append(ei.value)
        # fail-fast: no connect deadline waited out on the table ops
        assert time.monotonic() - t0 < 5.0
        assert t.fd == -1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert all(rep._is_wire_error(e) for e in errs), errs


class _FakeReplica:
    """The surface a replica channel reads: an incarnation that moves
    when told, and a failover that only counts its calls."""

    def __init__(self):
        self.incarnation = 1
        self.failovers = 0

    def failover(self, err=None):
        self.failovers += 1
        return False


def test_replica_channel_raises_van_failover_on_a_superseded_incarnation(
        inproc_van):
    """A channel bound at incarnation 1 reconnects (and keeps working) while
    the incarnation holds; once it moves, an in-op reconnect — the one
    the port's late transport failure runs too — raises ``VanFailover``
    (rebind), not ``BlobTransportError``."""
    cls = rep._replica_channel_cls()
    fake = _FakeReplica()
    cid = mb.fresh_table_id()
    tx = cls("127.0.0.1", inproc_van, cid, connect_timeout_s=1.0)
    rx = cls("127.0.0.1", inproc_van, cid, connect_timeout_s=1.0)
    try:
        for ch in (tx, rx):
            ch._bind_replica(fake, 1.0)
        tx.put(b"one", 1)
        rx.reconnect()  # the same incarnation: a plain reconnect
        assert rx.get(1, timeout_s=5.0) == b"one"
        fake.incarnation = 2
        with pytest.raises(rep.VanFailover, match="incarnation 1"):
            rx.reconnect()
        with pytest.raises(rep.VanFailover):
            rx._transport_lost("get", -101)
        with pytest.raises(rep.VanFailover):
            tx._transport_lost("put", -101)
        assert fake.failovers == 0  # no reconnect failed: no dance
    finally:
        tx.close()
        rx.close()


def test_replica_channel_drives_the_dance_when_the_reconnect_fails():
    """A reconnect refused by a dead endpoint runs the replica's failover
    and raises the transport error once the wait is over."""
    from hetu_tpu_torch.resilience.shardproc import free_port
    cls = rep._replica_channel_cls()
    ch = cls.__new__(cls)  # a channel whose van has gone
    ch.host, ch.port, ch.id = "127.0.0.1", free_port(), 7
    ch._timeout_s, ch._rcv_timeout_s, ch.fd = 0.1, None, -1
    fake = _FakeReplica()
    ch._bind_replica(fake, 0.3)
    with pytest.raises(ConnectionError):
        ch.reconnect()
    assert fake.failovers >= 1 and ch.fd == -1


class _CloseSpy:
    """``van.lib`` with every ``ps_van_close`` recorded."""

    def __init__(self, lib):
        self._lib, self.closed = lib, []

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def ps_van_close(self, fd):
        self.closed.append(fd)
        self._lib.ps_van_close(fd)


def test_a_failed_reconnect_forgets_the_closed_descriptor(inproc_van,
                                                          monkeypatch):
    """A channel whose reconnect fails holds fd -1, not the number it
    closed: its later close closes nothing, where closing that number
    again could end a connection the kernel has since given it to."""
    from hetu_tpu_torch.resilience.shardproc import free_port
    spy = _CloseSpy(van.lib)
    monkeypatch.setattr(van, "lib", spy)
    ch = van.BlobChannel("127.0.0.1", inproc_van, mb.fresh_table_id(),
                         connect_timeout_s=1.0)
    old = ch.fd
    ch.port, ch._timeout_s = free_port(), 0.1  # its van has gone
    with pytest.raises(ConnectionError):
        ch.reconnect()
    assert ch.fd == -1 and spy.closed == [old]
    ch.close()
    assert spy.closed == [old]


def test_a_put_waiting_past_the_receive_timeout_does_not_wedge(inproc_van):
    """A put blocked on an unread slot for longer than the connection's
    receive timeout (the controller re-sending submits to a member still
    rebinding) waits on the server in slices: no transport failure, no
    resend whose parked copy re-stores the message after the reader acked
    it, and the next put and get go through."""
    cid = mb.fresh_table_id()
    tx = van.BlobChannel("127.0.0.1", inproc_van, cid, rcv_timeout_s=0.4)
    rx = van.BlobChannel("127.0.0.1", inproc_van, cid, rcv_timeout_s=0.4)
    reconnects = telemetry.default_registry.counter(
        "van.blob_channel.reconnects")
    before = reconnects.value
    try:
        tx.put(b"one", 1)
        t = threading.Thread(target=tx.put, args=(b"two", 2),
                             kwargs={"timeout_s": 10.0})
        t.start()
        time.sleep(1.0)  # the put outwaits the receive timeout 2.5x
        assert t.is_alive()
        assert rx.get(1, timeout_s=5.0) == b"one"
        t.join(JOIN_S)
        assert not t.is_alive()
        assert rx.get(2, timeout_s=5.0) == b"two"
        tx.put(b"three", 3, timeout_s=5.0)
        assert rx.get(3, timeout_s=5.0) == b"three"
        assert reconnects.value == before
    finally:
        tx.close()
        rx.close()


def test_retired_handle_gauge_returns_to_zero_after_grace():
    """``van.replica.floating_handles`` counts handles parked in the
    retire-grace window; after the grace lapses and a reaper pass runs,
    the gauge reads 0 again (``tests/test_health.py``'s test)."""
    class _H:
        closed = False

        def close(self):
            self.closed = True

    h = _H()
    rep.retire_handle(h, grace_s=0.05)
    g = telemetry.default_registry.gauge("van.replica.floating_handles")
    assert g.value >= 1.0
    assert not h.closed  # grace: a stale reference may still be inside
    assert rep._reap_retired(time.monotonic() + 0.1) >= 1
    assert h.closed
    assert g.value == 0.0


# ---------------------------------------------------------------------------
# standby-controller claim (the controller-row CAS, single-shot)
# ---------------------------------------------------------------------------

def _blackboard(port, n_slots=2):
    tid = mb.fresh_table_id()
    return mb.create_blackboard("127.0.0.1", port, table_id=tid,
                                n_slots=n_slots), tid


def test_two_standbys_exactly_one_promotes_x50(inproc_van):
    """Two standbys watching one silent controller row claim concurrently,
    x50 — exactly one wins each round, the loser reads the winner's
    incarnation and stands down FENCED."""
    for rnd in range(50):
        bb, _ = _blackboard(inproc_van)
        svc = mb.MembershipService(bb, 2, lease_s=10.0,
                                   suspect_grace_s=10.0)
        base_inc = svc.ctrl_incarnation
        sbs = [StandbyController(plane="serving", n_slots=2,
                                 lease_bound_s=0.0, table=bb,
                                 name=f"sb{i}") for i in range(2)]
        for sb in sbs:
            sb.observe()
            assert sb.ctrl_inc == base_inc
        results = _race(sbs, lambda sb: sb.try_claim())
        assert sorted(results) == [False, True], (rnd, results)
        assert all(sb.ctrl_inc == base_inc + 1 for sb in sbs), rnd
        bb.close()


def test_port_and_reference_standbys_one_promotes(inproc_van):
    """A port standby and a reference standby race the claim on one
    blackboard, x10: exactly one wins each round."""
    from hetu_tpu.resilience.standby import (
        StandbyController as JaxStandbyController,
    )
    for rnd in range(10):
        bb, _ = _blackboard(inproc_van)
        mb.MembershipService(bb, 2, lease_s=10.0, suspect_grace_s=10.0)
        sbs = [StandbyController(plane="serving", n_slots=2,
                                 lease_bound_s=0.0, table=bb),
               JaxStandbyController(plane="serving", n_slots=2,
                                    lease_bound_s=0.0, table=bb)]
        for sb in sbs:
            sb.observe()
        results = _race(sbs, lambda sb: sb.try_claim())
        assert sorted(results) == [False, True], (rnd, results)
        assert sbs[0].ctrl_inc == sbs[1].ctrl_inc, rnd
        bb.close()


def test_standby_watches_silence_then_claims(inproc_van):
    """The watch loop against a real blackboard: a beating controller
    holds the standby off; silence past the bound promotes exactly once
    (claim only: the takeover is replaced here; the plane's takeover
    runs with real processes in ``test_torch_vanchaos.py``)."""
    bb, _ = _blackboard(inproc_van)
    svc = mb.MembershipService(bb, 2, lease_s=10.0, suspect_grace_s=10.0)
    sb = StandbyController(plane="serving", n_slots=2, lease_bound_s=0.3,
                           poll_s=0.02, table=bb)
    try:
        # beating for 3x the bound: no claim
        deadline = time.monotonic() + 0.9
        while time.monotonic() < deadline:
            svc.poll()  # beats the controller row
            assert sb.run_once() is None
            time.sleep(0.02)
        inc_before = sb.ctrl_inc
        sb._invoke_takeover = lambda: "adopted-sentinel"
        assert sb.watch(timeout_s=10.0) == "promoted"
        assert sb.ctrl_inc == inc_before + 1
        assert sb.adopted == "adopted-sentinel"
        assert sb.promoted_at >= sb.detected_at
        # the claim is visible van-side: the zombie service now fences
        with pytest.raises(mb.ControllerFenced):
            svc.poll()
            svc.publish_control(epoch=2, width=2, alive_mask=3)
    finally:
        bb.close()


def test_standby_run_once_joins_its_bridge():
    """``run_once`` returns only after the claim's bridge thread has
    ended (a departure from the reference, which leaves it beating): a
    table whose ``row_cas`` sleeps sees no call in flight when
    ``run_once`` returns, and none starts afterwards, so the caller may
    close the table at once."""
    class SlowTable:
        def __init__(self):
            self.lock = threading.Lock()
            self.in_flight = 0
            self.calls = 0

        def sparse_pull(self, rows):
            return np.zeros((len(rows), mb.MEMBER_DIM), np.float32)

        def row_cas(self, row, col, expect, desired):
            with self.lock:
                self.in_flight += 1
                self.calls += 1
            time.sleep(0.15)
            with self.lock:
                self.in_flight -= 1
            return True, desired

    table = SlowTable()
    sb = StandbyController(plane="serving", n_slots=2, lease_bound_s=0.0,
                           table=table)
    # the takeover outlasts a few bridge beats
    sb._invoke_takeover = lambda: time.sleep(0.4) or "adopted"
    assert sb.run_once() == "promoted"
    with table.lock:
        assert table.in_flight == 0
        calls = table.calls
    assert calls >= 2  # the claim, then at least one bridge beat
    time.sleep(0.5)
    with table.lock:
        assert table.calls == calls and table.in_flight == 0


def test_standby_rejects_unknown_plane():
    with pytest.raises(ValueError, match="plane"):
        StandbyController(plane="nope", n_slots=1, table=object())


def test_standby_mpmd_plane_invokes_the_pipeline_takeover(monkeypatch):
    """``plane="mpmd"`` promotes into ``MPMDPipelineSupervisor.takeover``
    with the standby's workdir, port and takeover keywords, as the
    reference's standby does; the supervisor is a stub here and the
    blackboard an injected table whose claim always swaps."""
    from hetu_tpu_torch.parallel import mpmd_elastic

    class Table:
        def sparse_pull(self, rows):
            return np.zeros((len(rows), mb.MEMBER_DIM), np.float32)

        def row_cas(self, row, col, expect, desired):
            return True, desired

    calls = []

    def takeover(**kw):
        calls.append(kw)
        return "adopted pipeline"

    monkeypatch.setattr(mpmd_elastic.MPMDPipelineSupervisor, "takeover",
                        staticmethod(takeover))
    sb = StandbyController(plane="mpmd", workdir="/nonexistent", port=4321,
                           n_slots=3, lease_bound_s=0.0, table=Table(),
                           takeover_kwargs={"lease_s": 0.5})
    assert sb.run_once() == "promoted"
    assert sb.adopted == "adopted pipeline"
    assert calls == [{"workdir": "/nonexistent", "port": 4321,
                      "lease_s": 0.5}]
    assert sb.ctrl_inc == 1


def test_standby_claim_refuses_a_van_without_cas():
    """A van that cannot CAS cannot decide a single-shot race: the claim
    is refused rather than made un-fenced, as in the reference."""
    class NoCas:
        def row_cas(self, *a):
            raise NotImplementedError

    for cls in (StandbyController,
                __import__("hetu_tpu.resilience.standby",
                           fromlist=["x"]).StandbyController):
        sb = cls(plane="serving", n_slots=1, table=NoCas())
        with pytest.raises(RuntimeError, match="CAS"):
            sb.try_claim()


def test_membership_malformed_replica_fails_as_the_reference(tmp_path):
    """``_replica_of`` resolves through ``ReplicaSpec``: malformed specs
    fail with the reference's exception type."""
    for bad in ({"endpoints": []}, {"x": 1},
                {"endpoints": [["127.0.0.1", 1]]}):
        with pytest.raises(Exception) as want:
            jmb._replica_of(bad)
        with pytest.raises(type(want.value)):
            mb._replica_of(bad)
    assert mb._replica_of(None) is None and mb._replica_of({}) is None
