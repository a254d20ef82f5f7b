"""The port's membership plane (``hetu_tpu_torch.ps.membership``) against
hetu_tpu's on the CPU.

Mirrored, on numpy fake tables (no van, no process):

* the 10 fast tests of ``tests/test_crosshost_serve.py`` (the lease
  machine, the mask, ``control_rpc``, the ``MemberSpec`` round trip);
* ``tests/test_netem.py``'s membership and ``control_rpc`` tests
  (probe-failed against beats-stopped suspicion, deaf members, the named
  and bounded ``control_rpc`` timeout);
* ``tests/test_ctrlchaos.py``'s claim, fence, zombie, stale-row, silence
  and snapshot-ledger tests;
* ``tests/test_delta_ledger.py``'s 8 other fast tests, and its torn-state
  property held deterministically: the reader and the writer interleave
  at chosen points of the fake table's pulls, so no scheduling decides
  it.

Added: a port ``MembershipService`` with a reference ``MembershipClient``
and the reverse on one fake table, all four pairings leaving the same
rows bit for bit; ledgers written by one package and read by the other,
the tables bitwise equal; ``replica=`` failing on a malformed spec as
the reference does, and building a replicated blackboard and ledger over
two van processes.

The lease machine runs on a fake clock (``time`` in the membership
module replaced): silences are advanced, not slept, with margins of 3x
or more against the lease and the grace.
"""

import threading
import types

import numpy as np
import pytest

from hetu_tpu.ps import membership as jmb
from hetu_tpu_torch.ps import membership as mb


class FakeClock:
    """Stands in for the ``time`` module of a membership module: its
    ``monotonic`` is advanced by hand, and ``sleep`` advances it."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def sleep(self, s):
        self.now += max(float(s), 0.0)

    def advance(self, s):
        self.now += float(s)


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    fake = types.SimpleNamespace(monotonic=c.monotonic, sleep=c.sleep,
                                 time=c.monotonic)
    monkeypatch.setattr(mb, "time", fake)
    return c


class FakeTable:
    """In-memory stand-in for the blackboard's RemotePSTable surface;
    ``down`` makes its pulls fail (the controller side of an asymmetric
    partition).  A lock makes each set and pull atomic like the van
    server's per-table mutex."""

    def __init__(self, rows, dim=mb.MEMBER_DIM):
        self.rows = np.zeros((rows, dim), np.float32)
        self.down = False
        self._mu = threading.Lock()

    def sparse_set(self, idx, vals):
        with self._mu:
            self.rows[np.asarray(idx, int)] = np.asarray(vals, np.float32)

    def sparse_pull(self, idx):
        if self.down:
            raise ConnectionError("injected: controller link down")
        with self._mu:
            return self.rows[np.asarray(idx, int)].copy()


def _beat(table, slot, inc, beat, *, flag=1.0, committed=0.0,
          epoch_ack=0.0, healthy=1.0):
    row = np.zeros((1, mb.MEMBER_DIM), np.float32)
    row[0, mb.F_INCARNATION] = inc
    row[0, mb.F_BEAT] = beat
    row[0, mb.F_FLAG] = flag
    row[0, mb.F_HEALTHY] = healthy
    row[0, mb.F_COMMITTED] = committed
    row[0, mb.F_EPOCH_ACK] = epoch_ack
    table.sparse_set([slot], row)


def _svc(n=2, lease=1.0, grace=1.0, **kw):
    t = FakeTable(n + 2)
    return t, mb.MembershipService(t, n, lease_s=lease,
                                   suspect_grace_s=grace, **kw)


# ------------------------------------------ mirrors: test_crosshost_serve

def test_join_and_steady_beats_stay_alive(clock):
    t, svc = _svc()
    _beat(t, 0, 7, 1)
    assert svc.poll() == [("join", 0)]
    for b in range(2, 5):
        clock.advance(0.2)
        _beat(t, 0, 7, b)
        assert svc.poll() == []
        assert svc.state_of(0).state == "alive"
    assert svc.alive_slots() == [0]


def test_suspend_then_resume_clears_without_loss_or_rejoin(clock):
    """Silence shorter than lease+grace goes suspect and CLEARS — never
    lost, never rejoined."""
    t, svc = _svc(lease=1.0, grace=9.0)
    _beat(t, 0, 7, 1)
    svc.poll()
    clock.advance(3.0)  # 3x the lease: beats stopped (SIGSTOP lookalike)
    assert svc.poll() == [("suspect", 0)]
    assert svc.alive_slots() == []          # no NEW work routed at it
    assert svc.present_slots() == [0]       # but it still counts as mesh
    _beat(t, 0, 7, 2)                       # resumed: same incarnation
    assert svc.poll() == [("clear", 0)]
    assert svc.state_of(0).state == "alive"
    assert svc.poll() == []  # no late lost/rejoin materializes


def test_silence_past_grace_is_lost_then_new_incarnation_rejoins(clock):
    t, svc = _svc()
    _beat(t, 0, 7, 1)
    svc.poll()
    clock.advance(3.0)
    assert svc.poll() == [("suspect", 0)]
    clock.advance(3.0)
    assert svc.poll() == [("lost", 0)]
    # the SAME incarnation resurfacing after lost is a zombie: ignored
    _beat(t, 0, 7, 2)
    assert svc.poll() == []
    assert svc.state_of(0).state == "lost"
    # a NEW incarnation is the rejoin
    _beat(t, 0, 8, 1)
    assert svc.poll() == [("rejoin", 0)]
    assert svc.state_of(0).state == "alive"


def test_clean_leave_is_not_grieved(clock):
    t, svc = _svc()
    _beat(t, 0, 7, 1)
    svc.poll()
    _beat(t, 0, 7, 2, flag=0.0)
    assert svc.poll() == [("left", 0)]
    clock.advance(10.0)
    assert svc.poll() == []  # no suspect/lost for a member that left


def test_new_incarnation_in_live_slot_reports_lost_then_rejoin(clock):
    t, svc = _svc()
    _beat(t, 0, 7, 1)
    svc.poll()
    _beat(t, 0, 9, 1)  # restarted faster than one poll
    assert svc.poll() == [("lost", 0), ("rejoin", 0)]


def test_mask_roundtrip():
    slots = [0, 3, 5]
    assert mb.MembershipService.slots_of(
        mb.MembershipService.mask_of(slots)) == slots
    assert mb.MembershipService.mask_of(slots) == \
        jmb.MembershipService.mask_of(slots)


def test_control_rpc_retries_transient_then_succeeds(clock):
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("transient")
        return "ok"

    assert mb.control_rpc(flaky, attempts=4, base_s=0.001) == "ok"
    assert len(calls) == 3


def test_control_rpc_nontransient_raises_immediately(clock):
    calls = []

    def bug():
        calls.append(1)
        raise ValueError("real bug")

    with pytest.raises(ValueError):
        mb.control_rpc(bug, attempts=5, base_s=0.001)
    assert len(calls) == 1


def test_control_rpc_exhausts_attempts(clock):
    def always():
        raise TimeoutError("down")

    with pytest.raises(TimeoutError):
        mb.control_rpc(always, attempts=3, base_s=0.001,
                       is_transient=lambda e: True)


def test_member_spec_roundtrip():
    from hetu_tpu.serve.crosshost import MemberSpec as JaxMemberSpec
    from hetu_tpu_torch.serve.crosshost import MemberSpec
    spec = MemberSpec(port=1234, slot=1, n_slots=2, submit_ch=10,
                      event_ch=11, model={"seed": 3})
    assert MemberSpec.from_json(spec.to_json()) == spec
    # the spawn config keeps the reference's keys: either package reads
    # the other's
    assert JaxMemberSpec.from_json(spec.to_json()).to_json() == \
        spec.to_json()


# -------------------------------------------------- mirrors: test_netem

def test_probe_failure_suspects_but_never_grieves(clock):
    """The controller's OWN pull failing is 'my probe failed', not
    'their beats stopped': members degrade to suspect(probe_failed), the
    silence clocks freeze, and however long the blindness lasts nothing
    is lost on that evidence."""
    t, svc = _svc(lease=1.0, grace=1.0, rpc_deadline_s=0.1)
    _beat(t, 0, 7, 1)
    _beat(t, 1, 9, 1)
    assert sorted(svc.poll()) == [("join", 0), ("join", 1)]
    _beat(t, 0, 7, 2)
    _beat(t, 1, 9, 2)
    svc.poll()
    t.down = True
    assert sorted(svc.poll()) == [("suspect", 0), ("suspect", 1)]
    assert svc.state_of(0).suspect_reason == "probe_failed"
    assert svc.alive_slots() == []          # blind: stop routing
    assert sorted(svc.present_slots()) == [0, 1]  # but nobody kicked
    clock.advance(10.0)  # far past lease+grace if it counted
    assert svc.poll() == []  # still blind, still silent, still no loss
    t.down = False
    _beat(t, 0, 7, 3)  # slot 0 was beating all along
    evs = svc.poll()
    assert ("clear", 0) in evs
    assert ("lost", 1) not in evs  # slot 1 judged on OBSERVED silence
    assert svc.state_of(0).state == "alive"
    assert svc.probe_failures == 2
    assert svc.probe_blind_s >= 10.0
    # slot 1 really is silent now: observed silence escalates normally
    assert svc.state_of(1).suspect_reason == "beats_stopped"
    clock.advance(3.0)
    _beat(t, 0, 7, 4)
    assert svc.poll() == [("lost", 1)]


def test_beats_stopped_still_escalates_to_lost(clock):
    t, svc = _svc(n=1)
    _beat(t, 0, 5, 1)
    svc.poll()
    clock.advance(3.0)
    assert svc.poll() == [("suspect", 0)]
    assert svc.state_of(0).suspect_reason == "beats_stopped"
    clock.advance(3.0)
    assert svc.poll() == [("lost", 0)]


def test_deaf_member_suspected_then_cleared_on_ack(clock):
    t, svc = _svc(lease=100.0, grace=100.0, deaf_ack_s=1.0)
    _beat(t, 0, 7, 1, epoch_ack=0)
    _beat(t, 1, 9, 1, epoch_ack=0)
    assert sorted(svc.poll()) == [("join", 0), ("join", 1)]
    svc.publish_control(epoch=3, width=2, alive_mask=3)
    # inside the bound: behind on acks is not yet deafness
    _beat(t, 0, 7, 2, epoch_ack=3)   # slot 0 hears and acks
    _beat(t, 1, 9, 2, epoch_ack=0)   # slot 1's ingress is cut
    assert svc.poll() == []
    clock.advance(3.0)               # past deaf_ack_s
    _beat(t, 0, 7, 3, epoch_ack=3)
    _beat(t, 1, 9, 3, epoch_ack=0)
    assert svc.poll() == [("suspect", 1)]
    assert svc.state_of(1).suspect_reason == "deaf"
    assert svc.alive_slots() == [0]          # unroutable
    assert sorted(svc.present_slots()) == [0, 1]  # but never kicked
    for b in (4, 5, 6):  # beats flow: neither clear nor lost
        _beat(t, 1, 9, b, epoch_ack=0)
        assert svc.poll() == []
        assert svc.state_of(1).state == "suspect"
    _beat(t, 1, 9, 7, epoch_ack=3)  # the ingress heals
    assert svc.poll() == [("clear", 1)]
    assert svc.state_of(1).state == "alive"
    assert svc.state_of(1).suspect_reason is None


def test_deaf_member_never_lost_while_beating_even_past_grace(clock):
    t, svc = _svc(lease=3.0, grace=0.2, deaf_ack_s=0.3)
    _beat(t, 0, 7, 1, epoch_ack=0)
    _beat(t, 1, 9, 1, epoch_ack=0)
    svc.poll()
    svc.publish_control(epoch=2, width=2, alive_mask=3)
    clock.advance(1.0)
    _beat(t, 0, 7, 2, epoch_ack=2)
    _beat(t, 1, 9, 2, epoch_ack=0)
    assert svc.poll() == [("suspect", 1)]
    beat = 3
    for _ in range(10):
        # many polls land between two beats; the grace elapses each time
        for _ in range(4):
            assert svc.poll() == []
            clock.advance(0.2)
        _beat(t, 0, 7, beat, epoch_ack=2)
        _beat(t, 1, 9, beat, epoch_ack=0)
        beat += 1
    assert svc.state_of(1).state == "suspect"
    assert svc.state_of(1).suspect_reason == "deaf"
    assert svc.poll() == []  # absorb the last beat
    clock.advance(9.0)  # 3x the lease: reclassified to beats_stopped
    _beat(t, 0, 7, 99, epoch_ack=2)
    assert svc.poll() == []
    assert svc.state_of(1).suspect_reason == "beats_stopped"
    clock.advance(0.6)  # 3x the (restarted) grace
    _beat(t, 0, 7, 100, epoch_ack=2)
    assert svc.poll() == [("lost", 1)]


def test_fresh_joiner_is_not_instantly_deaf(clock):
    t, svc = _svc(lease=100.0, grace=100.0, deaf_ack_s=1.0)
    _beat(t, 0, 7, 1, epoch_ack=0)
    svc.poll()
    svc.publish_control(epoch=2, width=2, alive_mask=3)
    _beat(t, 0, 7, 2, epoch_ack=2)
    svc.poll()
    clock.advance(3.0)           # well past deaf_ack_s since publication
    _beat(t, 1, 9, 1, epoch_ack=0)   # the replacement joins only NOW
    assert svc.poll() == [("join", 1)]
    _beat(t, 1, 9, 2, epoch_ack=0)   # first beat advance, ack pending
    assert svc.poll() == []    # inside ITS OWN window: not deaf yet
    assert svc.state_of(1).state == "alive"
    clock.advance(3.0)           # its window elapses without an ack
    _beat(t, 1, 9, 3, epoch_ack=0)
    assert svc.poll() == [("suspect", 1)]
    assert svc.state_of(1).suspect_reason == "deaf"


def test_deaf_detection_disabled_by_default(clock):
    t, svc = _svc(n=1, lease=100.0, grace=100.0)
    _beat(t, 0, 5, 1, epoch_ack=0)
    assert svc.poll() == [("join", 0)]
    svc.publish_control(epoch=4, width=1, alive_mask=1)
    clock.advance(10.0)
    _beat(t, 0, 5, 2, epoch_ack=0)   # never acks; still fine
    assert svc.poll() == []
    assert svc.state_of(0).state == "alive"


def test_deaf_clock_starts_at_epoch_publication(clock):
    t, svc = _svc(n=1, lease=100.0, grace=100.0, deaf_ack_s=1.0)
    _beat(t, 0, 5, 1, epoch_ack=0)
    svc.poll()
    svc.publish_control(epoch=2, width=1, alive_mask=1)
    clock.advance(3.0)
    # same epoch re-published (a set_slow-style rewrite): no clock reset
    svc.publish_control(epoch=2, width=1, alive_mask=1, phase=1)
    _beat(t, 0, 5, 2, epoch_ack=0)
    assert svc.poll() == [("suspect", 0)]
    assert svc.state_of(0).suspect_reason == "deaf"


def test_control_rpc_names_op_and_link_on_exhaustion(clock):
    def always():
        raise ConnectionError("wire down")

    with pytest.raises(mb.MembershipWireError) as ei:
        mb.control_rpc(always, attempts=3, base_s=0.001,
                       op="heartbeat", link="member0->van")
    msg = str(ei.value)
    assert "heartbeat" in msg and "member0->van" in msg
    assert "3 attempts" in msg
    assert isinstance(ei.value.__cause__, ConnectionError)


def test_control_rpc_wall_clock_cap(clock):
    """deadline_s bounds TOTAL wall-clock (attempts + backoff)."""
    calls = []

    def always():
        calls.append(clock.now)
        raise ConnectionError("drop")

    t0 = clock.now
    with pytest.raises(mb.MembershipWireError):
        mb.control_rpc(always, attempts=50, base_s=0.2, max_s=5.0,
                       deadline_s=0.3, link="member1->van")
    assert clock.now - t0 <= 0.3 + 1e-9


# ------------------------------------------------ mirrors: test_ctrlchaos

def _bb(n=2):
    return FakeTable(n + 2)


def test_claim_is_monotonic_and_beats_ride_poll():
    t = _bb()
    svc = mb.MembershipService(t, 2, lease_s=10.0, suspect_grace_s=10.0)
    assert svc.ctrl_incarnation == 1
    row = t.sparse_pull([3])[0]
    assert int(row[mb.R_CINC]) == 1
    beat0 = int(row[mb.R_CBEAT])
    svc.poll()
    svc.poll()
    assert int(t.sparse_pull([3])[0][mb.R_CBEAT]) > beat0


def test_takeover_fences_the_old_controller():
    t = _bb()
    old = mb.MembershipService(t, 2, lease_s=10.0, suspect_grace_s=10.0)
    old.publish_control(epoch=1, width=2, alive_mask=3)
    new = mb.MembershipService(t, 2, lease_s=10.0, suspect_grace_s=10.0)
    assert new.ctrl_incarnation == old.ctrl_incarnation + 1
    with pytest.raises(mb.ControllerFenced):
        old.publish_control(epoch=2, width=2, alive_mask=3)
    assert old.fenced
    with pytest.raises(mb.ControllerFenced):
        old.poll()  # fenced once = fenced forever
    new.publish_control(epoch=2, width=2, alive_mask=3)
    assert new.poll() == []
    assert not new.fenced
    assert int(t.sparse_pull([2])[0][mb.C_CTRL_INC]) == \
        new.ctrl_incarnation


def test_zombie_poll_detects_fence_before_acting():
    t = _bb()
    old = mb.MembershipService(t, 2, lease_s=0.01, suspect_grace_s=0.01)
    old.publish_control(epoch=1, width=2, alive_mask=3)
    new = mb.MembershipService(t, 2, lease_s=10.0, suspect_grace_s=10.0)
    beat_row = t.sparse_pull([3])[0].copy()
    with pytest.raises(mb.ControllerFenced):
        old.poll()
    # the zombie's poll wrote NO controller beat over the new owner's
    np.testing.assert_array_equal(t.sparse_pull([3])[0], beat_row)
    assert new.poll() == []


def test_member_client_rejects_stale_control_rows():
    t = _bb()
    svc = mb.MembershipService(t, 2, lease_s=10.0, suspect_grace_s=10.0)
    svc2 = mb.MembershipService(t, 2, lease_s=10.0, suspect_grace_s=10.0)
    svc2.publish_control(epoch=5, width=2, alive_mask=3)
    client = mb.MembershipClient(slot=0, n_slots=2, table=t)
    assert client.read_control()[0] == 5
    assert client.ctrl_inc == svc2.ctrl_incarnation
    row = np.zeros((1, mb.MEMBER_DIM), np.float32)
    row[0, mb.C_EPOCH] = 99
    row[0, mb.C_CTRL_INC] = svc.ctrl_incarnation  # the superseded one
    t.sparse_set([2], row)
    assert client.read_control()[0] == 5  # stale write ignored
    assert client.stale_control_reads == 1


def test_member_detects_controller_silence_and_recovery(clock):
    t = _bb()
    svc = mb.MembershipService(t, 2, lease_s=10.0, suspect_grace_s=10.0)
    svc.publish_control(epoch=1, width=2, alive_mask=3)
    client = mb.MembershipClient(slot=0, n_slots=2, table=t)
    client.read_control()
    assert not client.controller_silent(1.0)
    clock.advance(3.0)  # no polls: the controller row froze
    client.read_control()
    assert client.controller_silent(1.0)
    assert not client.controller_silent(None)  # disabled = never silent
    svc.poll()  # the controller beats again (same incarnation)
    client.read_control()
    assert not client.controller_silent(1.0)
    clock.advance(3.0)  # a TAKEOVER beat (new incarnation) also unparks
    client.read_control()
    assert client.controller_silent(1.0)
    mb.MembershipService(t, 2, lease_s=10.0, suspect_grace_s=10.0)
    client.read_control()
    assert not client.controller_silent(1.0)


def _snap_ledger(module, rows=64, dim=8, table=None):
    return module.ControllerLedger(table=table or FakeTable(rows, dim),
                                   rows=rows, dim=dim)


def test_ledger_roundtrip_version_and_empty_read():
    led = _snap_ledger(mb)
    assert led.read() is None  # never written
    state = {"requests": {"7": {"msg": {"prompt": [1, 2, 3]},
                                "member": 1, "retries": 0}},
             "drains": {}, "rid": 7}
    v1 = led.write(state, ctrl_inc=3)
    got = led.read()
    assert got["state"] == state
    assert got["version"] == v1 == 1
    assert got["ctrl_inc"] == 3
    assert led.write({"rid": 8}, ctrl_inc=3) == 2
    assert led.read()["state"] == {"rid": 8}  # a shrink reads clean


def test_ledger_write_is_fenced():
    led = _snap_ledger(mb)
    led.write({"a": 1}, ctrl_inc=5)
    with pytest.raises(mb.ControllerFenced):
        led.write({"a": 2}, ctrl_inc=4)  # the zombie's snapshot
    assert led.read()["state"] == {"a": 1}
    led.write({"a": 3}, ctrl_inc=6)  # the successor clobbers freely
    assert led.read()["ctrl_inc"] == 6


def test_ledger_rejects_oversize_snapshot():
    led = _snap_ledger(mb, rows=4)
    assert led.capacity_bytes() == 48
    with pytest.raises(ValueError, match="capacity"):
        led.write({"blob": "x" * 200}, ctrl_inc=1)


def test_ledger_roundtrips_non_ascii_and_odd_lengths():
    led = _snap_ledger(mb)
    for state in ({"s": "abc"}, {"s": "abcd"}, {"s": "π∂η"},
                  {}, {"n": [1, 2, 3], "f": 1.5}):
        led.write(state, ctrl_inc=1)
        assert led.read()["state"] == state


# --------------------------------------------- mirrors: test_delta_ledger

def _ledger(rows=64, dim=16, module=mb, **kw):
    return module.DeltaLedger(table=FakeTable(rows, dim), rows=rows,
                              dim=dim, **kw)


def _fresh_reader(led, module=mb, table=None):
    """A takeover-style second handle on the SAME table."""
    return module.DeltaLedger(table=table or led._table, rows=led.rows,
                              dim=led.dim, base_rows=led.base_rows,
                              create=False)


def _replay(got):
    """Base requests + accept/resolve deltas → the final request set."""
    reqs = dict((got["state"].get("requests") or {}))
    resolved = dict((got["state"].get("resolved") or {}))
    for d in got["deltas"]:
        if "a" in d:
            reqs[str(int(d["a"][0]))] = {"msg": d["a"][1]}
        elif "r" in d:
            reqs.pop(str(int(d["r"][0])), None)
            resolved[str(int(d["r"][0]))] = d["r"][1]
    return reqs, resolved


def test_append_read_roundtrip_and_fresh_reader():
    led = _ledger()
    led.append({"a": [1, {"prompt": [1, 2, 3], "s": "π∂η"}]}, ctrl_inc=1)
    led.append([{"o": [1, 0, 0]}, {"r": [1, "ok"]}], ctrl_inc=1)
    got = led.read()
    assert got["state"] == {}
    assert len(got["deltas"]) == 3
    assert got["deltas"][0]["a"][1]["s"] == "π∂η"
    assert _fresh_reader(led).read()["deltas"] == got["deltas"]


def test_uninitialized_table_reads_none():
    led = mb.DeltaLedger(table=FakeTable(64, 16), rows=64, dim=16,
                         create=False)
    assert led.read() is None


def test_append_is_o_delta_not_o_inflight():
    import json

    from hetu_tpu_torch.telemetry import default_registry
    led = _ledger(rows=4096, dim=32)
    state = {"requests": {str(i): {"msg": {"prompt": list(range(8))}}
                          for i in range(300)}}
    led.compact(state, ctrl_inc=1)
    c = default_registry.counter("ledger.delta_bytes")
    before = c.value
    led.append({"a": [1000, {"prompt": [1, 2, 3]}]}, ctrl_inc=1)
    per_accept = c.value - before
    state_bytes = len(json.dumps(state).encode())
    assert per_accept <= 4 * led.dim * 4, per_accept
    assert per_accept * 10 < state_bytes, (per_accept, state_bytes)


def test_sustained_accepts_past_snapshot_cliff_zero_refusals():
    led = _ledger(rows=128, dim=16)
    inflight, resolved, compactions, journaled = {}, {}, 0, 0
    for i in range(1, 1200):
        rec = {"a": [i, {"prompt": list(range(10))}]}
        inflight[str(i)] = {"msg": rec["a"][1]}
        recs = [rec]
        if len(inflight) > 6:
            rid = min(inflight, key=int)
            del inflight[rid]
            resolved[rid] = "ok"
            while len(resolved) > 16:
                resolved.pop(min(resolved, key=int))
            recs.append({"r": [int(rid), "ok"]})
        state = {"requests": dict(inflight), "resolved": dict(resolved)}
        try:
            led.append(recs, ctrl_inc=1)
        except mb.LedgerCompactionNeeded:
            led.compact(state, ctrl_inc=1)
            led.append(recs, ctrl_inc=1)
            compactions += 1
        journaled += sum(len(str(r)) for r in recs)
    assert journaled > 64 * 1024
    assert compactions >= 3
    reqs, _ = _replay(led.read())
    assert set(reqs) == set(inflight)


def test_takeover_mid_compaction_restores_exact_request_set():
    led = _ledger(rows=64, dim=16)
    inflight = {}
    for i in range(1, 9):
        inflight[str(i)] = {"msg": {"prompt": [i]}}
        led.append({"a": [i, {"prompt": [i]}]}, ctrl_inc=1)
    led.append({"r": [3, "ok"]}, ctrl_inc=1)
    del inflight["3"]
    want = set(inflight)
    before, _ = _replay(_fresh_reader(led).read())
    assert set(before) == want
    led.compact({"requests": dict(inflight)}, ctrl_inc=1)
    after, _ = _replay(_fresh_reader(led).read())
    assert set(after) == want
    led.append({"a": [9, {"prompt": [9]}]}, ctrl_inc=1)
    got, _ = _replay(_fresh_reader(led).read())
    assert set(got) == want | {"9"}


class _Interleaved:
    """The reader's view of a table: before the reader's k-th pull it
    runs one step of the writer when ``pattern[k % len(pattern)]``."""

    def __init__(self, table, writer_step, pattern):
        self.table = table
        self.step = writer_step
        self.pattern = pattern
        self.k = 0

    def sparse_set(self, idx, vals):
        self.table.sparse_set(idx, vals)

    def sparse_pull(self, idx):
        if self.pattern[self.k % len(self.pattern)]:
            self.step()
        self.k += 1
        return self.table.sparse_pull(idx)


def _writer_ops(led, n=400):
    """The reference test's writer as a generator: one ledger frame a
    step, recording the request set after each."""
    inflight = {}
    for i in range(1, n):
        inflight[str(i)] = {"msg": {"p": [i]}}
        if len(inflight) > 5:
            rid = min(inflight, key=int)
            del inflight[rid]
            try:
                led.append({"r": [int(rid), "ok"]}, ctrl_inc=1)
                yield frozenset(k for k in inflight if k != str(i))
            except mb.LedgerCompactionNeeded:
                # the new base already holds request i
                led.compact({"requests": dict(inflight)}, ctrl_inc=1)
                yield frozenset(inflight)
        try:
            led.append({"a": [i, {"p": [i]}]}, ctrl_inc=1)
        except mb.LedgerCompactionNeeded:
            led.compact({"requests": dict(inflight)}, ctrl_inc=1)
        yield frozenset(inflight)


@pytest.mark.parametrize("pattern", [(True,), (False, True),
                                     (True, False, False),
                                     (False, False, True)],
                         ids=["every_pull", "between_probe_and_read",
                              "before_probe", "every_third"])
def test_concurrent_reader_never_sees_torn_state(pattern):
    """A writer appends and compacts while a reader replays, the two
    interleaved at fixed points of the reader's pulls: every read that
    returns decodes cleanly to a request set the writer had after one of
    its frames, never earlier than the last read's."""
    led = _ledger(rows=64, dim=16)
    history = [frozenset()]
    ops = _writer_ops(led)
    done = []

    def step():
        if done:
            return
        try:
            history.append(next(ops))
        except StopIteration:
            done.append(True)

    reader = _fresh_reader(led, table=_Interleaved(led._table, step,
                                                   pattern))
    seen, last, busy = 0, 0, 0
    while not done:
        try:
            got = reader.read()
        except RuntimeError as e:  # the writer never paused: allowed
            assert "quiescent" in str(e)
            busy += 1
            continue
        if got is None:
            continue
        reqs, _ = _replay(got)
        at = [j for j, h in enumerate(history) if h == frozenset(reqs)]
        assert at, f"a torn state: {sorted(reqs, key=int)}"
        assert max(at) >= last
        last = max(at)
        seen += 1
    assert seen >= 20, (seen, busy)
    assert led.compactions >= 3
    reqs, _ = _replay(_fresh_reader(led).read())
    assert max(int(k) for k in reqs) == 399


def test_append_is_fenced_and_successor_geometry_adopted():
    led = _ledger()
    led.append({"a": [1, {}]}, ctrl_inc=5)
    zombie = _fresh_reader(led)
    zombie.read()
    led.append({"a": [2, {}]}, ctrl_inc=7)  # the successor writes
    with pytest.raises(mb.ControllerFenced):
        zombie.append({"a": [3, {}]}, ctrl_inc=5)
    led.append({"a": [4, {}]}, ctrl_inc=7)
    assert len(led.read()["deltas"]) == 3


def test_compact_rejects_oversize_base():
    led = _ledger(rows=32, dim=8)
    with pytest.raises(ValueError, match="base capacity"):
        led.compact({"blob": "x" * 4096}, ctrl_inc=1)


def test_needs_compaction_margin():
    led = _ledger(rows=64, dim=16)
    assert not led.needs_compaction()
    while True:
        try:
            led.append({"a": [1, {"p": list(range(12))}]}, ctrl_inc=1)
        except mb.LedgerCompactionNeeded:
            break
    assert led.needs_compaction(margin_rows=1)


# ---------------------------------------------------------------- added

def _script(svc_mod, client_mod):
    """One scripted lifetime of a two-slot blackboard: a controller of
    ``svc_mod`` and two members of ``client_mod`` (fixed incarnations),
    joins, beats, a control publish, a leave, a takeover.  Returns the
    table's rows, the events and what the clients read."""
    t = _bb(2)
    svc = svc_mod.MembershipService(t, 2, lease_s=100.0,
                                    suspect_grace_s=100.0)
    svc.publish_control(epoch=1, width=2, alive_mask=0)
    a = client_mod.MembershipClient(slot=0, n_slots=2, table=t,
                                    incarnation=4242)
    b = client_mod.MembershipClient(slot=1, n_slots=2, table=t,
                                    incarnation=77)
    reads = [a.read_control(), b.read_control()]
    a.join(epoch_ack=1.0)
    b.join(epoch_ack=1.0, load=3.0)
    events = svc.poll()
    a.heartbeat(load=2.0, committed=17.0, epoch_ack=1.0)
    b.heartbeat(healthy=False, epoch_ack=1.0)
    events += svc.poll()
    svc.publish_control(epoch=2, width=2,
                        alive_mask=svc.mask_of(svc.present_slots()),
                        resume_step=5, phase=1)
    reads += [a.read_control(), b.read_control()]
    b.leave()
    events += svc.poll()
    new = svc_mod.MembershipService(t, 2, lease_s=100.0,
                                    suspect_grace_s=100.0)
    new.publish_control(epoch=3, width=2, alive_mask=1)
    reads += [a.read_control(), (a.ctrl_inc, a.stale_control_reads)]
    states = [(m.state, m.incarnation, m.load, m.healthy, m.committed,
               m.epoch_ack) for m in svc.members]
    return t.rows.copy(), events, reads, states


def test_blackboard_rows_are_bitwise_equal_across_packages():
    """Port controller + reference members, reference controller + port
    members, and each package alone: the same script leaves the same
    blackboard bit for bit, the same events and the same reads."""
    runs = {(s.__name__, c.__name__): _script(s, c)
            for s in (mb, jmb) for c in (mb, jmb)}
    rows0, ev0, reads0, states0 = runs[(mb.__name__, mb.__name__)]
    assert [e for e in ev0] == [("join", 0), ("join", 1), ("left", 1)]
    assert states0[0][0] == "alive" and states0[1][0] == "left"
    for key, (rows, ev, reads, states) in runs.items():
        assert rows.tobytes() == rows0.tobytes(), key
        assert ev == ev0, key
        assert reads == reads0, key
        assert states == states0, key


def _ledger_frames(module, table):
    led = module.DeltaLedger(table=table, rows=64, dim=16)
    led.append({"a": [1, {"prompt": [5, 6, 7], "tenant": "π∂η"}]},
               ctrl_inc=3)
    led.append([{"o": [1, 0, 0]}, {"a": [2, {"prompt": [9]}]}],
               ctrl_inc=3)
    led.compact({"rid": 2, "requests": {"2": {"msg": {"prompt": [9]},
                                              "member": None,
                                              "retries": 0}}},
                ctrl_inc=4)
    led.append({"r": [2, "ok"]}, ctrl_inc=4)
    snap = module.ControllerLedger(table=FakeTable(32, 8), rows=32, dim=8)
    snap.write({"rid": 9, "s": "odd"}, ctrl_inc=2)
    return led, snap


def test_ledgers_written_by_one_package_decode_in_the_other():
    tp, tj = FakeTable(64, 16), FakeTable(64, 16)
    led_p, snap_p = _ledger_frames(mb, tp)
    led_j, snap_j = _ledger_frames(jmb, tj)
    assert tp.rows.tobytes() == tj.rows.tobytes()
    assert snap_p._table.rows.tobytes() == snap_j._table.rows.tobytes()
    want = led_p.read()
    got_ref = _fresh_reader(led_p, module=jmb).read()
    got_port = _fresh_reader(led_j, module=mb).read()
    for k in ("state", "deltas", "ctrl_inc", "compactions"):
        assert got_ref[k] == want[k] == got_port[k], k
    assert jmb.ControllerLedger(table=snap_p._table, rows=32,
                                dim=8).read() == snap_p.read()
    assert mb.ControllerLedger(table=snap_j._table, rows=32,
                               dim=8).read() == snap_j.read()


def test_replicated_tier_is_refused_by_name(tmp_path):
    """``replica=`` does what the reference's does.  A malformed spec
    (no endpoints, an unknown key) fails with the exception the
    reference's ``ReplicaSpec`` raises for the same arguments; a
    well-formed one over two van processes builds a replicated
    blackboard (create and attach) and delta ledger whose writes land
    on both vans, bitwise."""
    from hetu_tpu_torch.ps import replica as rep
    from hetu_tpu_torch.ps.van import RemotePSTable
    from hetu_tpu_torch.resilience.shardproc import (
        free_port, spawn_shard_server,
    )
    calls = [
        lambda m, r: m.create_blackboard("127.0.0.1", 1, table_id=1,
                                         n_slots=2, replica=r),
        lambda m, r: m.attach_blackboard("127.0.0.1", 1, table_id=1,
                                         n_slots=2, replica=r),
        lambda m, r: m.DeltaLedger("127.0.0.1", 1, table_id=1, replica=r)]
    for bad in ({"endpoints": []}, {"x": 1}):
        for fn in calls:
            with pytest.raises(Exception) as want:
                fn(jmb, bad)
            assert isinstance(want.value, (ValueError, TypeError))
            with pytest.raises(type(want.value)):
                fn(mb, bad)
    ports = [free_port(), free_port()]
    vans = [spawn_shard_server(tmp_path, p, f"v{i}")
            for i, p in enumerate(ports)]
    try:
        spec = {"endpoints": [["127.0.0.1", p] for p in ports],
                "epoch_table": mb.fresh_table_id(), "promote_after_s": 0.3,
                "rcv_timeout_s": 1.5}
        r = rep.VanReplica.from_spec(spec, bootstrap=True)
        assert r.incarnation == 1 and r.primary == ("127.0.0.1", ports[0])
        tid, lid = mb.fresh_table_id(), mb.fresh_table_id()
        bb = mb.create_blackboard("127.0.0.1", 0, table_id=tid, n_slots=2,
                                  replica=spec)
        assert isinstance(bb, rep.ReplicatedPSTable) and bb.replica is r
        row = np.arange(mb.MEMBER_DIM, dtype=np.float32).reshape(1, -1)
        bb.sparse_set([1], row)
        peer = mb.attach_blackboard("127.0.0.1", 0, table_id=tid,
                                    n_slots=2, replica=r)
        assert peer.sparse_pull([1]).tobytes() == row.tobytes()
        led = mb.DeltaLedger(table_id=lid, rows=64, dim=16, replica=spec)
        led.append({"a": [1, {"prompt": [1]}]}, ctrl_inc=1)
        for table_id, rows, dim in ((tid, 4, mb.MEMBER_DIM),
                                    (lid, 64, 16)):
            got = [RemotePSTable("127.0.0.1", p, rows, dim,
                                 table_id=table_id, create=False)
                   for p in ports]
            assert got[0].dense_pull().tobytes() == \
                got[1].dense_pull().tobytes()
            assert got[0].dense_pull().any()
            for t in got:
                t.close()
        assert led.read()["deltas"] == [{"a": [1, {"prompt": [1]}]}]
        for t in (led, bb, peer):
            t.close()
    finally:
        for v in vans:
            v.kill()
            v.wait()
