"""Cluster membership over the van wire: join / heartbeat / lease
(counterpart of ``hetu_tpu/ps/membership.py``).  Row layouts and the
ledgers' encoding are the reference's, bit for bit: a controller of one
package and a member of the other read the same blackboard, and a ledger
written by one decodes in the other, also through the replicated
durable tier (``replica=``, :mod:`hetu_tpu_torch.ps.replica`), whose
dual-writes keep both vans' rows bitwise equal.

The cross-process control plane both deployment tiers share (arXiv
2412.14374's multi-controller coordination over DCN, scaled to this
repo's van): serving-pool member processes and elastic training worker
processes each own a SLOT in a small f32 "blackboard" table on the van
server, heartbeat into their row, and read a controller-written CONTROL
row back.  The controller never talks to a member directly to learn
liveness — it watches beats advance and runs a lease state machine:

``alive`` --lease_s without a beat--> ``suspect`` --suspect_grace_s
more--> ``lost``; a beat landing while ``suspect`` CLEARS the suspicion
(the member was partitioned/SIGSTOPped, not dead — this is the state
that keeps a paused process from being double-counted as
lost-then-rejoined), and a beat carrying a NEW incarnation after
``lost``/``left`` is a rejoin.

Why a table and not new csrc ops: the blackboard needs exactly the
sparse_set/sparse_pull semantics the van already ships — idempotent
row writes, reads of any subset, survives client reconnects — so the
membership plane is ordinary wire traffic (visible in ``van.*``
telemetry, injectable by the chaos van hook) rather than a parallel
protocol.  All values are small integers, exact in f32 up to 2**24.

Row layout (``MEMBER_DIM`` f32 fields per member slot)::

    0 incarnation  random nonzero id per process lifetime (0 = empty)
    1 beat         monotonically increasing heartbeat counter
    2 flag         0 = left (clean exit), 1 = serving/training
    3 load         workload-defined load signal (routing hint)
    4 healthy      0/1: the member's own engine/loop health
    5 committed    workload-defined progress (training: last committed step)
    6 epoch_ack    last control epoch this member has acted on
    7 pid          OS pid (debugging only; never trusted for liveness)

The CONTROL row (slot ``n_slots``) is controller-written, member-read::

    0 epoch  1 width  2 alive_mask  3 resume_step  4 phase
    5 slow_slot  6 slow_ms  7 ctrl_inc (the incarnation FENCE)

and the CONTROLLER row (slot ``n_slots + 1``) is the controller's OWN
lease — the control plane stops being a single point of failure the
moment the controller is just another leased member of the blackboard::

    0 incarnation  1 beat  2 epoch  3 pid  4.. unused

Controller incarnations are MONOTONIC fencing tokens (claim = read the
row, write ``old + 1``), not random ids: a SIGSTOPped controller that
wakes after a takeover holds a strictly smaller incarnation, so members
(and the controller's own read-before-write checks) can reject its
writes — the split-brain guard.  Members watch the controller beat the
same way the controller watches theirs; silence past a bound means
"park safely until a controller (any incarnation) beats again".

``phase`` makes epoch transitions two-phase (the freeze the
multi-controller trainer needs): ``1`` = PREPARE — members stop taking
new steps at their next step boundary and ack the epoch with their
frozen progress; once every present member acked, the controller
publishes the same epoch with ``phase=0`` and an exact ``resume_step``
computed from the frozen (no longer racing) progress values.

Every wire op here goes through :func:`control_rpc` — bounded retries
with exponential backoff and jittered deadlines — because membership is
exactly the traffic that must survive a transiently overloaded van.
"""

from __future__ import annotations

import json
import os
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

MEMBER_DIM = 8
# base blackboard table ids ('MEMB' / 'WKRS') — controllers normally
# draw a FRESH id (fresh_table_id) and hand it to member processes via
# their spawn config: the native table registry outlives van.stop(), so
# a fixed id would collide with a previous pool's blackboard in any
# process that builds two pools (tests, notebooks)
SERVE_MEMBERSHIP_TABLE = 0x4D454D42
TRAIN_MEMBERSHIP_TABLE = 0x574B5253


def fresh_table_id() -> int:
    """A unique van table id (the RemotePSTable convention — random
    30-bit band, cross-process collision negligible)."""
    from hetu_tpu_torch.ps.van import fresh_table_id as _fresh
    return _fresh()

F_INCARNATION, F_BEAT, F_FLAG, F_LOAD = 0, 1, 2, 3
F_HEALTHY, F_COMMITTED, F_EPOCH_ACK, F_PID = 4, 5, 6, 7
# control row: fields 5/6 are the straggler-injection plane (a slot the
# controller wants running behind an emulated slow link, and the per-op
# netem delay in ms) — carried on the control row because workers
# already poll it every step and a SEPARATE wire for fault plumbing
# would not survive the very link faults it injects
C_EPOCH, C_WIDTH, C_MASK, C_RESUME, C_PHASE = 0, 1, 2, 3, 4
C_SLOW_SLOT, C_SLOW_MS = 5, 6
# the fence every control-row publish carries: members ignore a control
# row whose incarnation is lower than the highest they have seen
C_CTRL_INC = 7
# controller row (slot n_slots + 1): the controller's own lease
R_CINC, R_CBEAT, R_CEPOCH, R_CPID = 0, 1, 2, 3


class ControllerFenced(RuntimeError):
    """This controller's incarnation has been superseded: a NEWER
    incarnation claimed the controller row (a takeover happened while
    this process was suspended/partitioned).  Every control-plane write
    path raises this instead of writing — a fenced zombie must stop,
    loudly, without touching the fleet it no longer owns."""


class MembershipWireError(TimeoutError):
    """A membership control-plane RPC exhausted its bounded retries (or
    its wall-clock budget) against transient transport failures.  Names
    the op and the LINK so an operator reading a chaos log knows which
    wire was down — a bare ``ConnectionError`` from the Nth retry says
    neither.  Subclasses ``TimeoutError``: the caller-visible semantic
    is "the control plane did not answer in time", and retry layers
    above must not spin on it (the bounded retrying already happened
    here)."""


def fresh_incarnation() -> int:
    """Random nonzero 20-bit id — exact in f32, negligible collision odds
    across the handful of processes sharing one blackboard."""
    return 1 + int.from_bytes(os.urandom(3), "little") % ((1 << 20) - 1)


def control_rpc(fn: Callable, *, attempts: int = 4, base_s: float = 0.05,
                max_s: float = 1.0, rng: Optional[random.Random] = None,
                is_transient: Optional[Callable] = None,
                op: str = "", link: str = "",
                deadline_s: Optional[float] = None):
    """Run one control-plane wire op with bounded retry + exponential
    backoff + jittered deadlines.  Membership traffic shares the van with
    bulk KV/gradient transfers, so a transiently saturated (or
    fault-injected) wire must cost a retry, not a false loss decision —
    while real bugs (non-transient errors) surface immediately.

    Exhausting the retries against TRANSIENT failures raises
    :class:`MembershipWireError` naming ``op`` and ``link`` (when given)
    with the last underlying error chained — under a 100%-loss link
    (netem partition) the caller gets a clear, attributable timeout, not
    the Nth bare ``ConnectionError``.  ``deadline_s`` additionally caps
    the TOTAL wall-clock across attempts and backoff sleeps: once the
    budget is spent no further attempt starts and the remaining backoff
    is truncated, so a fully partitioned member's heartbeat loop cycles
    at a bounded period instead of stacking full backoff ladders."""
    if is_transient is None:
        from hetu_tpu_torch.resilience.supervisor import default_is_transient
        is_transient = default_is_transient
    rng = rng if rng is not None else random
    t0 = time.monotonic()
    delay = base_s
    last = None
    attempts = max(int(attempts), 1)
    for attempt in range(attempts):
        try:
            return fn()
        except Exception as e:
            if not is_transient(e):
                raise
            last = e
            elapsed = time.monotonic() - t0
            out_of_time = (deadline_s is not None and
                           elapsed >= deadline_s)
            if attempt + 1 >= attempts or out_of_time:
                where = f" {op}" if op else ""
                via = f" over link {link}" if link else ""
                raise MembershipWireError(
                    f"membership rpc{where}{via} failed after "
                    f"{attempt + 1} attempts in {elapsed:.2f}s "
                    f"(last error: {e!r})") from e
            # full jitter: desynchronize N members retrying against the
            # same recovering van (a fixed backoff would re-stampede it)
            sleep_s = rng.uniform(0.0, min(delay, max_s))
            if deadline_s is not None:
                sleep_s = min(sleep_s,
                              max(deadline_s - (time.monotonic() - t0),
                                  0.0))
            time.sleep(sleep_s)
            delay *= 2.0
    raise MembershipWireError(  # attempts == 0 guard; unreachable above
        f"membership rpc {op or fn!r} made no attempts") from last


def _replica_of(replica):
    """Accept a :class:`~hetu_tpu_torch.ps.replica.VanReplica`, a
    ``ReplicaSpec``, or a spec dict; returns the per-process replica
    coordinator (or None).  Resolution rides ``from_spec`` so a
    process spawned AFTER a failover adopts the promoted endpoint
    before any handle binds the dead original primary.  A malformed
    spec fails as ``ReplicaSpec`` does (``ValueError`` under two
    endpoints, ``TypeError`` for an unknown key)."""
    if not replica:
        return None
    from hetu_tpu_torch.ps.replica import VanReplica
    return VanReplica.from_spec(replica)


def create_blackboard(host: str, port: int, *, table_id: int,
                      n_slots: int, connect_timeout_s: float = 10.0,
                      replica=None):
    """Controller side: create the membership table.  ``n_slots`` member
    rows + 1 control row + 1 controller row, zero-initialized; plain SGD
    so ``sparse_set`` writes rows verbatim.

    ``replica`` (a ``VanReplica``/``ReplicaSpec``/spec dict) builds the
    blackboard over the REPLICATED durable tier instead: membership
    rows are load-bearing, so every write dual-writes synchronously and
    a primary-van death surfaces as a retryable
    :class:`~hetu_tpu_torch.ps.replica.VanFailover` under
    ``control_rpc``."""
    rep = _replica_of(replica)
    if rep is not None:
        return rep.table(n_slots + 2, MEMBER_DIM, table_id=table_id,
                         create=True, sync=True, init="zeros",
                         optimizer="sgd", lr=0.0,
                         connect_timeout_s=connect_timeout_s)
    from hetu_tpu_torch.ps.van import RemotePSTable
    return RemotePSTable(host, port, n_slots + 2, MEMBER_DIM,
                         table_id=table_id, create=True, init="zeros",
                         optimizer="sgd", lr=0.0,
                         connect_timeout_s=connect_timeout_s)


def attach_blackboard(host: str, port: int, *, table_id: int,
                      n_slots: int, connect_timeout_s: float = 10.0,
                      replica=None):
    """Member (or takeover-controller) side: attach to an EXISTING
    table (no create — a member racing the controller must fail loudly,
    not fork the id; a takeover must adopt the rows, not zero them).
    ``replica`` attaches over the replicated tier (see
    :func:`create_blackboard`)."""
    rep = _replica_of(replica)
    if rep is not None:
        return rep.table(n_slots + 2, MEMBER_DIM, table_id=table_id,
                         create=False, sync=True,
                         connect_timeout_s=connect_timeout_s)
    from hetu_tpu_torch.ps.van import RemotePSTable
    return RemotePSTable(host, port, n_slots + 2, MEMBER_DIM,
                         table_id=table_id, create=False,
                         connect_timeout_s=connect_timeout_s)


class MembershipClient:
    """A member process's handle on the blackboard: join once, then
    heartbeat on a cadence; ``read_control`` returns the controller's
    decided ``(epoch, width, alive_mask, resume_step)``."""

    def __init__(self, host: str = "", port: int = 0, *, table_id: int = 0,
                 slot: int, n_slots: int, incarnation: Optional[int] = None,
                 connect_timeout_s: float = 10.0,
                 rpc_deadline_s: float = 5.0, table=None, replica=None):
        if not 0 <= int(slot) < int(n_slots):
            raise ValueError(f"slot {slot} outside [0, {n_slots})")
        self.slot = int(slot)
        self.n_slots = int(n_slots)
        self.incarnation = int(incarnation) if incarnation else \
            fresh_incarnation()
        self.beat = 0
        # the link name every RPC failure carries, and the total
        # wall-clock cap per RPC (attempts + backoff): under a 100%-loss
        # link the beat loop must cycle bounded, erroring with the link
        # named — not stack backoff ladders into an unbounded hang
        self.link = f"member{self.slot}->van"
        self.rpc_deadline_s = float(rpc_deadline_s)
        # `table` injects a pre-built table surface (tests); the normal
        # path attaches over the van (replicated when `replica` names
        # the durable-tier pair — failover is then a retried transient)
        self._table = table if table is not None else attach_blackboard(
            host, port, table_id=table_id, n_slots=n_slots,
            connect_timeout_s=connect_timeout_s, replica=replica)
        self._rng = random.Random(self.incarnation * 1000003 + self.slot)
        # last-written workload fields: a later write that doesn't name a
        # field must NOT zero it (leave() clobbering `committed` would
        # erase the very progress record the controller reads post-exit)
        self._last = {"load": 0.0, "healthy": 1.0, "committed": 0.0,
                      "epoch_ack": 0.0}
        # the member-side half of the controller lease: highest
        # incarnation ever observed (the fence), its beat, and when the
        # beat last ADVANCED (the silence clock `controller_silent`
        # reads).  Updated by every read_control().
        self.ctrl_inc = 0
        self.ctrl_beat = -1
        self._ctrl_advance: Optional[float] = None
        self.stale_control_reads = 0
        # the registry twin of the attribute: rejected zombie control
        # rows are durable-tier health evidence, so they must ride the
        # member's registry dump into fleet_metrics()/Prometheus
        from hetu_tpu_torch.telemetry import default_registry as _reg
        self._m_stale = _reg.counter(
            "membership.stale_control_reads",
            help="control rows rejected for carrying a superseded "
                 "controller incarnation (zombie fence hits)")
        self._accepted_control = (0, 0, 0, 0, 0, -1, 0)

    def _bump_beat(self) -> None:
        # wrap WELL below 2**24: the row is f32, and a beat counter that
        # saturates (float32(2**24+1) == 2**24) would stop "advancing" —
        # a healthy 15-days-uptime member would be declared lost.  The
        # service only compares beats for INEQUALITY, so wrapping is safe
        self.beat = (self.beat + 1) % (1 << 20)

    def _write_row(self, flag: float, **fields) -> None:
        self._last.update({k: float(v) for k, v in fields.items()})
        row = np.zeros((1, MEMBER_DIM), np.float32)
        row[0, F_INCARNATION] = self.incarnation
        row[0, F_BEAT] = self.beat
        row[0, F_FLAG] = flag
        row[0, F_LOAD] = self._last["load"]
        row[0, F_HEALTHY] = self._last["healthy"]
        row[0, F_COMMITTED] = self._last["committed"]
        row[0, F_EPOCH_ACK] = self._last["epoch_ack"]
        row[0, F_PID] = os.getpid() % (1 << 24)
        control_rpc(lambda: self._table.sparse_set([self.slot], row),
                    rng=self._rng, op="member_row_write", link=self.link,
                    deadline_s=self.rpc_deadline_s)

    def join(self, **fields) -> int:
        """Claim the slot with this process's incarnation; returns it."""
        self._bump_beat()
        self._write_row(1.0, **fields)
        return self.incarnation

    def heartbeat(self, *, healthy: bool = True, **fields) -> None:
        self._bump_beat()
        self._write_row(1.0, healthy=1.0 if healthy else 0.0, **fields)

    def leave(self) -> None:
        """Clean exit (planned drain / normal shutdown): the controller
        must not grieve a member that said goodbye.  The workload fields
        keep their last written values — a finished worker's committed
        step survives its departure."""
        self._bump_beat()
        self._write_row(0.0)

    def read_control(self) -> tuple:
        """``(epoch, width, alive_mask, resume_step, phase, slow_slot,
        slow_ms)`` as ints — ``slow_slot`` is -1 when no straggler
        injection is active.

        One pull fetches the control row AND the controller row: the
        controller's lease (incarnation + beat) is tracked on this
        client, and a control row carrying a LOWER incarnation than the
        highest ever seen is a fenced zombie's write — ignored, the
        last accepted control tuple returned instead (counted in
        ``stale_control_reads``).  This member-side rejection is the
        authoritative half of the fence: the zombie's own
        read-before-write checks only narrow the race window."""
        rows = control_rpc(
            lambda: self._table.sparse_pull([self.n_slots,
                                             self.n_slots + 1]),
            rng=self._rng, op="read_control", link=self.link,
            deadline_s=self.rpc_deadline_s)
        crow = rows[1]
        inc, beat = int(crow[R_CINC]), int(crow[R_CBEAT])
        now = time.monotonic()
        if inc > self.ctrl_inc:
            self.ctrl_inc, self.ctrl_beat = inc, beat
            self._ctrl_advance = now
        elif inc == self.ctrl_inc and beat != self.ctrl_beat:
            self.ctrl_beat = beat
            self._ctrl_advance = now
        row = rows[0]
        ci = int(row[C_CTRL_INC])
        if ci and ci < self.ctrl_inc:
            self.stale_control_reads += 1
            self._m_stale.inc()
            return self._accepted_control
        out = (int(row[C_EPOCH]), int(row[C_WIDTH]),
               int(row[C_MASK]), int(row[C_RESUME]),
               int(row[C_PHASE]), int(row[C_SLOW_SLOT]),
               int(row[C_SLOW_MS]))
        self._accepted_control = out
        return out

    def controller_silent(self, bound_s: Optional[float]) -> bool:
        """True when a controller has been observed AND its beat has
        not advanced for ``bound_s`` (judged on this client's
        ``read_control`` history — callers that never read cannot
        detect silence).  ``bound_s`` None/<=0 disables."""
        if not bound_s or bound_s <= 0 or self._ctrl_advance is None \
                or self.ctrl_inc == 0:
            return False
        return time.monotonic() - self._ctrl_advance > float(bound_s)

    def close(self) -> None:
        self._table.close()


@dataclass
class MemberState:
    """Controller-side view of one slot."""

    slot: int
    state: str = "empty"          # empty|alive|suspect|lost|left
    incarnation: int = 0
    beat: int = -1
    last_advance: float = 0.0     # monotonic ts of the last beat advance
    suspect_since: Optional[float] = None
    # why the member is suspect: "beats_stopped" (their beats froze —
    # the classic silence that escalates to lost past the grace),
    # "probe_failed" (the CONTROLLER could not read the blackboard —
    # the member may be beating perfectly; never escalates to lost), or
    # "deaf" (beats arrive but control-row epochs are never acked — the
    # ingress-cut gray failure; clears when the ack catches up)
    suspect_reason: Optional[str] = None
    # when this incarnation was first observed — the deaf bound measures
    # time the MEMBER had to ack, so a fresh joiner is never deaf-
    # suspected for an epoch published before it existed
    joined_at: float = 0.0
    # when the slot was declared lost — the van-failover forgiveness
    # check needs to know whether a loss straddled a promotion
    lost_at: Optional[float] = None
    row: np.ndarray = field(default_factory=lambda: np.zeros(
        MEMBER_DIM, np.float32))

    @property
    def load(self) -> float:
        return float(self.row[F_LOAD])

    @property
    def healthy(self) -> bool:
        return bool(self.row[F_HEALTHY])

    @property
    def committed(self) -> int:
        return int(self.row[F_COMMITTED])

    @property
    def epoch_ack(self) -> int:
        return int(self.row[F_EPOCH_ACK])


class MembershipService:
    """Controller-side lease machine over the blackboard.

    :meth:`poll` pulls every member row and returns membership EVENTS in
    slot order: ``("join"|"rejoin"|"suspect"|"clear"|"lost"|"left",
    slot)``.  The caller (a serving pool controller or the
    multi-controller training supervisor) decides what each event means —
    the service only decides WHEN a silence becomes a loss:

    * no beat advance for ``lease_s``      → ``suspect`` (stop routing
      new work to it, but its state is presumed intact);
    * ``suspect_grace_s`` more of silence  → ``lost`` (failover/reshard);
    * a beat while ``suspect``             → ``clear`` — the member was
      paused or partitioned, NOT dead, and must not be double-counted
      as a loss followed by a rejoin (the chaos acceptance invariant);
    * ``flag=0``                           → ``left`` (clean exit, never
      grieved);
    * a NEW incarnation in a ``lost``/``left``/``empty`` slot → ``join``
      / ``rejoin``; in a live slot, the process restarted faster than
      one poll — surfaced honestly as ``lost`` then ``rejoin``.
    """

    def __init__(self, table, n_slots: int, *, lease_s: float = 1.0,
                 suspect_grace_s: float = 1.0,
                 rpc_deadline_s: float = 5.0,
                 deaf_ack_s: Optional[float] = None):
        self.table = table
        self.n_slots = int(n_slots)
        self.lease_s = float(lease_s)
        self.suspect_grace_s = float(suspect_grace_s)
        self.rpc_deadline_s = float(rpc_deadline_s)
        # deaf-member detection (the INGRESS-cut gray failure: beats
        # flow out, but the member never hears the controller — netem
        # can inject it, and without this bound membership cannot see
        # it).  A member whose beats advance but whose epoch_ack stays
        # behind the published epoch for deaf_ack_s goes
        # suspect(reason="deaf") — unroutable, but never escalated to
        # lost on that evidence alone (it is demonstrably alive); the
        # ack catching up clears it.  None disables (membership planes
        # whose members do not ack epochs must not all read as deaf).
        self.deaf_ack_s = None if deaf_ack_s is None else float(deaf_ack_s)
        self._published_epoch = 0
        self._published_epoch_at: Optional[float] = None
        # monotonic ts of the last durable-tier failover the caller
        # reported via note_van_failover(); None = never (default
        # semantics unchanged for planes without a replicated tier)
        self._van_failover_at: Optional[float] = None
        self.members = [MemberState(slot=i) for i in range(self.n_slots)]
        self._rng = random.Random(0x4C454153)
        self.link = "controller->van"
        # probe-failure accounting: while the CONTROLLER's own pulls
        # fail, no silence clock may advance — the members are not
        # observable, which is not evidence they stopped
        self.probe_failures = 0
        self.probe_blind_s = 0.0
        self._blind_since: Optional[float] = None
        # straggler-injection plane, persisted across epoch publishes
        self._slow = (-1, 0)
        # the controller's OWN lease: claiming bumps the stored
        # incarnation (a monotonic fencing token — takeover = old + 1),
        # and every poll beats the controller row so members can tell a
        # live controller from a dead one
        self.ctrl_incarnation = 0
        self.ctrl_beat = 0
        self.fenced = False
        self.claim_controller()

    # ---- the controller's own lease ----
    def claim_controller(self) -> int:
        """Claim (or take over) the controller row: the new incarnation
        is the old one + 1 — strictly greater, so every write the OLD
        incarnation attempts from here on is rejectable by comparison
        alone.  Returns the claimed incarnation.

        The claim is a van-side COMPARE-AND-SET (``OP_ROW_CAS`` on the
        incarnation field): of two SIMULTANEOUS claimants exactly one
        swap lands — ties are impossible, not merely converged-away —
        and the loser reads the winner's incarnation from the CAS
        response and re-claims one higher.  Against an old van that
        does not speak the op, falls back to the verified
        read-then-write loop (re-read, check the pid, re-claim on a
        tie), which converges but leaves a sub-RPC split-brain window.
        """
        row = control_rpc(
            lambda: self.table.sparse_pull([self.n_slots + 1]),
            rng=self._rng, op="controller_claim", link=self.link,
            deadline_s=self.rpc_deadline_s)
        observed = int(row[0, R_CINC])
        for _ in range(16):
            want = max(observed + 1, self.ctrl_incarnation + 1)
            desired = np.zeros(MEMBER_DIM, np.float32)
            desired[R_CINC] = want
            desired[R_CBEAT] = 1
            desired[R_CEPOCH] = self._published_epoch
            desired[R_CPID] = os.getpid() % (1 << 24)
            try:
                swapped, actual = control_rpc(
                    lambda: self.table.row_cas(
                        self.n_slots + 1, R_CINC, float(observed),
                        desired),
                    rng=self._rng, op="controller_claim_cas",
                    link=self.link, deadline_s=self.rpc_deadline_s)
            except (NotImplementedError, AttributeError):
                return self._claim_controller_rmw()
            if swapped:
                self.ctrl_incarnation = want
                self.ctrl_beat = 1
                return want
            # lost the race: the response carries the winner's row
            observed = int(actual[R_CINC])
        raise ControllerFenced(
            "could not claim the controller row: persistent claim "
            "contention (another controller keeps out-claiming us)")

    def _claim_controller_rmw(self) -> int:
        """Pre-CAS fallback claim (old van servers): read-then-write
        with a verify re-read — two simultaneous claimants can tie for
        one RPC, but each retry strictly raises the incarnation and the
        last writer keeps it."""
        for _ in range(8):
            row = control_rpc(
                lambda: self.table.sparse_pull([self.n_slots + 1]),
                rng=self._rng, op="controller_claim", link=self.link,
                deadline_s=self.rpc_deadline_s)
            self.ctrl_incarnation = max(int(row[0, R_CINC]) + 1,
                                        self.ctrl_incarnation + 1)
            self.ctrl_beat = 1
            self._write_ctrl_row()
            back = control_rpc(
                lambda: self.table.sparse_pull([self.n_slots + 1]),
                rng=self._rng, op="controller_claim_verify",
                link=self.link, deadline_s=self.rpc_deadline_s)
            if int(back[0, R_CINC]) == self.ctrl_incarnation and \
                    int(back[0, R_CPID]) == os.getpid() % (1 << 24):
                return self.ctrl_incarnation
            time.sleep(self._rng.uniform(0.0, 0.05))
        raise ControllerFenced(
            "could not claim the controller row: persistent claim "
            "contention (another controller keeps out-claiming us)")

    def _write_ctrl_row(self) -> None:
        row = np.zeros((1, MEMBER_DIM), np.float32)
        row[0, R_CINC] = self.ctrl_incarnation
        row[0, R_CBEAT] = self.ctrl_beat
        row[0, R_CEPOCH] = self._published_epoch
        row[0, R_CPID] = os.getpid() % (1 << 24)
        control_rpc(
            lambda: self.table.sparse_set([self.n_slots + 1], row),
            rng=self._rng, op="controller_beat", link=self.link,
            deadline_s=self.rpc_deadline_s)

    def _check_fence(self, crow=None) -> None:
        """Read-before-write fence: raise :class:`ControllerFenced` when
        a HIGHER incarnation owns the controller row.  ``crow`` reuses a
        row already pulled this sweep; otherwise a fresh pull is made
        (best-effort — an unreadable row skips the check, because the
        member-side incarnation comparison is the authoritative fence
        and refusing to publish on a transient pull failure would turn
        every van hiccup into a false fencing)."""
        if self.fenced:
            raise ControllerFenced(
                f"controller incarnation {self.ctrl_incarnation} was "
                f"superseded (previously observed a newer claim)")
        if crow is None:
            try:
                crow = control_rpc(
                    lambda: self.table.sparse_pull([self.n_slots + 1]),
                    rng=self._rng, op="controller_fence_check",
                    link=self.link, deadline_s=self.rpc_deadline_s)[0]
            except MembershipWireError:
                return
        observed = int(crow[R_CINC])
        if observed > self.ctrl_incarnation:
            self.fenced = True
            raise ControllerFenced(
                f"controller incarnation {self.ctrl_incarnation} fenced "
                f"by {observed}: a takeover happened — stop writing")

    def read_control_row(self) -> dict:
        """The last published control row, as the takeover path adopts
        it (epoch/width/mask/resume/phase + the straggler fields)."""
        row = control_rpc(
            lambda: self.table.sparse_pull([self.n_slots]),
            rng=self._rng, op="read_control_row", link=self.link,
            deadline_s=self.rpc_deadline_s)[0]
        return dict(epoch=int(row[C_EPOCH]), width=int(row[C_WIDTH]),
                    alive_mask=int(row[C_MASK]),
                    resume_step=int(row[C_RESUME]),
                    phase=int(row[C_PHASE]),
                    slow_slot=int(row[C_SLOW_SLOT]),
                    slow_ms=int(row[C_SLOW_MS]))

    # ---- controller → members ----
    def publish_control(self, *, epoch: int, width: int, alive_mask: int,
                        resume_step: int = 0, phase: int = 0,
                        slow_slot: Optional[int] = None,
                        slow_ms: Optional[int] = None) -> None:
        """Write the control row.  ``slow_slot``/``slow_ms`` (the
        straggler-injection fields) default to whatever was last
        published — an epoch transition must not silently heal an
        injected slow link.

        Every publish is FENCED: it carries this controller's
        incarnation in ``C_CTRL_INC`` (members reject lower ones) and
        is preceded by a read-before-write check of the controller row
        (raises :class:`ControllerFenced` when superseded)."""
        self._check_fence()
        if slow_slot is not None or slow_ms is not None:
            self._slow = (int(self._slow[0] if slow_slot is None
                              else slow_slot),
                          int(self._slow[1] if slow_ms is None
                              else slow_ms))
        row = np.zeros((1, MEMBER_DIM), np.float32)
        row[0, C_EPOCH] = int(epoch)
        row[0, C_WIDTH] = int(width)
        row[0, C_MASK] = int(alive_mask)
        row[0, C_RESUME] = int(resume_step)
        row[0, C_PHASE] = int(phase)
        row[0, C_SLOW_SLOT] = self._slow[0]
        row[0, C_SLOW_MS] = self._slow[1]
        row[0, C_CTRL_INC] = self.ctrl_incarnation
        self._last_control = dict(epoch=int(epoch), width=int(width),
                                  alive_mask=int(alive_mask),
                                  resume_step=int(resume_step),
                                  phase=int(phase))
        if int(epoch) > self._published_epoch:
            # the deaf clock starts at first publication of an epoch; a
            # re-publish of the same epoch (phase flip, set_slow) must
            # not restart it
            self._published_epoch = int(epoch)
            self._published_epoch_at = time.monotonic()
        control_rpc(lambda: self.table.sparse_set([self.n_slots], row),
                    rng=self._rng, op="publish_control", link=self.link,
                    deadline_s=self.rpc_deadline_s)
        # control-plane ids into the trace: every epoch/phase/width
        # published, stamped with the publishing incarnation — on a
        # merged fleet trace these instants are the controller-side
        # markers member spans' ``ci`` args line up against
        from hetu_tpu_torch.telemetry import trace as _trace
        _trace.instant("ctrl.publish",
                       {"epoch": int(epoch), "width": int(width),
                        "phase": int(phase),
                        "inc": int(self.ctrl_incarnation)}, cat="ctrl")

    def adopt_slow(self, slot: int, ms: int) -> None:
        """Takeover path: seed the straggler-injection fields from the
        PREDECESSOR's control row before the first republish — an
        epoch transition (including the takeover's own re-freeze) must
        not silently heal an injected slow link.  No write happens
        here; the next :meth:`publish_control` carries the values."""
        self._slow = (int(slot), int(ms))

    def set_slow(self, slot: int, ms: int) -> None:
        """Flip ONLY the straggler-injection fields, re-publishing the
        last control row otherwise unchanged (no epoch bump — injecting
        a slow link is not a membership change).  ``slot=-1`` clears."""
        last = getattr(self, "_last_control", None)
        if last is None:
            raise RuntimeError("set_slow before any publish_control")
        self.publish_control(**last, slow_slot=int(slot), slow_ms=int(ms))

    # ---- members → controller ----
    def poll(self) -> list:
        """One lease sweep; returns membership events (see class doc).

        Probe-failure handling (the "my probe failed" half of gray-
        failure suspicion): when the controller's OWN blackboard pull
        fails transiently — its link to the van is down, not the
        members' — every alive member degrades to ``suspect`` with
        ``suspect_reason="probe_failed"`` (stop routing new work: we
        are blind) but NO silence clock advances and nothing ever
        escalates to ``lost`` on that evidence.  When visibility
        returns, the blind window is added back to every silence clock
        — members whose beats advanced while we were blind ``clear``
        immediately, and a member that was genuinely silent is judged
        only on OBSERVED silence, so a controller-side partition can
        never grieve a healthy, heartbeating member."""
        try:
            rows = control_rpc(
                lambda: self.table.sparse_pull(
                    list(range(self.n_slots)) + [self.n_slots + 1]),
                rng=self._rng, op="membership_poll", link=self.link,
                deadline_s=self.rpc_deadline_s)
        except MembershipWireError:
            return self._probe_failed()
        # the controller row rode the same pull: fence-check (a zombie
        # waking after a takeover dies HERE, before acting on anything
        # it read), then beat — the poll cadence IS the controller's
        # heartbeat cadence, so members' silence clocks track exactly
        # how live the lease machine is
        self._check_fence(rows[self.n_slots])
        self.ctrl_beat = (self.ctrl_beat + 1) % (1 << 20)
        try:
            self._write_ctrl_row()
        except MembershipWireError:
            pass  # a transiently unreachable van: the next poll beats
        now = time.monotonic()
        events = []
        if self._blind_since is not None:
            # visibility restored: the blind window was unobservable,
            # not silent — shift every clock past it before judging
            blind_dt = now - self._blind_since
            self.probe_blind_s += blind_dt
            self._blind_since = None
            if self._published_epoch_at is not None:
                self._published_epoch_at += blind_dt
            for m in self.members:
                m.last_advance += blind_dt
                m.joined_at += blind_dt
                if m.suspect_since is not None:
                    m.suspect_since += blind_dt
                if m.suspect_reason == "probe_failed":
                    # reclassify: from here the normal machinery rules —
                    # an advancing beat clears below; a genuinely frozen
                    # one is now ordinary observed silence
                    m.suspect_reason = "beats_stopped"
        for m in self.members:
            row = rows[m.slot]
            inc, beat = int(row[F_INCARNATION]), int(row[F_BEAT])
            flag = int(row[F_FLAG])
            m.row = row
            if inc == 0:
                continue  # slot never claimed
            if inc != m.incarnation:
                # a different process lifetime now owns the slot
                if m.state in ("alive", "suspect"):
                    events.append(("lost", m.slot))
                    events.append(("rejoin", m.slot))
                else:
                    events.append(
                        ("rejoin" if m.state in ("lost", "left") else
                         "join", m.slot))
                m.incarnation, m.beat = inc, beat
                m.last_advance = now
                m.joined_at = now
                m.suspect_since = None
                m.suspect_reason = None
                m.state = "alive"
                continue
            if flag == 0:
                if m.state in ("alive", "suspect"):
                    events.append(("left", m.slot))
                    m.state = "left"
                    m.suspect_since = None
                continue
            if m.state in ("lost", "left"):
                # same incarnation resurfacing after we already declared
                # it: its old lease is void — only a NEW incarnation (a
                # restarted process) re-admits the slot.  Keeps a
                # zombie's stale beats from flapping the fleet.
                #
                # One exception: a loss declared on the heels of a
                # durable-tier failover.  The member was beating into a
                # van that died and spent the silence running its own
                # promotion dance; once its beats ADVANCE again they can
                # only be landing on the CURRENT primary (the dead van
                # is fenced), so the process is demonstrably live and
                # connected — re-admit without demanding a restart.
                if (m.state == "lost" and beat != m.beat and
                        self._van_failover_forgives(m)):
                    m.beat = beat
                    m.last_advance = now
                    m.joined_at = now
                    m.suspect_since = None
                    m.suspect_reason = None
                    m.lost_at = None
                    m.state = "alive"
                    events.append(("rejoin", m.slot))
                continue
            if beat != m.beat:
                m.beat = beat
                m.last_advance = now
                deaf = (self.deaf_ack_s is not None and
                        self._published_epoch > 0 and
                        m.epoch_ack < self._published_epoch and
                        self._published_epoch_at is not None and
                        now - max(self._published_epoch_at,
                                  m.joined_at) > self.deaf_ack_s)
                if m.state == "suspect" and m.suspect_reason == "deaf":
                    if not deaf:
                        # the ack caught up (or the bound no longer
                        # applies): the ingress path works again
                        events.append(("clear", m.slot))
                        m.state = "alive"
                        m.suspect_since = None
                        m.suspect_reason = None
                    continue  # advancing beats never clear deafness
                if m.state == "suspect":
                    events.append(("clear", m.slot))
                m.state = "alive"
                m.suspect_since = None
                m.suspect_reason = None
                if deaf:
                    # beats arrive but the member never acted on the
                    # published epoch inside the bound: it hears
                    # nothing (ingress cut) — unroutable, yet alive,
                    # so suspicion never escalates to lost from here
                    m.state = "suspect"
                    m.suspect_since = now
                    m.suspect_reason = "deaf"
                    events.append(("suspect", m.slot))
            elif m.state == "alive" and now - m.last_advance > self.lease_s:
                m.state = "suspect"
                m.suspect_since = now
                m.suspect_reason = "beats_stopped"
                events.append(("suspect", m.slot))
            elif m.state == "suspect" and m.suspect_reason == "deaf" \
                    and now - m.last_advance > self.lease_s:
                # the deaf member's BEATS also stopped: from here it is
                # ordinary observed silence — reclassify and let the
                # grace run from now (a poll landing between two
                # heartbeats must never read as silence, so deafness
                # alone can never reach this escalation)
                m.suspect_reason = "beats_stopped"
                m.suspect_since = now
            elif m.state == "suspect" and \
                    m.suspect_reason == "beats_stopped" and \
                    now - m.suspect_since > self.suspect_grace_s:
                # only OBSERVED silence escalates: probe_failed
                # suspicion (our link, not theirs) and deaf suspicion
                # (their ingress, beats still flowing) hold at suspect
                m.state = "lost"
                m.lost_at = now
                events.append(("lost", m.slot))
        return events

    def note_van_failover(self) -> None:
        """The durable tier just failed over: members could not land
        beats while the van pair promoted, so silence accrued during
        the window is the tier's fault, not theirs.  Grant every
        alive/suspect member a fresh lease clock, and remember the
        moment — a ``lost`` declared shortly after (the member's own
        failover dance outlasting the grace) is forgiven in the sweep
        when its beats resume advancing.  Callers serialize this with
        ``poll()``."""
        now = time.monotonic()
        self._van_failover_at = now
        for m in self.members:
            if m.state in ("alive", "suspect"):
                m.last_advance = now
                if m.suspect_since is not None:
                    m.suspect_since = now

    def _van_failover_forgives(self, m: "MemberState") -> bool:
        """Was this slot's loss plausibly induced by the last durable-
        tier failover?  A failover-induced loss lands one silence
        budget after the fresh clock note_van_failover() grants — but
        probe_failed blind windows (the controller itself mid-failover)
        freeze the silence clocks while wall time runs, so the
        declaration can drift well past that.  Four budgets of wall
        time bounds the drift; the advancing-beat requirement at the
        call site keeps the re-admission evidence-based regardless."""
        if self._van_failover_at is None or m.lost_at is None:
            return False
        budget = self.lease_s + self.suspect_grace_s
        return 0.0 <= m.lost_at - self._van_failover_at <= 4.0 * budget

    def _probe_failed(self) -> list:
        """The controller could not read the blackboard: freeze the
        silence clocks and degrade alive members to unroutable
        ``suspect(probe_failed)``.  Returns the suspect events (first
        blind poll only — later blind polls are silent)."""
        now = time.monotonic()
        self.probe_failures += 1
        events = []
        if self._blind_since is None:
            self._blind_since = now
            for m in self.members:
                if m.state == "alive":
                    m.state = "suspect"
                    m.suspect_since = now
                    m.suspect_reason = "probe_failed"
                    events.append(("suspect", m.slot))
        return events

    # ---- views ----
    def alive_slots(self) -> list:
        """Slots currently usable for routing/placement: alive AND not
        suspect (a suspected member gets no NEW work until it clears)."""
        return [m.slot for m in self.members if m.state == "alive"]

    def present_slots(self) -> list:
        """Alive + suspect — membership that has not been declared lost
        (a suspect still counts toward the mesh until its grace runs
        out; kicking it early is exactly the double-count bug)."""
        return [m.slot for m in self.members
                if m.state in ("alive", "suspect")]

    def member_pids(self) -> dict:
        """slot → advertised OS pid for every present member.  After a
        controller takeover these processes are the DEAD controller's
        children — the pid off the lease row is the only handle the
        successor's close()/replace paths have on them.  Debugging
        grade by design: never consulted for liveness (the beat is),
        only for delivering signals to an adopted fleet."""
        return {m.slot: int(m.row[F_PID]) for m in self.members
                if m.state in ("alive", "suspect") and int(m.row[F_PID])}

    def wait_present(self, timeout_s: float, *, poll=None) -> bool:
        """Poll until at least one member is present or ``timeout_s``
        elapses; returns whether anyone is present.  The ONE adoption
        wait every takeover plane shares — and a fleet that FINISHED
        and left cleanly (flag=0) will never be present again: every
        slot ``left``/``empty`` (at least one ``left``) breaks
        immediately rather than stalling the takeover of a completed
        run for the whole spawn budget.

        ``poll`` substitutes the caller's event-processing sweep (the
        serving pool folds membership events into failover/quarantine
        state; dropping them here would skip that bookkeeping)."""
        poll = self.poll if poll is None else poll
        deadline = time.monotonic() + float(timeout_s)
        while not self.present_slots() and time.monotonic() < deadline:
            poll()
            if not self.present_slots() and \
                    any(m.state == "left" for m in self.members) and \
                    all(m.state in ("left", "empty")
                        for m in self.members):
                break
            time.sleep(0.05)
        return bool(self.present_slots())

    def state_of(self, slot: int) -> MemberState:
        return self.members[int(slot)]

    @staticmethod
    def mask_of(slots) -> int:
        mask = 0
        for s in slots:
            mask |= 1 << int(s)
        return mask

    @staticmethod
    def slots_of(mask: int) -> list:
        return [i for i in range(24) if int(mask) & (1 << i)]


# ---------------------------------------------------------------------------
# controller ledger: durable controller state on the van
# ---------------------------------------------------------------------------

# header magic, < 2**24 so it is exact in f32
LEDGER_MAGIC = 0xBEEF42
# header row fields: [magic, nbytes, version, ctrl_inc]
L_MAGIC, L_NBYTES, L_VERSION, L_CINC = 0, 1, 2, 3


class ControllerLedger:
    """A small controller-state blob journaled to a PS table on the van.

    Everything a controller holds ONLY in RAM that cannot be re-derived
    from lease rows / the control row / member-side records (the serving
    plane's rid→member ownership, retry budgets, half-open drains) is
    written here as one JSON snapshot per state change, so a takeover
    reads blackboard + ledger and owns the fleet.  Why a PS table and
    not a blob channel: blob channels are single-slot acked queues — an
    unread put blocks the writer, and the ledger's reader is by
    definition not there until the writer is dead.

    Encoding: JSON bytes packed TWO per f32 as u16 values (0..65535 —
    exact in f32; storing raw f32 bit patterns would let the wire's NaN
    quieting silently corrupt arbitrary bytes).  Header row carries
    ``[magic, nbytes, version, ctrl_inc]``; header + payload go down in
    ONE ``sparse_set`` frame, so a write is atomic on the van server
    and a reader never sees a torn snapshot.

    Writes are FENCED like every other controller write: the header's
    recorded incarnation is read first, and a lower-incarnation writer
    raises :class:`ControllerFenced` instead of clobbering its
    successor's ledger.
    """

    def __init__(self, host: str = "", port: int = 0, *, table_id: int = 0,
                 rows: int = 1024, dim: int = 32, create: bool = True,
                 connect_timeout_s: float = 10.0,
                 rpc_deadline_s: float = 5.0, table=None):
        self.rows, self.dim = int(rows), int(dim)
        if table is not None:
            self._table = table
        else:
            from hetu_tpu_torch.ps.van import RemotePSTable
            self._table = RemotePSTable(
                host, port, self.rows, self.dim, table_id=int(table_id),
                create=create, init="zeros", optimizer="sgd", lr=0.0,
                connect_timeout_s=connect_timeout_s)
        self.version = 0
        self.rpc_deadline_s = float(rpc_deadline_s)
        self._rng = random.Random(0x4C4544)
        # the write fence is READ-cached: the member-side incarnation
        # comparison is the authoritative fence (see read_control) and
        # a zombie's poll fences it within one poll period anyway, so
        # paying a header pull on EVERY hot-path journal write buys
        # only a narrower race window — re-read at most this often
        self.fence_cache_s = 0.25
        self._fence_read_at: Optional[float] = None
        self._fenced_by = 0

    def _rpc(self, fn, op: str):
        """Ledger wire ops ride the same bounded-retry wrapper as every
        other control-plane RPC: one transient van hiccup must cost a
        retry, not a refused accept (submit treats a journal failure as
        refuse-the-accept — correctly, but only for REAL failures)."""
        return control_rpc(fn, rng=self._rng, op=op, link="ledger->van",
                           deadline_s=self.rpc_deadline_s)

    def capacity_bytes(self) -> int:
        return (self.rows - 1) * self.dim * 2

    def write(self, state: dict, *, ctrl_inc: int) -> int:
        """Journal one full snapshot; returns the new version."""
        data = json.dumps(state, separators=(",", ":")).encode()
        if len(data) > self.capacity_bytes():
            raise ValueError(
                f"ledger snapshot {len(data)}B exceeds table capacity "
                f"{self.capacity_bytes()}B — prune resolved entries or "
                f"size the ledger up")
        now = time.monotonic()
        if self._fenced_by > int(ctrl_inc):
            raise ControllerFenced(
                f"ledger owned by incarnation {self._fenced_by} > "
                f"{int(ctrl_inc)}: a takeover happened — stop writing")
        if self._fence_read_at is None or \
                now - self._fence_read_at >= self.fence_cache_s:
            head = self._rpc(lambda: self._table.sparse_pull([0]),
                             "ledger_fence_read")
            self._fence_read_at = now
            if int(head[0, L_MAGIC]) == LEDGER_MAGIC:
                self._fenced_by = max(self._fenced_by,
                                      int(head[0, L_CINC]))
                self.version = max(self.version,
                                   int(head[0, L_VERSION]))
            if self._fenced_by > int(ctrl_inc):
                raise ControllerFenced(
                    f"ledger owned by incarnation {self._fenced_by} > "
                    f"{int(ctrl_inc)}: a takeover happened — stop "
                    f"writing")
        version = self.version + 1
        pad = data + b"\x00" * (len(data) % 2)
        u16 = np.frombuffer(pad, np.uint16).astype(np.float32)
        n_payload = -(-u16.size // self.dim) if u16.size else 0
        frame = np.zeros((1 + n_payload, self.dim), np.float32)
        frame[0, L_MAGIC] = LEDGER_MAGIC
        frame[0, L_NBYTES] = len(data)
        frame[0, L_VERSION] = version
        frame[0, L_CINC] = int(ctrl_inc)
        if n_payload:
            frame[1:].reshape(-1)[:u16.size] = u16
        self._rpc(lambda: self._table.sparse_set(
            np.arange(1 + n_payload), frame), "ledger_write")
        # the highest incarnation EVER seen through this handle also
        # fences (no RPC): a lower-incarnation write through the same
        # (or a later-reading) handle is refused instantly, and the
        # cache above only bounds the cross-process zombie window
        self._fenced_by = max(self._fenced_by, int(ctrl_inc))
        self.version = version
        return version

    def read(self) -> Optional[dict]:
        """Latest snapshot as ``{"state", "version", "ctrl_inc"}``, or
        None when nothing was ever journaled."""
        last = None
        for _ in range(3):  # header+payload are two pulls; a concurrent
            # write between them decodes garbage — retry, it converges
            try:
                head = self._rpc(lambda: self._table.sparse_pull([0]),
                                 "ledger_read")
                if int(head[0, L_MAGIC]) != LEDGER_MAGIC:
                    return None
                nbytes = int(head[0, L_NBYTES])
                n_u16 = (nbytes + 1) // 2
                n_payload = -(-n_u16 // self.dim) if n_u16 else 0
                if n_payload:
                    rows = self._rpc(
                        lambda: self._table.sparse_pull(
                            np.arange(1, 1 + n_payload)),
                        "ledger_read_payload")
                    data = rows.reshape(-1)[:n_u16].astype(
                        np.uint16).tobytes()[:nbytes]
                else:
                    data = b""
                out = {"state": json.loads(data) if data else {},
                       "version": int(head[0, L_VERSION]),
                       "ctrl_inc": int(head[0, L_CINC])}
                self.version = out["version"]
                self._fenced_by = max(self._fenced_by,
                                      out["ctrl_inc"])
                return out
            except ValueError as e:
                last = e
                time.sleep(0.02)
        raise RuntimeError(f"ledger snapshot would not decode: {last!r}")

    def close(self) -> None:
        close = getattr(self._table, "close", None)
        if close is not None:
            close()


# ---------------------------------------------------------------------------
# delta ledger: append-only accept/resolve records + periodic compaction
# ---------------------------------------------------------------------------

# header magic for the delta layout, < 2**24 so it is exact in f32 (and
# distinct from LEDGER_MAGIC, so a reader can tell the layouts apart)
DELTA_MAGIC = 0xD017A5
# header row fields
D_MAGIC, D_CINC, D_SEQ, D_BASE_NBYTES = 0, 1, 2, 3
D_HEAD, D_NREC, D_COMPACTIONS = 4, 5, 6


class LedgerCompactionNeeded(RuntimeError):
    """The delta region is full: the caller must :meth:`DeltaLedger.
    compact` a fresh base snapshot (one amortized O(state) write) and
    re-append.  Raised INSTEAD of refusing the accept — the old
    snapshot ledger's hard capacity cliff becomes a compaction
    trigger."""


class DeltaLedger:
    """Append-only controller ledger: O(delta) bytes per state change.

    :class:`ControllerLedger` journals ONE full JSON snapshot per
    accept — O(inflight) bytes serialized behind one lock, with a hard
    refuse-accepts cliff at the table's capacity.  This layout splits
    the same PS table into three regions instead::

        row 0                       header [magic, ctrl_inc, seq,
                                    base_nbytes, head, n_records,
                                    compactions]
        rows [1, 1+base_rows)       the BASE snapshot (u16-packed JSON,
                                    rewritten only at compaction)
        rows [1+base_rows, rows)    append-only DELTA records, each
                                    [nbytes, u16 payload...] packed into
                                    whole rows

    Every :meth:`append` writes header + the new record rows in ONE
    ``sparse_set`` frame (atomic on the van server — the same
    atomicity argument as the snapshot ledger), so an accept costs
    bytes proportional to the RECORD, not to everything in flight.
    When the delta region fills, the caller compacts: the current full
    state becomes the new base and ``head`` resets, again one atomic
    frame — a reader at ANY instant sees either (old base + old
    deltas) or (new base, zero deltas), never a torn mix, so a
    takeover mid-compaction restores the exact request set.

    Readers use a two-pull protocol: probe the header, pull rows
    ``[0, head)`` in one atomic op, and retry only if the header
    inside the big pull says the writer appended past the probed head
    meanwhile.  Fencing matches :class:`ControllerLedger`: the header
    carries the owning incarnation, writes refuse when a higher one
    was ever observed (cache-bounded re-read), and the member-side
    incarnation comparison stays the authoritative fence.

    Dual use with the replicated durable tier: the whole ledger is
    verbatim ``sparse_set`` traffic, so a synchronously replicated
    table keeps byte-identical ledgers on both vans.
    """

    def __init__(self, host: str = "", port: int = 0, *, table_id: int = 0,
                 rows: int = 1024, dim: int = 32,
                 base_rows: Optional[int] = None, create: bool = True,
                 connect_timeout_s: float = 10.0,
                 rpc_deadline_s: float = 5.0, table=None, replica=None):
        self.rows, self.dim = int(rows), int(dim)
        self.base_rows = int(base_rows) if base_rows is not None \
            else max((self.rows - 1) // 2, 8)
        self.delta_start = 1 + self.base_rows
        if self.delta_start + 8 > self.rows:
            raise ValueError(
                f"ledger too small: {self.rows} rows leaves no delta "
                f"region past base_rows={self.base_rows}")
        if table is not None:
            self._table = table
        else:
            rep = _replica_of(replica)
            if rep is not None:
                self._table = rep.table(
                    self.rows, self.dim, table_id=int(table_id),
                    create=create, sync=True, init="zeros",
                    optimizer="sgd", lr=0.0,
                    connect_timeout_s=connect_timeout_s)
            else:
                from hetu_tpu_torch.ps.van import RemotePSTable
                self._table = RemotePSTable(
                    host, port, self.rows, self.dim,
                    table_id=int(table_id), create=create, init="zeros",
                    optimizer="sgd", lr=0.0,
                    connect_timeout_s=connect_timeout_s)
        self.rpc_deadline_s = float(rpc_deadline_s)
        self._rng = random.Random(0x44454C54)
        self.seq = 0
        self.head = self.delta_start
        self.n_records = 0
        self.compactions = 0
        self._base_nbytes = 0
        self.fence_cache_s = 0.25
        self._fence_read_at: Optional[float] = None
        self._fenced_by = 0
        from hetu_tpu_torch.telemetry import default_registry as _reg
        self._m_appends = _reg.counter(
            "ledger.delta_appends", help="delta records appended")
        self._m_append_bytes = _reg.counter(
            "ledger.delta_bytes",
            help="wire bytes of appended delta frames (header row "
                 "included) — O(record), not O(inflight)")
        self._m_compactions = _reg.counter(
            "ledger.compactions", help="base-snapshot compactions")
        self._m_compaction_bytes = _reg.counter(
            "ledger.compaction_bytes",
            help="wire bytes of compaction frames (the amortized "
                 "O(state) cost)")
        if create and table is None:
            self._init_header()
        else:
            self.sync()

    def _rpc(self, fn, op: str):
        return control_rpc(fn, rng=self._rng, op=op, link="ledger->van",
                           deadline_s=self.rpc_deadline_s)

    # ---- geometry ----
    def base_capacity_bytes(self) -> int:
        return self.base_rows * self.dim * 2

    def delta_capacity_rows(self) -> int:
        return self.rows - self.delta_start

    def _record_rows(self, nbytes: int) -> int:
        n_u16 = (int(nbytes) + 1) // 2
        return max(-(-(1 + n_u16) // self.dim), 1)

    def _header_row(self, *, ctrl_inc: int) -> np.ndarray:
        h = np.zeros(self.dim, np.float32)
        h[D_MAGIC] = DELTA_MAGIC
        h[D_CINC] = int(ctrl_inc)
        h[D_SEQ] = self.seq
        h[D_BASE_NBYTES] = self._base_nbytes
        h[D_HEAD] = self.head
        h[D_NREC] = self.n_records
        h[D_COMPACTIONS] = self.compactions
        return h

    def _init_header(self) -> None:
        self.seq = 1
        frame = self._header_row(ctrl_inc=0).reshape(1, -1)
        self._rpc(lambda: self._table.sparse_set([0], frame),
                  "ledger_init")

    def _load_header(self, row) -> bool:
        if int(row[D_MAGIC]) != DELTA_MAGIC:
            return False
        self.seq = int(row[D_SEQ])
        self._base_nbytes = int(row[D_BASE_NBYTES])
        self.head = int(row[D_HEAD])
        self.n_records = int(row[D_NREC])
        self.compactions = int(row[D_COMPACTIONS])
        self._fenced_by = max(self._fenced_by, int(row[D_CINC]))
        return True

    def sync(self) -> bool:
        """Adopt the table's current header (attach / takeover path).
        Returns False when the table was never initialized."""
        row = self._rpc(lambda: self._table.sparse_pull([0]),
                        "ledger_sync")[0]
        return self._load_header(row)

    # ---- fencing (the ControllerLedger contract, verbatim) ----
    def _check_fence(self, ctrl_inc: int) -> None:
        now = time.monotonic()
        if self._fenced_by > int(ctrl_inc):
            raise ControllerFenced(
                f"ledger owned by incarnation {self._fenced_by} > "
                f"{int(ctrl_inc)}: a takeover happened — stop writing")
        if self._fence_read_at is None or \
                now - self._fence_read_at >= self.fence_cache_s:
            head = self._rpc(lambda: self._table.sparse_pull([0]),
                             "ledger_fence_read")
            self._fence_read_at = now
            if int(head[0, D_MAGIC]) == DELTA_MAGIC:
                self._fenced_by = max(self._fenced_by,
                                      int(head[0, D_CINC]))
                if int(head[0, D_SEQ]) > self.seq:
                    # a successor (or a pre-fence write of ours that
                    # raced) advanced the ledger: adopt its geometry
                    # rather than append over it
                    self._load_header(head[0])
            if self._fenced_by > int(ctrl_inc):
                raise ControllerFenced(
                    f"ledger owned by incarnation {self._fenced_by} > "
                    f"{int(ctrl_inc)}: a takeover happened — stop "
                    f"writing")

    # ---- codec ----
    @staticmethod
    def _pack_u16(data: bytes) -> np.ndarray:
        pad = data + b"\x00" * (len(data) % 2)
        return np.frombuffer(pad, np.uint16).astype(np.float32)

    def _encode_record(self, rec: dict) -> np.ndarray:
        data = json.dumps(rec, separators=(",", ":")).encode()
        u16 = self._pack_u16(data)
        nrows = self._record_rows(len(data))
        flat = np.zeros(nrows * self.dim, np.float32)
        flat[0] = len(data)
        flat[1:1 + u16.size] = u16
        return flat.reshape(nrows, self.dim)

    @staticmethod
    def _decode_bytes(flat: np.ndarray, nbytes: int) -> bytes:
        n_u16 = (int(nbytes) + 1) // 2
        return flat[:n_u16].astype(np.uint16).tobytes()[:int(nbytes)]

    # ---- writes ----
    def append(self, records, *, ctrl_inc: int) -> int:
        """Append one or more delta records in ONE atomic frame;
        returns the new seq.  Raises :class:`LedgerCompactionNeeded`
        when they do not fit the remaining delta region."""
        if isinstance(records, dict):
            records = [records]
        if not records:
            return self.seq
        self._check_fence(ctrl_inc)
        encoded = [self._encode_record(r) for r in records]
        k = sum(e.shape[0] for e in encoded)
        if self.head + k > self.rows:
            raise LedgerCompactionNeeded(
                f"delta region full ({self.head - self.delta_start}/"
                f"{self.delta_capacity_rows()} rows used, {k} more "
                f"needed): compact")
        self.seq += 1
        self.head += k
        self.n_records += len(records)
        frame = np.concatenate(
            [self._header_row(ctrl_inc=ctrl_inc).reshape(1, -1)]
            + encoded, axis=0)
        idx = np.concatenate(
            [[0], np.arange(self.head - k, self.head)])
        try:
            self._rpc(lambda: self._table.sparse_set(idx, frame),
                      "ledger_append")
        except Exception:
            # nothing (or everything) landed — re-sync before the next
            # append so local geometry cannot drift from the table
            self.seq -= 1
            self.head -= k
            self.n_records -= len(records)
            self._fence_read_at = None
            raise
        self._fenced_by = max(self._fenced_by, int(ctrl_inc))
        self._m_appends.inc(len(records))
        self._m_append_bytes.inc(int(frame.nbytes))
        return self.seq

    def compact(self, state: dict, *, ctrl_inc: int) -> int:
        """Write ``state`` as the new base and reset the delta region —
        one atomic frame, amortized O(state).  Returns the new seq."""
        self._check_fence(ctrl_inc)
        data = json.dumps(state, separators=(",", ":")).encode()
        if len(data) > self.base_capacity_bytes():
            raise ValueError(
                f"ledger base snapshot {len(data)}B exceeds base "
                f"capacity {self.base_capacity_bytes()}B — size the "
                f"ledger up")
        u16 = self._pack_u16(data)
        nrows = -(-u16.size // self.dim) if u16.size else 0
        base = np.zeros((nrows, self.dim), np.float32)
        if nrows:
            base.reshape(-1)[:u16.size] = u16
        self.seq += 1
        self._base_nbytes = len(data)
        self.head = self.delta_start
        self.n_records = 0
        self.compactions += 1
        frame = np.concatenate(
            [self._header_row(ctrl_inc=ctrl_inc).reshape(1, -1), base],
            axis=0)
        idx = np.arange(1 + nrows)
        self._rpc(lambda: self._table.sparse_set(idx, frame),
                  "ledger_compact")
        self._fenced_by = max(self._fenced_by, int(ctrl_inc))
        self._m_compactions.inc()
        self._m_compaction_bytes.inc(int(frame.nbytes))
        return self.seq

    def needs_compaction(self, margin_rows: int = 16) -> bool:
        return self.head + int(margin_rows) > self.rows

    # ---- reads ----
    def read(self) -> Optional[dict]:
        """``{"state", "deltas", "seq", "ctrl_inc", "compactions"}`` —
        the base snapshot plus every delta appended since, in order —
        or None when nothing was ever journaled.  The caller replays
        the deltas over the state."""
        probe = self._rpc(lambda: self._table.sparse_pull([0]),
                          "ledger_read_header")[0]
        if int(probe[D_MAGIC]) != DELTA_MAGIC:
            return None
        want_head = int(probe[D_HEAD])
        for _ in range(8):
            rows = self._rpc(
                lambda: self._table.sparse_pull(np.arange(want_head)),
                "ledger_read")
            hdr = rows[0]
            if int(hdr[D_MAGIC]) != DELTA_MAGIC:
                return None
            head = int(hdr[D_HEAD])
            if head > want_head:
                want_head = head  # the writer appended mid-read: grow
                continue
            self._load_header(hdr)
            nbytes = int(hdr[D_BASE_NBYTES])
            state = {}
            if nbytes:
                base_flat = rows[1:1 + self.base_rows].reshape(-1)
                state = json.loads(self._decode_bytes(base_flat, nbytes))
            deltas = []
            r = self.delta_start
            while r < head:
                rec_nbytes = int(rows[r][0])
                nrows = self._record_rows(rec_nbytes)
                flat = rows[r:r + nrows].reshape(-1)[1:]
                deltas.append(json.loads(
                    self._decode_bytes(flat, rec_nbytes)))
                r += nrows
            return {"state": state, "deltas": deltas, "seq": self.seq,
                    "ctrl_inc": int(hdr[D_CINC]),
                    "compactions": int(hdr[D_COMPACTIONS])}
        raise RuntimeError(
            "ledger read could not catch a quiescent header in 8 "
            "attempts (writer appending continuously)")

    def close(self) -> None:
        close = getattr(self._table, "close", None)
        if close is not None:
            close()
