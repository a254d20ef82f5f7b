"""Replicated durable tier: a backup van shadowing the primary
(counterpart of ``hetu_tpu/ps/replica.py``).

Controllers are killable; the van process they journal into is then the
last single point of failure — one SIGKILL of the durable tier takes the
membership blackboard, the controller ledger and PS-resident model state
with it.  This module closes that hole at the CLIENT wire layer (the van
server stays the untouched C++ of ``csrc/hetu_ps_van.cpp``):

* :class:`ReplicatedPSTable` — the ``RemotePSTable`` surface over a
  primary + backup van pair.  Mutating ops (``sparse_set`` /
  ``slots_set`` / ``sparse_push`` / ``dense_push`` / ``row_cas`` /
  ``clear``) dual-write: SYNCHRONOUSLY for load-bearing tables
  (membership rows, the controller ledger, versioned weights — the
  write returns only once BOTH vans acked), or ASYNC lag-bounded for
  everything else (a bounded queue drains to the backup on a streamer
  thread; a full queue blocks the writer, so replication lag is capped
  at ``max_lag`` ops).  Reads always go to the primary.

* :class:`VanReplica` — the per-process failover brain.  A 1-row EPOCH
  table on every van carries ``[incarnation, primary_idx, pid,
  backup_port]``; promotion is a van-side ``OP_ROW_CAS`` on the
  incarnation field of the SURVIVOR's epoch row, so of N clients (or
  standbys) racing to promote, exactly one swap lands — the losers
  adopt the winner's incarnation from the CAS response.  A claimant may
  only promote after the primary stayed unreachable past
  ``promote_after_s`` (re-pinged with a short receive timeout, so a
  SIGSTOPped van — whose TCP stack still accepts — fails the ping
  instead of hanging the fleet).  After promotion the new epoch row is
  fence-written into the OLD primary (retried in the background until
  it lands), so a SIGSTOPped-then-resumed primary advertises its own
  supersession: any client still bound to it discovers the fence on its
  next revalidation window and gets :class:`VanFailover` instead of
  landing a stale write.

* :class:`VanFailover` — a ``ConnectionError`` subclass raised AFTER
  the client re-targeted to the promoted endpoint.  Every retry layer
  (``control_rpc``, blob same-seq resend) already treats
  ``ConnectionError`` as transient, so a van failover replays in-flight
  ops exactly like a netem drop.

Epoch rows, the promotion protocol and every table's rows are the
reference's, bit for bit: a port replica and a reference replica racing
on one van pair yield one winner, and a ledger written through a
replicated pair by one package decodes in the other.

Departures from the reference:

* the replica's own van handles FAIL FAST
  (``RemotePSTable(reconnect=False)``: the port's table handle replaces
  a broken connection before it raises, which against a SIGKILLed
  primary would wait out the whole connect deadline inside the failover
  it is about to drive), and a handle or channel (re)built on an op path
  dials for at most :meth:`VanReplica.connect_budget_s`, the promotion
  grace (the reference: 1 s, twice, and 2 s for a channel);
* the resilver's verify passes hold the table's write lock, which this
  process's replicated writes hold from the primary write through the
  backup write, and the cutover resets the table's negative cache of a
  dead backup: in the reference a repair can copy a primary row older
  than a write that already reached the backup, and writes right after
  the cutover can be skipped, and an append-only ledger row written once
  then never reaches the backup;
* :func:`_is_wire_error` also takes the port's
  :class:`~hetu_tpu_torch.ps.van.BlobTransportError`.

Determinism note: synchronous dual-write keeps the two vans BITWISE
identical for verbatim writes (``sparse_set``/``slots_set``/
``row_cas`` — the blackboard, ledger, and double-buffered stage
weights are all written this way) and for optimizer-applying pushes
issued by a single writer in order.  Concurrent unordered pushes from
several processes may apply in different interleavings on the two vans
— exactly the same nondeterminism those pushes already have on ONE
van.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import traceback
import weakref
from dataclasses import asdict, dataclass, field
from typing import Optional

import numpy as np

from hetu_tpu_torch.telemetry import trace as _trace

# epoch-row fields (dim 8, exact in f32 like every blackboard value).
# E_BPORT names the CURRENT backup endpoint's port (0 = the spec's
# original): a re-silver swaps the backup van under a LIVE incarnation,
# and every process discovers the new endpoint from the primary's epoch
# row on its normal revalidation cadence — no side channel.
E_INC, E_PRIMARY, E_PID, E_BPORT = 0, 1, 2, 3
EPOCH_DIM = 8
# default epoch-table id band marker ('VEPO'); deployments normally draw
# a fresh id (the native registry outlives van.stop())
VAN_EPOCH_TABLE = 0x5645504F


_DBG = os.environ.get("HETU_DEBUG_REPLICA") == "1"


def _dbg(msg: str) -> None:
    if _DBG:
        import sys
        sys.stderr.write(
            f"[replica pid={os.getpid()} t={time.monotonic():.3f}] "
            f"{msg}\n")
        sys.stderr.flush()


class VanFailover(ConnectionError):
    """The primary van died and this client re-targeted to the promoted
    backup.  Raised INSTEAD of the op result so the caller's retry
    layer replays the op against the new primary — failover is a
    transient, exactly like a dropped frame."""


class VanFenced(VanFailover):
    """A write was refused because this handle's van incarnation has
    been superseded (the old primary it targeted is no longer
    authoritative).  Subclasses :class:`VanFailover`: by the time it
    raises, the handle already re-targeted — retry and the op lands on
    the promoted van."""


def _is_wire_error(e: BaseException) -> bool:
    """A transport failure of a van op (retry, or fail over), as against a
    server-side refusal or a bug: a dropped or refused connection
    (``ConnectionError``, :class:`VanFailover` among them), a receive
    timeout, a native table op's ``hetu_ps ... rc=`` error, and a blob
    op whose transport failed past its deadline
    (:class:`~hetu_tpu_torch.ps.van.BlobTransportError`, whose text names
    no library)."""
    if isinstance(e, (ConnectionError, TimeoutError)):
        return True
    from hetu_tpu_torch.ps.van import BlobTransportError
    if isinstance(e, BlobTransportError):
        return True
    return isinstance(e, RuntimeError) and "hetu_ps" in str(e)


# ---------------------------------------------------------------------------
# deferred handle close (the fd-reassignment race)
# ---------------------------------------------------------------------------
# Failover paths drop handles that OTHER threads may still be using: an
# op thread takes its handle reference lock-free, then runs the native
# wire op outside any lock — if the dropping thread close()s that fd
# mid-op, the kernel reassigns the number to whatever connects next
# (a fresh channel, a spawn pipe) and the in-flight op reads/writes a
# STRANGER's stream.  Observed as garbage bytes on a spawner's stdout
# pipe and EBADF out of set_rcv_timeout during the chaos soak's second
# fault.  Handles retired here are closed by a reaper only after a
# grace period longer than any bounded wire op (connect deadline +
# SO_RCVTIMEO), so a stale reference finishes (failing harmlessly on
# its own connection) before the fd number can be recycled.

_RETIRE_GRACE_S = 10.0
# owed writes a table keeps for a backup that failed them (beyond this
# the backup is dead, not flaky, and a resilver's copy is the remedy)
_OWED_MAX = 4096
_retired: list = []            # (deadline, closeable)
_retired_lock = threading.Lock()
_reaper_started = False


def _reap_retired(now: Optional[float] = None) -> int:
    """One reaper pass: close every handle whose grace lapsed, update
    the ``van.replica.floating_handles`` gauge to what still floats.
    Split from the loop so tests (and a health dashboard curious about
    leak regressions) can drive a pass deterministically."""
    now = time.monotonic() if now is None else float(now)
    due = []
    with _retired_lock:
        keep = []
        for item in _retired:
            (due if item[0] <= now else keep).append(item)
        _retired[:] = keep
        _reg().gauge("van.replica.floating_handles").set(len(keep))
    for _, h in due:
        try:
            h.close()
        except Exception:
            pass
    return len(due)


def _reaper_loop() -> None:
    while True:
        time.sleep(_RETIRE_GRACE_S / 4)
        _reap_retired()


def retire_handle(h, *, grace_s: float = _RETIRE_GRACE_S) -> None:
    """Schedule ``h.close()`` after ``grace_s`` instead of closing now.
    Use on any van handle/channel another thread might still be inside."""
    global _reaper_started
    if h is None:
        return
    with _retired_lock:
        _retired.append((time.monotonic() + float(grace_s), h))
        _reg().gauge("van.replica.floating_handles").set(len(_retired))
        if not _reaper_started:
            _reaper_started = True
            threading.Thread(target=_reaper_loop, daemon=True,
                             name="van-handle-reaper").start()


@dataclass
class ReplicaSpec:
    """Everything a process needs to find (and fail over between) the
    replicated durable tier — JSON-serialized into spawn configs like
    every other control-plane id."""

    endpoints: list = field(default_factory=list)  # [[host, port], ...]
    epoch_table: int = VAN_EPOCH_TABLE
    promote_after_s: float = 0.5
    max_lag: int = 64              # async stream bound, in ops
    rcv_timeout_s: float = 5.0     # SO_RCVTIMEO on replica connections
    revalidate_s: float = 0.25     # stale-primary fence check cadence
    resilver_settle_s: float = 0.5  # wait for peers to adopt the new
    # backup endpoint (>= their revalidate cadence) before snapshotting
    resilver_repair_passes: int = 8  # verify/repair rounds per table
    # owner-maintained pair-membership snapshot on SHARED storage (the
    # fleet workdir): the epoch-row discovery protocol needs at least
    # one reachable van, so a process whose entire cached endpoint view
    # died (it missed a re-silver's bport publication, then the second
    # fault took the promoted primary too) re-reads the pair from here
    # instead of livelocking against two dead ports
    rendezvous: Optional[str] = None

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "ReplicaSpec":
        return cls(**json.loads(s))

    @classmethod
    def from_dict(cls, d) -> Optional["ReplicaSpec"]:
        if not d:
            return None
        return cls(**dict(d))


def _reg():
    from hetu_tpu_torch.telemetry import default_registry
    return default_registry


class VanReplica:
    """Per-process failover coordinator over a primary/backup van pair.

    One instance per (endpoints, epoch_table) per process — use
    :meth:`get` so every table/channel in the process shares one view
    of which endpoint is authoritative.  Thread-safe."""

    _instances: dict = {}
    _instances_lock = threading.Lock()

    def __init__(self, spec: ReplicaSpec):
        if len(spec.endpoints) < 2:
            raise ValueError("a van replica needs >= 2 endpoints "
                             "(primary + backup)")
        self.spec = spec
        self.endpoints = [(str(h), int(p)) for h, p in spec.endpoints]
        self.lock = threading.RLock()
        # serializes WIRE ops on the (shared) epoch handles: revalidate
        # runs on op threads while promote/_publish_bport/_mirror run on
        # failover + resilver threads — interleaved frames on one fd
        # desync the stream for every later request on it
        self._elock = threading.Lock()
        self.incarnation = 0
        self.primary_idx = 0
        self._epoch: list = [None] * len(self.endpoints)
        self._callbacks: list = []
        self._first_fail: Optional[float] = None
        self._fail_t0_us: Optional[float] = None
        self._revalidated_at = 0.0
        self._rdv_read_at = 0.0  # rendezvous re-read rate limit
        reg = _reg()
        self._m_promotions = reg.counter(
            "van.replica.promotions",
            help="van promotions this process WON (CAS swap landed)")
        self._m_adopted = reg.counter(
            "van.replica.promotions_adopted",
            help="van promotions won elsewhere and adopted here")
        self._m_failovers = reg.counter(
            "van.replica.failovers",
            help="ops re-targeted to the promoted endpoint")
        self._m_inc = reg.gauge(
            "van.replica.incarnation",
            help="highest van incarnation observed by this process")
        self._m_lag = reg.gauge(
            "van.replica.lag_ops",
            help="async replication ops queued, all streamed tables")
        self._m_degraded = reg.gauge(
            "van.replica.degraded",
            help="1 while this process's writes reach only one van "
                 "(post-promotion, before re-silvering completes)")
        self._lag_sources: list = []
        # ---- re-silvering state ----
        # every ReplicatedPSTable over this pair registers itself so a
        # resilver can snapshot-copy EVERY open table (weak: a closed
        # table must not be pinned alive by the registry)
        self._tables: "weakref.WeakSet" = weakref.WeakSet()
        self.degraded = False          # promoted, redundancy not yet
        self._unrepl_debt = 0          # restored; writes since then that
        #                                reached only the surviving van
        self.spawn_backup = None       # owner-provided () -> (host, port)
        # of a FRESH backup van; when set, a promotion auto-resilvers
        self._resilvering = False
        # owner-side: a promotion scheduled a resilver that has not
        # COMPLETED yet.  While set, dual-writes landing on the
        # half-attached backup must not clear the degraded window —
        # "both vans acked" is not "the snapshot copy finished"
        self._resilver_due = False
        self._resilver_lock = threading.Lock()
        self._m_resilvers = reg.counter(
            "van.resilver.runs",
            help="re-silver attempts started by this process")
        self._m_resilver_rows = reg.counter(
            "van.resilver.rows_copied",
            help="table rows snapshot-copied onto a fresh backup")
        self._m_resilver_catchup = reg.counter(
            "van.resilver.catchup_ops",
            help="journaled writes replayed onto the fresh backup at "
                 "cutover (landed mid-copy)")
        self._m_resilver_repaired = reg.counter(
            "van.resilver.repaired_rows",
            help="rows re-copied by the post-copy verify/repair loop")
        self._m_resilver_active = reg.gauge(
            "van.resilver.active",
            help="1 while a re-silver is streaming in this process")

    # ---- construction ----
    @classmethod
    def get(cls, spec: ReplicaSpec) -> "VanReplica":
        key = (tuple(tuple(e) for e in spec.endpoints),
               int(spec.epoch_table))
        with cls._instances_lock:
            inst = cls._instances.get(key)
            if inst is None:
                inst = cls(spec)
                cls._instances[key] = inst
            return inst

    @classmethod
    def from_spec(cls, spec, *, bootstrap: bool = False) -> "VanReplica":
        """The ONE construction path every plane shares: accept a
        VanReplica / ReplicaSpec / spec dict, resolve the per-process
        instance, and make sure it knows the CURRENT incarnation —
        a process spawned AFTER a failover must not bind the dead
        original primary.  ``bootstrap=True`` additionally creates the
        epoch tables and claims incarnation 1 (the deployment-creation
        path; attach/takeover paths refresh only)."""
        if isinstance(spec, cls):
            rep = spec
        elif isinstance(spec, ReplicaSpec):
            rep = cls.get(spec)
        else:
            rep = cls.get(ReplicaSpec.from_dict(spec))
        if bootstrap:
            rep.bootstrap()
        elif rep.incarnation == 0:
            # never resolved in this process: adopt whatever the pair
            # currently says before any handle binds an endpoint
            rep.refresh()
        return rep

    def bootstrap(self) -> int:
        """Deployment side: create the epoch table on EVERY van and
        claim incarnation 1 via CAS (idempotent — a second bootstrap
        adopts the existing row).  Returns the current incarnation."""
        for i in range(len(self.endpoints)):
            h = self._epoch_handle(i, create=True)
            if i == 0 and h is not None:
                desired = np.zeros(EPOCH_DIM, np.float32)
                desired[E_INC] = 1.0
                desired[E_PID] = os.getpid() % (1 << 24)
                desired[E_BPORT] = self.endpoints[1][1]
                try:
                    swapped, actual = h.row_cas(0, E_INC, 0.0, desired)
                    inc = 1 if swapped else int(actual[E_INC])
                    pidx = 0 if swapped else int(actual[E_PRIMARY])
                    bport = 0 if swapped else int(actual[E_BPORT])
                except NotImplementedError:
                    row = h.sparse_pull([0])[0]
                    if int(row[E_INC]) == 0:
                        h.sparse_set([0], desired.reshape(1, -1))
                        inc, pidx, bport = 1, 0, 0
                    else:
                        inc, pidx, bport = (int(row[E_INC]),
                                            int(row[E_PRIMARY]),
                                            int(row[E_BPORT]))
                with self.lock:
                    self.incarnation = max(self.incarnation, inc)
                    self.primary_idx = pidx
                    self._m_inc.set(self.incarnation)
                    self._adopt_bport_locked(inc, pidx, bport)
        # mirror the claimed row onto the backups (verbatim — the fence
        # every later promotion CASes against)
        self._mirror_epoch_row()
        return self.incarnation

    def refresh(self) -> int:
        """Adopt the highest incarnation any endpoint's epoch row
        carries (attach/takeover path: the pair may have failed over
        before this process existed).  Returns the incarnation."""
        best = None
        for i in range(len(self.endpoints)):
            info = self._read_epoch(i)
            if info is not None and \
                    (best is None or info[0] > best[0]):
                best = info
        if best is not None:
            with self.lock:
                if best[0] > self.incarnation:
                    self.incarnation, self.primary_idx = best[:2]
                    self._m_inc.set(self.incarnation)
                self._adopt_bport_locked(*best)
        return self.incarnation

    def _mirror_epoch_row(self) -> None:
        with self.lock:
            inc, pidx = self.incarnation, self.primary_idx
            bidx = self.backup_idx
            bport = self.endpoints[bidx][1] if bidx is not None else 0
        row = np.zeros((1, EPOCH_DIM), np.float32)
        row[0, E_INC] = inc
        row[0, E_PRIMARY] = pidx
        row[0, E_PID] = os.getpid() % (1 << 24)
        row[0, E_BPORT] = bport
        for i in range(len(self.endpoints)):
            if i == pidx:
                continue
            h = self._epoch_handle(i, create=True)
            if h is None:
                continue
            try:
                with self._elock:
                    h.sparse_set([0], row)
            except Exception:
                pass  # an unreachable backup mirrors later (promotion
                # falls back to CAS-from-0 there)

    def _epoch_handle(self, idx: int, *, create: bool = False):
        from hetu_tpu_torch.ps.van import RemotePSTable
        h = self._epoch[idx]
        if h is not None and h.fd >= 0:
            return h
        host, port = self.endpoints[idx]
        for do_create in ((True, False) if create else (False, True)):
            try:
                h = RemotePSTable(
                    host, port, 1, EPOCH_DIM,
                    table_id=self.spec.epoch_table, create=do_create,
                    init="zeros", optimizer="sgd", lr=0.0,
                    connect_timeout_s=self.connect_budget_s(),
                    rcv_timeout_s=self.spec.rcv_timeout_s,
                    reconnect=False)
                self._epoch[idx] = h
                return h
            except ConnectionError:
                return None  # unreachable: the other mode dials it again
            except Exception:
                continue
        return None

    def connect_budget_s(self) -> float:
        """The connect deadline of a handle (re)built on an op path: the
        promotion grace, at most 1 s.  A live van accepts at once, and a
        stopped one accepts too (its kernel does; the receive timeout
        catches it), so a longer wait only delays the failover against a
        van that is gone."""
        return min(1.0, float(self.spec.promote_after_s))

    # ---- views ----
    def current_spec(self) -> dict:
        """ReplicaSpec dict with the CURRENT pair membership — what a
        spawn config written after failovers/re-silvers must carry: the
        original spec's endpoints may BOTH be dead by then, and a fresh
        process has no rendezvous to discover a re-silvered van from a
        fully-stale endpoint list."""
        with self.lock:
            d = asdict(self.spec)
            d["endpoints"] = [list(e) for e in self.endpoints]
        return d

    def write_rendezvous(self) -> None:
        """Owner-side: atomically snapshot the CURRENT pair membership
        to ``spec.rendezvous`` (shared fleet storage).  Peers read it
        only as a last resort — when their whole cached endpoint view
        is unreachable — so staleness costs nothing and freshness
        rescues a process that slept through a re-silver."""
        path = self.spec.rendezvous
        if not path:
            return
        try:
            with self.lock:
                snap = {"incarnation": int(self.incarnation),
                        "primary_idx": int(self.primary_idx),
                        "endpoints": [list(e) for e in self.endpoints]}
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(snap, f)
            os.replace(tmp, path)
        except Exception:
            pass  # best-effort: the epoch rows remain the truth

    def _refresh_from_rendezvous(self) -> bool:
        """Reload pair membership from the owner's rendezvous snapshot.
        Called when the failover dance dead-ends (primary AND backup
        unreachable): a process that missed a re-silver's bport
        publication — and then lost the promoted primary to the next
        fault — holds a fully-dead endpoint view with no van left to
        discover the survivors from.  Returns True when the snapshot
        moved an endpoint; the caller re-runs discovery against the
        refreshed pair (the epoch rows there carry the authoritative
        incarnation — the file never adopts one directly)."""
        path = self.spec.rendezvous
        if not path:
            return False
        now = time.monotonic()
        with self.lock:
            if now - self._rdv_read_at < 1.0:
                return False
            self._rdv_read_at = now
        try:
            with open(path) as f:
                snap = json.load(f)
            inc = int(snap["incarnation"])
            eps = [(str(h), int(p)) for h, p in snap["endpoints"]]
        except Exception:
            return False
        with self.lock:
            if inc < self.incarnation or len(eps) != len(self.endpoints):
                return False
            cand = []
            for i, ep in enumerate(eps):
                if ep == self.endpoints[i]:
                    continue
                if inc == self.incarnation and i == self.primary_idx:
                    # under an UNCHANGED incarnation only the backup
                    # slot legitimately moves (re-silver); the primary
                    # moves only with an incarnation advance
                    continue
                cand.append(i)
        changed = False
        for i in cand:
            # the file can be STALER than this process's view (a
            # half-attached backup's epoch read fails even though its
            # van answers): never replace an endpoint that still
            # accepts — regressing a live slot to a dead snapshot
            # would wedge the very failover this fallback unsticks
            if self._ping(i):
                continue
            with self.lock:
                if eps[i] == self.endpoints[i]:
                    continue
                _dbg(f"rendezvous: slot {i} {self.endpoints[i]} -> "
                     f"{eps[i]} (file inc={inc}, ours={self.incarnation})")
                self.endpoints[i] = eps[i]
                h, self._epoch[i] = self._epoch[i], None
                retire_handle(h)
                for t in list(self._tables):
                    t._drop_handle(i)
                changed = True
        return changed

    @property
    def primary(self) -> tuple:
        with self.lock:
            return self.endpoints[self.primary_idx]

    @property
    def backup_idx(self) -> Optional[int]:
        with self.lock:
            for i in range(len(self.endpoints)):
                if i != self.primary_idx:
                    return i
        return None

    def register(self, cb) -> None:
        """``cb(replica)`` runs after every adopted/won promotion —
        tables re-target themselves; the serving pool rebinds its blob
        channels."""
        with self.lock:
            self._callbacks.append(cb)

    def unregister(self, cb) -> None:
        with self.lock:
            if cb in self._callbacks:
                self._callbacks.remove(cb)

    def register_lag_source(self, fn) -> None:
        with self.lock:
            self._lag_sources.append(fn)

    def export_lag(self) -> int:
        """Refresh the replication-lag gauge.  While the pair is
        DEGRADED (promoted, backup not yet re-silvered) the unreplicated
        write debt counts as lag: the async streamer drains (dropping)
        against the dead ex-backup, so raw queue depth reads 0 exactly
        when the pair is least healthy — the satellite bug this method
        used to have."""
        with self.lock:
            srcs = list(self._lag_sources)
            debt = self._unrepl_debt if self.degraded else 0
        lag = debt
        for fn in srcs:
            try:
                lag += int(fn())
            except Exception:
                pass
        self._m_lag.set(lag)
        return lag

    def _note_unreplicated(self) -> None:
        """A mutating op reached only the surviving van — the debt the
        degraded-window lag gauge must keep visible."""
        with self.lock:
            self._unrepl_debt += 1
            if self.degraded:
                self._m_lag.set(self._unrepl_debt)

    def _note_replicated(self) -> None:
        """A write landed on BOTH vans again.  Outside a resilver that
        means the backup endpoint is live (either it bounced back or
        this process adopted a re-silvered endpoint) — clear the
        degraded flag.  During a resilver the owner keeps it set until
        the snapshot copy + catchup drain actually finish."""
        if not self.degraded or self._resilvering or self._resilver_due:
            return
        with self.lock:
            if self.degraded and not self._resilvering \
                    and not self._resilver_due:
                self.degraded = False
                self._unrepl_debt = 0
                self._m_degraded.set(0)

    def _adopt_bport_locked(self, inc: int, pidx: int,
                            bport: int) -> bool:
        """Caller holds ``self.lock``.  Adopt a re-silvered backup
        endpoint advertised in an epoch row: the backup slot's PORT
        moves (host stays — re-silvering is same-host in this tier),
        and every handle bound to the replaced endpoint is dropped so
        it rebuilds against the new van."""
        if bport <= 0 or inc < self.incarnation:
            return False
        try:
            bidx = next(i for i in range(len(self.endpoints))
                        if i != pidx)
        except StopIteration:
            return False
        host, cur = self.endpoints[bidx]
        if int(bport) == cur:
            return False
        _dbg(f"adopt bport inc={inc} pidx={pidx} "
             f"bport {cur}->{int(bport)}")
        self.endpoints[bidx] = (host, int(bport))
        h, self._epoch[bidx] = self._epoch[bidx], None
        retire_handle(h)  # the failover dance may be inside it
        for t in list(self._tables):
            t._drop_handle(bidx)
        return True

    # ---- the failover dance ----
    def note_ok(self) -> None:
        if self._first_fail is not None:
            with self.lock:
                self._first_fail = None
                self._fail_t0_us = None

    def revalidate(self, *, force: bool = False) -> bool:
        """Cheap stale-primary fence check, at most once per
        ``revalidate_s``: read the CURRENT primary's epoch row — a
        fence write landed by a promotion elsewhere shows a higher
        incarnation, and this process adopts it (returns True).  The
        check that rejects a resumed old primary's would-be writes."""
        now = time.monotonic()
        with self.lock:
            if not force and \
                    now - self._revalidated_at < self.spec.revalidate_s:
                return False
            self._revalidated_at = now
            pidx = self.primary_idx
        info = self._read_epoch(pidx)
        if info is None:
            return False
        inc, new_pidx, bport = info
        with self.lock:
            # a re-silvered backup endpoint rides the SAME incarnation
            # (the primary did not change): adopt it silently — the
            # write proceeds, now dual-writing to the fresh backup
            self._adopt_bport_locked(inc, new_pidx, bport)
            if inc > self.incarnation:
                self._adopt_locked(inc, new_pidx, won=False)
                return True
        return False

    def _read_epoch(self, idx: int) -> Optional[tuple]:
        h = self._epoch_handle(idx)
        if h is None:
            return None
        try:
            with self._elock:
                row = h.sparse_pull([0])[0]
        except Exception:
            self._epoch[idx] = None
            retire_handle(h)  # epoch handles are shared across threads
            return None
        return int(row[E_INC]), int(row[E_PRIMARY]), int(row[E_BPORT])

    def _ping(self, idx: int) -> bool:
        """Fresh short-deadline connect + ping: a SIGKILLed van refuses
        fast; a SIGSTOPped one accepts but the ping recv times out."""
        from hetu_tpu_torch.ps.binding import lib
        from hetu_tpu_torch.ps.van import set_rcv_timeout
        host, port = self.endpoints[idx]
        fd = lib.ps_van_connect(host.encode(), port)
        if fd < 0:
            return False
        try:
            set_rcv_timeout(fd, min(self.spec.promote_after_s, 1.0))
            return lib.ps_van_ping(fd) == 0
        finally:
            lib.ps_van_close(fd)

    def failover(self, err: Optional[BaseException] = None) -> bool:
        """Called when a primary op failed transport-wise.  Returns True
        when the primary CHANGED (the caller must re-target and raise
        :class:`VanFailover`); False when the failure should surface
        as the ordinary transient it is."""
        now = time.monotonic()
        with self.lock:
            if self._first_fail is None:
                self._first_fail = now
                self._fail_t0_us = _trace.now_us()
            first_fail = self._first_fail
            pidx = self.primary_idx
            bidx = self.backup_idx
        if bidx is None:
            return False
        # did someone already promote?  The survivor's epoch row is the
        # cheapest truth — adopt before pinging anything
        info = self._read_epoch(bidx)
        if info is not None and info[0] > self.incarnation:
            with self.lock:
                self._adopt_bport_locked(*info)
                self._adopt_locked(info[0], info[1], won=False)
            return True
        if info is None and self._refresh_from_rendezvous():
            # the whole cached pair view was dead: the owner's
            # snapshot replaced it — re-run discovery against the
            # refreshed endpoints (either slot's epoch row carries the
            # authoritative incarnation; the fresh backup's is mirrored
            # at resilver cutover)
            with self.lock:
                pidx = self.primary_idx
                bidx = self.backup_idx
            for idx in (bidx, pidx):
                if idx is None:
                    continue
                info = self._read_epoch(idx)
                if info is not None and info[0] > self.incarnation:
                    with self.lock:
                        self._adopt_bport_locked(*info)
                        self._adopt_locked(info[0], info[1], won=False)
                    return True
        if self._ping(pidx):
            self.note_ok()
            return False
        if now - first_fail < self.spec.promote_after_s:
            return False  # not yet: a netem wobble must not promote
        return self.promote()

    def promote(self) -> bool:
        """Claim the promotion via CAS on the survivor's epoch row.
        Exactly one claimant's swap lands per incarnation; the losers
        adopt the winner's row from the same round trip.  Returns True
        when the primary changed (won or adopted)."""
        with self.lock:
            pidx = self.primary_idx
            bidx = self.backup_idx
            observed = self.incarnation
        if bidx is None:
            return False
        h = self._epoch_handle(bidx, create=True)
        if h is None:
            return False
        desired = np.zeros(EPOCH_DIM, np.float32)
        desired[E_INC] = observed + 1
        desired[E_PRIMARY] = bidx
        desired[E_PID] = os.getpid() % (1 << 24)
        # after the swap the ex-primary slot IS the backup: carry its
        # current port so late-joining processes reconstruct the pair's
        # true membership even after earlier re-silvers moved it
        desired[E_BPORT] = self.endpoints[pidx][1]
        try:
            with self._elock:
                swapped, actual = h.row_cas(0, E_INC, float(observed),
                                            desired)
                if not swapped and not np.asarray(actual).any():
                    # never-mirrored epoch row: a half-attached backup
                    # whose resilver died before cutover answers with
                    # the zeroed row create-on-connect planted.  Claim
                    # from zero — the CAS still arbitrates racing
                    # claimants, exactly one swap lands
                    swapped, actual = h.row_cas(0, E_INC, 0.0, desired)
        except NotImplementedError:
            # old van: read-then-write (the verified pre-CAS fallback)
            with self._elock:
                row = h.sparse_pull([0])[0]
                if int(row[E_INC]) > observed:
                    swapped, actual = False, row
                else:
                    h.sparse_set([0], desired.reshape(1, -1))
                    swapped, actual = True, desired
        except Exception:
            return False
        with self.lock:
            if swapped:
                self._adopt_locked(observed + 1, bidx, won=True)
            else:
                inc, np_idx = int(actual[E_INC]), int(actual[E_PRIMARY])
                if inc <= self.incarnation or np_idx == pidx:
                    # CAS lost against a row that still names the dead
                    # primary (e.g. a never-mirrored epoch row): adopt
                    # nothing — the next attempt re-reads and converges
                    return False
                self._adopt_bport_locked(inc, np_idx,
                                         int(actual[E_BPORT]))
                self._adopt_locked(inc, np_idx, won=False)
        return True

    def _adopt_locked(self, inc: int, pidx: int, *, won: bool) -> None:
        """Caller holds ``self.lock``."""
        _dbg(f"adopt inc={inc} pidx={pidx} won={won} "
             f"endpoints={self.endpoints}")
        old_pidx = self.primary_idx
        self.incarnation = int(inc)
        self.primary_idx = int(pidx)
        self._m_inc.set(self.incarnation)
        t0 = self._fail_t0_us
        self._first_fail = None
        self._fail_t0_us = None
        cbs = list(self._callbacks)
        if won:
            self._m_promotions.inc()
        else:
            self._m_adopted.inc()
        self._m_failovers.inc()
        # the promoted pair runs on ONE van until a resilver lands:
        # mark the degraded window and re-export the lag gauge under
        # the new incarnation NOW — the streamer is about to drain
        # (dropping) against the dead ex-backup and would read 0
        self.degraded = True
        self._unrepl_debt = 0
        self._m_degraded.set(1)
        self._m_lag = _reg().gauge(
            "van.replica.lag_ops",
            help="async replication ops queued, all streamed tables")
        self._m_lag.set(0)
        if self.spawn_backup is not None:
            # the resilver owner keeps the shared rendezvous snapshot
            # current so peers stranded on dead endpoints can re-find
            # the pair (the resilver completion re-writes it with the
            # fresh backup)
            self.write_rendezvous()
            self._resilver_due = True
            threading.Thread(target=self._auto_resilver,
                             daemon=True).start()
        # the retroactive recovery span the timeline pairs with
        # fault.van_kill / fault.van_suspend: detection start -> adopted
        _trace.complete(
            "van.promote", t0 if t0 is not None else _trace.now_us(),
            {"incarnation": self.incarnation, "primary": int(pidx),
             "won": bool(won)}, cat="van")
        # fence the OLD primary in the background: when it resumes
        # (SIGSTOP case) its epoch row must already say "superseded",
        # so clients still bound to it refuse their next write
        threading.Thread(target=self._fence_old_primary,
                         args=(old_pidx, self.incarnation,
                               self.primary_idx),
                         daemon=True).start()
        for cb in cbs:
            try:
                cb(self)
            except Exception:
                traceback.print_exc()

    def _fence_old_primary(self, old_idx: int, inc: int,
                           pidx: int) -> None:
        with self.lock:
            old_ep = self.endpoints[old_idx]
        row = np.zeros((1, EPOCH_DIM), np.float32)
        row[0, E_INC] = inc
        row[0, E_PRIMARY] = pidx
        row[0, E_PID] = os.getpid() % (1 << 24)
        row[0, E_BPORT] = old_ep[1]
        deadline = time.monotonic() + 600.0
        while time.monotonic() < deadline:
            with self.lock:
                if self.incarnation > inc:
                    return  # a later promotion owns the fencing now
                if self.endpoints[old_idx] != old_ep:
                    # a re-silver replaced this slot's endpoint: the
                    # SIGKILLed van this fence was aimed at is never
                    # coming back, and dialing the slot now reaches the
                    # FRESH backup — where a create-on-connect would
                    # plant a zeroed epoch row and this fence row (its
                    # E_BPORT names the dead port) could clobber the
                    # mirrored one.  The fence is moot; stop.
                    return
            h = self._epoch_handle(old_idx, create=True)
            if h is not None:
                try:
                    with self._elock:
                        cur = h.sparse_pull([0])[0]
                        if int(cur[E_INC]) >= inc:
                            return  # already fenced (by us or a peer)
                        h.sparse_set([0], row)
                    return
                except Exception:
                    self._epoch[old_idx] = None
                    retire_handle(h)
            time.sleep(1.0)

    # ---- re-silvering: restore redundancy after a promotion ----
    def register_table(self, table) -> None:
        with self.lock:
            self._tables.add(table)

    def _auto_resilver(self) -> None:
        """Promotion hook (``spawn_backup`` installed): attach a fresh
        backup without an operator.  Retried against a deadline — the
        first attempt may race the tail of the failover it reacts to,
        and on a loaded host the snapshot copy itself can time out
        repeatedly before the fresh van warms up."""
        with self.lock:
            inc0 = self.incarnation
        ep = None
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            with self.lock:
                if self.incarnation != inc0:
                    return  # superseded: the next promotion re-runs it
            try:
                if self.resilver(ep):
                    return
            except Exception:
                traceback.print_exc()
            # a failed attempt whose van still answers retries onto
            # the SAME van: a fresh spawn per attempt leaks the orphan
            # and re-pays process warmup — the main reason attempts
            # time out back-to-back under load
            ep = None
            with self.lock:
                bidx = self.backup_idx
            if bidx is not None and self._ping(bidx):
                with self.lock:
                    ep = tuple(self.endpoints[bidx])
            time.sleep(max(self.spec.promote_after_s, 0.5))

    def _publish_bport(self, inc: int, pidx: int, bport: int) -> bool:
        """CAS the re-silvered backup port into the PRIMARY's epoch row
        under the UNCHANGED incarnation — a racing promotion moves the
        incarnation and the CAS loses, aborting the resilver (the new
        primary's owner re-runs it)."""
        h = self._epoch_handle(pidx, create=True)
        if h is None:
            return False
        desired = np.zeros(EPOCH_DIM, np.float32)
        desired[E_INC] = inc
        desired[E_PRIMARY] = pidx
        desired[E_PID] = os.getpid() % (1 << 24)
        desired[E_BPORT] = bport
        try:
            with self._elock:
                swapped, _ = h.row_cas(0, E_INC, float(inc), desired)
            return bool(swapped)
        except NotImplementedError:
            with self._elock:
                row = h.sparse_pull([0])[0]
                if int(row[E_INC]) != inc:
                    return False
                h.sparse_set([0], desired.reshape(1, -1))
            return True
        except Exception:
            return False

    def resilver(self, endpoint=None, *,
                 settle_s: Optional[float] = None) -> bool:
        """Restore redundancy after a promotion: attach a FRESH backup
        van and stream a consistent snapshot of every open table onto
        it over the durable-slot snapshot/repair wire (rows via
        ``dense_pull``/``sparse_set``, optimizer slots via
        ``slots_get``/``slots_set``), while dual-write journaling
        catches up writes that land mid-copy.

        Sequence (one resilver at a time per process):

        1. resolve the new endpoint — the ``endpoint`` argument, else
           the owner-installed ``spawn_backup`` hook;
        2. adopt it locally and CAS-publish it (``E_BPORT``) on the
           primary's epoch row under the UNCHANGED incarnation; every
           peer process adopts it on its next revalidation window and
           resumes dual-writing, so peer writes during the copy land
           on the new backup too;
        3. settle for >= the peers' revalidate cadence, then journal
           this process's own replication stream per table and
           snapshot-copy rows + slots primary -> backup;
        4. cut over: drain the journal onto the backup, resume direct
           dual-write;
        5. verify/repair: re-compare rows + slots on both sides and
           re-copy divergent rows (peer writes that raced the copy)
           until bitwise identical or the pass budget runs out —
           still-hot rows converge through the restored dual-write;
        6. re-assert the epoch row on the primary (incarnation still
           unchanged), mirror it verbatim onto the new backup, clear
           the degraded window.

        Returns True when the pair is redundant again."""
        if not self._resilver_lock.acquire(blocking=False):
            return False
        t0 = _trace.now_us()
        ok = False
        tables: list = []
        rows_copied = catchup_ops = repaired = 0
        port = 0
        try:
            with self.lock:
                inc0 = self.incarnation
                pidx = self.primary_idx
                bidx = self.backup_idx
            if bidx is None:
                return False
            if endpoint is None:
                if self.spawn_backup is None:
                    return False
                endpoint = self.spawn_backup(self)
            host, port = str(endpoint[0]), int(endpoint[1])
            self._m_resilvers.inc()
            self._resilvering = True
            self._m_resilver_active.set(1)
            with self.lock:
                self.endpoints[bidx] = (host, port)
                h, self._epoch[bidx] = self._epoch[bidx], None
                if h is not None:
                    try:
                        h.close()
                    except Exception:
                        pass
                tables = [t for t in self._tables if t.replicate]
                for t in tables:
                    t._drop_handle(bidx)
            if not self._publish_bport(inc0, pidx, port):
                return False
            # the pair's MEMBERSHIP changed the moment the bport
            # published — peers dual-write to the fresh van from their
            # next revalidation on, whether or not this copy attempt
            # finishes.  Mirror the epoch row and rewrite the
            # rendezvous snapshot NOW: a failed copy must not leave an
            # adopted backup that is unpromotable (zeroed epoch row)
            # and undiscoverable (stale snapshot) through the next
            # fault.
            self._mirror_epoch_row()
            self.write_rendezvous()
            time.sleep(self.spec.resilver_settle_s
                       if settle_s is None else float(settle_s))
            for t in tables:
                t._begin_catchup()
            for t in tables:
                rows_copied += t._resilver_copy(bidx)
            for t in tables:
                catchup_ops += t._drain_catchup()
            for t in tables:
                repaired += t._resilver_verify(
                    bidx, self.spec.resilver_repair_passes)
            # the incarnation must not have moved during the copy
            if not self._publish_bport(inc0, pidx, port):
                return False
            with self.lock:
                if self.incarnation != inc0:
                    return False
            self._mirror_epoch_row()
            with self.lock:
                self.degraded = False
                self._resilver_due = False
                self._unrepl_debt = 0
                self._m_degraded.set(0)
            self.export_lag()
            # peers discover the fresh backup from the epoch row on
            # their revalidate cadence; the rendezvous snapshot covers
            # the ones that miss the window entirely
            self.write_rendezvous()
            ok = True
            return True
        finally:
            self._resilvering = False
            self._m_resilver_active.set(0)
            for t in tables:
                t._abort_catchup()  # no-op after a clean cutover
            self._m_resilver_rows.inc(rows_copied)
            self._m_resilver_catchup.inc(catchup_ops)
            self._m_resilver_repaired.inc(repaired)
            _trace.complete(
                "van.resilver", t0,
                {"ok": ok, "tables": len(tables),
                 "rows_copied": rows_copied,
                 "catchup_ops": catchup_ops,
                 "repaired_rows": repaired,
                 "backup_port": port,
                 "incarnation": self.incarnation}, cat="van")
            self._resilver_lock.release()

    # ---- factories ----
    def table(self, rows: int, dim: int, **kw) -> "ReplicatedPSTable":
        return ReplicatedPSTable(self, rows, dim, **kw)

    def channel(self, channel_id: int, *,
                connect_timeout_s: Optional[float] = None,
                failover_wait_s: Optional[float] = None):
        """A ``BlobChannel`` at the CURRENT primary.  Channels are
        transient transport, not durable state — they are not
        replicated; callers rebind (``BlobChannel`` at the new
        endpoint, seq reset) when the incarnation bumps, exactly like
        a controller-incarnation rebind.  The connect budget is SHORT
        (its in-op reconnects inherit it): a channel op against a dead
        primary must fail fast so the failover dance runs, not park
        the caller for the default 20s.  It defaults to
        :meth:`connect_budget_s` (the reference: 2 s), as the table
        handles' does: an in-op reconnect to a dead primary then hands
        over to the failover dance within the promotion grace.

        A refused connect DRIVES the failover dance here, exactly like
        a failed table op in :class:`ReplicatedPSTable`: binding a
        channel is often the FIRST van contact after a rebind signal,
        and on a second/third fault the rebind itself may be what
        discovers the fresh corpse — the bind must promote and
        re-target, not surface a crash to the watch/rebind loop that
        called it.  ``failover_wait_s`` bounds the retry window
        (default: promote_after_s plus connect slack).

        The SAME applies mid-op: an ESTABLISHED channel whose van dies
        reconnects inside put/get/ack, and a reconnect that dialed the
        snapshot endpoint would ring a corpse for the whole op timeout
        — with the caller often holding a per-member send lock, so one
        wedged scrape serializes every later submit behind it.  The
        returned channel therefore re-resolves the CURRENT primary and
        drives the failover dance on every in-op reconnect too."""
        cls = _replica_channel_cls()
        if connect_timeout_s is None:
            connect_timeout_s = self.connect_budget_s()
        if failover_wait_s is None:
            failover_wait_s = self.spec.promote_after_s + 3.0
        deadline = time.monotonic() + failover_wait_s
        while True:
            host, port = self.primary
            try:
                ch = cls(host, port, channel_id,
                         connect_timeout_s=connect_timeout_s,
                         rcv_timeout_s=self.spec.rcv_timeout_s)
                ch._bind_replica(self, failover_wait_s)
                return ch
            except ConnectionError as e:
                if self.failover(e):
                    continue  # promoted/adopted: bind at the new primary
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.05)


_REPLICA_CHANNEL_CLS = None


def _replica_channel_cls():
    """Lazily defined (van.py imports stay function-local here): a
    ``BlobChannel`` whose mid-op reconnects chase the replica's CURRENT
    primary instead of the endpoint snapshotted at bind time."""
    global _REPLICA_CHANNEL_CLS
    if _REPLICA_CHANNEL_CLS is None:
        from hetu_tpu_torch.ps.van import BlobChannel

        class _ReplicaBlobChannel(BlobChannel):
            _replica: Optional[VanReplica] = None
            _failover_wait_s = 3.0
            _bound_inc = 0

            def _bind_replica(self, replica, failover_wait_s) -> None:
                self._replica = replica
                self._failover_wait_s = float(failover_wait_s)
                self._bound_inc = replica.incarnation

            def _reconnect(self) -> None:
                rep = self._replica
                if rep is None:
                    return super()._reconnect()
                deadline = time.monotonic() + self._failover_wait_s
                while True:
                    if rep.incarnation != self._bound_inc:
                        # the van this channel's STATE lived on is
                        # gone: a reconnect that silently resumed this
                        # seq on the promoted van would desync against
                        # the peer's rebound seq-1 stream.  The caller
                        # must REBIND (fresh channel, seq reset) — the
                        # in-op reconnect's job is only to drive the
                        # promotion so that rebind has a live target.
                        raise VanFailover(
                            "van channel bound to superseded "
                            f"incarnation {self._bound_inc}; rebind "
                            f"at incarnation {rep.incarnation}")
                    try:
                        return super()._reconnect()
                    except ConnectionError as e:
                        rep.failover(e)  # drive the dance; the loop
                        # head turns a landed promotion into rebind
                        if time.monotonic() >= deadline:
                            raise
                        time.sleep(0.05)

        _REPLICA_CHANNEL_CLS = _ReplicaBlobChannel
    return _REPLICA_CHANNEL_CLS


def open_table(van_spec, host: str, port: int, rows: int, dim: int, *,
               table_id: int, create: bool, sync: bool = True, **kw):
    """Table factory shared by every plane's spawn path: a plain
    ``RemotePSTable`` at (host, port) — or, when ``van_spec`` (a
    ReplicaSpec dict / ReplicaSpec / VanReplica) names a durable-tier
    pair, a :class:`ReplicatedPSTable` over it.  The one-line switch
    that lets a worker/stage spawn config opt its weights tables into
    replication."""
    if van_spec:
        rep = VanReplica.from_spec(van_spec)
        return rep.table(rows, dim, table_id=table_id, create=create,
                         sync=sync, **kw)
    from hetu_tpu_torch.ps.van import RemotePSTable
    return RemotePSTable(host, port, rows, dim, table_id=table_id,
                         create=create, **kw)


class _ReplicaStreamer:
    """Async (lag-bounded) replication: a bounded queue of mutating ops
    drained to the backup on one daemon thread.  The queue bound IS the
    lag bound — a full queue blocks the writer, so the backup is never
    more than ``max_lag`` ops behind.  Ops that fail against the backup
    are retried a few times, then dropped with a counter (a dead backup
    must not wedge the primary's write path)."""

    def __init__(self, owner: "ReplicatedPSTable", max_lag: int):
        self.owner = owner
        self.q: queue.Queue = queue.Queue(maxsize=max(int(max_lag), 1))
        self._stop = threading.Event()
        self._m_dropped = _reg().counter(
            "van.replica.async_dropped",
            help="async replication ops dropped (backup unreachable)")
        self._m_streamed = _reg().counter(
            "van.replica.async_streamed",
            help="async replication ops applied to the backup")
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def put(self, name: str, args, kw) -> None:
        self.q.put((name, args, kw))

    def lag(self) -> int:
        return self.q.qsize()

    def flush(self, timeout_s: float = 1.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while self.q.qsize() and time.monotonic() < deadline:
            time.sleep(0.01)
        return not self.q.qsize()

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                item = self.q.get(timeout=0.2)
            except queue.Empty:
                continue
            name, args, kw = item
            ok = False
            for _ in range(3):
                h = self.owner._backup_handle()
                if h is None:
                    break
                try:
                    getattr(h, name)(*args, **kw)
                    ok = True
                    break
                except Exception as e:
                    if not _is_wire_error(e):
                        break
                    self.owner._drop_backup_handle()
                    time.sleep(0.05)
            if ok:
                self._m_streamed.inc()
                self.owner.replica._note_replicated()
            else:
                self._m_dropped.inc()
                # a dropped op is exactly the debt the degraded-window
                # lag gauge must keep visible (the queue itself drains)
                self.owner.replica._note_unreplicated()


class ReplicatedPSTable:
    """``RemotePSTable`` surface over a :class:`VanReplica` pair.

    ``sync=True`` (the default) dual-writes every mutating op — the
    op returns only once both vans acked, so a failover loses nothing
    ever written through this handle.  ``sync=False`` streams mutations
    to the backup through a lag-bounded queue instead (see
    :class:`_ReplicaStreamer`).  On a primary failure the handle runs
    the replica's failover dance and, when the primary changed, raises
    :class:`VanFailover` so the caller's retry layer replays the op
    against the promoted endpoint."""

    def __init__(self, replica: VanReplica, rows: int, dim: int, *,
                 table_id: int, create: bool = True, sync: bool = True,
                 replicate: bool = True, **table_kw):
        self.replica = replica
        self.rows, self.dim = int(rows), int(dim)
        self.id = int(table_id)
        self.sync = bool(sync)
        self.replicate = bool(replicate)
        self._create = bool(create)
        self._table_kw = dict(table_kw)
        self._hlock = threading.Lock()
        self._handles: dict = {}
        self._bound_inc = replica.incarnation
        self._m_sync = _reg().counter(
            "van.replica.sync_writes",
            help="dual-written mutating ops (both vans acked)")
        self._m_unrepl = _reg().counter(
            "van.replica.unreplicated_writes",
            help="mutating ops that reached only one van (backup "
                 "down, or post-failover single-van operation)")
        self._streamer: Optional[_ReplicaStreamer] = None
        # resilver catch-up journal: while a resilver snapshot-copies
        # this table, replication writes queue here instead of racing
        # the copy; the cutover drains them onto the new backup
        self._cu_lock = threading.Lock()
        self._catchup: Optional[list] = None
        # this process's replicated writes hold the write lock from the
        # primary write through the backup write, and the resilver's
        # verify passes hold it while they compare and repair: a repair
        # then never copies a primary row older than a write that already
        # reached the backup (an append-only ledger row, written once,
        # would stay stale for good)
        self._wlock = threading.RLock()
        # negative cache for a DEAD backup endpoint: in the degraded
        # window (promoted, resilver not yet landed) the backup slot
        # names the fresh corpse, and a sync-replicated write must not
        # pay the full connect deadline re-probing it — that stall sat
        # on the controller's poll loop and turned the SECOND fault's
        # promotion from sub-second into tens of seconds.  One probe
        # per window; an endpoint change (resilver adoption) resets it
        self._backup_down_until = 0.0
        # writes of this process that reached the primary but not the
        # backup while the backup was meant to be live (a transient fault
        # after a resilver's cutover, say): kept in order and replayed
        # onto the backup before any later write, and by a flusher thread
        # when no later write comes.  The reference drops them, and an
        # append-only ledger row dropped once never reaches the backup.
        # ``_owed_to`` is the (incarnation, backup endpoint) they are owed
        # to: once the pair moves, a promotion lost them with the old
        # primary or a resilver's snapshot copy covers them
        self._owed: list = []
        self._owed_to = None
        self._owed_flusher: Optional[threading.Thread] = None
        self._closed = False
        self._m_owed = _reg().counter(
            "van.replica.owed_writes",
            help="mutating ops whose backup half failed while the backup "
                 "was live, kept to replay")
        self._m_replayed = _reg().counter(
            "van.replica.owed_replayed",
            help="owed ops replayed onto the backup, in order")
        # build the primary handle eagerly (construction errors must
        # surface like RemotePSTable's)
        h = self._build_handle(replica.primary_idx)
        if h is None:
            host, port = replica.primary
            raise ConnectionError(
                f"cannot reach primary van {host}:{port}")
        if self.replicate and self.sync and create:
            # sync+create: bring the BACKUP copy up NOW — the creator
            # (a supervisor) may never mutate the table itself, and a
            # worker attaching later must find the backup table already
            # there (its attach handle does not create)
            self._backup_handle()
        if self.replicate and not self.sync:
            self._streamer = _ReplicaStreamer(self,
                                              replica.spec.max_lag)
            replica.register_lag_source(self._streamer.lag)
        if self.replicate:
            replica.register_table(self)
        self.dtype = self._table_kw.get("dtype", "f32")

    # ---- handles ----
    def _build_handle(self, idx: int,
                      connect_timeout_s: Optional[float] = None):
        """Try the preferred create mode first, then the other: create
        fails when the table already exists on that van (a rebuilt
        handle attaches), attach fails when it does not yet (the first
        handle on a fresh backup creates)."""
        from hetu_tpu_torch.ps.van import RemotePSTable
        host, port = self.replica.endpoints[idx]
        kw = dict(self._table_kw)
        if connect_timeout_s is not None:
            kw["connect_timeout_s"] = connect_timeout_s
        kw.setdefault("rcv_timeout_s", self.replica.spec.rcv_timeout_s)
        # fail fast: a broken op surfaces at once and the failover dance
        # decides; the handle is rebuilt (short deadline) by _handle
        kw["reconnect"] = False
        for do_create in (self._create, not self._create):
            try:
                h = RemotePSTable(host, port, self.rows, self.dim,
                                  table_id=self.id, create=do_create,
                                  **kw)
                with self._hlock:
                    self._handles[idx] = h
                return h
            except ConnectionError:
                return None  # unreachable: the other mode dials it again
            except Exception:
                continue
        return None

    def _handle(self, idx: int):
        with self._hlock:
            h = self._handles.get(idx)
        if h is not None and h.fd >= 0:
            return h
        # lazy rebuilds keep a SHORT connect budget: they run on op
        # paths (often against a dead endpoint) where the caller's
        # retry layer owns the patience
        return self._build_handle(
            idx, connect_timeout_s=self.replica.connect_budget_s())

    def _primary_handle(self):
        return self._handle(self.replica.primary_idx)

    def _backup_handle(self):
        bidx = self.replica.backup_idx
        if bidx is None:
            return None
        return self._handle(bidx)

    def _drop_backup_handle(self) -> None:
        bidx = self.replica.backup_idx
        with self._hlock:
            h = self._handles.pop(bidx, None)
        retire_handle(h)

    def _drop_handle(self, idx: int) -> None:
        with self._hlock:
            h = self._handles.pop(idx, None)
        # topology moved under this slot (promotion re-labeled it, or a
        # resilver replaced the endpoint): the backup negative cache is
        # stale — allow an immediate re-probe
        self._backup_down_until = 0.0
        # deferred close: an op thread may still be inside this handle
        retire_handle(h)

    # ---- the fence / failover core ----
    def _pre_write_check(self) -> None:
        """The stale-primary fence: before a mutating op, a cheap
        (cadence-capped) revalidation of the current primary's epoch
        row.  A promotion that happened elsewhere (this process idle
        throughout) surfaces here as :class:`VanFenced` BEFORE the
        write lands on the superseded van."""
        if self.replica.revalidate():
            raise VanFenced(
                "van primary superseded (fence observed on epoch "
                "row); re-targeted to the promoted endpoint — retry")
        if self.replica.incarnation != self._bound_inc:
            self._bound_inc = self.replica.incarnation

    def _primary_op(self, name: str, args, kw=None, *, write: bool):
        if write and self.replicate:
            with self._wlock:
                return self._op(name, args, kw, write=True)
        return self._op(name, args, kw, write=write)

    def _op(self, name: str, args, kw=None, *, write: bool):
        kw = kw or {}
        if write:
            self._pre_write_check()
        pidx = self.replica.primary_idx
        h = self._handle(pidx)
        if h is None:
            if self.replica.failover():
                self._bound_inc = self.replica.incarnation
                raise VanFailover(
                    "van primary unreachable; promoted "
                    f"incarnation {self.replica.incarnation} — retry")
            host, port = self.replica.endpoints[pidx]
            raise ConnectionError(f"cannot reach van {host}:{port}")
        try:
            out = getattr(h, name)(*args, **kw)
        except Exception as e:
            if not _is_wire_error(e):
                raise
            self._drop_handle(pidx)
            if self.replica.failover(e):
                self._bound_inc = self.replica.incarnation
                raise VanFailover(
                    "van primary failed over to incarnation "
                    f"{self.replica.incarnation} — retry") from e
            raise
        self.replica.note_ok()
        if write and self.replicate:
            self._replicate(name, args, kw)
        return out

    def _replicate(self, name: str, args, kw) -> None:
        """The backup half of a write (the caller holds ``_wlock``)."""
        op = (name, args, kw)
        with self._cu_lock:
            if self._catchup is not None:
                # a resilver is snapshot-copying this table: journal
                # the write; the cutover drains it onto the backup in
                # order, after the copy
                self._catchup.append(op)
                return
        if self._streamer is not None:
            self._streamer.put(name, args, kw)
            return
        # an owed write goes first: this one queues behind it
        if not self._pay_owed() or not self._apply_backup(op):
            self._owe(op)

    def _apply_backup(self, op) -> bool:
        """One write onto the backup, with one rebuild-and-retry: a
        backup that bounced (or a stale fd) must not instantly degrade
        the table to unreplicated.  A failure arms the 1 s negative
        cache.  Returns whether the backup took the write."""
        if time.monotonic() < self._backup_down_until:
            return False
        name, args, kw = op
        h = self._backup_handle()
        err = None
        if h is not None:
            try:
                getattr(h, name)(*args, **kw)
            except Exception as e:
                if not _is_wire_error(e):
                    raise
                err = e
                self._drop_backup_handle()
                h = self._backup_handle()
                if h is not None:
                    try:
                        getattr(h, name)(*args, **kw)
                        err = None
                    except Exception as e2:
                        if not _is_wire_error(e2):
                            raise
                        self._drop_backup_handle()
            if err is None and h is not None:
                self._m_sync.inc()
                self.replica._note_replicated()
                return True
        bidx = self.replica.backup_idx
        _dbg(f"table {self.id:#x}: backup "
             f"{self.replica.endpoints[bidx] if bidx is not None else None}"
             f" {'unreachable' if err is None else f'failed ({err!r})'}; "
             f"writes owed to it for 1 s")
        self._backup_down_until = time.monotonic() + 1.0
        return False

    def _owed_target(self):
        with self.replica.lock:
            bidx = self.replica.backup_idx
            return (self.replica.incarnation,
                    None if bidx is None else self.replica.endpoints[bidx])

    def _owe(self, op) -> None:
        """A write that reached only the primary: keep it for the backup,
        in order, and make sure a flusher replays it.  Not in the
        degraded window before a resilver starts, when the backup is the
        van that died: the snapshot copy covers those writes."""
        self._m_unrepl.inc()
        self.replica._note_unreplicated()
        if self.replica.degraded and not self.replica._resilvering:
            return
        to = self._owed_target()
        with self._cu_lock:
            if self._owed_to != to:
                self._owed.clear()
                self._owed_to = to
            if len(self._owed) >= _OWED_MAX:
                # a backup down this long is a dead one: a promotion or
                # a resilver moves the pair, and the copy covers these
                return
            self._owed.append(op)
            self._m_owed.inc()
            if self._owed_flusher is None and not self._closed:
                self._owed_flusher = threading.Thread(
                    target=self._flush_owed, daemon=True,
                    name=f"van-owed-{self.id:#x}")
                self._owed_flusher.start()

    def _pay_owed(self) -> bool:
        """Replay the owed writes onto the backup, oldest first (the
        caller holds ``_wlock``, as every writer of ``_owed`` does).
        Returns True when none is left."""
        if not self._owed:
            return True
        while True:
            to = self._owed_target()
            with self._cu_lock:
                if self._owed and self._owed_to != to:
                    self._owed.clear()
                if not self._owed:
                    return True
                op = self._owed[0]
            if not self._apply_backup(op):
                return False
            with self._cu_lock:
                if self._owed and self._owed[0] is op:
                    self._owed.pop(0)
                    self._m_replayed.inc()

    def _flush_owed(self) -> None:
        """Flusher thread: replays owed writes when no later write comes
        to push them, once the negative cache has run out."""
        while not self._closed:
            time.sleep(min(max(self._backup_down_until - time.monotonic(),
                               0.05), 1.0))
            with self._wlock:
                paid = self._pay_owed()
            with self._cu_lock:
                if paid and not self._owed:
                    self._owed_flusher = None
                    return
        with self._cu_lock:
            self._owed_flusher = None

    # ---- resilver plumbing (driven by VanReplica.resilver) ----
    def _begin_catchup(self) -> None:
        # under the write lock, so that no write of ours is between its
        # primary and its backup half: everything owed so far landed on
        # the primary, and the snapshot copy that follows covers it
        with self._wlock, self._cu_lock:
            self._catchup = []
            self._owed.clear()

    def _drain_catchup(self) -> int:
        """Cutover: apply the journaled writes to the new backup in
        order, then resume direct dual-write.  Holds the write lock
        throughout — concurrent writers block for the (short) drain
        instead of interleaving out of order; a journaled write the
        backup refuses is owed, with those after it."""
        n = 0
        with self._wlock:
            with self._cu_lock:
                ops, self._catchup = (self._catchup or []), None
                # dual-write resumes against the FRESH backup: a negative
                # cache armed by the dead one (or by a write that raced
                # the endpoint swap) must not hold back the writes that
                # follow the cutover (the reference keeps the cache)
                self._backup_down_until = 0.0
            for i, op in enumerate(ops):
                if not self._apply_backup(op):
                    for rest in ops[i:]:
                        self._owe(rest)
                    break
                n += 1
        return n

    def _abort_catchup(self) -> None:
        """A resilver died mid-copy: the journaled writes never reached
        the backup — count them as unreplicated debt and resume the
        normal (degraded) write path."""
        with self._cu_lock:
            ops, self._catchup = (self._catchup or []), None
        for _ in ops:
            self.replica._note_unreplicated()

    def _resilver_conn(self, idx: int):
        """Dedicated connection for bulk resilver traffic on slot
        ``idx``, never entered into the handle cache.  The cached
        op-path handles are shared by op threads with no per-fd lock;
        a full-table snapshot interleaving frames with a concurrent op
        desyncs the stream for BOTH users, and every later request on
        that fd returns a transport error.  Bulk copy and verify run
        on private fds instead, closed when the pass finishes."""
        from hetu_tpu_torch.ps.van import RemotePSTable
        host, port = self.replica.endpoints[idx]
        kw = dict(self._table_kw)
        kw["connect_timeout_s"] = 2.0
        # full-table pulls are much larger than op-path frames
        kw["rcv_timeout_s"] = max(
            float(self.replica.spec.rcv_timeout_s), 5.0)
        kw["reconnect"] = False
        for do_create in (self._create, not self._create):
            try:
                return RemotePSTable(host, port, self.rows, self.dim,
                                     table_id=self.id, create=do_create,
                                     **kw)
            except Exception:
                continue
        return None

    def _resilver_copy(self, bidx: int) -> int:
        """Snapshot rows + optimizer slots primary -> fresh backup over
        the durable-slot repair wire.  The backup-side handle CREATES
        the table (same table_kw) when it does not exist yet."""
        hp = self._resilver_conn(self.replica.primary_idx)
        hb = self._resilver_conn(bidx)
        try:
            if hp is None or hb is None:
                raise ConnectionError(
                    f"resilver: van pair unreachable for table "
                    f"{self.id:#x}")
            idx = np.arange(self.rows, dtype=np.int64)
            hb.sparse_set(idx, hp.dense_pull())
            s1, s2, step = hp.slots_get(idx)
            hb.slots_set(idx, s1, s2, step)
            return self.rows
        finally:
            for h in (hp, hb):
                if h is not None:
                    try:
                        h.close()
                    except Exception:
                        pass

    def _resilver_verify(self, bidx: int, passes: int) -> int:
        """Compare rows + slots on both vans, re-copying divergent rows
        (peer writes that raced the snapshot), until bitwise identical
        or the pass budget runs out.  Rows still being written diverge
        transiently between the two (non-atomic) reads — the restored
        dual-write converges them; quiesced tables come out exact."""
        hp = self._resilver_conn(self.replica.primary_idx)
        hb = self._resilver_conn(bidx)
        try:
            if hp is None or hb is None:
                raise ConnectionError(
                    f"resilver: van pair unreachable for table "
                    f"{self.id:#x}")
            idx = np.arange(self.rows, dtype=np.int64)
            repaired = 0
            for _ in range(max(int(passes), 1)):
                with self._wlock:  # no write of ours half-landed
                    wp, wb = hp.dense_pull(), hb.dense_pull()
                    s1p, s2p, stp = hp.slots_get(idx)
                    s1b, s2b, stb = hb.slots_get(idx)
                    bad = ~(np.all(wp == wb, axis=1)
                            & np.all(s1p == s1b, axis=1)
                            & np.all(s2p == s2b, axis=1)
                            & (stp == stb))
                    if not bad.any():
                        self._owed.clear()
                        break
                    rows = idx[bad]
                    hb.sparse_set(rows, wp[bad])
                    hb.slots_set(rows, s1p[bad], s2p[bad], stp[bad])
                    # every write of ours is on the backup now: a replay
                    # of an owed push would apply it twice
                    self._owed.clear()
                repaired += int(bad.sum())
            return repaired
        finally:
            for h in (hp, hb):
                if h is not None:
                    try:
                        h.close()
                    except Exception:
                        pass

    # ---- RemotePSTable surface ----
    def ping(self) -> bool:
        try:
            return bool(self._primary_op("ping", (), write=False))
        except Exception:
            return False

    def sparse_pull(self, indices):
        return self._primary_op("sparse_pull", (indices,), write=False)

    def dense_pull(self):
        return self._primary_op("dense_pull", (), write=False)

    def slots_get(self, indices):
        return self._primary_op("slots_get", (indices,), write=False)

    def sparse_push(self, indices, grads) -> None:
        self._primary_op("sparse_push", (indices, grads), write=True)

    def dense_push(self, grad) -> None:
        self._primary_op("dense_push", (grad,), write=True)

    def sparse_set(self, indices, values) -> None:
        # materialize: async replication must not race the caller's
        # buffer reuse (the queue holds a reference, not a copy)
        idx = np.ascontiguousarray(np.asarray(indices).reshape(-1))
        v = np.ascontiguousarray(values)
        self._primary_op("sparse_set", (idx, v), write=True)

    def slots_set(self, indices, s1, s2, step) -> None:
        self._primary_op("slots_set", (indices, s1, s2, step),
                         write=True)

    def row_cas(self, row: int, fld: int, expected: float, desired):
        """Dual-written CAS: the primary decides (its swap result is
        THE result); the decided row is mirrored to the backup as a
        verbatim ``sparse_set`` of the actual post-op row — so the
        backup converges to the primary's decision whichever claimant
        won."""
        with self._wlock:
            self._pre_write_check()
            swapped, actual = self._primary_op(
                "row_cas", (row, fld, expected, desired), write=False)
            if self.replicate:
                self._replicate("sparse_set",
                                ([int(row)], actual.reshape(1, -1)), {})
        return swapped, actual

    def clear(self) -> None:
        self._primary_op("clear", (), write=True)

    def flush_replication(self, timeout_s: float = 2.0) -> bool:
        if self._streamer is not None:
            return self._streamer.flush(timeout_s)
        return True

    def replication_lag(self) -> int:
        return self._streamer.lag() if self._streamer is not None else 0

    def close(self) -> None:
        self._closed = True
        if self._streamer is not None:
            self._streamer.flush(0.5)
            self._streamer.stop()
        with self._hlock:
            handles, self._handles = dict(self._handles), {}
        for h in handles.values():
            try:
                h.close()
            except Exception:
                pass

    @property
    def fd(self) -> int:
        """The primary connection's fd (diagnostics only)."""
        h = self._handles.get(self.replica.primary_idx)
        return h.fd if h is not None else -1
