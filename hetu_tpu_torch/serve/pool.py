"""Serving-pool HA (counterpart of ``hetu_tpu/serve/pool.py``):
health-routed routing over N engines, planned drain with live KV
migration, unplanned failover with re-prefill.

One :class:`~hetu_tpu_torch.serve.server.InferenceServer` survives an
engine crash (requeue + re-prefill + ``restart_engine``), but a pool of
them is what preemptible capacity needs: requests route to the least
loaded healthy member, a PLANNED preemption (``serve_preempt`` fault or
an operator calling :meth:`ServingPool.drain_member`) migrates the
member's live KV slots and mid-decode requests to a peer over the van
blob channel — the peer continues token-for-token with ZERO re-prefill —
and an UNPLANNED death (``serve_engine_kill``: the engine is gone, state
and all) falls back to the fold-and-re-prefill on a surviving peer.  The
client-visible contract either way: every accepted request completes.

Topology: the pool owns ONE van server; members are
``InferenceServer``\\ s with ``max_clients=0`` (engine loop + failover
machinery, no wire listeners — the pool is the front door and routes
in-process).  Each member's engine sits behind a kill-switch proxy so
chaos runs can SIGKILL-alike it deterministically.  Recovery spans:
planned drains record ``serve.migrate``, unplanned failovers
``serve.failover`` — :data:`hetu_tpu_torch.telemetry.timeline.RECOVERY_FOR`
pairs them with the injected ``fault.serve_*`` instants so a chaos run
reports per-kind detection/recovery percentiles.

The engines are the port's ``ServeEngine`` s, on the card or the CPU;
the pool itself is host Python and moves K/V only through the engines'
own ``export_slots`` / ``adopt_slots``.
"""

from __future__ import annotations

import itertools
import threading
import traceback
from typing import Optional

from hetu_tpu_torch.serve import migrate as _migrate
from hetu_tpu_torch.serve.metrics import ServeMetrics
from hetu_tpu_torch.serve.scheduler import (
    ContinuousBatchingScheduler, Request, cancel_detached, finish_request,
)
from hetu_tpu_torch.serve.server import InferenceServer
from hetu_tpu_torch.telemetry import trace

# migration transfers use their own channel-id namespace, ~1e8 ids BELOW
# the serve request/response namespace (SERVE_CHANNEL_BASE = 0x53525645
# in server.py — this base counts upward toward that gap); each transfer
# gets a fresh id so seqs never collide
MIGRATE_CHANNEL_BASE = 0x4D494752  # 'MIGR'

# PROCESS-GLOBAL transfer counter: the van server is process-wide and
# ``own_van=False`` explicitly supports several pools attaching to one
# van — pool-local counters would hand two concurrent drains the SAME
# channel id, and each receiver would consume the other's (individually
# CRC-valid) chunks.
_MIG_SEQ = itertools.count(1)


class EngineKilled(RuntimeError):
    """The pool's kill switch fired: this member's engine is gone."""


class _GuardedEngine:
    """Kill-switch proxy over a ServeEngine.

    ``kill()`` makes every subsequent engine VERB raise — the in-process
    analog of SIGKILLing a member's GPU process: unannounced and
    state-losing (the KV tensors become unreachable through the proxy's
    verbs; the raw cache stays readable so a dead member's slots can
    still be freed and its telemetry read)."""

    def __init__(self, inner):
        self.inner = inner
        self.killed = False

    @property
    def cache(self):
        return self.inner.cache

    @property
    def metrics(self):
        return self.inner.metrics

    def kill(self) -> None:
        self.killed = True

    def _check(self) -> None:
        if self.killed:
            raise EngineKilled("pool member engine killed")

    def alloc_slot(self):
        self._check()
        return self.inner.alloc_slot()

    def release(self, slot):
        self._check()
        self.inner.release(slot)

    def prefill(self, slot, prompt):
        self._check()
        return self.inner.prefill(slot, prompt)

    def decode(self):
        self._check()
        return self.inner.decode()

    def export_slots(self, slot_ids):
        self._check()
        return self.inner.export_slots(slot_ids)

    def adopt_slots(self, snapshots):
        self._check()
        return self.inner.adopt_slots(snapshots)

    def resume_slots(self, slot_ids):
        self._check()
        self.inner.resume_slots(slot_ids)


class PoolMember:
    """One engine + scheduler + (listener-less) server in the pool.

    ``fresh_engine`` builds a new GUARDED engine from the member's
    factory — ``revive_member`` goes through it so a custom member kind
    (the CTR members ``member_factory`` builds in serve/recsys.py) revives
    with ITS guard class, not the LLM one."""

    def __init__(self, name: str, factory, scheduler, server, *,
                 fresh_engine=None):
        self.name = name
        self.factory = factory
        self.scheduler = scheduler
        self.server = server
        self.fresh_engine = fresh_engine if fresh_engine is not None \
            else (lambda: _GuardedEngine(factory()))
        self.draining = False  # planned drain in progress / completed
        self.dead = False      # failed over or drained-and-closed
        self.pending = 0       # submits routed here, not yet queued

    @property
    def engine(self):
        return self.scheduler.engine

    @property
    def available(self) -> bool:
        return (not self.draining and not self.dead and
                self.server.healthy)


class ServingPool:
    """Router + supervisor over N serving members.

    ``engine_factories``: ``{name: factory}`` (or a list; names become
    ``m0..mN``) where each factory builds a fresh ``ServeEngine`` — the
    same factory revives a member after death.  The pool starts one van
    server for the whole process (``own_van=False`` + ``port`` attaches
    to an existing one) — members share it for migration transfers.

    Health: a poll thread watches ``member.server.healthy`` and fails a
    dead member's queue over to surviving peers automatically
    (``health_poll_s``; pass ``start_poll=False`` to drive :meth:`poll`
    manually in tests).
    """

    def __init__(self, engine_factories, *, port: int = 0,
                 own_van: bool = True, max_requeues: int = 5, max_loop_errors: int = 2,
                 failover_grace_s: float = 30.0,
                 health_poll_s: float = 0.05,
                 request_timeout_s: float = 60.0,
                 chunk_bytes: int = _migrate.DEFAULT_CHUNK_BYTES,
                 migrate_codec: str = "none",
                 metrics: Optional[ServeMetrics] = None,
                 member_factory=None,
                 start_poll: bool = True):
        from hetu_tpu_torch.ps import van
        # member_factory(pool, name, engine_factory) -> PoolMember lets a
        # different serving workload (the CTR members of
        # serve/recsys.RecsysPool) ride the SAME routing/drain/failover
        # machinery; None = the LLM member (engine + continuous-batching
        # scheduler + listener-less InferenceServer)
        self._member_factory = member_factory
        items = list(engine_factories.items()) \
            if isinstance(engine_factories, dict) \
            else [(f"m{i}", f) for i, f in enumerate(engine_factories)]
        if not items:
            # validate BEFORE starting the van: raising after serve()
            # would leak the process-wide van server with no owner
            raise ValueError("a serving pool needs at least one member")
        self._van = van
        self._own_van = own_van
        if own_van:
            self.port = van.serve(port)
        else:
            if not port:
                raise ValueError("own_van=False needs the running van's port")
            self.port = port
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.request_timeout_s = float(request_timeout_s)
        self._max_requeues = int(max_requeues)
        self._max_loop_errors = int(max_loop_errors)
        self._failover_grace_s = float(failover_grace_s)
        self._chunk_bytes = int(chunk_bytes)
        # wire codec for drain payloads ("bf16"/"int8", see migrate.pack;
        # "auto" picks per drain from the known link rate)
        self.migrate_codec = _migrate.check_codec(migrate_codec)
        self._lock = threading.RLock()
        self.members: dict = {}
        try:
            for name, factory in items:
                self.members[str(name)] = self._make_member(str(name),
                                                            factory)
        except Exception:
            self.close()
            raise
        self._stop = threading.Event()
        self._poll_thread = None
        if start_poll:
            self._poll_thread = threading.Thread(
                target=self._poll_loop, args=(float(health_poll_s),),
                daemon=True)
            self._poll_thread.start()

    def _make_member(self, name: str, factory) -> PoolMember:
        if self._member_factory is not None:
            return self._member_factory(self, name, factory)
        engine = _GuardedEngine(factory())
        sched = ContinuousBatchingScheduler(
            engine, max_requeues=self._max_requeues)
        srv = InferenceServer(
            sched, port=self.port, own_van=False, max_clients=0,
            request_timeout_s=self.request_timeout_s,
            max_loop_errors=self._max_loop_errors,
            failover_grace_s=self._failover_grace_s)
        return PoolMember(name, factory, sched, srv)

    # ---- routing ----
    @property
    def healthy(self) -> bool:
        with self._lock:
            return any(m.available for m in self.members.values())

    def pick(self, *, exclude=()) -> Optional[PoolMember]:
        """Least-loaded available member, or None.  The load signal
        counts submits already routed to a member but not yet visible in
        its queue (``member.pending``): the queue append happens outside
        the pool lock, so without it N concurrent submits all read the
        same stale count and pile onto one member — leaving its peers
        idle, which under chaos means a killed idle peer whose death
        nothing ever detects."""
        with self._lock:
            cands = [m for m in self.members.values()
                     if m.available and m.name not in exclude]
            if not cands:
                return None
            return min(cands, key=lambda m: m.scheduler.load + m.pending)

    def submit(self, request: Request) -> Request:
        """Route to the healthiest member; with no member available the
        request completes immediately with status 'error' (fail fast —
        nothing would ever serve it).

        The member's ``scheduler.submit`` runs OUTSIDE the pool lock: it
        takes that member's scheduler lock, which its engine loop holds
        across whole decode steps — submitting under the pool lock would
        stall all routing (and failover detection) behind one busy or
        wedged member.  The cost is a race with a concurrent
        drain/failover of the picked member, resolved by re-routing: a
        rejected submit (terminal status, zero tokens) retries the next
        member."""
        for _ in range(len(self.members) + 1):
            with self._lock:
                m = self.pick()
                if m is not None:
                    m.pending += 1  # claim the routing slot under the lock
            if m is None:
                break
            try:
                m.scheduler.submit(request, resolve_on_reject=False)
            finally:
                with self._lock:
                    m.pending -= 1
            if not request.rejected:
                self.metrics.inc("pool_requests")
                return request
            # the picked member drained between pick and submit — its
            # scheduler flagged the EXPLICIT reject (an accepted request
            # that genuinely failed with zero tokens must NOT re-route:
            # a member already finished it) without resolving the
            # request (resolve_on_reject=False), so a waiter already
            # parked on request.done sleeps through the re-route — no
            # event swap, no transient terminal state for it to misread.
            # Clear the flag and try another member
            request.rejected = False
        self._finish_unrouted(request, "error")
        self.metrics.inc("requests_rejected_no_member")
        return request

    def _finish_unrouted(self, req: Request, status: str) -> None:
        # same terminal bookkeeping as a scheduler finish, against the
        # POOL's metrics — the requests the HA layer itself resolves
        # must not vanish from the requests_<status> counters a chaos
        # dashboard reads
        finish_request(req, status, self.metrics)

    def generate(self, prompt, *, max_tokens: int = 16, eos_id=None,
                 timeout_s: Optional[float] = None) -> dict:
        """Blocking convenience: submit + wait; the response dict matches
        the wire server's shape."""
        req = Request(prompt=[int(t) for t in prompt],
                      max_tokens=int(max_tokens), eos_id=eos_id,
                      timeout_s=float(timeout_s if timeout_s is not None
                                      else self.request_timeout_s))
        self.submit(req)
        # generous backstop over the serving deadline: a mid-flight
        # migration/failover must not strand the waiter
        if not req.done.wait(timeout=req.timeout_s + 15.0):
            # resolve 'timeout', not 'cancelled' — unless the request
            # finished in the race, in which case the cancel keeps its
            # real terminal status
            self._cancel(req, "timeout")
        return {"id": req.rid, "status": req.status or "ok",
                "tokens": list(req.tokens), "ttft_s": req.ttft_s}

    def _cancel(self, req: Request, status: str = "cancelled") -> None:
        # go straight to the request's stamped owner instead of scanning
        # every member with owns(): the scan takes each scheduler's lock
        # in turn, so ONE wedged member (engine stuck mid-step, loop
        # thread alive and 'healthy') would block cancelling a request
        # served by a healthy peer forever — the exact backstop this
        # cancel exists to provide.  cancel_detached resolves the waiter
        # WITHOUT the owner's scheduler lock (the owner itself may be
        # the wedged member) and detaches the dequeue/slot cleanup.  A
        # stale owner read (the request migrated underneath us) still
        # resolves the request, and finish_request's per-request guard
        # keeps the racing finishers single-charged.
        owner = req.owner
        if owner is not None:
            cancel_detached(owner, req, status)
            return
        if not req.done.is_set():  # in transit between members
            self._finish_unrouted(req, status)

    # ---- health / unplanned failover ----
    def _poll_loop(self, poll_s: float) -> None:
        while not self._stop.wait(poll_s):
            try:
                self.poll()
            except Exception:
                traceback.print_exc()  # the poll must survive anything

    def poll(self) -> int:
        """One health sweep: members whose engine loop died hand their
        surviving queue to peers (the unplanned path).  Returns how many
        members failed over."""
        with self._lock:
            down = [m for m in self.members.values()
                    if not m.dead and not m.draining
                    and not m.server.healthy]
        n = 0
        for m in down:
            self.failover(m.name)
            n += 1
        return n

    def failover(self, name: str) -> int:
        """Unplanned failover: the member's engine is gone (KV state and
        all), so its queue — including requests the dying engine loop
        already requeued — re-prefills on surviving peers.  Records a
        ``serve.failover`` recovery span.  Returns requests moved."""
        m = self.members[name]
        with self._lock:
            # a member mid-drain belongs to drain_member: ripping its
            # scheduler's intake out from under the drain would make the
            # drain's failure ROLLBACK impossible (adopt-back onto a
            # drained scheduler raises, terminally 'error'-ing accepted
            # requests a peer could still serve).  If the drain fails it
            # clears `draining` and the next health sweep lands here.
            if m.dead or m.draining:
                return 0
            m.dead = True
        with trace.span("serve.failover", cat="serve") as sp:
            sp.set("member", name)
            # the dead member's grace timer must not fire later and
            # 'error'-drain bookkeeping we are about to hand to a peer.
            # Nothing here may abort the failover: m.dead is already
            # claimed, so an exception would strand the queue forever
            # (the disarm itself is the event set, which cannot fail)
            try:
                m.server.cancel_failover_grace()
            except Exception:
                traceback.print_exc()
            # close intake BEFORE the export: a submit that lost the
            # pick-vs-failover race is then REJECTED (and re-routed by
            # pool.submit) — were intake still open, it could be
            # admitted AFTER the export into a queue nothing will ever
            # serve and be terminally drained by the member's close
            m.scheduler.stop_intake("error")
            pairs = m.scheduler.export_inflight(fold=True)
            moved = self._rehome(pairs, tried={name})
            sp.set("requests", moved)
        self.metrics.inc("pool_failovers")
        self.metrics.inc("requests_failed_over", moved)
        return moved

    def _rehome(self, pairs, *, tried: set) -> int:
        """Adopt exported ``(request, None)`` pairs onto surviving peers
        (the re-prefill path); requests nothing can serve resolve
        'error' — never stranded.  The whole batch adopts in ONE
        ``adopt_inflight`` call per picked peer (all-or-nothing for
        slotless pairs): the target's scheduler lock is held across
        whole decode steps, so per-request adopts would make failover
        wall-clock O(requests x decode_step).  ``tried`` carries across
        attempts: a peer that failed the adopt (drained/dead) is no
        home for ANY of this batch.  Returns how many requests found a
        peer."""
        remaining = [req for req, _ in pairs if not req.done.is_set()]
        # done-in-transit: over-cap requests finished 'error' in the export
        moved = 0
        while remaining:
            with self._lock:
                tgt = self.pick(exclude=tuple(tried))
            if tgt is None:
                break
            try:
                # count what the target ACTUALLY attached: a request
                # that finished in transit (cancel/backstop-timeout
                # racing the failover) is skipped by adopt_inflight and
                # must not inflate requests_failed_over / the
                # serve.failover span
                _, moved = tgt.scheduler.adopt_inflight(
                    [(req, None) for req in remaining], return_count=True)
            except Exception:
                # the peer drained between pick and adopt: try next
                tried.add(tgt.name)
                continue
            remaining = []
        for req in remaining:
            self._finish_unrouted(req, "error")
            self.metrics.inc("requests_lost_no_peer")
        return moved

    # ---- planned drain (live migration) ----
    def drain_member(self, name: str, *, close: bool = True,
                     wire: bool = True,
                     codec: Optional[str] = None) -> dict:
        """Planned drain (operator signal or ``serve_preempt`` fault):
        migrate every live KV slot and in-flight request to a surviving
        peer — the peer continues mid-decode sequences token-for-token
        with zero re-prefill — then take the member out of service
        (``close=True``: shut its server down, the migrate-then-exit a
        preemption notice wants).  Records a ``serve.migrate`` recovery
        span.  Returns ``{source_slot: dest_slot}``.

        ``wire=True`` sends the K/V payload over the pool's van as
        CRC-checked chunks (the same path a cross-process pool takes);
        ``wire=False`` hands the host arrays over directly.

        ``codec`` overrides the pool-level ``migrate_codec`` for THIS
        drain only: a preemption-deadline drain can pick
        "int8" (~4x smaller payload, near-lossless) while routine drains
        stay on the pool default — the codec is a per-eviction-notice
        decision, not a pool property.  ``None`` = the pool default.

        On failure the member re-adopts everything and KEEPS SERVING
        (the error re-raises) — unless its engine is already dead, in
        which case the caller's health poll takes the failover path.
        """
        codec = self.migrate_codec if codec is None \
            else _migrate.check_codec(codec)
        m = self.members[name]
        if codec == "auto":
            # per-drain resolution from the known link rate (a netem cap
            # if one is installed) and THIS member's live payload: the
            # migration-vs-size crossover, applied at drain time
            codec = _migrate.resolve_codec("auto", m.scheduler.engine)
        with self._lock:
            if m.dead or m.draining:
                return {}
            m.draining = True  # stops routing before the export
        tried = {name}
        try:
            with trace.span("serve.migrate", cat="serve") as sp:
                sp.set("member", name)
                while True:
                    with self._lock:
                        tgt = self.pick(exclude=tuple(tried))
                    if tgt is None:
                        raise RuntimeError(
                            f"no surviving peer to drain '{name}' into")
                    sp.set("target", tgt.name)
                    chs: list = []
                    try:
                        # a queued-only / idle member has no K/V to ship:
                        # migrate_inflight would never touch the wire, so
                        # don't connect (and burn a channel id) for
                        # nothing.  Lock-free read; a request admitted to
                        # running in the window just takes the in-process
                        # hand-over (wire=None), which is equally exact
                        if wire and m.scheduler.running_count:
                            # each channel tracked as constructed, so a
                            # failure building the SECOND one still
                            # closes the first — and a wire-layer setup
                            # failure aborts the drain instead of
                            # blaming (and excluding) a healthy target
                            ch_id = MIGRATE_CHANNEL_BASE + next(_MIG_SEQ)
                            for _ in range(2):
                                chs.append(self._van.BlobChannel(
                                    "127.0.0.1", self.port, ch_id))
                    except Exception:
                        for ch in chs:
                            try:
                                ch.close()
                            except Exception:
                                pass
                        raise
                    try:
                        slot_map = _migrate.migrate_inflight(
                            m.scheduler, tgt.scheduler,
                            wire=tuple(chs) if chs else None,
                            codec=codec,
                            chunk_bytes=self._chunk_bytes)
                        break
                    except _migrate.MigrationTargetError:
                        # migrate_inflight rolled everything back onto
                        # the source, so retrying elsewhere is safe — a
                        # TARGET that failed the adoption (e.g. its
                        # engine was killed but not yet detected) is no
                        # home for this member's work; try the next
                        # peer.  Source-side/wire failures propagate
                        # instead: re-exporting against another peer
                        # would fail identically.
                        tried.add(tgt.name)
                        if len(tried) >= len(self.members):
                            # every member tried: re-raise THIS error —
                            # looping once more would pick() None and
                            # bury the real adoption failure under the
                            # generic 'no surviving peer'
                            raise
                    finally:
                        for ch in chs:
                            try:
                                ch.close()
                            except Exception:
                                pass
                sp.set("slots", len(slot_map))
        except Exception:
            with self._lock:
                m.draining = False  # back in service (or the poll's hands)
            raise
        self.metrics.inc("pool_migrations")
        self.metrics.inc("slots_migrated", len(slot_map))
        if close:
            # a submit that raced pick-vs-drain may have been admitted
            # AFTER the export: close intake first (late submits now
            # reject and pool.submit re-routes them), then sweep
            # anything that landed in the window onto the peers — the
            # close below must never terminally 'shutdown' an accepted
            # request
            m.scheduler.stop_intake("shutdown")
            stragglers = m.scheduler.export_inflight(fold=True)
            if stragglers:
                swept = self._rehome(stragglers, tried={name})
                self.metrics.inc("requests_swept_on_drain", swept)
            m.server.close()
            self._close_engine(m)
            with self._lock:
                m.dead = True
        return slot_map

    # ---- membership ----
    def kill_member(self, name: str) -> None:
        """Flip the member's engine kill switch (the ``serve_engine_kill``
        chaos fault): the engine loop strikes out, ``healthy`` drops, and
        the health poll fails its queue over to a peer."""
        self.members[name].engine.kill()
        self.metrics.inc("members_killed")

    def revive_member(self, name: str) -> None:
        """Bring a dead/drained member back with a fresh engine from its
        factory; it rejoins routing immediately."""
        m = self.members[name]
        self._close_engine(m)  # the dead engine's resources (e.g. a CTR
        # member's serving caches, whose open degrade window must be
        # recorded, not dropped) are released before the replacement
        if m.server._stop.is_set():
            # drained-and-closed: the old server is gone; rebuild whole
            self.members[name] = self._make_member(name, m.factory)
        else:
            m.server.restart_engine(m.fresh_engine())
            with self._lock:
                m.dead = False
                m.draining = False
        self.metrics.inc("members_revived")

    # ---- chaos integration ----
    def apply_fault(self, kind: str, member_idx: int) -> None:
        """Route an injected serve fault at a member by index (modulo the
        pool size, insertion order): ``serve_preempt`` = planned drain
        (migrate-then-exit), ``serve_engine_kill`` = abrupt engine death
        (the health poll then fails it over)."""
        names = list(self.members)
        name = names[int(member_idx) % len(names)]
        if kind == "serve_preempt":
            try:
                self.drain_member(name)
            except Exception:
                # no peer / engine already dead: the failover path (or
                # the operator) owns it now — a chaos injection must not
                # kill the chaos loop
                traceback.print_exc()
        elif kind == "serve_engine_kill":
            self.kill_member(name)
        else:
            raise ValueError(f"unknown serve fault kind {kind!r}")

    def run_fault_events(self, events) -> None:
        """Apply events drained from
        ``FaultInjector.pop_serve_events()``."""
        for kind, idx in events:
            self.apply_fault(kind, idx)

    # ---- lifecycle ----
    @staticmethod
    def _close_engine(m: PoolMember) -> None:
        """Best-effort engine close where the engine kind has one (the
        LLM ServeEngine does not; a CTR engine closes its serving
        caches, recording any still-open degrade span)."""
        close = getattr(m.scheduler.engine, "close", None)
        if close is None:
            return
        try:
            close()
        except Exception:
            traceback.print_exc()

    def close(self, timeout_s: float = 10.0) -> None:
        stop = getattr(self, "_stop", None)
        if stop is not None:
            stop.set()
        t = getattr(self, "_poll_thread", None)
        if t is not None:
            t.join(timeout_s)
        for m in self.members.values():
            try:
                m.server.close(timeout_s)
            except Exception:
                traceback.print_exc()
            self._close_engine(m)
        if self._own_van:
            self._van.stop()
