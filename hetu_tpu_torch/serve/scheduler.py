"""Continuous-batching scheduler over a ServeEngine.

Static batch-at-once serving wastes every slot that finishes early;
continuous batching admits new requests into freed slots at EVERY decode
step (the Orca/vLLM iteration-level scheduling idea): each ``step()``
first admits queued requests while (a) a cache slot is free and (b) the
token budget holds the working set — prompt + one generated token must
fit alongside the tokens already cached (backpressure, so a burst of
long prompts queues instead of thrashing the cache) — then runs ONE
decode step for every active slot and evicts sequences that hit EOS,
their ``max_tokens``, the cache's ``max_len``, or their deadline.

Thread-safe: the server's listener threads ``submit()``/``cancel()``
concurrently with the engine loop calling ``step()``.

A copy of ``hetu_tpu/serve/scheduler.py`` (pure Python, no framework
code), kept as it is apart from these imports so the two packages admit,
evict and order requests identically.  Both engines of this package back
it: the slot :class:`ServeEngine` (``alloc_slot``/``prefill``/``decode``/
``release``) and the :class:`PagedServeEngine`, which adds the paged
branches (page-budget admission through ``admission_ok``, chunked prefill
through ``begin_prefill``/``prefill_step`` interleaved with decode, and
the ``PagePoolExhausted`` preemption).  Both engines also back the
migration surface (``export_inflight``/``export_inflight_with_slots``/
``adopt_inflight``, used by serve/migrate.py) with ``export_slots``,
``resume_slots`` and ``adopt_slots``, and the paged engine re-indexes
adopted pages through ``reindex_prefix``.

One departure from the reference: the lock hand-off.  A control call
(``submit``, ``stop_intake``, the exports and ``adopt_inflight``)
registers itself while it waits for the scheduler lock, and an engine
loop calls :meth:`yield_to_control` between two steps, so the waiting
call takes the lock before the next step.  Without it the loop re-takes
the lock the instant ``step()`` releases it, and a drain or a failover
can wait until the whole burst is served.  The hand-off moves only when
a control call runs between steps; it changes no token.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

from hetu_tpu_torch.serve.kv_cache import PagePoolExhausted
from hetu_tpu_torch.telemetry import trace

_ids = itertools.count(1)


def finish_request(req: "Request", status: str, metrics=None) -> bool:
    """Terminal-resolve a request — the ONE way a request reaches
    ``done`` everywhere (scheduler ``_finish``, pool rejects/cancels,
    migration double-failure): status, state, timestamp, the
    ``requests_<status>`` / ``generated_tokens`` counters against
    whatever metrics sink is in scope, then the waiter's event.

    Guarded per-request: of racing finishers (a pool backstop cancel vs
    the owning engine loop completing the same request) exactly ONE
    wins — returns True to it — and the losers are no-ops, so a settled
    status is never rewritten and terminal counters never double-charge.
    """
    with req._term_lock:
        if req.done.is_set():
            return False
        req.status = status
        req.state = "done"
        req.finished_at = time.monotonic()
        if metrics is not None:
            metrics.inc(f"requests_{status}")
            metrics.inc("generated_tokens", len(req.tokens))
        req.done.set()
        return True


def cancel_detached(scheduler, req: "Request", status: str,
                    metrics=None) -> None:
    """Backstop cancel that can NEVER block on the scheduler lock:
    resolve the waiter immediately (:func:`finish_request` needs only
    the request's terminal lock), then run the owner-side cleanup
    (dequeue + slot release via :meth:`ContinuousBatchingScheduler.
    cancel`) in a detached daemon thread.  The backstop exists
    precisely for a WEDGED member — engine stuck mid-step, scheduler
    lock held indefinitely — and a plain ``scheduler.cancel`` would
    hang the caller on exactly that lock.  A healthy owner completes
    the detached cleanup promptly; a wedged one strands only the
    daemon thread, and the slot is reclaimed anyway by the next
    healthy step's deadline eviction."""
    finish_request(req, status,
                   metrics if metrics is not None else scheduler.metrics)

    def _cleanup():
        try:
            scheduler.cancel(req, status)
        except Exception:
            pass  # cleanup is best-effort; the waiter is already resolved

    threading.Thread(target=_cleanup, daemon=True).start()


def release_slot_best_effort(engine, slot) -> None:
    """Release a cache slot through the engine, falling back to the raw
    cache when the engine is too broken to do it — else a dead engine's
    slots stay allocated forever.  The ONE slot-freeing idiom shared by
    the scheduler (under its lock) and migration commit/rollback."""
    try:
        engine.release(slot)
    except Exception:
        try:
            engine.cache.free(slot)
        except Exception:
            pass  # restart replaces the whole engine+cache


@dataclass(eq=False)
class Request:
    """One generation request and its lifecycle record.

    ``eq=False``: requests compare (and hash) by IDENTITY — queue
    membership scans (``owns``, adoption rollback) mean "this object",
    and a field-wise ``__eq__`` would deep-compare full prompt/token
    lists against every queued request on the serving path."""

    prompt: list
    max_tokens: int = 16
    eos_id: Optional[int] = None
    timeout_s: Optional[float] = None   # deadline from submit()
    rid: int = field(default_factory=lambda: next(_ids))
    tenant: Optional[str] = None  # multi-tenant accounting key
    slo: Optional[str] = None     # SLO class name (scheduler slo_classes)

    # filled in by the scheduler
    tokens: list = field(default_factory=list)
    state: str = "new"        # new|queued|running|done
    status: str = ""          # ok|timeout|cancelled|overflow|shutdown|shed
    slot: Optional[int] = None
    requeues: int = 0         # engine-failover requeue count (bounded)
    rejected: bool = False    # intake-closed reject: the pool re-routes
    # scheduler currently holding this request (None in transit) — a
    # pool cancels straight through it instead of scanning every
    # member's lock; and the terminal-resolution guard (finish_request)
    owner: object = field(default=None, repr=False)
    _term_lock: threading.Lock = field(default_factory=threading.Lock,
                                       repr=False)
    folded: int = 0           # tokens already folded into prompt on requeue
    submitted_at: Optional[float] = None
    admitted_at: Optional[float] = None   # queue → slot (prefill starts)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    done: threading.Event = field(default_factory=threading.Event)

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_at is None or self.submitted_at is None:
            return None
        return self.first_token_at - self.submitted_at


class ContinuousBatchingScheduler:
    def __init__(self, engine, *, token_budget: Optional[int] = None,
                 metrics=None, max_requeues: int = 3,
                 shed: bool = False, shed_headroom: float = 1.0,
                 prefill_chunks_per_step: int = 1,
                 slo_classes: Optional[dict] = None):
        self.engine = engine
        self.metrics = metrics or engine.metrics
        # engine-failover requeue budget per request: a request whose
        # (re)admission keeps killing engines must eventually fail instead
        # of poisoning every restarted incarnation
        self.max_requeues = int(max_requeues)
        cache = engine.cache
        # default budget: the cache itself (backpressure only kicks in
        # when admission would overrun physical capacity anyway).  For a
        # PAGED engine the token budget is vestigial: admission gates on
        # the engine's page ledger instead (admission_ok), which credits
        # prefix-shared pages and nets out outstanding reservations.
        self.token_budget = int(token_budget or
                                cache.num_slots * cache.max_len)
        # chunked-prefill interleave (paged engines): per step, at most
        # this many prefill chunks advance before the decode round, so a
        # 4k-context arrival adds ONE bounded chunk of latency per step
        # to in-flight decodes instead of a whole-prompt stall
        self.prefill_chunks_per_step = int(prefill_chunks_per_step)
        self._prefilling = {}  # slot -> Request (chunked prefill running)
        # overload shedding (admission control): with ``shed`` on, a
        # submit whose PROJECTED completion (queue-delay model below)
        # already blows its deadline resolves instantly as 'shed' —
        # the client learns in microseconds instead of burning a slot's
        # worth of work on an answer it will throw away, and the queue
        # stays short enough that ACCEPTED requests still meet theirs.
        # ``shed_headroom`` scales the projection (<1 sheds earlier,
        # >1 later).  Off by default: a lone server with no deadline
        # contract should queue, not reject.
        self.shed = bool(shed)
        self.shed_headroom = float(shed_headroom)
        # per-tenant SLO classes: {name: {"priority": int, "weight":
        # float, "ttft_slo_s": float|None}}.  Higher priority admits
        # first under pressure (strict tiering — a page-budget stall at
        # a high-priority head deliberately blocks lower tiers: pages
        # freed by completions go to the tier that matters); WITHIN a
        # tier, weighted fair queueing over (slo, tenant) flows via
        # virtual finish tags, so one tenant's burst cannot starve its
        # classmates.  Empty (the default) keeps pure FIFO — the pick
        # below returns index 0 and no behavior changes.  Requests
        # naming no/unknown class get priority 0, weight 1.0.
        self.slo_classes = {str(k): dict(v)
                            for k, v in (slo_classes or {}).items()}
        self._vtime = 0.0     # WFQ virtual clock
        self._vfinish = {}    # flow (slo, tenant) -> virtual finish tag
        self._ewma_service_s: Optional[float] = None
        self._lock = threading.Lock()
        # the lock hand-off: control calls waiting for _lock, counted
        # under _handoff (see _control_lock / yield_to_control)
        self._handoff = threading.Condition()
        self._handoff_waiting = 0
        self._queue = deque()
        self._running = {}   # slot -> Request
        self._accepting = True
        self._reject_status = "shutdown"  # status for post-drain submits

    # ---- the lock hand-off ----
    @contextmanager
    def _control_lock(self):
        """Hold the scheduler lock for a control call, counted as waiting
        until it has the lock: an engine loop in :meth:`yield_to_control`
        lets it in before its next step."""
        with self._handoff:
            self._handoff_waiting += 1
        try:
            self._lock.acquire()
        finally:
            with self._handoff:
                self._handoff_waiting -= 1
                self._handoff.notify_all()
        try:
            yield
        finally:
            self._lock.release()

    @contextmanager
    def between_steps(self, timeout_s: float):
        """Like :meth:`_control_lock`, but waiting at most ``timeout_s``
        for the lock; yields whether it got it.  Counters read inside
        are not split by a step half done (a forward whose layers have
        launched in part)."""
        with self._handoff:
            self._handoff_waiting += 1
        try:
            got = self._lock.acquire(timeout=max(float(timeout_s), 0.0))
        finally:
            with self._handoff:
                self._handoff_waiting -= 1
                self._handoff.notify_all()
        try:
            yield got
        finally:
            if got:
                self._lock.release()

    @property
    def control_waiting(self) -> int:
        """Control calls waiting for the scheduler lock now."""
        return self._handoff_waiting

    def yield_to_control(self) -> bool:
        """Called by an engine loop between two steps (not holding the
        lock): while a control call waits for the lock, wait until it has
        it (at most a second: a waiter takes a free lock at once).
        Returns whether one was waiting."""
        with self._handoff:
            if not self._handoff_waiting:
                return False
            self._handoff.wait_for(lambda: not self._handoff_waiting, 1.0)
        return True

    # ---- request intake ----
    def projected_wait_s(self) -> float:
        """Queue-delay projection for a request submitted NOW: how long
        until the engine would COMPLETE it, from the load ahead of it
        and the EWMA of observed per-request service time.  0.0 until
        the first completion seeds the model (no evidence = no shed).
        Lock-free like :attr:`load` — a slightly stale projection only
        nudges the shed boundary."""
        ewma = self._ewma_service_s
        if ewma is None:
            return 0.0
        slots = max(self.engine.cache.num_slots, 1)
        ahead = len(self._queue) + len(self._running) + len(self._prefilling)
        # `ahead/slots` service generations drain before its turn, then
        # its own service — the M/M/c-flavored projection that needs
        # only numbers already on hand
        return (ahead / slots + 1.0) * ewma

    # ---- SLO classes (priority admission + WFQ) ----
    def _class_of(self, req) -> tuple:
        """``(priority, weight)`` for the request's SLO class —
        ``(0, 1.0)`` when classes are unconfigured or the name is
        unknown (an unknown class must degrade to best-effort, not
        raise on the submit path)."""
        if not self.slo_classes:
            return 0, 1.0
        cls = self.slo_classes.get(getattr(req, "slo", None))
        if cls is None:
            return 0, 1.0
        return int(cls.get("priority", 0)), \
            float(cls.get("weight", 1.0)) or 1.0

    def _pick_index_locked(self) -> int:
        """Index of the next request to admit (caller holds the lock).

        Pure — charges nothing; :meth:`_charge_wfq_locked` runs only
        when the pick actually dequeues for admission, so a page-budget
        stall re-picking the same head every step does not inflate its
        flow's finish tag.  Strict priority across classes, then the
        smallest WFQ virtual-finish tag within the winning tier, then
        FIFO.  O(queue) per admission — fine at serving depths, and the
        unconfigured fast path is O(1)."""
        if not self.slo_classes or len(self._queue) < 2:
            return 0
        best_key, best_idx = None, 0
        for idx, req in enumerate(self._queue):
            prio, weight = self._class_of(req)
            flow = (getattr(req, "slo", None), getattr(req, "tenant", None))
            tag = max(self._vtime, self._vfinish.get(flow, 0.0)) \
                + 1.0 / weight
            key = (-prio, tag, idx)
            if best_key is None or key < best_key:
                best_key, best_idx = key, idx
        return best_idx

    def _charge_wfq_locked(self, req) -> None:
        """Advance the picked flow's virtual finish tag — called at the
        moment a request is dequeued FOR ADMISSION (not at pick time,
        and not for timeout/overflow dequeues: those consumed no
        service)."""
        if not self.slo_classes:
            return
        _, weight = self._class_of(req)
        flow = (getattr(req, "slo", None), getattr(req, "tenant", None))
        start = max(self._vtime, self._vfinish.get(flow, 0.0))
        self._vfinish[flow] = start + 1.0 / weight
        self._vtime = start

    def _projected_wait_locked(self, priority: int) -> float:
        """:meth:`projected_wait_s`, but the queued backlog counts only
        requests at >= ``priority`` (caller holds the lock): admission
        serves strictly by priority, so a low-tier burst queued behind
        a high-tier submit is simply not ahead of it — without this,
        one bursting low-SLO tenant's backlog would shed every tenant's
        traffic instead of absorbing its own."""
        ewma = self._ewma_service_s
        if ewma is None:
            return 0.0
        slots = max(self.engine.cache.num_slots, 1)
        if self.slo_classes:
            ahead_q = sum(1 for r in self._queue
                          if self._class_of(r)[0] >= priority)
        else:
            ahead_q = len(self._queue)
        ahead = ahead_q + len(self._running) + len(self._prefilling)
        return (ahead / slots + 1.0) * ewma

    def submit(self, request: Request, *,
               resolve_on_reject: bool = True) -> Request:
        request.submitted_at = time.monotonic()
        shed = False
        with self._control_lock():
            if self._accepting and self.shed and \
                    request.timeout_s is not None:
                # the shed decision runs AFTER the accepting gate: a
                # submit that raced a drain must take the REJECT path
                # below (the pool re-routes it to a live peer) — a
                # draining member's queue is about to be handed away
                # and says nothing about whether the deadline is
                # feasible elsewhere
                prio, _ = self._class_of(request)
                projected = self._projected_wait_locked(prio) \
                    * self.shed_headroom
                shed = projected > request.timeout_s
            if not shed and not self._accepting:
                # a drain/stop_intake closed the front door — complete
                # immediately with that drain's status ('shutdown', or
                # 'error' for a dead engine) so the submitting listener
                # doesn't park on a request nothing will serve.  Counted
                # as a REJECT, not a requests_<status> completion: the
                # request was never accepted (a pool re-routes it to a
                # live peer), and charging requests_shutdown here would
                # make the per-member terminal counters sum past the
                # real request count on every drain/failover.  The
                # `rejected` flag (set before `done`) is the pool's
                # EXPLICIT re-route signal — inferring a reject from the
                # terminal state would also match a genuinely accepted
                # request that failed with zero tokens.
                # ``resolve_on_reject=False`` (the pool's routing path)
                # flags the reject WITHOUT touching done/status: the
                # pool retries another member, and a waiter already
                # parked on request.done must sleep through the re-route
                # — a transient terminal state here would wake it into
                # reading a half-routed request as an empty success
                request.rejected = True
                if resolve_on_reject:
                    finish_request(request, self._reject_status, None)
                self.metrics.inc("requests_rejected")
                return request
            if not shed:
                request.state = "queued"
                request.owner = self
                self._queue.append(request)
                self.metrics.inc("requests_submitted")
                self.metrics.set_gauge("queue_depth", len(self._queue))
        if shed:
            # instant reject: the deadline is already unmeetable —
            # resolving now is the difference between bounded-latency
            # partial service and every queued request timing out
            # together (the collapse mode).  Terminal (not a re-route
            # reject): every peer sees the same overload, and touring
            # the pool would just fail slower.
            trace.instant("serve.shed",
                          {"rid": int(request.rid),
                           "deadline_s": request.timeout_s})
            self._finish(request, "shed")
        return request

    def requeue_inflight(self, *, max_requeues: Optional[int] = None) -> int:
        """Engine-failover path: put every RUNNING request back at the
        head of the queue instead of failing it.  Each request's emitted
        tokens are folded into its prompt, so the next admission
        re-prefills from (prompt + tokens so far) and greedy decode
        continues token-for-token — a single engine crash loses zero
        accepted requests once a restarted engine picks the queue back up.

        A request requeued more than ``max_requeues`` times is finished
        with status 'error' instead: a deterministically-poisonous request
        must not kill every engine incarnation forever.  Returns how many
        requests were requeued.
        """
        cap = self.max_requeues if max_requeues is None else max_requeues
        with self._lock:
            requeued = 0
            # newest-submitted first + appendleft = oldest request ends up
            # at the queue head (slot index is NOT admission order once
            # slots get reused; submission time is).  Mid-chunked-prefill
            # requests requeue the same way — their partial KV died with
            # the engine, so they re-prefill from the prompt like anyone
            for slot, req in sorted(
                    list(self._running.items())
                    + list(self._prefilling.items()), reverse=True,
                    key=lambda kv: (kv[1].submitted_at or 0.0, kv[1].rid)):
                self._running.pop(slot, None)
                self._prefilling.pop(slot, None)
                self._release_slot_locked(slot)
                if self._requeue_locked(req, cap):
                    requeued += 1
            self.metrics.set_gauge("queue_depth", len(self._queue))
            return requeued

    def _release_slot_locked(self, slot: int) -> None:
        """:func:`release_slot_best_effort` against this engine (caller
        holds the lock)."""
        release_slot_best_effort(self.engine, slot)

    def _fold_locked(self, req: Request, cap: int) -> bool:
        """Fold emitted tokens into the prompt and charge one requeue
        (caller holds the lock) — the re-prefill hand-off shared by
        engine-crash requeue and pool failover.  Past ``cap`` the request
        finishes 'error' and False is returned."""
        req.slot = None
        req.requeues += 1
        if req.requeues > cap:
            self._finish(req, "error")
            return False
        fresh = req.tokens[req.folded:]
        req.prompt = list(req.prompt) + list(fresh)
        req.folded += len(fresh)
        req.state = "queued"
        return True

    def _requeue_locked(self, req: Request, cap: int, *,
                        tail: bool = False) -> bool:
        """Fold emitted tokens into the prompt and put ``req`` back in the
        queue (caller holds the lock) — at the head for engine-crash
        failover (preserves admission order), at the ``tail`` for a
        request whose own prefill failed (everyone else goes first).
        Over-``cap`` requests finish with 'error' instead.  Returns True
        if requeued."""
        if not self._fold_locked(req, cap):
            return False
        if tail:
            self._queue.append(req)
        else:
            self._queue.appendleft(req)
        self.metrics.inc("requests_requeued")
        return True

    # ---- migration hand-off (serve/migrate.py + serve/pool.py) ----
    def export_inflight(self, *, fold: bool = False) -> list:
        """Atomically remove EVERY running and queued request and return
        them as ``[(request, slot)]`` in admission order (queued requests
        carry ``slot=None``) — the scheduler half of a live hand-off to a
        peer (:meth:`adopt_inflight` on the receiving side).

        ``fold=False`` (planned migration): running requests KEEP their
        cache slots; the caller exports those slots' K/V
        (``engine.export_slots``) and the peer continues decoding
        token-for-token with zero re-prefill.  The slots stay allocated
        on this engine until the caller releases them — a failed transfer
        rolls back by re-adopting the same pairs here.

        ``fold=True`` (unplanned failover: the KV state died with the
        engine): emitted tokens fold into each running request's prompt,
        the slot is freed, and a requeue is charged — over-``cap``
        requests finish 'error' here, exactly like
        :meth:`requeue_inflight` — so the peer re-prefills from
        (prompt + tokens so far).

        Intake stays open: the caller decides when/whether to stop it
        (a pool stops routing first; a drain-to-exit closes the server
        afterwards).  For the fold=False path prefer
        :meth:`export_inflight_with_slots`, which also SNAPSHOTS the
        slots under the same lock hold — between a bare export and a
        later ``engine.export_slots`` call, a concurrent ``step()``
        admitting new work would decode the still-active exported slots
        and silently advance them past the requests' recorded tokens.
        """
        with self._control_lock():
            pairs = self._export_locked(fold)
            self.metrics.inc("requests_exported", len(pairs))
            return pairs

    def export_inflight_with_slots(self) -> tuple:
        """:meth:`export_inflight` (fold=False) plus the exported slots'
        KV snapshots (``engine.export_slots``), taken atomically under
        the scheduler lock — no decode step can run between the requests
        leaving ``_running`` and their K/V rows being captured, so the
        snapshot and each request's token list always agree.  Returns
        ``(pairs, snapshots)``."""
        with self._control_lock():
            pairs = self._export_locked(fold=False)
            slots = [slot for _, slot in pairs if slot is not None]
            try:
                snaps = self.engine.export_slots(slots) if slots else []
            except Exception:
                # the engine died mid-export: put everything straight
                # back (same lock hold) — the requests must never end up
                # in neither the queue nor _running, or they strand with
                # done never set while the failover path exports an
                # empty scheduler
                for req, slot in pairs:
                    if req.done.is_set():
                        # done-in-transit (a backstop cancel resolved it
                        # under the request's terminal lock, which this
                        # lock hold does not exclude): nothing re-attaches
                        # the slot, so it must be released here or it
                        # keeps decoding ownerless until max_len wedges
                        # the engine — same rule as adopt_inflight's
                        # done-in-transit branch
                        if slot is not None:
                            self._release_slot_locked(slot)
                        continue
                    req.owner = self
                    if slot is None:
                        req.state = "queued"
                        self._queue.append(req)
                    else:
                        req.slot = slot
                        req.state = "running"
                        self._running[slot] = req
                self.metrics.set_gauge("queue_depth", len(self._queue))
                raise
            # requests_exported is NOT charged here: a wire failure can
            # still roll this export back (migrate_inflight re-adopts at
            # the source), and the counter must only ever count hand-offs
            # that committed — migrate_inflight charges it on commit
            return pairs, snaps

    def _export_locked(self, fold: bool) -> list:
        out = []
        for slot, req in sorted(
                self._running.items(),
                key=lambda kv: (kv[1].submitted_at or 0.0, kv[1].rid)):
            del self._running[slot]
            if fold:
                self._release_slot_locked(slot)
                if self._fold_locked(req, self.max_requeues):
                    out.append((req, None))
            else:
                req.state = "migrating"
                out.append((req, slot))
        # mid-chunked-prefill requests export as QUEUED either way: a
        # partial prefill has no last_token to resume from, so the peer
        # re-prefills — from the prompt alone, so no requeue is charged
        # on the planned path (nothing emitted was lost)
        for slot, req in sorted(
                self._prefilling.items(),
                key=lambda kv: (kv[1].submitted_at or 0.0, kv[1].rid)):
            del self._prefilling[slot]
            self._release_slot_locked(slot)
            if fold:
                if self._fold_locked(req, self.max_requeues):
                    out.append((req, None))
            else:
                req.state = "queued"
                req.slot = None
                out.append((req, None))
        while self._queue:
            out.append((self._queue.popleft(), None))
        for req, _ in out:
            req.owner = None  # in transit until a peer adopts (or we do)
        self.metrics.set_gauge("queue_depth", 0)
        # requests_exported is charged by the CALLERS once the export is
        # final — export_inflight_with_slots can still roll this back
        # when the engine dies under it, and a rolled-back export must
        # not count (the counter would sum past real hand-offs)
        return out

    def adopt_inflight(self, pairs, snapshots=None, *,
                       return_count: bool = False):
        """Adopt requests exported from a peer (:meth:`export_inflight`).

        ``pairs``: ``[(request, slot)]``; ``slot=None`` requests queue
        (admitted through the normal prefill path, original submission
        time and deadline preserved).  With ``snapshots`` (peer KV
        exports), a pair's ``slot`` is the SOURCE slot id of its
        snapshot — the KV rows import here and the request resumes
        mid-decode, zero prefill.  Without snapshots, a non-None
        ``slot`` is a slot THIS engine already owns — the
        re-adopt-after-failed-transfer rollback path.

        KV adoption (``engine.adopt_slots``) and request attachment
        happen together UNDER THE SCHEDULER LOCK: this scheduler's live
        engine loop holds the same lock for every ``step()``, so a
        concurrent decode can neither swap the cache arrays out from
        under the import (discarding the imported rows) nor advance an
        adopted slot before its request is attached (losing a token).

        Requests that finished in transit (a cancel/timeout race) are
        skipped and their adopted slot released.  Returns the
        ``{source_slot: local_slot}`` map (empty without snapshots);
        with ``return_count=True`` returns ``(map, n_attached)`` —
        counted under the same lock as the attachments, so callers
        charging hand-off metrics see exactly what stuck (an outside
        read of ``requests_adopted`` deltas would race concurrent
        adoptions onto this scheduler).
        """
        pairs = list(pairs)
        n = 0
        with self._control_lock():
            if not self._accepting:
                raise RuntimeError(
                    "scheduler is drained; cannot adopt migrated requests")
            if snapshots:
                slot_map = self.engine.adopt_slots(snapshots)
            else:
                slot_map = None
                # local re-adoption: validate-first so attachment below
                # cannot fail halfway (all-or-nothing)
                want = [s for _, s in pairs if s is not None]
                taken = [s for s in want
                         if self._running.get(s) is not None]
                if taken or len(set(want)) != len(want):
                    raise RuntimeError(
                        f"cannot re-adopt slots {taken or want}: already "
                        f"running or duplicated")
                if want:
                    # the export SUSPENDED these slots on the engine so
                    # in-window decode steps could not advance them.
                    # Resume BEFORE attaching anything: resume can raise
                    # (the source engine died mid-rollback) and the
                    # attachment below must stay all-or-nothing — a
                    # raise here leaves the scheduler empty, so the
                    # caller's double-failure handler resolves requests
                    # that are attached NOWHERE (done-in-transit slots
                    # are resumed too, then released in the loop below)
                    self.engine.resume_slots(want)
            try:
                for req, src_slot in pairs:
                    if src_slot is None:
                        slot = None
                    elif slot_map is not None:
                        slot = slot_map.get(src_slot)
                        if slot is None:
                            raise RuntimeError(
                                f"no imported snapshot for source slot "
                                f"{src_slot}")
                    else:
                        slot = src_slot
                    if req.done.is_set():
                        if slot is not None:
                            self._release_slot_locked(slot)
                            if slot_map is not None:
                                del slot_map[src_slot]
                        continue
                    if slot is None:
                        req.slot = None
                        req.state = "queued"
                        self._queue.append(req)
                    else:
                        req.slot = slot
                        req.state = "running"
                        self._running[slot] = req
                    req.owner = self
                    n += 1
            except Exception:
                # all-or-nothing for the imported case: free every
                # imported slot and detach whatever was attached
                if slot_map is not None:
                    for slot in slot_map.values():
                        if self._running.get(slot) is not None:
                            del self._running[slot]
                        self._release_slot_locked(slot)
                    for req, _ in pairs:
                        if req in self._queue:
                            self._queue.remove(req)
                raise
            if snapshots and hasattr(self.engine, "reindex_prefix"):
                # re-dedup the imported pages into THIS engine's prefix
                # index: the scheduler is the one party that knows each
                # adopted slot's token stream (prompt + emitted tokens;
                # the cache holds only K/V rows).  The stream's last
                # emitted token has no K/V row yet (it is the pending
                # decode input) — reindex_prefix truncates to the
                # cache's recorded length, so passing the full stream
                # is correct.  Folded tokens are already inside prompt;
                # tokens[folded:] are the live emissions.  Best-effort:
                # re-dedup is an optimization and must never fail an
                # adoption that already attached.
                for req, _ in pairs:
                    if req.slot is None or req.done.is_set() or \
                            self._running.get(req.slot) is not req:
                        continue
                    try:
                        self.engine.reindex_prefix(
                            req.slot,
                            list(req.prompt)
                            + list(req.tokens[req.folded:]))
                    except Exception:
                        pass
            self.metrics.inc("requests_adopted", n)
            self.metrics.set_gauge("queue_depth", len(self._queue))
        if return_count:
            return slot_map or {}, n
        return slot_map or {}

    @property
    def load(self) -> int:
        """Queued + running request count (the pool's routing signal).

        Deliberately LOCK-FREE (``len()`` is atomic under the GIL, and a
        slightly stale count only nudges routing): the pool reads every
        member's load on the routing path, and taking the scheduler lock
        here would stall all routing behind any one member's in-flight
        decode step — and deadlock failover DETECTION behind a wedged
        one."""
        return len(self._queue) + len(self._running) + len(self._prefilling)

    @property
    def running_count(self) -> int:
        """Running-slot count, lock-free like :attr:`load` (the pool's
        drain gates wire setup on it — a queued-only member has no K/V
        to ship)."""
        return len(self._running)

    def owns(self, request: Request) -> bool:
        """True while this scheduler holds ``request`` (queued or
        running).  Takes the scheduler lock — latency-sensitive callers
        (the pool's backstop cancel) follow ``request.owner`` into
        :func:`cancel_detached` instead, which a wedged engine step
        cannot block."""
        with self._lock:
            return request in self._queue or (
                request.slot is not None and
                (self._running.get(request.slot) is request or
                 self._prefilling.get(request.slot) is request))

    def replace_engine(self, engine) -> None:
        """Swap in a (restarted) engine and reopen intake.  Any requests
        still marked running against the old engine are requeued first, so
        nothing references the dead engine's slots."""
        with self._lock:
            self._accepting = True
            self._reject_status = "shutdown"
        self.requeue_inflight()
        with self._lock:
            self.engine = engine

    def cancel(self, request: Request, status: str = "cancelled") -> None:
        """Abandon a request wherever it is, resolving it ``status``
        (clients cancelling pass the default; a caller whose WAIT
        expired passes 'timeout' — the dashboards must tell a
        server-side timeout from a client's change of mind).

        An ALREADY-resolved request still gets its queue/slot cleanup
        (without touching the settled status): :func:`cancel_detached`
        resolves the waiter first and hands this call the dequeue + slot
        release afterwards."""
        with self._lock:
            already = request.done.is_set()
            if request in self._queue:
                self._queue.remove(request)
            if request.slot is not None and \
                    self._running.get(request.slot) is request:
                del self._running[request.slot]
                # a dead engine must not abort the cancel: the caller's
                # whole point is resolving the request
                self._release_slot_locked(request.slot)
            elif request.slot is not None and \
                    self._prefilling.get(request.slot) is request:
                del self._prefilling[request.slot]
                self._release_slot_locked(request.slot)
            if not already:
                self._finish(request, status)

    # ---- the continuous-batching step ----
    def step(self) -> list:
        """Admit + one decode round.  Returns requests completed now.

        Error containment: a single request whose PREFILL raises is
        charged to that request (requeued at the tail, finished 'error'
        past its requeue cap) and other work continues — one poisoned
        prompt must not count engine-loop strikes while the engine is
        demonstrably serving everyone else.  The step re-raises the
        admission error only when NOTHING progressed (no successful
        prefill, no decode) — the whole-engine-failure signal the
        server's death counter needs.  Decode failures always raise
        (decode is one fused call over every slot: there is no
        per-request attribution)."""
        completed = []
        with self._lock, trace.span("serve.step") as sp:
            progressed, admit_exc = self._admit(completed)
            pf_progressed, pf_exc = self._advance_prefills(completed)
            progressed = progressed or pf_progressed
            admit_exc = admit_exc or pf_exc
            toks = None
            while self._running:
                try:
                    toks = self.engine.decode()
                except PagePoolExhausted:
                    # vLLM recompute-mode preemption: an UNRESERVED slot
                    # (adopted via migration — its import allocated live
                    # pages but reserved nothing for the decode ahead)
                    # outran the page pool.  Preempt a victim — release
                    # its slot (freeing its unshared pages), fold its
                    # tokens into its prompt, requeue at the HEAD — and
                    # retry the decode.  Retry is safe: prepare_write is
                    # idempotent (pages already appended are found in
                    # the table; a COW'd page has ref 1) and lengths
                    # only advance after the jitted step, so no token is
                    # lost or double-written.  No victim left => the
                    # exhaustion really is fatal; re-raise.
                    if not self._preempt_victim_locked(completed):
                        raise
                    continue
                break
            if toks is not None:
                progressed = True
                now = time.monotonic()
                for slot, req in list(self._running.items()):
                    req.tokens.append(toks[slot])
                    if self._should_evict(req, now):
                        del self._running[slot]
                        self.engine.release(slot)
                        self._finish(req, req.status or "ok")
                        completed.append(req)
            self.metrics.set_gauge("queue_depth", len(self._queue))
            self.metrics.set_gauge("slot_occupancy",
                                   self.engine.cache.occupancy)
            sp.set("completed", len(completed))
            sp.set("running", len(self._running))
            if admit_exc is not None and not progressed:
                raise admit_exc
        return completed

    def has_work(self) -> bool:
        with self._lock:
            return bool(self._queue or self._running or self._prefilling)

    # ---- internals (called under the lock) ----
    def _admit(self, completed: list):
        """Admit queued requests into free slots.  Returns ``(progressed,
        admit_exc)``: whether any prefill succeeded, and the last
        admission exception (step() re-raises it only on zero progress)."""
        progressed = False
        admit_exc = None
        now = time.monotonic()
        while self._queue and self.engine.cache.num_free:
            # SLO pick: rotate the chosen request to the head, then the
            # rest of the loop (and its popleft/appendleft failure
            # handling) runs unchanged against index 0.  FIFO when
            # classes are unconfigured (pick returns 0, no rotation).
            idx = self._pick_index_locked()
            if idx:
                chosen = self._queue[idx]
                del self._queue[idx]
                self._queue.appendleft(chosen)
            req = self._queue[0]
            if req.timeout_s is not None and \
                    now - req.submitted_at > req.timeout_s:
                self._queue.popleft()
                self._finish(req, "timeout")
                completed.append(req)
                continue
            n = len(req.prompt)
            if n == 0 or n + 1 > self.engine.cache.max_len \
                    or n + 1 > self.token_budget:
                # empty prompts, prompts too long for a slot, and prompts
                # whose working set could NEVER fit the budget must fail
                # the REQUEST — the alternatives are an exception in the
                # engine loop thread or a queue head wedged forever
                self._queue.popleft()
                self._finish(req, "overflow")
                completed.append(req)
                continue
            paged = hasattr(self.engine, "begin_prefill")
            # a requeued/preempted request's emitted tokens were FOLDED
            # into its prompt — its worst case is the remaining budget,
            # not max_tokens, or a fold near the page-pool ceiling
            # inflates the reservation past what the pool can EVER grant
            # and wedges the queue head forever
            remaining = max(int(req.max_tokens) - len(req.tokens), 1)
            if paged:
                # page-budget backpressure: the engine's ledger knows
                # what the request's worst case costs AFTER prefix
                # sharing and what outstanding reservations still claim
                if not self.engine.admission_ok(req.prompt, remaining):
                    break
            elif self.engine.cache.active_tokens + n + 1 > \
                    self.token_budget:
                # token-budget backpressure: the working set after
                # admission (fits eventually — running sequences will
                # finish and free it)
                break
            self._queue.popleft()
            self._charge_wfq_locked(req)
            try:
                slot = self.engine.alloc_slot()
            except Exception as e:
                # an engine broken enough to fail allocation must not
                # orphan the request it was about to admit: back to the
                # head, unchanged (no requeue charged — nothing ran).
                # This is engine-level, not request-level: stop admitting.
                req.state = "queued"
                self._queue.appendleft(req)
                admit_exc = e
                break
            req.slot = slot
            req.state = "running"
            if req.admitted_at is None:
                # first admission only: the queue-wait number a requeue
                # must not rewrite (same rule as first_token_at)
                req.admitted_at = time.monotonic()
            if paged:
                # chunked-prefill interleave: admission only ADOPTS the
                # shared prefix, reserves pages, and parks a cursor —
                # the chunks themselves advance one per step
                # (_advance_prefills), interleaved with decode rounds
                try:
                    self.engine.begin_prefill(slot, req.prompt,
                                              max_tokens=remaining)
                except Exception as e:
                    admit_exc = e
                    if not self._requeue_locked(req, self.max_requeues,
                                                tail=True):
                        completed.append(req)
                    try:
                        self.engine.release(slot)
                    except Exception:
                        pass
                    continue
                self._prefilling[slot] = req
                continue
            try:
                first = self.engine.prefill(slot, req.prompt)
            except Exception as e:
                # a prefill blow-up must not orphan the request: at this
                # point it is in NEITHER the queue NOR _running, so the
                # failover requeue could never find it — the client would
                # hang out its full timeout undiagnosed.  Requeue it at
                # the TAIL (other requests get served first; past its
                # requeue cap it fails 'error' — either way req resolves
                # even if the broken engine's release also throws), free
                # the slot best-effort, and keep admitting: step() decides
                # from overall progress whether this was the request's
                # fault or the engine's.
                admit_exc = e
                if not self._requeue_locked(req, self.max_requeues,
                                            tail=True):
                    completed.append(req)
                try:
                    self.engine.release(slot)
                except Exception:
                    pass  # engine already broken; the loop records that
                continue
            progressed = True
            req.tokens.append(first)
            now_t = time.monotonic()
            if req.first_token_at is None:
                # only the FIRST admission observes TTFT: a failover
                # re-prefill must not double-count the histogram or
                # overwrite the client-visible ttft_s
                req.first_token_at = now_t
                self.metrics.observe_ttft(req.ttft_s,
                                          tenant=req.tenant)
            self._running[slot] = req
            if self._should_evict(req, now_t):
                del self._running[slot]
                self.engine.release(slot)
                self._finish(req, req.status or "ok")
                completed.append(req)
        return progressed, admit_exc

    def _advance_prefills(self, completed: list):
        """Advance chunked prefills (paged engines), at most
        ``prefill_chunks_per_step`` chunks per step — the interleave
        policy that keeps a long-prompt arrival from spiking in-flight
        decode latency.  A prefill whose final chunk completes emits its
        first token and the request joins ``_running`` for the decode
        round below.  Returns ``(progressed, exc)`` like :meth:`_admit`
        (chunk failures are charged to the request; step() re-raises
        only on zero overall progress)."""
        if not self._prefilling:
            return False, None
        progressed = False
        exc = None
        # the timeout sweep runs over EVERY prefilling request BEFORE the
        # chunk budget gates anything: timing out costs no chunk, and a
        # deadline-blown request behind slower prefills must resolve (and
        # release its slot + page reservation) this step, not when the
        # queue ahead of it drains
        now = time.monotonic()
        for slot, req in list(self._prefilling.items()):
            if req.timeout_s is not None and \
                    now - req.submitted_at > req.timeout_s:
                del self._prefilling[slot]
                self._release_slot_locked(slot)
                self._finish(req, "timeout")
                completed.append(req)
        budget = max(self.prefill_chunks_per_step, 1)
        for slot, req in sorted(
                self._prefilling.items(),
                key=lambda kv: (kv[1].submitted_at or 0.0, kv[1].rid)):
            if budget <= 0:
                break
            try:
                tok = self.engine.prefill_step(slot)
            except Exception as e:
                # same containment as a monolithic prefill blow-up: the
                # request goes back to the TAIL (or fails past its
                # requeue cap), the slot frees, everyone else continues
                exc = e
                del self._prefilling[slot]
                if not self._requeue_locked(req, self.max_requeues,
                                            tail=True):
                    completed.append(req)
                self._release_slot_locked(slot)
                continue
            budget -= 1
            progressed = True
            if tok is None:
                continue
            del self._prefilling[slot]
            req.tokens.append(tok)
            now_t = time.monotonic()
            if req.first_token_at is None:
                req.first_token_at = now_t
                self.metrics.observe_ttft(req.ttft_s,
                                          tenant=req.tenant)
            self._running[slot] = req
            if self._should_evict(req, now_t):
                del self._running[slot]
                self.engine.release(slot)
                self._finish(req, req.status or "ok")
                completed.append(req)
        return progressed, exc

    def _preempt_victim_locked(self, completed: list) -> bool:
        """Evict one running request to free pages for the rest (caller
        holds the lock): lowest SLO priority first, newest submission
        within a tier (the newest request has the least sunk decode work
        to re-prefill).  The victim's emitted tokens fold into its
        prompt and it requeues at the HEAD (:meth:`_requeue_locked`) —
        its next admission re-prefills through the normal page-budget
        gate, so greedy decode continues token-for-token; past its
        requeue cap it finishes 'error' (appended to ``completed``).
        Returns False when nothing is running (no victim exists)."""
        if not self._running:
            return False
        slot, req = min(
            self._running.items(),
            key=lambda kv: (self._class_of(kv[1])[0],
                            -(kv[1].submitted_at or 0.0), -kv[1].rid))
        del self._running[slot]
        self._release_slot_locked(slot)
        self.metrics.inc("requests_preempted")
        trace.instant("serve.preempt",
                      {"rid": int(req.rid), "slot": int(slot),
                       "tokens": len(req.tokens)})
        if not self._requeue_locked(req, self.max_requeues):
            completed.append(req)
        return True

    def _should_evict(self, req: Request, now: float) -> bool:
        if req.eos_id is not None and req.tokens[-1] == req.eos_id:
            return True
        if len(req.tokens) >= req.max_tokens:
            return True
        # the cache slot is full: the next decode would have nowhere to
        # write — finish what we have
        if self.engine.cache.lengths[req.slot] + 1 >= self.engine.cache.max_len:
            return True
        if req.timeout_s is not None and \
                now - req.submitted_at > req.timeout_s:
            req.status = "timeout"
            return True
        return False

    def _finish(self, req: Request, status: str) -> None:
        if not finish_request(req, status, self.metrics):
            return
        if req.tenant is not None and hasattr(self.metrics, "note_tenant"):
            # per-tenant terminal + token accounting (rides the fleet
            # scrape: members' tenant.* counters sum in fleet_metrics,
            # so per-tenant shed/throughput is readable fleet-wide)
            self.metrics.note_tenant(req.tenant, status)
            if req.tokens:
                self.metrics.note_tenant(req.tenant, "tokens",
                                         len(req.tokens))
        if req.first_token_at is not None and \
                req.finished_at is not None:
            # learn per-request SERVICE time (first token -> finish:
            # queue wait excluded, or load would inflate the model and
            # the model then over-shed the load away) from every
            # request that actually ran, whatever its status
            service = max(req.finished_at - req.first_token_at, 1e-4)
            prev = self._ewma_service_s
            self._ewma_service_s = service if prev is None \
                else 0.8 * prev + 0.2 * service

    # ---- convenience loop (tests / offline batch use) ----
    def run(self, requests, *, max_steps: int = 100_000) -> dict:
        """Submit everything, step until drained; {rid: tokens}."""
        for r in requests:
            self.submit(r)
        for _ in range(max_steps):
            if not self.has_work():
                break
            self.step()
        return {r.rid: list(r.tokens) for r in requests}

    def stop_intake(self, status: str = "shutdown") -> None:
        """Stop accepting new submits (they finish immediately as
        rejects with ``status``) WITHOUT touching queued/running work.

        The pool closes a member's front door with this BEFORE exporting
        its queue, so a submit that raced the routing decision can only
        ever be rejected-and-rerouted — never admitted into a queue that
        is about to be handed away (and then terminally drained by the
        member's close).  ``drain(stop_accepting=True)`` is this plus
        resolving everything in flight; ``replace_engine`` reopens
        intake."""
        with self._control_lock():
            self._accepting = False
            self._reject_status = status

    def drain(self, status: str = "shutdown", *,
              stop_accepting: bool = False) -> None:
        """Complete everything still queued/running.  With
        ``stop_accepting`` (shutdown), later ``submit()`` calls finish
        immediately as 'shutdown' — an engine-error drain keeps accepting
        so the loop can serve the next request."""
        with self._lock:
            if stop_accepting:
                self._accepting = False
                self._reject_status = status
            while self._queue:
                self._finish(self._queue.popleft(), status)
            for slot, req in list(self._running.items()):
                # a dead engine must not abort the drain halfway — every
                # running request still gets its terminal status
                self._release_slot_locked(slot)
                self._finish(req, status)
            self._running.clear()
            for slot, req in list(self._prefilling.items()):
                self._release_slot_locked(slot)
                self._finish(req, status)
            self._prefilling.clear()
