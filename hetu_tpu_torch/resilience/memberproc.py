"""Shared control-plane loop for cross-process member processes
(counterpart of ``hetu_tpu/resilience/memberproc.py``).

Both lockstep training planes — the dp multi-controller worker
(:mod:`hetu_tpu_torch.resilience.multicontroller`) and the MPMD pipeline
stage (:mod:`hetu_tpu_torch.parallel.mpmd_elastic`) — speak the same
member protocol: heartbeat into a blackboard row on a cadence, honor the
control row's netem slow-link fields, ack PREPARE epochs with frozen
progress, and wait out generation-counted van barriers while
re-checking the control row so a membership move voids the in-flight
step.  This module is the ONE copy of that protocol; the step BODY
(what a member computes between barriers) stays with each plane.

A member class mixes in :class:`ControlPlaneMember`, calls
``_init_control_plane`` after its blackboard join is constructed, and
uses ``_epoch_barriers`` / ``_await_barrier`` / ``_check_epoch`` in its
run loop.  The shared methods read these attributes: ``member``
(:class:`~hetu_tpu_torch.ps.membership.MembershipClient`), ``committed``,
``epoch``, ``acked``, ``_work_ms``, and a spec-like object with
``hb_ms``, ``port``, ``barrier_base``, ``barrier_wait_s``.

The module imports neither ``torch`` nor ``jax``: a member process is
numpy over the van.
"""

from __future__ import annotations

import threading
import time


class EpochChanged(Exception):
    """The controller published a new membership epoch (or a PREPARE
    freeze) mid-step: the in-flight step is void (never logged/
    committed) and re-runs after the member adopts the new epoch."""


class ControlPlaneMember:
    """Mixin: heartbeat thread, slow-link honoring, epoch-scoped
    barrier pair, and movement-aware barrier waits."""

    def _init_control_plane(self, *, van, netem_local: str,
                            my_slot: int) -> None:
        self._van = van
        self._my_slot = int(my_slot)
        self.committed = -1
        self.epoch = 0
        self.acked = 0
        self._bars = None      # (key, sync_barrier, commit_barrier)
        # replicated durable tier: resolve the per-process VanReplica
        # (same cached instance the tables/membership already share) so
        # barriers can re-key and re-dial across a primary promotion
        self._replica = None
        self._van_voided = None   # epoch whose step a promotion voided
        van_spec = getattr(self.spec, "van", None)
        if van_spec:
            from hetu_tpu_torch.ps.replica import VanReplica
            self._replica = VanReplica.from_spec(van_spec)
        # the scalar WORK time reported in the heartbeat's load field —
        # work time only, barrier/mailbox waits excluded: a fast member
        # parked on a slow peer must not itself read as slow
        self._work_ms = 0.0
        # the injected slow link (control row C_SLOW_*): a NetEm
        # latency policy on this member's van ops — the fault is a slow
        # WIRE, not a sleep in the math, so detection sees exactly what
        # a congested DCN link would produce
        from hetu_tpu_torch.ps.netem import NetEm
        self.netem = NetEm(local=netem_local, peer="van")
        self.netem.install()
        self._slow_ms_active = 0
        self._stop = threading.Event()

    def _start_beat(self) -> None:
        self._beat = threading.Thread(target=self._beat_loop,
                                      daemon=True)
        self._beat.start()

    def _beat_loop(self) -> None:
        period = max(self.spec.hb_ms, 10) / 1000.0
        while not self._stop.wait(period):
            try:
                self._sync_row()
            except Exception:
                time.sleep(period)  # silence IS the loss signal

    def _sync_row(self) -> None:
        self.member.heartbeat(committed=float(self.committed),
                              epoch_ack=float(self.acked),
                              load=float(self._work_ms))

    def _apply_slow(self, slow_slot: int, slow_ms: int) -> None:
        """Honor the control row's straggler-injection fields: install
        (or clear) a symmetric latency policy on this member's van
        link.  Idempotent per published value."""
        from hetu_tpu_torch.ps.netem import LinkPolicy
        want = int(slow_ms) if (int(slow_slot) == self._my_slot and
                                int(slow_ms) > 0) else 0
        if want == self._slow_ms_active:
            return
        if want:
            self.netem.set_link(LinkPolicy(latency_s=want / 1000.0),
                                direction="both")
        else:
            self.netem.clear()
        self._slow_ms_active = want

    def _van_endpoint(self):
        """Where barriers dial: the replica pair's CURRENT primary, or
        the spec's fixed port when the plane runs unreplicated."""
        if self._replica is not None:
            host, port = self._replica.primary
            return host, port
        return "127.0.0.1", self.spec.port

    def _van_gen(self) -> int:
        """The van-generation band of barrier ids: 0 before any
        failover (incarnation 1 — ids are unchanged from the
        unreplicated plane), +1 per promotion.  A promoted van has NONE
        of the old van's arrival-generation state, so re-arriving at
        the OLD ids would resume someone else's generation counter;
        re-keying by ``(van_gen, epoch, phase)`` makes every member
        arrive at FRESH ids on the new primary instead — idempotently,
        because the voided step re-runs in full."""
        if self._replica is not None:
            return max(self._replica.incarnation - 1, 0)
        return 0

    def _barrier(self, phase: int, width: int):
        bid = (self.spec.barrier_base + self._van_gen() * (1 << 21)
               + 2 * self.epoch + phase)
        host, port = self._van_endpoint()
        return self._van.RemoteBarrier(host, port, bid, width)

    def _epoch_barriers(self, width: int):
        """The (sync, commit) barrier pair for the CURRENT (van_gen,
        epoch), cached — barrier ids and widths only change with the
        epoch or a van promotion, and opening two fresh van connections
        per STEP would put hundreds of connect/close cycles per second
        on the hot path."""
        key = (self._van_gen(), self.epoch)
        if self._bars is None or self._bars[0] != key:
            self._close_barriers()
            self._bars = (key, self._barrier(0, width),
                          self._barrier(1, width))
        return self._bars[1], self._bars[2]

    def _close_barriers(self) -> None:
        if self._bars is not None:
            for bar in self._bars[1:]:
                try:
                    bar.close()
                except Exception:
                    pass
            self._bars = None

    def _park_if_headless(self) -> bool:
        """Freeze at this step boundary while the CONTROLLER is silent
        (its blackboard beat stopped for ``spec.ctrl_lease_s``): a
        headless fleet must not race a takeover's re-freeze mid-step.
        Parking is pure waiting — the beat thread keeps heartbeating
        and the member's own lease stays live.

        Unparking is incarnation-aware: beats from the SAME incarnation
        mean the controller never died (a GC pause, a slow poll) —
        nothing was missed, continue immediately.  Beats from a NEW
        incarnation mean a takeover is in progress: hold until its
        republish (a new epoch, or a PREPARE) lands, so the takeover's
        freeze can never interleave with a half-run step — the one
        ordering that would turn a clean controller death into an
        at-least-once gradient (weight-byte-identity cannot absorb a
        post-push discard).  Returns True when a park happened (the
        caller re-reads the control row and continues).  Disabled when
        ``spec.ctrl_lease_s`` is 0/absent."""
        bound = float(getattr(self.spec, "ctrl_lease_s", 0.0) or 0.0)
        if bound <= 0.0 or not self.member.controller_silent(bound):
            return False
        self.parks = getattr(self, "parks", 0) + 1
        parked_inc = self.member.ctrl_inc
        parked_epoch = self.epoch
        while not self._stop.is_set():
            try:
                ctl = self.member.read_control()
            except Exception:
                ctl = None  # an unreachable van parks too; the beat
                # thread keeps trying — silence is judged on beats
            if ctl is None or self.member.controller_silent(bound):
                self._stop.wait(0.05)
                continue
            if self.member.ctrl_inc == parked_inc:
                break  # the same controller resumed: no takeover, no
                # republish coming — just continue
            if ctl[0] != parked_epoch or ctl[4] != 0:
                break  # the takeover's republish landed: the next
                # control read freezes/acks it at this boundary
            self._stop.wait(0.02)
        return True

    def _hold_for_republish(self, e: int, phase: int) -> bool:
        """True while the member should idle at its loop top after a
        promotion-driven step void: the controller (which learns of the
        promotion through its own replica callback) republishes a fresh
        epoch, and only THAT epoch's re-run is safe to log.  The hold
        never blocks a PREPARE — the loop's phase branch runs first, so
        the republish's ack path stays live."""
        if self._van_voided is None:
            return False
        if phase != 0 or e != self._van_voided:
            self._van_voided = None
            return False
        return True

    def _check_epoch(self) -> None:
        """Raise :class:`EpochChanged` when the controller moved the
        membership (new epoch OR a prepare freeze) — the in-flight step
        is then void."""
        e, _, _, _, phase, _, _ = self.member.read_control()
        if e != self.epoch or phase != 0:
            raise EpochChanged

    def _await_barrier(self, bar) -> None:
        """Wait out one lockstep barrier, re-checking the control row
        between short waits.  The generation-counted van barrier
        withdraws timed-out arrivals, so lockstep cannot release
        short-handed.  Transport failures run the replica failover
        dance: once the primary changes the in-flight step is void
        (:class:`EpochChanged`) and the re-run arrives at the re-keyed
        barrier ids on the promoted van."""
        faults = 0
        while True:
            try:
                bar.wait(timeout_s=self.spec.barrier_wait_s)
                return
            except TimeoutError:
                self._check_epoch()
            except (ConnectionError, RuntimeError) as e:
                faults += 1
                self._wire_fault(e, faults=faults)

    def _wire_fault(self, e: BaseException, *, faults: int = 1) -> None:
        """A van op (barrier wait, mailbox, table) failed transport-
        wise mid-step.  With a replicated durable tier, run the
        failover dance; once the primary changed, drop the stale
        barrier handles and void the step.  Without a replica (or for
        a non-wire error) the failure propagates — the van is the
        single point of failure it always was."""
        from hetu_tpu_torch.ps.replica import _is_wire_error
        wire = _is_wire_error(e) or (isinstance(e, RuntimeError)
                                     and "rc=" in str(e))
        if self._replica is None or not wire:
            raise e
        if self._replica.failover(e):
            self._close_barriers()
            # hold the re-run until the controller republishes: a
            # re-run at the OLD epoch would write a same-epoch
            # duplicate of the voided step's consumed record (the dp
            # plane's complete-cover evidence tolerates crash residue
            # ACROSS epochs, not same-epoch duplicates)
            self._van_voided = self.epoch
            raise EpochChanged from e
        if faults > 120:
            raise e  # the van is alive and the op persistently fails:
            # this is not a failover, surface the real error
        # not promoted yet (detection grace window): give the dance a
        # beat, then re-check the control row — a controller-driven
        # move can land while the pair is still deciding.  An
        # unreachable van parks the check too; the next wait retries.
        time.sleep(0.05)
        try:
            self._check_epoch()
        except EpochChanged:
            raise
        except Exception:
            pass

    def _close_control_plane(self) -> None:
        self._close_barriers()
        self.member.close()
        self.netem.uninstall()


def drive_controller_harness(poll, progress, done, *,
                             deadline_s: float,
                             on_progress=None, ready_words=()) -> int:
    """The ONE copy of the spawned-controller chaos-harness drive loop
    (the controller half of this module's member protocol).  Both
    training planes' ``--controller`` entry points delegate here, so
    the marker contract the chaos tests key on cannot drift between
    them: ``READY`` once the caller's supervisor is built (the spawn
    handshake), ``STEP <p>`` per ``progress()`` change, ``DEADLINE``
    (rc 2) when
    the fleet never finishes inside ``deadline_s`` — an ``ALLDONE``
    there would mask the hang as completion — ``ALLDONE`` then hold
    (the harness kills us, or we get fenced), and ``FENCED`` (rc 3)
    on :class:`~hetu_tpu_torch.ps.membership.ControllerFenced` WITHOUT any
    fleet teardown: a fenced zombie's close() would kill member
    processes the new incarnation now owns.

    ``on_progress(p)`` is the per-plane edge hook (e.g. the elastic
    harness's publish-PREPARE-then-hang mode); it may never return.
    ``ready_words`` follow ``READY`` on its line (the mpmd controller's
    ``jax=0 torch=0``).
    """
    from hetu_tpu_torch.ps import membership as _mb
    print("READY", *ready_words, flush=True)
    deadline = time.monotonic() + float(deadline_s)
    last = object()
    finished = False
    try:
        while time.monotonic() < deadline:
            poll()
            p = progress()
            if p != last:
                last = p
                print(f"STEP {p}", flush=True)
            if on_progress is not None:
                on_progress(p)
            if done():
                finished = True
                break
            time.sleep(0.03)
        if not finished:
            print("DEADLINE", flush=True)
            return 2
        print("ALLDONE", flush=True)
        while True:
            poll()
            time.sleep(0.05)
    except _mb.ControllerFenced:
        print("FENCED", flush=True)
        return 3
