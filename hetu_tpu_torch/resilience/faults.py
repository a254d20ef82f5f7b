"""Deterministic, seedable fault injection for chaos runs (counterpart
of ``hetu_tpu/resilience/faults.py``).

A recovery path that is never exercised is a recovery path that does not
work — this module makes the faults injectable, and crucially
REPLAYABLE: every fault is drawn from a seeded :class:`FaultSchedule`, so
a chaos run that fails reproduces byte-for-byte from its seed
(``FaultSchedule.to_json`` is the evidence).  The draw consumes
``np.random.default_rng(seed)`` in the reference's order, so the same
seed and keyword arguments give the reference's bytes.

Fault kinds
-----------
``van_error``      next client-side van wire op raises :class:`TransientFault`
``van_delay``      next client-side van wire op sleeps ``arg`` seconds first
``data_error``     next dataloader fetch raises :class:`TransientDataError`
``nan_grad``       the step's batch gets a NaN poisoned into its first float
                   leaf (a torch tensor or a numpy array) — the loss/grads
                   of a NaN input are NaN, exercising a nonfinite-step
                   guard without reaching inside the step
``kill_shard``     SIGKILL the PS shard subprocess ``arg`` (mid-step death)
``suspend_shard``  SIGSTOP shard ``arg`` for ``arg2`` seconds (GC-pause /
                   network-partition lookalike), then SIGCONT
``preempt``        deliver SIGTERM to the training process (simulated
                   preemption; the supervisor checkpoints and exits)
``worker_loss``    data-parallel worker ``arg`` is PERMANENTLY lost — the
                   elastic supervisor reforms the mesh at the surviving
                   width instead of aborting (resilience/elastic.py)
``worker_join``    worker ``arg`` (re)joins — the mesh regrows
``serve_preempt``  serving-pool member ``arg`` receives a preemption
                   notice: the pool drains it PLANNED — live KV slots
                   migrate to a peer (serve/pool.py, zero re-prefill)
``serve_engine_kill``  serving-pool member ``arg``'s engine dies
                   UNANNOUNCED (SIGKILL-alike, KV state lost); the pool
                   fails its queue over to a peer via re-prefill
``member_kill``    SIGKILL the serving-member PROCESS ``arg`` (real OS
                   death: the cross-process pool's lease expires and it
                   fails the member's requests over — serve/crosshost.py)
``member_suspend`` SIGSTOP member process ``arg`` for ``arg2`` seconds,
                   then SIGCONT — the partition lookalike the lease
                   machinery must NOT double-count as loss+rejoin
``worker_proc_kill``  SIGKILL training-worker PROCESS ``arg`` — the
                   multi-controller fleet resharding path
                   (resilience/multicontroller.py)
``netem_partition``  one-way partition of member/worker ``arg``'s
                   EGRESS for ``arg2`` seconds (ps/netem.py: its
                   writes black-hole, its reads still work — the
                   asymmetric gray failure the lease machine must
                   degrade-and-clear on, never lost+rejoin)
``netem_degrade``  member/worker ``arg``'s link turns gray for
                   ``arg2`` seconds: loss + latency + a bandwidth cap
                   (the pool's routing should penalize it; serving
                   degrades to bounded latency, not collapse)
``straggler``      worker ``arg`` runs behind an emulated slow link
                   for ``arg2`` seconds — alive, beating, 10x slow;
                   the straggler-aware barriers must detect it
                   (``train.straggler``) and apply the wait/evict
                   policy (resilience/multicontroller.py)
``stage_kill``     SIGKILL pipeline-stage PROCESS ``arg`` — the MPMD
                   pipeline's lease-expiry stage-replacement path
                   (parallel/mpmd_elastic.py: replacement pulls stage
                   weights from the PS, exact two-phase resume)
``stage_slow``     pipeline stage ``arg`` runs behind an emulated slow
                   link for ``arg2`` seconds — the pipeline straggler
                   the lockstep schedule must tolerate
                   (``train.straggler``, wait policy only: a stage is
                   not redundant)
``controller_kill``  SIGKILL the CONTROLLER process ``arg`` — the
                   control plane itself is the fault domain: members
                   park/queue, a new incarnation takes over from the
                   blackboard + ledger (``ctrl.takeover``), and the
                   fleet finishes token-exact / byte-identical
``controller_suspend``  SIGSTOP controller ``arg`` for ``arg2``
                   seconds, then SIGCONT — the ZOMBIE case: a takeover
                   during the pause must fence the resumed controller
                   (its writes rejected, fleet state unchanged)
``van_kill``       SIGKILL the primary VAN process ``arg`` — the
                   durable tier itself is the fault domain: clients'
                   ops fail transiently, the backup van is promoted
                   via the epoch-row CAS (``van.promote``), and every
                   table/channel re-resolves (ps/replica.py)
``van_suspend``    SIGSTOP van process ``arg`` for ``arg2`` seconds,
                   then SIGCONT — the durable-tier zombie: clients'
                   receive timeouts surface the hang, the backup
                   promotes, and the RESUMED old primary is fenced
                   (its epoch row names its successor)
``van_resilver_kill``  the SECOND-fault kind: once the previous van
                   fault's promotion has RE-SILVERED (a fresh backup
                   attached, pair bitwise-identical again), SIGKILL
                   the promoted primary — survival proves redundancy
                   was genuinely restored, not just reported.  Paced
                   by the chaos loop (recovery-aware: injected only after
                   ``van.resilver`` closed), drained via
                   :meth:`FaultInjector.pop_campaign_events`
``controller_kill_mid_failover``  SIGKILL the controller WHILE a van
                   failover/re-silver is in flight — the takeover must
                   re-derive both the fleet AND the current van pair
                   from what survives (paced by the chaos loop)
``member_kill_mid_resilver``  SIGKILL a serving-member process WHILE
                   the pair is re-silvering — the copy/catch-up stream
                   must stay consistent across a concurrent member
                   failover (paced by the chaos loop)

The van hooks ride :func:`hetu_tpu_torch.ps.van.set_fault_hook`
(one-shot faults) and :func:`hetu_tpu_torch.ps.van.set_netem_hook` (link
policies);
everything else is plain process/OS plumbing, so the harness needs no
native lib to import.  The netem/straggler kinds are RECORDED into
``net_events`` (like the worker/serve kinds) — the pool controller or
training supervisor drains them via :meth:`FaultInjector.
pop_net_events` and applies the link policy through its own control
plane, because the injector cannot reach into another process's wire.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
import zlib
from collections import defaultdict, deque
from dataclasses import dataclass

import numpy as np

from hetu_tpu_torch.telemetry import trace


class TransientFault(ConnectionError):
    """Injected transient van transport failure (send/recv)."""


class TransientDataError(RuntimeError):
    """Injected transient dataloader failure (flaky storage / decode)."""


KINDS = ("van_error", "van_delay", "data_error", "nan_grad",
         "kill_shard", "suspend_shard", "preempt",
         "worker_loss", "worker_join",
         "serve_preempt", "serve_engine_kill",
         "member_kill", "member_suspend", "worker_proc_kill",
         "netem_partition", "netem_degrade", "straggler",
         "stage_kill", "stage_slow",
         "controller_kill", "controller_suspend",
         "van_kill", "van_suspend",
         "van_resilver_kill", "controller_kill_mid_failover",
         "member_kill_mid_resilver")


@dataclass(frozen=True, order=True)
class FaultEvent:
    """One scheduled fault.  ``arg``/``arg2`` meaning depends on ``kind``:
    van_delay: arg=seconds; kill/suspend_shard: arg=shard index (arg2 =
    suspend duration seconds); others unused."""

    step: int
    kind: str
    arg: float = 0.0
    arg2: float = 0.0


class FaultSchedule:
    """An immutable, fully materialized list of :class:`FaultEvent`.

    Build one explicitly from events, or :meth:`generate` one from a seed —
    generation consumes a ``np.random.default_rng(seed)`` in a fixed order,
    so the same (seed, kwargs) always yields the identical schedule and
    ``to_json`` is byte-for-byte stable (the replay contract chaos tests
    assert on).
    """

    def __init__(self, events):
        events = list(events)
        bad = sorted({e.kind for e in events} - set(KINDS))
        if bad:
            raise ValueError(f"unknown fault kinds {bad}; known: {KINDS}")
        self.events = sorted(events)
        self._by_step = defaultdict(list)
        for e in self.events:
            self._by_step[int(e.step)].append(e)

    @classmethod
    def generate(cls, *, steps: int, seed: int,
                 van_errors: int = 0, van_delays: int = 0,
                 delay_s: float = 0.02, data_errors: int = 0,
                 nan_steps: int = 0, kill_shards: int = 0,
                 suspend_shards: int = 0, suspend_s: float = 0.3,
                 n_shards: int = 1,
                 preempt_at: int | None = None,
                 worker_losses: int = 0, worker_joins: int = 0,
                 n_workers: int = 1,
                 serve_preempts: int = 0, serve_engine_kills: int = 0,
                 n_members: int = 1,
                 member_kills: int = 0, member_suspends: int = 0,
                 member_suspend_s: float = 0.5,
                 worker_proc_kills: int = 0,
                 netem_partitions: int = 0, netem_partition_s: float = 0.8,
                 netem_degrades: int = 0, netem_degrade_s: float = 1.0,
                 stragglers: int = 0,
                 straggler_s: float = 1.0,
                 stage_kills: int = 0, stage_slows: int = 0,
                 stage_slow_s: float = 1.0,
                 n_stages: int = 1,
                 controller_kills: int = 0,
                 controller_suspends: int = 0,
                 controller_suspend_s: float = 1.0,
                 n_controllers: int = 1,
                 van_kills: int = 0, van_suspends: int = 0,
                 van_suspend_s: float = 1.5,
                 n_vans: int = 1,
                 van_resilver_kills: int = 0,
                 controller_mid_failover_kills: int = 0,
                 member_mid_resilver_kills: int = 0) -> "FaultSchedule":
        """Draw a schedule over training steps ``[1, steps)`` from ``seed``.

        Counts are clipped to the available steps.  Shard-targeted faults
        pick a victim shard uniformly from ``n_shards``.  ``preempt_at`` is
        explicit (a random preemption inside a bounded test run is rarely
        what you want — pass it when you do).

        Elastic membership: ``worker_losses`` permanent DP-worker losses
        (distinct victims drawn from ``n_workers``) and ``worker_joins``
        rejoins — each join revives an earlier-lost worker at a step
        strictly after its loss, so a generated schedule is always
        physically consistent (never joins a worker that is present).
        New draws consume the rng AFTER all pre-existing kinds, so
        schedules generated with the old kwargs are byte-identical.

        Serving-pool faults: ``serve_preempts`` planned member
        preemptions (the pool live-migrates the victim's KV slots) and
        ``serve_engine_kills`` abrupt engine deaths (re-prefill
        failover), each picking a victim member uniformly from
        ``n_members``.  Drawn after everything above — same
        byte-identity guarantee for pre-existing kwargs.

        Process-level faults (cross-process deployments):
        ``member_kills`` SIGKILL a serving-member process,
        ``member_suspends`` SIGSTOP one for ``member_suspend_s``
        seconds (then SIGCONT), ``worker_proc_kills`` SIGKILL a
        training-worker process — victims drawn uniformly from
        ``n_members`` / ``n_workers``, after ALL earlier kinds.

        Network-plane faults (gray failures, ps/netem.py):
        ``netem_partitions`` one-way egress partitions of a member for
        ``netem_partition_s`` seconds, ``netem_degrades`` gray-link
        windows (loss+latency+bandwidth cap) for ``netem_degrade_s``,
        ``stragglers`` slow-link windows on a training worker for
        ``straggler_s`` — victims uniform from ``n_members`` /
        ``n_members`` / ``n_workers``, drawn after EVERY pre-existing
        kind so old-seed schedules replay byte-identical (the frozen-
        bytes regression contract, third extension running).

        Pipeline-stage faults (parallel/mpmd_elastic.py):
        ``stage_kills`` SIGKILL a pipeline-stage process and
        ``stage_slows`` slow-link windows on a stage for
        ``stage_slow_s`` seconds — victims uniform from ``n_stages``,
        drawn after EVERY kind above (fourth extension of the
        frozen-bytes contract).

        Control-plane faults (the controller is just another fault
        domain): ``controller_kills`` SIGKILL a controller process,
        ``controller_suspends`` SIGSTOP one for
        ``controller_suspend_s`` seconds (the zombie-fencing path) —
        victims uniform from ``n_controllers``, drawn after EVERY kind
        above (FIFTH extension of the frozen-bytes contract).

        Durable-tier faults (the van itself): ``van_kills`` SIGKILL a
        primary van process, ``van_suspends`` SIGSTOP one for
        ``van_suspend_s`` seconds (the fenced-resume path) — victims
        uniform from ``n_vans``, drawn after EVERY kind above (SIXTH
        extension of the frozen-bytes contract).

        Sequential-campaign kinds (the SECOND-fault loop):
        ``van_resilver_kills`` kill the promoted primary only after the
        pair re-silvered, ``controller_mid_failover_kills`` kill the
        controller while a van failover is in flight,
        ``member_mid_resilver_kills`` kill a member mid-resilver —
        victims uniform from ``n_vans`` / ``n_controllers`` /
        ``n_members``, drawn after EVERY kind above (SEVENTH extension
        of the frozen-bytes contract).  These kinds are PACED: the
        injector records them (``pop_campaign_events``) and the chaos loop
        applies each only once its precondition (recovery of the
        previous fault / an in-flight failover or resilver) holds.
        """
        rng = np.random.default_rng(seed)
        hi = max(int(steps), 2)

        def pick(n: int) -> list[int]:
            n = min(int(n), hi - 1)
            if n <= 0:
                return []
            return [int(s) for s in rng.choice(np.arange(1, hi), size=n,
                                               replace=False)]

        events = []
        for s in pick(van_errors):
            events.append(FaultEvent(s, "van_error"))
        for s in pick(van_delays):
            events.append(FaultEvent(s, "van_delay", float(delay_s)))
        for s in pick(data_errors):
            events.append(FaultEvent(s, "data_error"))
        for s in pick(nan_steps):
            events.append(FaultEvent(s, "nan_grad"))
        for s in pick(kill_shards):
            events.append(FaultEvent(s, "kill_shard",
                                     float(rng.integers(max(n_shards, 1)))))
        for s in pick(suspend_shards):
            events.append(FaultEvent(s, "suspend_shard",
                                     float(rng.integers(max(n_shards, 1))),
                                     float(suspend_s)))
        if preempt_at is not None:
            events.append(FaultEvent(int(preempt_at), "preempt"))
        n_loss = min(int(worker_losses), max(n_workers - 1, 0), hi - 2)
        if n_loss > 0:
            loss_steps = sorted(pick(n_loss))
            # a joined worker's loss must leave room for a STRICTLY later
            # join step (a same-step pair sorts join-first and the monitor
            # would drop it, silently losing the worker forever): clamp
            # those losses to hi-2.  With hi < 3 there is no such room —
            # the joins are dropped, not mis-scheduled.
            n_join = min(int(worker_joins), n_loss) if hi >= 3 else 0
            if n_join:
                for i in range(n_join):
                    loss_steps[i] = min(loss_steps[i], hi - 2)
                loss_steps.sort()
            victims = [int(v) for v in rng.choice(np.arange(max(n_workers,
                                                                1)),
                                                  size=n_loss,
                                                  replace=False)]
            for s, v in zip(loss_steps, victims):
                events.append(FaultEvent(s, "worker_loss", float(v)))
            for i in range(n_join):
                join_s = int(rng.integers(loss_steps[i] + 1, hi))
                events.append(FaultEvent(join_s, "worker_join",
                                         float(victims[i])))
        for s in pick(serve_preempts):
            events.append(FaultEvent(s, "serve_preempt",
                                     float(rng.integers(max(n_members,
                                                            1)))))
        for s in pick(serve_engine_kills):
            events.append(FaultEvent(s, "serve_engine_kill",
                                     float(rng.integers(max(n_members,
                                                            1)))))
        # process-level kinds: real SIGKILL/SIGSTOP on Popen handles.
        # Drawn after EVERYTHING above — schedules generated with the
        # pre-existing kwargs stay byte-identical (the frozen-bytes test)
        for s in pick(member_kills):
            events.append(FaultEvent(s, "member_kill",
                                     float(rng.integers(max(n_members,
                                                            1)))))
        for s in pick(member_suspends):
            events.append(FaultEvent(s, "member_suspend",
                                     float(rng.integers(max(n_members,
                                                            1))),
                                     float(member_suspend_s)))
        for s in pick(worker_proc_kills):
            events.append(FaultEvent(s, "worker_proc_kill",
                                     float(rng.integers(max(n_workers,
                                                            1)))))
        # network-plane kinds: drawn after everything above — the same
        # frozen-bytes guarantee the process-level kinds honored
        for s in pick(netem_partitions):
            events.append(FaultEvent(s, "netem_partition",
                                     float(rng.integers(max(n_members,
                                                            1))),
                                     float(netem_partition_s)))
        for s in pick(netem_degrades):
            events.append(FaultEvent(s, "netem_degrade",
                                     float(rng.integers(max(n_members,
                                                            1))),
                                     float(netem_degrade_s)))
        for s in pick(stragglers):
            events.append(FaultEvent(s, "straggler",
                                     float(rng.integers(max(n_workers,
                                                            1))),
                                     float(straggler_s)))
        # pipeline-stage kinds: drawn after everything above — the same
        # frozen-bytes guarantee every earlier extension honored
        for s in pick(stage_kills):
            events.append(FaultEvent(s, "stage_kill",
                                     float(rng.integers(max(n_stages,
                                                            1)))))
        for s in pick(stage_slows):
            events.append(FaultEvent(s, "stage_slow",
                                     float(rng.integers(max(n_stages,
                                                            1))),
                                     float(stage_slow_s)))
        # control-plane kinds: drawn after everything above — the same
        # frozen-bytes guarantee every earlier extension honored
        for s in pick(controller_kills):
            events.append(FaultEvent(s, "controller_kill",
                                     float(rng.integers(
                                         max(n_controllers, 1)))))
        for s in pick(controller_suspends):
            events.append(FaultEvent(s, "controller_suspend",
                                     float(rng.integers(
                                         max(n_controllers, 1))),
                                     float(controller_suspend_s)))
        # durable-tier kinds: drawn after everything above — the same
        # frozen-bytes guarantee every earlier extension honored
        for s in pick(van_kills):
            events.append(FaultEvent(s, "van_kill",
                                     float(rng.integers(max(n_vans,
                                                            1)))))
        for s in pick(van_suspends):
            events.append(FaultEvent(s, "van_suspend",
                                     float(rng.integers(max(n_vans,
                                                            1))),
                                     float(van_suspend_s)))
        # sequential-campaign kinds: drawn after everything above — the
        # same frozen-bytes guarantee every earlier extension honored
        for s in pick(van_resilver_kills):
            events.append(FaultEvent(s, "van_resilver_kill",
                                     float(rng.integers(max(n_vans,
                                                            1)))))
        for s in pick(controller_mid_failover_kills):
            events.append(FaultEvent(s, "controller_kill_mid_failover",
                                     float(rng.integers(
                                         max(n_controllers, 1)))))
        for s in pick(member_mid_resilver_kills):
            events.append(FaultEvent(s, "member_kill_mid_resilver",
                                     float(rng.integers(max(n_members,
                                                            1)))))
        return cls(events)

    def at(self, step: int) -> list[FaultEvent]:
        return self._by_step.get(int(step), [])

    def __len__(self) -> int:
        return len(self.events)

    def to_json(self) -> str:
        """Canonical serialization — two schedules are the same chaos run
        iff their to_json bytes are equal."""
        return json.dumps([[e.step, e.kind, e.arg, e.arg2]
                           for e in self.events], separators=(",", ":"))

    @property
    def schedule_id(self) -> str:
        """Stable 8-hex id of the canonical serialization: the tag every
        injected fault's trace instant carries, so a trace names the exact
        chaos run that produced it (same seed+kwargs → same id)."""
        return f"{zlib.crc32(self.to_json().encode()):08x}"

    @classmethod
    def from_json(cls, s: str) -> "FaultSchedule":
        return cls([FaultEvent(int(st), k, float(a), float(a2))
                    for st, k, a, a2 in json.loads(s)])


class FaultInjector:
    """Drives a :class:`FaultSchedule` against a live training run.

    The supervisor calls :meth:`on_step` at the top of every step (arming
    one-shot van/data faults, killing/suspending shard subprocesses,
    delivering the preemption signal) and :meth:`corrupt_batch` on the
    fetched batch.  ``install()`` hooks the van client ops; always pair
    with ``uninstall()`` (the supervisor does both).

    ``counters`` tallies everything injected — the supervisor merges them
    into its own counters so they flow out through ``MetricLogger``.
    """

    def __init__(self, schedule: FaultSchedule, *, shard_procs=(),
                 member_procs=None, worker_procs=None, stage_procs=None,
                 ctrl_procs=None, van_procs=None,
                 pid: int | None = None):
        self.schedule = schedule
        self.shard_procs = list(shard_procs)  # subprocess.Popen-likes
        # LIVE references (not copies): the cross-process pool /
        # multi-controller supervisor revive slots in place, and a fault
        # landing after a revive must target the CURRENT incarnation
        self.member_procs = member_procs if member_procs is not None else []
        self.worker_procs = worker_procs if worker_procs is not None else []
        self.stage_procs = stage_procs if stage_procs is not None else []
        self.ctrl_procs = ctrl_procs if ctrl_procs is not None else []
        self.van_procs = van_procs if van_procs is not None else []
        self.pid = int(pid) if pid is not None else os.getpid()
        self.counters = defaultdict(int)
        self._armed_van = deque()   # one-shot ("error"|"delay", arg)
        self._armed_data = 0
        self._nan_armed = False
        # membership events for the elastic supervisor: ("loss"|"join",
        # worker_idx), drained via pop_worker_events() at the top of each
        # step — the injector records, the supervisor decides
        self.worker_events = deque()
        # serving-pool events: (kind, member_idx), drained via
        # pop_serve_events() by the pool's chaos loop (same record/
        # decide split: the injector cannot reach into the pool's engines)
        self.serve_events = deque()
        # network-plane events: (kind, victim_idx, duration_s), drained
        # via pop_net_events() — the controller applies the link policy
        # through its own control plane (the injector cannot reach into
        # another PROCESS's van hooks)
        self.net_events = deque()
        # sequential-campaign events: (kind, victim_idx), drained via
        # pop_campaign_events() — these kinds are RECOVERY-PACED (kill
        # the promoted primary only after the resilver closed, kill the
        # controller only mid-failover), and only the chaos loop can see
        # that state
        self.campaign_events = deque()
        self._lock = threading.Lock()
        self._prev_hook = None
        self._installed = False

    # ---- lifecycle ----
    def install(self) -> "FaultInjector":
        from hetu_tpu_torch.ps import van
        if not self._installed:
            self._prev_hook = van.set_fault_hook(self._van_hook)
            self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            from hetu_tpu_torch.ps import van
            van.set_fault_hook(self._prev_hook)
            self._installed = False

    # ---- van hook ----
    def _van_hook(self, op: str) -> None:
        with self._lock:
            fault = self._armed_van.popleft() if self._armed_van else None
        if fault is None:
            if self._prev_hook is not None:
                self._prev_hook(op)
            return
        kind, arg = fault
        if kind == "delay":
            self.counters["van_delays_injected"] += 1
            time.sleep(arg)
        else:
            self.counters["van_errors_injected"] += 1
            raise TransientFault(f"injected transient van fault before {op}")

    # ---- per-step hook ----
    def on_step(self, step: int) -> None:
        for ev in self.schedule.at(step):
            self.counters["faults_injected"] += 1
            k = ev.kind
            # one instant per injection: schedule.at() returns a sorted
            # deterministic order, so two runs with the same seed emit the
            # identical instant sequence (the timeline pairing contract)
            trace.instant("fault." + k,
                          {"kind": k, "step": int(step), "arg": ev.arg,
                           "arg2": ev.arg2,
                           "schedule": self.schedule.schedule_id})
            if k == "van_error":
                with self._lock:
                    self._armed_van.append(("error", 0.0))
            elif k == "van_delay":
                with self._lock:
                    self._armed_van.append(("delay", ev.arg or 0.02))
            elif k == "data_error":
                with self._lock:
                    self._armed_data += 1
            elif k == "nan_grad":
                self._nan_armed = True
            elif k == "kill_shard":
                self._kill(int(ev.arg))
            elif k == "suspend_shard":
                self._suspend(int(ev.arg), ev.arg2 or 0.3)
            elif k == "preempt":
                self.counters["preempts_injected"] += 1
                os.kill(self.pid, signal.SIGTERM)
            elif k == "worker_loss":
                self.counters["worker_losses_injected"] += 1
                with self._lock:
                    self.worker_events.append(("loss", int(ev.arg)))
            elif k == "worker_join":
                self.counters["worker_joins_injected"] += 1
                with self._lock:
                    self.worker_events.append(("join", int(ev.arg)))
            elif k in ("serve_preempt", "serve_engine_kill"):
                self.counters[k + "s_injected"] += 1
                with self._lock:
                    self.serve_events.append((k, int(ev.arg)))
            elif k == "member_kill":
                self._proc_kill(self.member_procs, int(ev.arg),
                                "member_procs_killed")
            elif k == "member_suspend":
                self._proc_suspend(self.member_procs, int(ev.arg),
                                   ev.arg2 or 0.5,
                                   "member_procs_suspended")
            elif k == "worker_proc_kill":
                self._proc_kill(self.worker_procs, int(ev.arg),
                                "worker_procs_killed")
            elif k == "stage_kill":
                self._proc_kill(self.stage_procs, int(ev.arg),
                                "stage_procs_killed")
            elif k == "controller_kill":
                self._proc_kill(self.ctrl_procs, int(ev.arg),
                                "controller_procs_killed")
            elif k == "controller_suspend":
                self._proc_suspend(self.ctrl_procs, int(ev.arg),
                                   ev.arg2 or 1.0,
                                   "controller_procs_suspended")
            elif k == "van_kill":
                self._proc_kill(self.van_procs, int(ev.arg),
                                "van_procs_killed")
            elif k == "van_suspend":
                self._proc_suspend(self.van_procs, int(ev.arg),
                                   ev.arg2 or 1.5,
                                   "van_procs_suspended")
            elif k in ("van_resilver_kill", "controller_kill_mid_failover",
                       "member_kill_mid_resilver"):
                self.counters[k + "s_injected"] += 1
                with self._lock:
                    self.campaign_events.append((k, int(ev.arg)))
            elif k == "stage_slow":
                self.counters["stage_slows_injected"] += 1
                with self._lock:
                    self.net_events.append((k, int(ev.arg),
                                            float(ev.arg2) or 1.0))
            elif k in ("netem_partition", "netem_degrade", "straggler"):
                self.counters[k + "s_injected"] += 1
                with self._lock:
                    self.net_events.append((k, int(ev.arg),
                                            float(ev.arg2) or 1.0))

    def pop_serve_events(self) -> list:
        """Drain pending serving-pool events as
        ``[("serve_preempt"|"serve_engine_kill", member_idx)]`` — feed
        them to ``ServingPool.run_fault_events``."""
        with self._lock:
            out = list(self.serve_events)
            self.serve_events.clear()
        return out

    def pop_net_events(self, kinds=None) -> list:
        """Drain pending network-plane events as ``[("netem_partition"
        |"netem_degrade"|"straggler"|"stage_slow", victim_idx,
        duration_s)]`` — feed them to
        ``CrossProcessServingPool.run_net_events`` (serving),
        ``MultiControllerElasticSupervisor`` (stragglers), or
        ``MPMDPipelineSupervisor`` (stage_slow).

        ``kinds`` drains selectively: events of OTHER kinds stay queued
        for the chaos loop that owns them.  A mixed schedule driven by the
        training supervisor (which applies only stragglers) must not
        silently swallow serving-plane partitions its injector already
        recorded as injected — an unclaimed event staying visible in
        the queue is the honest failure mode."""
        with self._lock:
            if kinds is None:
                out = list(self.net_events)
                self.net_events.clear()
            else:
                kinds = set(kinds)
                out = [e for e in self.net_events if e[0] in kinds]
                keep = [e for e in self.net_events if e[0] not in kinds]
                self.net_events.clear()
                self.net_events.extend(keep)
        return out

    def pop_campaign_events(self) -> list:
        """Drain pending sequential-campaign events as
        ``[("van_resilver_kill"|"controller_kill_mid_failover"|
        "member_kill_mid_resilver", victim_idx)]`` — the chaos loop applies
        each once its recovery-aware precondition holds (see
        :class:`SequentialFaultCampaign`)."""
        with self._lock:
            out = list(self.campaign_events)
            self.campaign_events.clear()
        return out

    def pop_worker_events(self) -> list:
        """Drain pending membership events as [("loss"|"join", worker)].
        Called by the elastic supervisor once per step."""
        with self._lock:
            out = list(self.worker_events)
            self.worker_events.clear()
        return out

    def _proc(self, idx: int):
        if 0 <= idx < len(self.shard_procs):
            return self.shard_procs[idx]
        self.counters["shard_faults_skipped_no_proc"] += 1
        return None

    def _kill(self, idx: int) -> None:
        p = self._proc(idx)
        if p is None:
            return
        p.kill()
        p.wait()
        self.counters["shards_killed"] += 1

    def _suspend(self, idx: int, duration_s: float) -> None:
        p = self._proc(idx)
        if p is None:
            return
        p.send_signal(signal.SIGSTOP)
        self.counters["shards_suspended"] += 1
        t = threading.Timer(duration_s,
                            lambda: p.send_signal(signal.SIGCONT))
        t.daemon = True
        t.start()

    # ---- process-level faults (cross-process pools / fleets) ----
    def _pick_proc(self, procs, idx: int):
        """Index modulo the LIVE slot list (a kill drawn for slot k must
        hit a real process even after drains emptied some slots)."""
        live = [p for p in procs if p is not None and p.poll() is None]
        if not live:
            self.counters["proc_faults_skipped_no_proc"] += 1
            return None
        return live[int(idx) % len(live)]

    def _proc_kill(self, procs, idx: int, counter: str) -> None:
        p = self._pick_proc(procs, idx)
        if p is None:
            return
        p.kill()
        p.wait()
        self.counters[counter] += 1

    def _proc_suspend(self, procs, idx: int, duration_s: float,
                      counter: str) -> None:
        p = self._pick_proc(procs, idx)
        if p is None:
            return
        p.send_signal(signal.SIGSTOP)
        self.counters[counter] += 1
        t = threading.Timer(duration_s,
                            lambda: p.send_signal(signal.SIGCONT))
        t.daemon = True
        t.start()

    # ---- batch plumbing ----
    def corrupt_batch(self, step: int, batch):
        """Poison the first float leaf with NaN when a ``nan_grad`` fault
        is armed.  Returns the (possibly copied) batch: the poisoned leaf
        is a copy, the caller's tensors and arrays are untouched.  Leaves
        are visited in the reference's pytree order (dict keys sorted,
        lists and tuples in order, ``None`` holds no leaf)."""
        if not self._nan_armed:
            return batch
        self._nan_armed = False
        out, done = _poison_first_float(batch)
        if done:
            self.counters["nan_injected"] += 1
        else:
            self.counters["nan_skipped_no_float_leaf"] += 1
        return out

    def wrap_batch_fn(self, batch_fn):
        """Wrap a ``batch_fn(step)`` so armed data faults raise
        :class:`TransientDataError` once each (the retry then succeeds)."""
        def wrapped(step):
            with self._lock:
                armed = self._armed_data > 0
                if armed:
                    self._armed_data -= 1
            if armed:
                self.counters["data_errors_injected"] += 1
                raise TransientDataError(
                    f"injected dataloader fault at step {step}")
            return batch_fn(step)
        return wrapped


def _poison_first_float(tree):
    """``(tree', True)`` with the first floating leaf replaced by a copy
    whose first element is NaN, or ``(tree, False)`` when no leaf is
    floating.  A torch tensor stays a tensor on its device; any other
    leaf is read through ``np.asarray``, as the reference reads its
    leaves."""
    if tree is None:
        return tree, False
    if isinstance(tree, dict):
        for k in sorted(tree):
            new, done = _poison_first_float(tree[k])
            if done:
                out = type(tree)(tree)
                out[k] = new
                return out, True
        return tree, False
    if isinstance(tree, (list, tuple)):
        for i, leaf in enumerate(tree):
            new, done = _poison_first_float(leaf)
            if done:
                items = list(tree)
                items[i] = new
                if isinstance(tree, list):
                    return items, True
                if hasattr(tree, "_fields"):  # a namedtuple
                    return type(tree)(*items), True
                return type(tree)(items), True
        return tree, False
    import torch
    if isinstance(tree, torch.Tensor):
        if not tree.is_floating_point():
            return tree, False
        a = tree.clone(memory_format=torch.contiguous_format)
        a.view(-1)[0] = float("nan")
        return a, True
    a = np.asarray(tree)
    if not np.issubdtype(a.dtype, np.floating):
        return tree, False
    a = a.copy()
    a.flat[0] = np.nan
    return a, True


class SequentialFaultCampaign:
    """A seeded SEQUENCE of faults with recovery-aware pacing — the
    second-fault chaos loop.

    A :class:`FaultSchedule` answers "which faults, at which steps";
    a campaign answers the question one fault at a time: every fault
    after the first is injected into the system state the PREVIOUS
    fault's recovery left behind (van_kill → wait for the promotion to
    re-silver → kill the promoted primary; controller_kill while a van
    failover is in flight; member_kill mid-resilver).  The campaign
    owns the DRAW (seeded, replayable — ``to_json`` is the evidence);
    the chaos loop owns injection, the recovery wait, and the invariant
    asserts, reporting each round back via :meth:`complete`.  Drawing
    the next round before completing the current one is a chaos-loop bug
    (the pacing contract IS the campaign), as is completing a round
    never drawn.

    The standing per-round invariants a soak loop asserts: zero lost
    accepted requests, token-exact serving, byte-identical training, and
    REDUNDANCY RESTORED (pair not degraded) before the next draw.
    """

    KINDS = ("van_kill", "van_resilver_kill",
             "controller_kill_mid_failover", "member_kill_mid_resilver")

    def __init__(self, *, seed: int, rounds: int, kinds=None,
                 n_victims: int = 1):
        self.seed = int(seed)
        self.kinds = tuple(kinds if kinds is not None else self.KINDS)
        bad = sorted(set(self.kinds) - set(KINDS))
        if bad:
            raise ValueError(f"unknown campaign kinds {bad}")
        rng = np.random.default_rng(self.seed)
        # one (kind, victim) pair per round, drawn up front: the draw
        # order is the replay contract, so pacing (which happens at
        # drive time) can never perturb WHAT is injected
        self.draws = [(self.kinds[int(rng.integers(len(self.kinds)))],
                       int(rng.integers(max(int(n_victims), 1))))
                      for _ in range(int(rounds))]
        self._next = 0
        self._open = False
        self.results: list = []

    @property
    def campaign_id(self) -> str:
        return f"{zlib.crc32(self.to_json().encode()):08x}"

    def to_json(self) -> str:
        return json.dumps([[k, v] for k, v in self.draws],
                          separators=(",", ":"))

    def draw(self) -> tuple:
        """The next round's ``(kind, victim)``.  Emits the fault
        instant (``fault.<kind>``) so the timeline pairing sees the
        campaign exactly like a scheduled fault."""
        if self._open:
            raise ValueError(
                "previous round not completed — recovery-aware pacing "
                "means one fault in flight at a time")
        if self._next >= len(self.draws):
            raise IndexError("campaign exhausted")
        kind, victim = self.draws[self._next]
        self._open = True
        trace.instant("fault." + kind,
                      {"kind": kind, "step": self._next, "arg": victim,
                       "campaign": self.campaign_id})
        return kind, victim

    def complete(self, *, ok: bool, recovery_s: float = 0.0,
                 detail: dict | None = None) -> None:
        """Close the in-flight round: the chaos loop verified recovery (or
        gave up).  ``recovery_s`` is fault→redundancy-restored wall
        time as the chaos loop measured it."""
        if not self._open:
            raise ValueError("no round in flight")
        kind, victim = self.draws[self._next]
        self.results.append({"round": self._next, "kind": kind,
                             "victim": victim, "ok": bool(ok),
                             "recovery_s": float(recovery_s),
                             **(detail or {})})
        self._open = False
        self._next += 1

    @property
    def exhausted(self) -> bool:
        return self._next >= len(self.draws)

    def report(self) -> dict:
        """Rounds survived / drawn, plus per-kind recovery seconds."""
        ok = [r for r in self.results if r["ok"]]
        per_kind: dict = defaultdict(list)
        for r in self.results:
            per_kind[r["kind"]].append(r["recovery_s"])
        return {"campaign_id": self.campaign_id,
                "rounds_drawn": len(self.results),
                "rounds_total": len(self.draws),
                "rounds_survived": len(ok),
                "recovery_s_by_kind": {k: sorted(v)
                                       for k, v in per_kind.items()}}
