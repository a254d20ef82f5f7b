"""Multi-controller elastic training: each dp worker is its own process
(counterpart of ``hetu_tpu/resilience/multicontroller.py``).

The in-process ``ElasticSupervisor``
(:mod:`hetu_tpu_torch.resilience.elastic`) reshapes ONE process's mesh;
this module is the cross-process promotion (arXiv 2412.14374's
multi-controller coordination over DCN, with arXiv 2004.13336's
width-as-resharding contract): N worker PROCESSES coordinate through the
van — weights and optimizer state live on a PS table (which is what
makes membership change cheap: resharding moves no parameter bytes, only
the DATA partition), membership crosses the
:mod:`hetu_tpu_torch.ps.membership` blackboard, and steps synchronize on
van barriers.

The determinism contract of the elastic batch schedule, literal across
processes: the global batch sequence is a pure function of ``(seed,
step)`` (:class:`~hetu_tpu_torch.data.dataloader.ElasticBatchSchedule`),
and a resize only re-slices each global batch over the survivors.  Every worker
appends a CONSUMED record (step, epoch, width, rank, slice CRC) to its
log right after its gradient push — the record is evidence the slice's
bytes entered training.  :func:`check_complete_cover` then asserts the
cross-run invariant: every step in order carries a COMPLETE cover (one
width, every rank, each slice CRC equal to the width-invariant
schedule's bytes) at the step's LATEST epoch — so the committed batch
sequence is byte-identical to a never-resized run.  A step a worker
died inside may additionally carry partial records from the aborted
epoch (torn state at SIGKILL is unknowable; the epoch that re-ran the
step is the committed one): gradient application across a crash step is
AT-LEAST-ONCE (benign — the PS-side SGD is linear, a re-pushed slice is
a second small step, not corruption), while batch-sequence consumption
is exactly-once.

Per step, per worker::

    sync barrier(epoch)  →  pull weights  →  grad on local_slice(step,
    rank, width)  →  push grad  →  commit barrier(epoch)  →  write the
    commit to the blackboard  →  log + step+1

Barrier ids encode ``(epoch, phase)``: a worker that timed out (peer
suspended/killed) re-reads the control row — if the controller moved the
membership, the in-flight step is DISCARDED (never logged) and re-runs
at the new width from ``resume_step``; otherwise it simply re-waits.
The generation-counted van barrier withdraws timed-out arrivals, so
lockstep cannot release short-handed.

Epoch transitions are TWO-PHASE, because ``resume_step`` must be exact:
the fleet keeps committing steps while the controller deliberates, so a
resume computed from racing progress reports would re-run (or skip) a
global batch.  The controller first publishes the new epoch with
``phase=PREPARE``: every worker stops at its next step boundary and
acks with its frozen committed step; only when every present worker has
acked does the controller publish ``phase=0`` with ``resume_step =
max(frozen committed) + 1`` — commits are barrier-atomic, so the frozen
values agree and the resume is exact for survivors and rejoiners alike.

The CONTROLLER process (:class:`MultiControllerElasticSupervisor`) owns
no training math at all: it spawns workers, watches leases, and
publishes membership epochs — worker SIGKILL → lease expiry →
``elastic.reshard`` span (ends when every survivor acked the new epoch)
→ survivors reshard; a replacement process joins with a fresh
incarnation and is re-admitted and re-placed the same way.

Where it runs: the workers and the controller are numpy over the van and
import neither ``torch`` nor ``jax`` — the data plane is the van, not an
accelerator, so a fleet on a GPU box never has N processes contending for
the card.  Departures from the reference: a worker's READY line says
whether the process loaded ``jax`` or ``torch`` (its first two fields are
the reference's); ``controller_main`` also reads ``features``,
``out_dim``, ``n_samples``, ``lr`` and ``ordered_grads`` from its config
(the reference's defaults when absent); the spawn sets no
``JAX_PLATFORMS``; a worker writes its metrics registry into its trace
stream when it counts a re-pushed gradient and when it closes, and
:func:`worker_metrics` (``MultiControllerElasticSupervisor.
fleet_metrics``) folds those dumps.
"""

from __future__ import annotations

import json
import os
import signal as _signal
import time
import traceback
import zlib
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

from hetu_tpu_torch.ps import membership as _mb
from hetu_tpu_torch.resilience.memberproc import (
    ControlPlaneMember, EpochChanged as _EpochChanged,
    drive_controller_harness,
)
from hetu_tpu_torch.telemetry import trace

WEIGHTS_TABLE_ID = 0x57454947          # 'WEIG'
BARRIER_BASE = 0x42415252              # 'BARR'


@dataclass
class WorkerSpec:
    """Everything a worker process needs — JSON into the spawn config.
    The dataset is REGENERATED from ``data_seed`` in every process
    (deterministic), so no training bytes ever cross the spawn
    boundary; only the PS table does."""

    port: int
    slot: int
    n_slots: int
    steps: int
    global_batch: int
    features: int = 8
    out_dim: int = 4
    n_samples: int = 256
    data_seed: int = 0
    lr: float = 0.05
    hb_ms: int = 80
    membership_table: int = _mb.TRAIN_MEMBERSHIP_TABLE
    weights_table: int = WEIGHTS_TABLE_ID
    barrier_base: int = BARRIER_BASE
    barrier_wait_s: float = 0.5
    # per-step throttle: a CPU-box fleet steps this tiny model at
    # 50-100 steps/s, far faster than any lease window — chaos tests
    # (and the bench's detect/recover timing) pace the fleet so faults
    # land INSIDE a run, not after it finished
    step_sleep_s: float = 0.0
    # park when the CONTROLLER's blackboard beat is silent this long
    # (0 disables): a headless fleet freezes at its next step boundary
    # and resumes on the first beat from ANY controller incarnation —
    # the member half of fenced control-plane takeover
    ctrl_lease_s: float = 0.0
    # rank-ordered gradient application: workers STAGE their gradients
    # (idempotent sparse_set into per-rank rows of `staging_table`),
    # barrier, then rank 0 applies them to the weights IN RANK ORDER
    # over one connection — f32 addition is not associative, so
    # arrival-order pushes reproduce same-seed runs only to ~1e-3;
    # rank order makes clean same-seed dp runs BITWISE identical
    # (the byte-identity level the MPMD plane already has)
    ordered_grads: bool = False
    staging_table: int = 0
    log_path: str = ""
    # replicated durable tier: a ReplicaSpec dict — non-empty means the
    # worker's blackboard + weights/staging tables dual-write over the
    # primary+backup van pair and re-resolve on primary death
    van: dict = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "WorkerSpec":
        return cls(**json.loads(s))


def make_dataset(spec: WorkerSpec):
    """Seeded synthetic regression problem, identical in every process:
    ``Y = X @ W_true`` plus small noise."""
    rng = np.random.default_rng(spec.data_seed)
    X = rng.standard_normal((spec.n_samples, spec.features),
                            dtype=np.float32)
    w_true = rng.standard_normal((spec.features, spec.out_dim),
                                 dtype=np.float32)
    Y = X @ w_true + 0.01 * rng.standard_normal(
        (spec.n_samples, spec.out_dim), dtype=np.float32)
    return X, Y


def make_schedule(spec: WorkerSpec):
    from hetu_tpu_torch.data.dataloader import ElasticBatchSchedule
    X, Y = make_dataset(spec)
    return ElasticBatchSchedule((X, Y), spec.global_batch,
                                seed=spec.data_seed)


def slice_crc(arrays) -> int:
    crc = 0
    for a in arrays:
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
    return crc


# ---------------------------------------------------------------------------
# worker process
# ---------------------------------------------------------------------------

class WorkerProcess(ControlPlaneMember):
    """One dp worker: its own controller over its own slice (numpy math
    — the data plane here is the VAN, not the accelerator; the
    executor path stays with the in-process supervisors).  The member
    control plane (beats, slow-link honoring, epoch barriers) is the
    shared :class:`~hetu_tpu_torch.resilience.memberproc.ControlPlaneMember`;
    this class owns the step body and the consumed-batch log."""

    def __init__(self, spec: WorkerSpec):
        from hetu_tpu_torch.ps import van
        self.spec = spec
        self.schedule = make_schedule(spec)
        from hetu_tpu_torch.ps.replica import open_table
        self.member = _mb.MembershipClient(
            "127.0.0.1", spec.port, table_id=spec.membership_table,
            slot=spec.slot, n_slots=spec.n_slots,
            replica=spec.van or None)
        self.table = open_table(
            spec.van, "127.0.0.1", spec.port, spec.features,
            spec.out_dim, table_id=spec.weights_table, create=False)
        self._staging = None
        if spec.ordered_grads and spec.staging_table:
            self._staging = open_table(
                spec.van, "127.0.0.1", spec.port,
                spec.n_slots * spec.features, spec.out_dim,
                table_id=spec.staging_table, create=False)
        self._sbar = None  # (epoch, stage barrier) — ordered_grads only
        self._init_control_plane(van=van, netem_local=f"w{spec.slot}",
                                 my_slot=spec.slot)
        # straggler plane: per-phase wall timing, logged per step
        self.phase_ms: dict = {}
        self._log = open(spec.log_path or
                         f"worker_{spec.slot}.jsonl", "a")
        self.member.join(committed=-1.0)
        self._start_beat()

    def run(self) -> None:
        spec = self.spec
        step = 0
        while not self._stop.is_set():
            e, width, mask, resume, phase, slow_slot, slow_ms = \
                self.member.read_control()
            self._apply_slow(slow_slot, slow_ms)
            if self._park_if_headless():
                continue  # controller silent: frozen at this boundary
                # until a (possibly new-incarnation) controller beats
            if e == 0:
                if self._stop.wait(0.05):
                    break
                continue
            if phase != 0:
                # PREPARE: freeze at this step boundary and ack with the
                # frozen progress (the controller computes the exact
                # resume from these rows)
                if self.acked < e:
                    self.acked = e
                    try:
                        self._sync_row()
                    except Exception:
                        pass  # the beat thread resends the ack in hb_ms
                if self._stop.wait(0.02):
                    break
                continue
            if self._hold_for_republish(e, phase):
                # a van promotion voided the in-flight step: wait for
                # the controller's republish before re-running it
                if self._stop.wait(0.02):
                    break
                continue
            if e != self.epoch:
                # the resume is EXACT (computed from frozen acks), so
                # adopting it never re-runs or skips a committed step
                self.epoch = e
                self.acked = max(self.acked, e)
                step = resume
            slots = _mb.MembershipService.slots_of(mask)
            if spec.slot not in slots:
                # excluded (evicted straggler): keep probing the van
                # link and report the probe time as load — the
                # probation loop's evidence that the link healed.  The
                # probe is a timed pull + zero-push pair, i.e. a real
                # step's WIRE cost (a zero gradient is a no-op on the
                # weights), so an injected slow link keeps the probe
                # honestly slow until it actually heals.  Probed every
                # loop iteration (faster than the beat cadence) so each
                # beat the controller counts carries a FRESH sample —
                # a throttled probe would let one lucky measurement be
                # double-counted toward re-admission.
                try:
                    t0 = time.perf_counter()
                    w = self.table.dense_pull()
                    self.table.dense_push(np.zeros_like(w))
                    self._work_ms = (time.perf_counter() - t0) * 1e3
                except Exception:
                    pass  # an unreachable van is the beat's problem
                if self._stop.wait(0.05):
                    break
                continue
            rank = slots.index(spec.slot)
            if step >= spec.steps:
                break
            bar_sync, bar_commit = self._epoch_barriers(width)
            pushed = False  # did THIS attempt's gradient land on the
            # tier?  read by the failover handler below: a step voided
            # after its push re-pushes on re-run, and that duplicate is
            # counted
            try:
                t0 = time.perf_counter()
                self._await_barrier(bar_sync)
                t1 = time.perf_counter()
                Xb, Yb = self.schedule.local_slice(step, rank, width)
                w = self.table.dense_pull()
                t2 = time.perf_counter()
                err = Xb @ w - Yb
                # d/dw of mean_{GLOBAL batch} ||Xw - Y||^2: each
                # worker pushes its slice's share; the PS-side SGD is
                # linear, so N sequential pushes apply exactly the
                # summed global-mean gradient
                grad = (2.0 / spec.global_batch) * (Xb.T @ err)
                t3 = time.perf_counter()
                if self._staging is not None:
                    self._push_ordered(grad, rank, width)
                else:
                    self.table.dense_push(grad)
                pushed = True
                t4 = time.perf_counter()
                # the WORK phases only (pull/grad/push) feed the
                # heartbeat's load field: barrier waits are time spent
                # on PEERS, and charging them here would make every
                # healthy worker in a fleet with one straggler read as
                # a straggler itself
                self._work_ms = (t4 - t1) * 1e3
                # the consumption record lands BEFORE the commit
                # barrier: the push already happened, so if this
                # process is SIGKILLed parked in the barrier (whose
                # server-side arrival can still release the peers —
                # the ghost-arrival window), the evidence that its
                # slice entered training is on disk.  A record whose
                # step later re-runs at a new epoch is crash residue
                # check_complete_cover knowingly tolerates.
                self._log.write(json.dumps(
                    {"step": step, "epoch": self.epoch,
                     "width": width, "rank": rank,
                     "crc": slice_crc((Xb, Yb)),
                     "loss": float(np.mean(err * err)),
                     "ms": {"bar_sync": round((t1 - t0) * 1e3, 3),
                            "pull": round((t2 - t1) * 1e3, 3),
                            "grad": round((t3 - t2) * 1e3, 3),
                            "push": round((t4 - t3) * 1e3, 3)}}) + "\n")
                self._log.flush()
                self._await_barrier(bar_commit)
                self.phase_ms = {
                    "bar_sync": (t1 - t0) * 1e3, "pull": (t2 - t1) * 1e3,
                    "grad": (t3 - t2) * 1e3, "push": (t4 - t3) * 1e3,
                    "bar_commit": (time.perf_counter() - t4) * 1e3}
            except _EpochChanged:
                continue  # step discarded, re-run at the new width
            except Exception as e:
                # a table op mid-step hit the durable-tier failover
                # (VanFailover after the dance, or a raw wire error the
                # dance can absorb): void the step exactly like an
                # epoch change — the re-run re-pulls and re-pushes on
                # the promoted primary at re-keyed barrier ids.  The
                # re-push is the plane's documented at-least-once
                # (check_complete_cover tolerance); byte-identity under
                # van chaos lives with the idempotent MPMD plane.
                if pushed:
                    # the gradient landed, then the step voided: the
                    # re-run WILL push it again.  Count the duplicate
                    # where it happens — ``ps.dp_repush_duplicates``
                    # rides fleet_metrics() so an operator can bound
                    # how non-idempotent a chaotic run actually was.
                    self._count_repush()
                try:
                    self._wire_fault(e)
                except _EpochChanged:
                    pass
                continue
            # COMMITTED: every worker of this epoch passed the commit
            # barrier; the blackboard row is written BEFORE proceeding,
            # so a prepare freeze always reads current progress
            self.committed = step
            try:
                self._sync_row()
            except Exception:
                pass  # the beat thread re-writes it within hb_ms
            step += 1
            if spec.step_sleep_s > 0:
                self._stop.wait(spec.step_sleep_s)
        self.close()

    def _stage_barrier(self, width: int):
        """The ordered-apply barrier for the current epoch, cached like
        ``_epoch_barriers`` — in a DISJOINT id band (the epoch pair
        occupies ``base + 2*epoch + phase``, so a third phase would
        collide with the next epoch's sync barrier).  Re-keyed by the
        van generation and dialed at the current primary, exactly like
        the epoch pair — a promoted van has no arrival state to
        resume."""
        key = (self._van_gen(), self.epoch)
        if self._sbar is None or self._sbar[0] != key:
            if self._sbar is not None:
                try:
                    self._sbar[1].close()
                except Exception:
                    pass
            bid = (self.spec.barrier_base + self._van_gen() * (1 << 21)
                   + (1 << 20) + self.epoch)
            host, port = self._van_endpoint()
            self._sbar = (key, self._van.RemoteBarrier(host, port, bid,
                                                       width))
        return self._sbar[1]

    def _push_ordered(self, grad, rank: int, width: int) -> None:
        """Rank-ordered gradient application: stage this rank's gradient
        (idempotent ``sparse_set`` into its staging rows — a crash-step
        re-run overwrites, never double-stages), barrier until every
        rank of the epoch staged, then rank 0 pulls all staged slices
        and applies them to the weights IN RANK ORDER over its single
        connection (the van serves one connection's requests in order).
        The commit barrier that follows in the step body fences the
        applies before anyone's next pull.  Determinism: the PS-side
        SGD now always sums the same f32 values in the same order, so
        clean same-seed runs produce bitwise-identical weights.  Crash
        semantics are unchanged (at-least-once across a discarded
        epoch, tolerated exactly like a re-pushed slice)."""
        f = self.spec.features
        rows = np.arange(rank * f, (rank + 1) * f, dtype=np.int64)
        self._staging.sparse_set(rows, grad.astype(np.float32))
        self._await_barrier(self._stage_barrier(width))
        if rank == 0:
            idx = np.arange(width * f, dtype=np.int64)
            staged = self._staging.sparse_pull(idx)
            for r in range(width):
                self.table.dense_push(staged[r * f:(r + 1) * f])

    def _count_repush(self) -> None:
        """Count one re-pushed gradient in this process's registry and
        write the registry into the trace stream at once: a worker can
        be SIGKILLed before its close, and the stream on disk is where
        :meth:`MultiControllerElasticSupervisor.fleet_metrics` reads
        it."""
        from hetu_tpu_torch.telemetry import default_registry
        default_registry.counter("ps.dp_repush_duplicates").inc()
        _dump_metrics()

    def close(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        try:
            self._sync_row()
            self.member.leave()
        except Exception:
            pass
        _dump_metrics()
        self._log.close()
        self.table.close()
        if self._staging is not None:
            try:
                self._staging.close()
            except Exception:
                pass
        if self._sbar is not None:
            try:
                self._sbar[1].close()
            except Exception:
                pass
        self._close_control_plane()


def _dump_metrics() -> None:
    """This process's registry as a ``hetu_metrics`` black-box record on
    its trace stream (a no-op without one)."""
    from hetu_tpu_torch.telemetry import default_registry
    tracer = trace.get_tracer()
    if tracer is not None:
        tracer.metric_dump(default_registry.dump())


def worker_main(config_path: str) -> int:
    import sys
    spec = WorkerSpec.from_json(open(config_path).read())
    # crash-durable span stream in the run workdir (the spawn config's
    # directory IS the workdir): the elastic worker's flight recorder
    trace.open_process_stream(Path(config_path).resolve().parent,
                              f"worker_s{spec.slot}_p{os.getpid()}")
    worker = WorkerProcess(spec)
    # the READY line says whether the worker loaded jax or torch
    # (neither: numpy over the van)
    print("READY", spec.slot, f"jax={int('jax' in sys.modules)}",
          f"torch={int('torch' in sys.modules)}", flush=True)
    worker.run()
    return 0


def worker_metrics(workdir):
    """The registries of a run's workers folded into one (counters
    summed): the last ``hetu_metrics`` record of every worker trace stream
    in ``workdir``, killed workers' included — e.g.
    ``ps.dp_repush_duplicates``, which a worker counts where a voided step
    re-pushes its gradient."""
    from hetu_tpu_torch.telemetry import fleet
    dumps = []
    for path in sorted(Path(workdir).glob("worker_s*_p*.trace.jsonl")):
        got = fleet.stream_metric_dumps(path)
        if got:
            dumps.append(got[-1])
    return fleet.merge_registry_dumps(dumps)


# ---------------------------------------------------------------------------
# consumed-batch verification (the byte-identity evidence)
# ---------------------------------------------------------------------------

def merge_consumed_logs(paths) -> dict:
    """Merge worker logs → ``{step: [(epoch, width, rank, crc), ...]}``."""
    out: dict = {}
    for p in paths:
        p = Path(p)
        if not p.exists():
            continue
        for line in p.read_text().splitlines():
            if not line.strip():
                continue
            rec = json.loads(line)
            out.setdefault(int(rec["step"]), []).append(
                (int(rec["epoch"]), int(rec["width"]), int(rec["rank"]),
                 int(rec["crc"])))
    return out


def check_complete_cover(consumed: dict, schedule, steps: int) -> None:
    """Assert the merged logs prove the run consumed byte-identical
    global batches vs a never-resized run, for every step in
    ``[0, steps)``:

    * the step's LATEST epoch carries a COMPLETE cover — one width,
      every rank ``0..width-1`` exactly once, each slice's CRC equal to
      the width-invariant schedule's bytes (``local_slice`` partitions
      the SAME ``global_batch(step)`` at every width, so a complete
      cover at ANY width is the same global bytes);
    * records from EARLIER epochs of the same step are crash residue —
      a worker SIGKILLed between its gradient push and the commit
      barrier (gradient at-least-once, tolerated) — and must still be a
      valid partial slicing (CRCs match, no duplicate rank per width).

    Raises AssertionError naming the first violation."""
    for step in range(int(steps)):
        recs = consumed.get(step)
        assert recs, f"step {step} was never consumed by any worker"
        last_epoch = max(e for e, _, _, _ in recs)
        cover = [(w, r) for e, w, r, _ in recs if e == last_epoch]
        widths = {w for w, _ in cover}
        assert len(widths) == 1, \
            (f"step {step}: epoch {last_epoch} records carry several "
             f"widths {sorted(widths)}")
        width = widths.pop()
        ranks = sorted(r for _, r in cover)
        assert ranks == list(range(width)), \
            (f"step {step}: epoch {last_epoch} ranks {ranks} do not "
             f"cover width {width}")
        seen = set()
        for e, w, r, crc in recs:
            assert (e, w, r) not in seen, \
                f"step {step}: duplicate record for epoch {e} rank {r}/{w}"
            seen.add((e, w, r))
            want = slice_crc(schedule.local_slice(step, r, w))
            assert crc == want, \
                (f"step {step} rank {r}/{w}: consumed slice CRC "
                 f"{crc:#x} != schedule's {want:#x}")


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------

@dataclass
class ReshardRecord:
    """One published membership epoch, for reports/benches."""

    epoch: int
    kind: str          # "shrink" | "grow"
    slot: int
    width: int
    resume_step: int
    downtime_s: float
    alive: tuple = field(default_factory=tuple)


class MultiControllerElasticSupervisor:
    """Membership authority over N worker PROCESSES.

    Owns the van, the weights table (where the model actually lives —
    the property that makes a worker process stateless-but-for-data),
    the blackboard, and the lease state machine.  It publishes decided
    membership epochs; workers do everything else.  ``procs`` holds the
    live ``Popen`` handles the ``worker_proc_kill`` chaos fault targets.
    """

    def __init__(self, n_workers: int, *, workdir, steps: int,
                 global_batch: int, features: int = 8, out_dim: int = 4,
                 n_samples: int = 256, data_seed: int = 0,
                 lr: float = 0.05, hb_ms: int = 80,
                 lease_s: float = 0.6, suspect_grace_s: float = 0.4,
                 deaf_ack_s: Optional[float] = None,
                 min_width: int = 1, port: int = 0,
                 own_van: bool = True,
                 step_sleep_s: float = 0.0,
                 ctrl_lease_s: float = 0.0,
                 injector=None, spawn_timeout_s: float = 120.0,
                 straggler_factor: float = 4.0,
                 straggler_policy: str = "wait",
                 straggler_evict_after: int = 3,
                 straggler_slow_ms: int = 120,
                 straggler_readmit_after: int = 3,
                 ordered_grads: bool = False,
                 van_spec: Optional[dict] = None,
                 _takeover_spec: Optional[WorkerSpec] = None):
        from hetu_tpu_torch.ps import van
        if n_workers < 1:
            raise ValueError("need at least one worker")
        for w in range(max(min_width, 1), n_workers + 1):
            if global_batch % w:
                raise ValueError(
                    f"global batch {global_batch} must divide by every "
                    f"reachable width (fails at {w})")
        self._van = van
        self._own_van = bool(own_van)
        if not van_spec and _takeover_spec is not None:
            # the durable-tier pair is recorded in the spawn configs on
            # disk, like every other control-plane id
            van_spec = getattr(_takeover_spec, "van", None) or None
        # replicated durable tier: weights/staging/blackboard tables
        # dual-write over a primary+backup van pair; a primary SIGKILL
        # is a retried transient at every op site (VanFailover), so the
        # PS-resident model survives the van process itself
        self._replica = None
        self._van_spec = dict(van_spec) if van_spec else {}
        if self._van_spec:
            if own_van:
                raise ValueError(
                    "a replicated durable tier is external by "
                    "definition: pass own_van=False with van_spec")
            from hetu_tpu_torch.ps.replica import VanReplica
            self._replica = VanReplica.from_spec(
                self._van_spec, bootstrap=_takeover_spec is None)
            if _takeover_spec is not None:
                self._replica.refresh()  # unconditional: a stale
                # cached view must not adopt the dead primary
            port = self._replica.primary[1]
            # a van promotion republishes a fresh epoch from poll():
            # members that detected the failover themselves converge on
            # the re-keyed barriers anyway; the republish gives any
            # still-parked member a control-row edge to re-read, and
            # records the event as a reshard
            self._van_failover_pending = False
            self._replica.register(
                lambda _rep: setattr(self, "_van_failover_pending",
                                     True))
        if own_van:
            self.port = van.serve(port)
        else:
            # attach to an EXTERNAL van process (the durable tier the
            # ROADMAP's controller-failover story needs: a controller
            # crash must not take the blackboard and the model with it)
            if not port:
                raise ValueError("own_van=False needs the running "
                                 "van's port")
            self.port = int(port)
        self.workdir = Path(workdir)
        self.steps = int(steps)
        self.n_workers = int(n_workers)
        self.min_width = int(min_width)
        self.injector = injector
        self._spawn_timeout_s = float(spawn_timeout_s)
        self._incarnations = 0
        self.epoch = 0
        self.resume_step = 0
        self.resizes: list = []
        self.log_paths: list = []
        # straggler plane (the slow-vs-dead split the lease machine
        # cannot make: a straggler's beats FLOW, its work time grows).
        # Detection: reported work_ms > straggler_factor x the median
        # of its peers'.  Policy "wait" = record + tolerate (the
        # barriers already pace the fleet at the straggler's speed);
        # "evict" = after `straggler_evict_after` slow COMMITTED steps,
        # reshard around it (a shrink epoch excluding the slot — batch
        # byte-identity preserved by the same complete-cover machinery
        # as any other shrink).
        if straggler_policy not in ("wait", "evict"):
            raise ValueError(f"unknown straggler_policy "
                             f"{straggler_policy!r}: wait|evict")
        self.straggler_factor = float(straggler_factor)
        self.straggler_policy = straggler_policy
        self.straggler_evict_after = int(straggler_evict_after)
        self.straggler_slow_ms = int(straggler_slow_ms)
        # auto re-admission probation: an evicted-but-alive slot keeps
        # probing its van link (the worker times a weights pull while
        # excluded and reports it as load), and after this many
        # consecutive healthy probed beats the controller lifts the
        # eviction (readmit_straggler).  0 disables — eviction then
        # stays operator-lifted only.
        self.straggler_readmit_after = int(straggler_readmit_after)
        self._evicted: set = set()
        self._probation: dict = {}         # slot -> {"beat", "ok"}
        self.procs: list = [None] * n_workers
        self._member_pids: dict = {}    # takeover-adopted pids (no Popen)
        self._fired_through = 0
        from hetu_tpu_torch.resilience.straggler import (
            SupervisorStragglerPlane,
        )
        if _takeover_spec is not None:
            # ---- takeover: adopt a running fleet whose controller
            # died.  Everything the old controller held in RAM is
            # re-derived from what survives on the van: the control row
            # (epoch / mask / resume / a half-open PREPARE), the lease
            # rows (who is alive, frozen committed progress), and the
            # spawn configs on disk (every table id).  The fleet is
            # parked (ctrl_lease_s) or frozen (phase=1); the republish
            # below un-parks it with an EXACT resume.
            self.spec = WorkerSpec(**{**asdict(_takeover_spec),
                                      "slot": -1, "log_path": ""})
            # the whole attach sequence is guarded: a blackboard/claim
            # failure after the weights table connected must close it,
            # not leak the van connection for the process's life
            try:
                from hetu_tpu_torch.ps.replica import open_table
                self.table = open_table(
                    self._replica, "127.0.0.1", self.port,
                    int(features), int(out_dim),
                    table_id=self.spec.weights_table, create=False)
                self._bb = _mb.attach_blackboard(
                    "127.0.0.1", self.port,
                    table_id=self.spec.membership_table,
                    n_slots=n_workers, replica=self._replica)
                self.svc = _mb.MembershipService(
                    self._bb, n_workers, lease_s=lease_s,
                    suspect_grace_s=suspect_grace_s,
                    deaf_ack_s=deaf_ack_s)
                self._stragglers = SupervisorStragglerPlane(
                    self.svc, factor=self.straggler_factor,
                    subject="worker", policy=straggler_policy,
                    evict_after=self.straggler_evict_after,
                    slow_ms=self.straggler_slow_ms)
                self.log_paths = sorted(
                    str(p) for p in self.workdir.glob("worker_*_*.jsonl")
                    # the workers' telemetry span streams live in the
                    # same workdir and match the stem — they are NOT
                    # consumed-batch logs
                    if not p.name.endswith(".trace.jsonl"))
                self._incarnations = len(
                    list(self.workdir.glob("worker_*_*.json")))
                self._adopt()
            except Exception:
                self.close()
                raise
            return
        # ---- normal bring-up ----
        # fresh table/barrier ids per supervisor: the native table and
        # barrier registries outlive van.stop(), so fixed ids would leak
        # state between two fleets built in one process (tests, benches)
        weights_table = _mb.fresh_table_id()
        membership_table = _mb.fresh_table_id()
        staging_table = _mb.fresh_table_id() if ordered_grads else 0
        barrier_base = BARRIER_BASE + (_mb.fresh_table_id() << 8)
        self.spec = WorkerSpec(
            port=self.port, slot=-1, n_slots=n_workers, steps=self.steps,
            global_batch=int(global_batch), features=int(features),
            out_dim=int(out_dim), n_samples=int(n_samples),
            data_seed=int(data_seed), lr=float(lr), hb_ms=int(hb_ms),
            membership_table=membership_table,
            weights_table=weights_table, barrier_base=barrier_base,
            step_sleep_s=float(step_sleep_s),
            ctrl_lease_s=float(ctrl_lease_s),
            ordered_grads=bool(ordered_grads),
            staging_table=staging_table, van=self._van_spec)
        # everything after van.serve is guarded: a table/blackboard/
        # spawn failure must stop the in-process van server (and close
        # what was created) instead of leaking it for the process's life
        try:
            from hetu_tpu_torch.ps.replica import open_table
            self.table = open_table(
                self._replica, "127.0.0.1", self.port, int(features),
                int(out_dim), table_id=weights_table, create=True,
                init="zeros", optimizer="sgd", lr=float(lr))
            if ordered_grads:
                # gradient staging area: one block of `features` rows
                # per rank, lr=0 SGD so sparse_set writes verbatim (the
                # blackboard convention) — workers stage here and rank 0
                # applies to the weights table in rank order
                self._staging = open_table(
                    self._replica, "127.0.0.1", self.port,
                    n_workers * int(features), int(out_dim),
                    table_id=staging_table, create=True,
                    init="zeros", optimizer="sgd", lr=0.0)
            self._bb = _mb.create_blackboard(
                "127.0.0.1", self.port,
                table_id=membership_table, n_slots=n_workers,
                replica=self._replica)
            self.svc = _mb.MembershipService(
                self._bb, n_workers, lease_s=lease_s,
                suspect_grace_s=suspect_grace_s, deaf_ack_s=deaf_ack_s)
            self._stragglers = SupervisorStragglerPlane(
                self.svc, factor=self.straggler_factor, subject="worker",
                policy=straggler_policy,
                evict_after=self.straggler_evict_after,
                slow_ms=self.straggler_slow_ms)
            for slot in range(n_workers):
                self._spawn(slot)
            self._wait_joined(range(n_workers))
        except Exception:
            self.close()
            raise
        # epoch numbering starts at 1: a zeroed control row must not
        # read as a published membership
        self._publish(kind=None)

    @classmethod
    def takeover(cls, *, workdir, port, lease_s: float = 0.6,
                 suspect_grace_s: float = 0.4,
                 deaf_ack_s: Optional[float] = None, min_width: int = 1,
                 spawn_timeout_s: float = 120.0, injector=None,
                 **straggler_kw) -> "MultiControllerElasticSupervisor":
        """Become the fleet's NEW controller after the old one died:
        re-derive the supervisor from the worker spawn configs under
        ``workdir`` and the still-running van at ``port``, claim the
        controller row with a higher incarnation, and republish the
        frozen membership with an exact resume (a two-phase re-freeze)
        under a ``ctrl.takeover`` span.  The killed-mid-PREPARE case is
        covered by construction: the fresh epoch supersedes the
        half-open one and collects fresh frozen acks."""
        cfgs = sorted(Path(workdir).glob("worker_*_*.json"),
                      key=lambda p: p.stat().st_mtime)
        if not cfgs:
            raise FileNotFoundError(
                f"no worker spawn configs under {workdir}")
        spec = WorkerSpec.from_json(cfgs[-1].read_text())
        return cls(spec.n_slots, workdir=workdir, steps=spec.steps,
                   global_batch=spec.global_batch,
                   features=spec.features, out_dim=spec.out_dim,
                   n_samples=spec.n_samples, data_seed=spec.data_seed,
                   lr=spec.lr, hb_ms=spec.hb_ms, lease_s=lease_s,
                   suspect_grace_s=suspect_grace_s,
                   deaf_ack_s=deaf_ack_s, min_width=min_width,
                   port=port, own_van=False,
                   step_sleep_s=spec.step_sleep_s,
                   ctrl_lease_s=spec.ctrl_lease_s, injector=injector,
                   spawn_timeout_s=spawn_timeout_s,
                   _takeover_spec=spec, **straggler_kw)

    def _adopt(self) -> None:
        """Adopt the fleet: republish the frozen epoch under the new
        incarnation.  Every piece of the old controller's RAM is
        re-derived — epoch and resume from the control row, the evicted
        set from (alive lease rows) minus (published mask), the
        committed high-water from the frozen progress rows."""
        ctrl = self.svc.read_control_row()
        self.epoch = int(ctrl["epoch"])
        self.resume_step = int(ctrl["resume_step"])
        # carry the predecessor's straggler injection forward: the
        # takeover republish must not silently heal an injected slow
        # link (the same rule every epoch transition honors)
        self.svc.adopt_slow(ctrl["slow_slot"], ctrl["slow_ms"])
        # learn who is beating before judging anything
        self.svc.wait_present(self._spawn_timeout_s)
        # worker pids off the lease rows: these processes are the DEAD
        # controller's children — the pid is the only handle
        # close()/spawn_replacement have on them
        self._member_pids.update(self.svc.member_pids())
        if self.epoch > 0:
            mask_slots = set(_mb.MembershipService.slots_of(
                int(ctrl["alive_mask"])))
            self._evicted = {s for s in self.svc.present_slots()
                             if s not in mask_slots}
        with trace.span("ctrl.takeover", cat="ctrl") as sp:
            sp.set("plane", "elastic")
            sp.set("incarnation", self.svc.ctrl_incarnation)
            sp.set("epoch_adopted", self.epoch)
            sp.set("phase_at_death", int(ctrl["phase"]))
            if self._present():
                # the two-phase re-freeze: exact resume from fresh
                # frozen acks — this is also what finishes an epoch the
                # old controller died inside (phase=1 half-open)
                t0 = time.perf_counter()
                self._publish(kind="takeover", t0=t0)
            sp.set("epoch", self.epoch)
            sp.set("resume_step", self.resume_step)
        self.takeover_report = {
            "incarnation": self.svc.ctrl_incarnation,
            "epoch": self.epoch, "resume_step": self.resume_step,
            "evicted": sorted(self._evicted),
            "present": sorted(self.svc.present_slots()),
        }

    # ---- spawning ----
    def _spawn(self, slot: int) -> None:
        from hetu_tpu_torch.resilience.shardproc import spawn_module
        self._incarnations += 1
        tag = f"worker_{slot}_{self._incarnations}"
        if self._replica is not None:
            # spawn configs carry the CURRENT pair membership: after a
            # failover + re-silver the original endpoints may both be
            # dead, and a fresh process has no other rendezvous
            self.spec = WorkerSpec(**{**asdict(self.spec),
                                      "van": self._replica.current_spec()})
        spec = WorkerSpec(**{**asdict(self.spec), "slot": int(slot),
                             "log_path": str(self.workdir /
                                             f"{tag}.jsonl")})
        cfg = self.workdir / f"{tag}.json"
        cfg.write_text(spec.to_json())
        self.log_paths.append(spec.log_path)
        # workers are numpy+van only: they never import torch, so a
        # fleet on a GPU box never has N processes contending for the card
        self.procs[slot] = spawn_module(
            self.workdir, tag, "hetu_tpu_torch.resilience.multicontroller",
            [str(cfg)], timeout_s=self._spawn_timeout_s)

    def _wait_joined(self, slots, timeout_s: Optional[float] = None):
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self._spawn_timeout_s)
        want = set(int(s) for s in slots)
        while time.monotonic() < deadline:
            self.svc.poll()
            if want <= set(self.svc.present_slots()):
                return
            time.sleep(0.05)
        raise TimeoutError(f"workers {sorted(want)} did not join in time")

    # ---- membership → epochs ----
    def _publish(self, *, kind: Optional[str], slot: int = -1,
                 t0: Optional[float] = None) -> None:
        """Move the fleet to a new membership epoch.

        Two-phase when the fleet is live (``kind`` set): publish
        ``phase=PREPARE`` (workers freeze at their next step boundary
        and ack with frozen progress), wait for every present worker's
        ack — re-preparing with a fresh epoch if the membership moves
        again mid-wait — then publish ``phase=0`` with the EXACT
        ``resume_step`` computed from the frozen values.  Initial
        bring-up (``kind=None``) skips the prepare: nobody is stepping
        yet."""
        while True:
            present = self._present()
            width = len(present)
            if width < max(self.min_width, 1):
                raise RuntimeError(
                    f"only {width} workers present (min_width="
                    f"{self.min_width}); cannot reform the fleet")
            mask = _mb.MembershipService.mask_of(present)
            self.epoch += 1
            if kind is None:
                self.resume_step = 0
                self.svc.publish_control(epoch=self.epoch, width=width,
                                         alive_mask=mask, resume_step=0)
                return
            self.svc.publish_control(epoch=self.epoch, width=width,
                                     alive_mask=mask, phase=1)
            deadline = time.monotonic() + 30.0
            moved = False
            while time.monotonic() < deadline:
                if any(k in ("lost", "join", "rejoin", "left")
                       for k, _ in self.svc.poll()):
                    moved = True  # membership moved again: re-prepare
                    break
                if all(self.svc.state_of(s).epoch_ack >= self.epoch
                       for s in self.svc.present_slots()):
                    break
                time.sleep(0.02)
            else:
                raise TimeoutError(
                    f"epoch {self.epoch} prepare not acked by "
                    f"{self.svc.present_slots()} within 30s")
            if moved:
                continue
            present = self._present()
            # the resume considers EVERY slot that ever reported progress
            # (present, left, lost — commits are barrier-atomic, so no
            # departed row can be ahead of a live one): a worker
            # rejoining a finished-and-departed fleet must resume AFTER
            # the work, not re-train the dataset alone from step 0
            frozen = [m.committed for m in self.svc.members
                      if m.state != "empty"]
            self.resume_step = max(max(frozen) + 1, 0)
            self.svc.publish_control(
                epoch=self.epoch, width=len(present),
                alive_mask=_mb.MembershipService.mask_of(present),
                resume_step=self.resume_step)
            dt = time.perf_counter() - (t0 if t0 is not None
                                        else time.perf_counter())
            self.resizes.append(ReshardRecord(
                epoch=self.epoch, kind=kind, slot=int(slot),
                width=len(present), resume_step=self.resume_step,
                downtime_s=dt, alive=tuple(present)))
            return

    def _present(self) -> list:
        """Membership minus straggler evictions: a slot resharded
        around for slowness is alive and beating — excluded from the
        published mask, not from the lease machine."""
        return [s for s in self.svc.present_slots()
                if s not in self._evicted]

    def poll(self) -> list:
        """One membership sweep: drives the injector by observed
        committed step, applies lease decisions as published epochs,
        and runs the straggler detector over the reported work times.
        Returns the membership events seen."""
        if self.injector is not None:
            cur = max((self.svc.state_of(s).committed
                       for s in range(self.n_workers)), default=-1)
            for t in range(self._fired_through + 1, cur + 1):
                self.injector.on_step(t)
            self._fired_through = max(self._fired_through, cur)
            # claim only the straggler events: serving-plane netem
            # kinds stay queued for whoever drives the pool
            for _, idx, dur in self.injector.pop_net_events(
                    kinds=("straggler",)):
                self.inject_straggler(int(idx) % self.n_workers, dur)
        # the heal runs HERE, serialized with every other control-row
        # write (see SupervisorStragglerPlane)
        self._stragglers.maybe_heal()
        if self._replica is not None and self._van_failover_pending:
            self._van_failover_pending = False
            t0 = time.perf_counter()
            with trace.span("elastic.reshard") as sp:
                sp.set("kind", "van_failover")
                sp.set("van_incarnation", self._replica.incarnation)
                if self._present():
                    # a finished-and-departed fleet needs no republish
                    # (and could not reform below min_width anyway)
                    self._publish(kind="van_failover", t0=t0)
                sp.set("width", len(self.svc.present_slots()))
        events = self.svc.poll()
        for kind, slot in events:
            if kind == "lost":
                t0 = time.perf_counter()
                with trace.span("elastic.reshard") as sp:
                    sp.set("kind", "shrink")
                    sp.set("worker", int(slot))
                    self._publish(kind="shrink", slot=slot, t0=t0)
                    sp.set("width", len(self.svc.present_slots()))
            elif kind in ("rejoin", "join"):
                t0 = time.perf_counter()
                with trace.span("elastic.reshard") as sp:
                    sp.set("kind", "grow")
                    sp.set("worker", int(slot))
                    self._publish(kind="grow", slot=slot, t0=t0)
                    sp.set("width", len(self.svc.present_slots()))
        self._check_stragglers()
        self._check_probation()
        return events

    # ---- straggler detection / policy ----
    def inject_straggler(self, slot: int, duration_s: float,
                         slow_ms: Optional[int] = None) -> None:
        """Apply the ``straggler`` chaos fault via the shared
        :class:`~hetu_tpu_torch.resilience.straggler.
        SupervisorStragglerPlane` (injection + serialized-heal glue —
        one copy for both cross-process training planes)."""
        self._stragglers.inject(slot, duration_s, slow_ms)

    @property
    def straggle_records(self) -> list:
        """Closed ``train.straggler`` episodes (the shared detector's
        span args verbatim)."""
        return self._stragglers.records

    def _check_stragglers(self) -> None:
        """Per-phase timing turned into a slow-vs-dead decision: a
        worker whose reported WORK time (load field — barrier waits
        excluded) exceeds ``straggler_factor`` x the median of its
        peers' is a straggler — alive (its beats flow, the lease
        machine never fires) but pacing the whole lockstep fleet.
        Episode spans live in the shared detector plane; the POLICY is
        applied here: under ``straggler_policy="evict"`` the fleet
        reshards around the worker once it has been slow for
        ``straggler_evict_after`` committed steps."""
        slots = [s for s in self._present()
                 if self.svc.state_of(s).state == "alive"]
        for slot in self._stragglers.observe(slots):
            if self.straggler_policy == "evict" and \
                    slot not in self._evicted:
                self._evict_straggler(slot)

    def _evict_straggler(self, slot: int) -> None:
        """The evict policy: reshard the fleet AROUND the straggler.
        The slot stays in the lease machine (alive, beating — not
        lost) but leaves the published mask; survivors re-cover every
        global batch at the smaller width, byte-identical by the same
        complete-cover contract as any other shrink."""
        self._evicted.add(int(slot))
        self._stragglers.close(slot, resolution="evicted")
        t0 = time.perf_counter()
        with trace.span("elastic.reshard") as sp:
            sp.set("kind", "shrink")
            sp.set("worker", int(slot))
            sp.set("reason", "straggler_evict")
            self._publish(kind="shrink", slot=slot, t0=t0)
            sp.set("width", len(self._present()))

    def _check_probation(self) -> None:
        """Auto re-admission of evicted stragglers: an evicted slot
        stays alive and beating, and while excluded its worker probes
        the van link (a timed pull+push pair — a step's wire cost) and
        reports the probe time as load.  Each NEW beat carrying a probe
        under the RE-ADMISSION bar counts toward
        ``straggler_readmit_after`` consecutive healthy beats; a slow
        probe resets the count.  The re-admission bar is HALF the
        eviction bar (hysteresis): the probe measures only the wire
        share of a step while peers report wire+compute, so a
        borderline link that barely clears the eviction bar must not
        readmit only to be re-evicted — an indefinite evict/readmit
        flap, two reshard epochs per cycle.  Reaching the count lifts
        the eviction (the grow epoch re-covers every batch at the wider
        width — same byte-identity contract as any other grow)."""
        if self.straggler_readmit_after <= 0:
            return
        active = [self.svc.state_of(s).load for s in self._present()
                  if self.svc.state_of(s).state == "alive" and
                  self.svc.state_of(s).load > 0.0]
        for slot in list(self._evicted):
            m = self.svc.state_of(slot)
            st = self._probation.setdefault(slot, {"beat": m.beat,
                                                   "ok": 0})
            if m.state != "alive":
                st["ok"] = 0
                continue
            if m.beat == st["beat"]:
                continue  # no fresh evidence since the last look
            st["beat"] = m.beat
            med = float(np.median(active)) if active else 0.0
            healthy = m.load > 0.0 and (
                med <= 0.0 or m.load <= 0.5 * self.straggler_factor *
                max(med, 1e-3))
            st["ok"] = st["ok"] + 1 if healthy else 0
            if st["ok"] >= self.straggler_readmit_after:
                self._probation.pop(slot, None)
                self.readmit_straggler(slot)

    def readmit_straggler(self, slot: int) -> None:
        """Operator/test path: lift a straggler eviction (e.g. after
        the slow link healed); the next publish regrows the mesh."""
        if int(slot) in self._evicted:
            self._evicted.discard(int(slot))
            self._probation.pop(int(slot), None)
            t0 = time.perf_counter()
            with trace.span("elastic.reshard") as sp:
                sp.set("kind", "grow")
                sp.set("worker", int(slot))
                self._publish(kind="grow", slot=slot, t0=t0)
                sp.set("width", len(self._present()))

    def spawn_replacement(self, slot: int) -> None:
        """Re-admit a lost worker slot with a FRESH process: it joins
        with a new incarnation, the next poll publishes a grow epoch,
        and the worker re-places itself (weights come from the PS —
        rejoin ships zero parameter bytes from the controller)."""
        p = self.procs[slot]
        if p is not None and p.poll() is None:
            p.kill()
            p.wait()
        elif slot in self._member_pids:
            # a takeover-adopted worker (the dead controller's child):
            # the pid is the only handle
            try:
                os.kill(self._member_pids[slot], _signal.SIGKILL)
            except OSError:
                pass
        self._member_pids.pop(slot, None)
        self._spawn(slot)

    # ---- driving ----
    def run(self, *, deadline_s: float = 300.0,
            poll_s: float = 0.05) -> dict:
        """Poll until every present worker committed the final step (or
        left after doing so).  Returns a report dict."""
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            self.poll()
            states = [self.svc.state_of(s) for s in range(self.n_workers)]
            # an evicted straggler is alive-but-excluded: it will never
            # advance past its eviction point, so completion is judged
            # on the workers actually IN the published mask
            present = [m for m in states
                       if m.state in ("alive", "suspect") and
                       m.slot not in self._evicted]
            finished = [m for m in states
                        if m.state == "left" and
                        m.committed >= self.steps - 1]
            if present and all(m.committed >= self.steps - 1
                               for m in present):
                break
            if not present and finished:
                break
            time.sleep(poll_s)
        else:
            raise TimeoutError(
                f"fleet did not finish {self.steps} steps within "
                f"{deadline_s}s: "
                f"{[(m.slot, m.state, m.committed) for m in states]}")
        # a still-open straggle window at run end must land in the
        # trace (an unclosed span would silently drop the episode)
        self._stragglers.close_all(resolution="run_end")
        consumed = merge_consumed_logs(self.log_paths)
        return {
            "steps": self.steps,
            "epochs": self.epoch,
            "resizes": [asdict(r) for r in self.resizes],
            "consumed": consumed,
            "final_weights": self.table.dense_pull(),
        }

    def fleet_metrics(self):
        """The workers' registries folded into one
        (:func:`worker_metrics` of the workdir)."""
        return worker_metrics(self.workdir)

    def verify_consumed(self, consumed: Optional[dict] = None) -> None:
        """The chaos acceptance check: complete-cover-per-step,
        width-invariant, byte-identical global-batch consumption."""
        if consumed is None:
            consumed = merge_consumed_logs(self.log_paths)
        check_complete_cover(consumed, make_schedule(self.spec),
                             self.steps)

    def close(self) -> None:
        # a FENCED controller no longer owns the fleet: its close()
        # must not kill worker processes the new incarnation adopted
        # (the same rule as the serving pool's fenced close)
        svc = getattr(self, "svc", None)
        fenced = bool(getattr(svc, "fenced", False))
        for p in self.procs if not fenced else ():
            if p is None:
                continue
            try:
                if p.poll() is None:
                    p.kill()
                p.wait()
            except Exception:
                traceback.print_exc()
        # takeover-adopted workers have no Popen handle — the pid off
        # the lease row is the only one.  Only still-present slots are
        # signalled (a finished fleet left cleanly; killing a recycled
        # pid would hit an innocent process), and they were reparented
        # when their spawner died, so there is no zombie-reap concern
        for slot, pid in (() if fenced else
                          list(getattr(self, "_member_pids",
                                       {}).items())):
            if svc is not None and \
                    svc.state_of(slot).state not in ("alive", "suspect"):
                continue
            try:
                os.kill(pid, _signal.SIGKILL)
            except OSError:
                pass
        for t in (getattr(self, "table", None), getattr(self, "_bb", None),
                  getattr(self, "_staging", None)):
            if t is not None:
                try:
                    t.close()
                except Exception:
                    pass
        if getattr(self, "_own_van", True):
            self._van.stop()


# ---------------------------------------------------------------------------
# controller process harness (the chaos kill target)
# ---------------------------------------------------------------------------

def controller_main(config_path: str) -> int:
    """Entry point for a spawned CONTROLLER process: build the
    supervisor against an EXTERNAL van, drive the fleet, and print the
    progress markers the chaos harness keys on (``STEP k`` per
    committed high-water advance, ``PREPARED`` for the killed-mid-
    PREPARE edge mode, ``ALLDONE``, ``FENCED``).  ``prepare_hang_at``
    publishes a PREPARE freeze at the named committed step and then
    hangs — the takeover must finish the half-open epoch with an exact
    resume.  Beyond the reference's keys, the config may set the
    problem's ``features``, ``out_dim``, ``n_samples``, ``lr`` and
    ``ordered_grads`` (the supervisor's defaults when absent)."""
    cfg = json.loads(open(config_path).read())
    trace.open_process_stream(cfg["workdir"],
                              f"controller_p{os.getpid()}")
    sup = MultiControllerElasticSupervisor(
        int(cfg["n_workers"]), workdir=cfg["workdir"],
        steps=int(cfg["steps"]), global_batch=int(cfg["global_batch"]),
        data_seed=int(cfg.get("data_seed", 0)),
        lease_s=float(cfg.get("lease_s", 0.6)),
        suspect_grace_s=float(cfg.get("suspect_grace_s", 0.4)),
        step_sleep_s=float(cfg.get("step_sleep_s", 0.0)),
        ctrl_lease_s=float(cfg.get("ctrl_lease_s", 0.0)),
        hb_ms=int(cfg.get("hb_ms", 80)),
        port=int(cfg["port"]), own_van=False,
        features=int(cfg.get("features", 8)),
        out_dim=int(cfg.get("out_dim", 4)),
        n_samples=int(cfg.get("n_samples", 256)),
        lr=float(cfg.get("lr", 0.05)),
        ordered_grads=bool(cfg.get("ordered_grads", False)))
    hang_at = cfg.get("prepare_hang_at")

    def progress():
        return max((sup.svc.state_of(s).committed
                    for s in range(sup.n_workers)), default=-1)

    def hang_mid_prepare(hw):
        if hang_at is None or hw < int(hang_at):
            return
        # die mid-transition: PREPARE published, acks never collected —
        # the takeover edge case
        sup.epoch += 1
        present = sup._present()
        sup.svc.publish_control(
            epoch=sup.epoch, width=len(present),
            alive_mask=_mb.MembershipService.mask_of(present), phase=1)
        print("PREPARED", flush=True)
        while True:
            time.sleep(3600)

    def done():
        states = [sup.svc.state_of(s) for s in range(sup.n_workers)]
        present = [m for m in states
                   if m.state in ("alive", "suspect") and
                   m.slot not in sup._evicted]
        finished = [m for m in states
                    if m.state == "left" and
                    m.committed >= sup.steps - 1]
        return bool((present and all(m.committed >= sup.steps - 1
                                     for m in present)) or
                    (not present and finished))

    rc = drive_controller_harness(
        sup.poll, progress, done,
        deadline_s=float(cfg.get("deadline_s", 300.0)),
        on_progress=hang_mid_prepare)
    return 0 if rc is None else rc


if __name__ == "__main__":
    import sys
    if sys.argv[1] == "--controller":
        sys.exit(controller_main(sys.argv[2]))
    sys.exit(worker_main(sys.argv[1]))
