"""Fault-tolerant cross-process MPMD pipeline training (counterpart of
``hetu_tpu/parallel/mpmd_elastic.py``).

:mod:`hetu_tpu_torch.parallel.mpmd` runs heterogeneous per-stage programs
in separate processes, but a dead stage kills the whole run.  This module
lifts the pipeline onto the membership/barrier plane the rest of the
cross-process stack uses (arXiv 2412.14374's MPMD pipeline parallelism
over the multi-controller coordination of
:mod:`hetu_tpu_torch.resilience.multicontroller`):

* each pipeline STAGE is its own OS process (spawned through
  :func:`~hetu_tpu_torch.resilience.shardproc.spawn_module`) with a row on
  the :mod:`hetu_tpu_torch.ps.membership` join/heartbeat/lease blackboard;
* stage weights AND momentum slots live on a per-stage PS table, so
  replacing a stage moves zero parameter bytes from the controller — the
  replacement pulls them;
* activations and cotangents hop stages over
  :class:`~hetu_tpu_torch.parallel.mpmd.VanMailbox` blob channels with
  the ``bf16``/``int8`` wire codecs and per-edge byte counters;
* the microbatch order of a step is a real GPipe or 1F1B schedule
  (:func:`~hetu_tpu_torch.parallel.mpmd.schedule_ops`), driven by the
  same generation-counted van barriers as the multi-controller trainer.

The robustness contract: SIGKILL of a mid-pipeline stage → lease expiry
→ the controller freezes the survivors with a two-phase epoch (PREPARE
published BEFORE the spawn, so the replacement can never observe a
runnable stale epoch), spawns a replacement, collects frozen-progress
acks, and publishes an exact ``resume_step``; the replacement pulls its
stage state from the PS and the run finishes with parameters
byte-identical to an un-killed same-seed run.

Why byte-identity holds across a kill: the step-``s`` weight update is
written as ONE atomic ``sparse_set`` frame carrying ``[w(s+1), m(s+1),
w(s), m(s), ver=s+1]`` — a version-gated double buffer.  A stage that
re-runs step ``s`` (because it, or a peer, died mid-step) pulls the
table, sees either ``ver == s`` (use the current buffer) or ``ver ==
s+1`` (its previous incarnation already applied the update; use the
PREVIOUS buffer, i.e. exactly ``w(s)``), recomputes the identical f32
math, and re-issues the byte-identical write.  In-flight microbatch
traffic is recomputed on fresh epoch-scoped channels — activations are
AT-LEAST-ONCE, optimizer updates EXACTLY-ONCE.  Both schedules emit
backwards in ascending microbatch order, so GPipe and 1F1B produce
bitwise-equal gradients.

A SLOW stage (an injected ``stage_slow`` netem link, or a congested
host) is not a membership change: its beats flow, its reported work time
grows, and the controller's straggler detector opens a
``train.straggler`` span — the lockstep barriers already pace the fleet
at the slowest stage.  A SIGSTOPped stage is suspected-then-cleared by
the lease machine with zero replacements.

Where it runs: the stages and the controller are numpy over the van and
import neither ``torch`` nor ``jax`` (an ``int8`` edge loads ``torch``
for the port's codec).  The math is the reference's, operation for
operation, so a same-seed run ends with the reference supervisor's
parameters bit for bit.  Departures from the reference: a stage's READY
line says whether the process loaded ``jax`` or ``torch`` (its first two
fields are the reference's), and so does the controller harness's;
the spawn sets no ``JAX_PLATFORMS``;
:meth:`MPMDPipelineSupervisor.wait_stages_left` lets a promoted standby
close the supervisor without killing the stages it adopted.
"""

from __future__ import annotations

import json
import os
import signal as _signal
import sys
import time
import traceback
from collections import defaultdict
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

from hetu_tpu_torch.parallel.mpmd import VanMailbox, schedule_ops
from hetu_tpu_torch.ps import membership as _mb
from hetu_tpu_torch.resilience.memberproc import (
    ControlPlaneMember, EpochChanged as _EpochChanged,
    drive_controller_harness,
)
from hetu_tpu_torch.telemetry import trace

PIPE_BARRIER_BASE = 0x50424152         # 'PBAR'


@dataclass
class StageSpec:
    """Everything a stage process needs — JSON into the spawn config.
    The per-step batch and the stage's initial weights are REGENERATED
    from ``data_seed`` in every process (deterministic), so no training
    bytes cross the spawn boundary; only the PS tables do."""

    port: int
    stage: int
    n_stages: int
    steps: int
    n_microbatches: int
    width: int                  # feature dim D (stage weights are DxD)
    batch: int                  # global batch B; microbatch = B // M
    data_seed: int = 0
    lr: float = 0.05
    momentum: float = 0.9
    schedule: str = "1f1b"      # "gpipe" | "1f1b"
    stash_limit: int = 0        # gpipe activation-stash bound (0 = M)
    wire: str = "f32"           # activation/cotangent wire dtype
    hb_ms: int = 60
    membership_table: int = 0
    table_base: int = 0         # stage s weights table = table_base + s
    mail_base: int = 0
    barrier_base: int = PIPE_BARRIER_BASE
    barrier_wait_s: float = 0.5
    # per-op synthetic compute (the bench's bubble measurements need
    # compute to dominate the tiny matmuls) and per-step pacing so chaos
    # lands inside a run
    compute_sleep_s: float = 0.0
    step_sleep_s: float = 0.0
    # park when the CONTROLLER's blackboard beat is silent this long
    # (0 disables): a headless pipeline freezes at its next step
    # boundary and resumes on the first beat from ANY controller
    # incarnation — the member half of fenced control-plane takeover
    ctrl_lease_s: float = 0.0
    log_path: str = ""
    # replicated durable tier: a ReplicaSpec dict — non-empty means the
    # stage's blackboard + weights tables dual-write over the
    # primary+backup van pair and re-resolve on primary death
    van: dict = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "StageSpec":
        return cls(**json.loads(s))


def step_batch(spec: StageSpec, step: int):
    """The step's global (X, Y): a pure function of (data_seed, step),
    identical in every process — stage 0 slices X per microbatch, the
    last stage slices the targets Y."""
    rng = np.random.default_rng((int(spec.data_seed), int(step)))
    X = rng.standard_normal((spec.batch, spec.width), dtype=np.float32)
    Y = (0.1 * rng.standard_normal((spec.batch, spec.width),
                                   dtype=np.float32)).astype(np.float32)
    return X, Y


def stage_init_weights(spec: StageSpec, stage: int) -> np.ndarray:
    """Stage ``stage``'s initial DxD weight — seeded, regenerable."""
    rng = np.random.default_rng((int(spec.data_seed), 1000 + int(stage)))
    return (0.4 * rng.standard_normal((spec.width, spec.width),
                                      dtype=np.float32)).astype(np.float32)


def stage_table_rows(width: int) -> int:
    """Stage-table layout: ``[w_cur (D) | m_cur (D) | w_prev (D) |
    m_prev (D) | version row]`` — 4*D+1 rows of D f32s.  The version row
    (element 0) holds ``last_applied_step + 1``; writing all rows in ONE
    ``sparse_set`` frame makes the update atomic on the van server."""
    return 4 * int(width) + 1


# ---------------------------------------------------------------------------
# stage worker process
# ---------------------------------------------------------------------------

class PipelineStageProcess(ControlPlaneMember):
    """One pipeline stage: pure-numpy ``y = tanh(x @ w)`` with a manual
    vjp (numpy — bitwise determinism across processes is the
    byte-identity contract, and the data plane here is the van).  The
    member control plane (beats, slow-link honoring, epoch barriers) is
    the shared :class:`~hetu_tpu_torch.resilience.memberproc.
    ControlPlaneMember`; this class owns the microbatch schedule, the
    mailboxes, and the PS-resident stage state."""

    def __init__(self, spec: StageSpec):
        from hetu_tpu_torch.ps import van
        self.spec = spec
        s = spec.stage
        D = spec.width
        if spec.batch % spec.n_microbatches:
            raise ValueError(f"batch {spec.batch} must divide into "
                             f"{spec.n_microbatches} microbatches")
        self.mb_size = spec.batch // spec.n_microbatches
        self._cap = self.mb_size * D
        from hetu_tpu_torch.ps.replica import open_table
        self.member = _mb.MembershipClient(
            "127.0.0.1", spec.port, table_id=spec.membership_table,
            slot=s, n_slots=spec.n_stages, replica=spec.van or None)
        self.table = open_table(
            spec.van, "127.0.0.1", spec.port, stage_table_rows(D), D,
            table_id=spec.table_base + s, create=False)
        self._init_control_plane(van=van, netem_local=f"stage{s}",
                                 my_slot=s)
        self._mail: dict = {}
        self._seq: dict = {}
        self._mail_epoch = -1
        # run-cumulative edge bytes: epoch changes discard mailboxes,
        # so their counters are folded in here before the close
        self._wire_totals = {"logical": 0, "wire": 0}
        self._log = open(spec.log_path or f"stage_{s}.jsonl", "a")
        self.member.join(committed=-1.0)
        self._start_beat()

    # ---- epoch-scoped mailboxes ----
    def _chan(self, edge: int, backward: bool) -> VanMailbox:
        gen_key = (self._van_gen(), self.epoch)
        if self._mail_epoch != gen_key:
            for mbx in self._mail.values():
                self._wire_totals["logical"] += mbx.bytes_logical
                self._wire_totals["wire"] += mbx.bytes_wire
                try:
                    mbx.close()
                except Exception:
                    pass
            self._mail.clear()
            self._seq.clear()
            self._mail_epoch = gen_key
        key = (edge, backward)
        if key not in self._mail:
            # channel ids are EPOCH-scoped: a membership change abandons
            # every in-flight message (at-least-once activations) and
            # both endpoints restart seq-aligned on fresh channels.  A
            # van promotion does the same — the promoted van has no
            # channel state, so both endpoints of every edge discard
            # their mailboxes (the (van_gen, epoch) key above) and
            # restart seq-aligned against the new primary.
            cid = (self.spec.mail_base + (self.epoch << 8) + edge * 2 +
                   (1 if backward else 0))
            host, port = self._van_endpoint()
            self._mail[key] = VanMailbox(
                host, port, cid, self._cap,
                wire=self.spec.wire,
                metric_path=f"mpmd.edge{edge}."
                            f"{'bwd' if backward else 'fwd'}")
            self._seq[key] = 0
        return self._mail[key]

    def _mail_put(self, edge: int, backward: bool, arr) -> None:
        ch = self._chan(edge, backward)
        self._seq[(edge, backward)] += 1
        seq = self._seq[(edge, backward)]
        faults = 0
        while True:
            try:
                ch.put(arr, seq, timeout_s=self.spec.barrier_wait_s)
                return
            except TimeoutError:
                self._check_epoch()  # blob put is same-seq idempotent
            except (ConnectionError, RuntimeError) as e:
                faults += 1
                self._wire_fault(e, faults=faults)

    def _mail_get(self, edge: int, backward: bool, shape) -> np.ndarray:
        ch = self._chan(edge, backward)
        self._seq[(edge, backward)] += 1
        seq = self._seq[(edge, backward)]
        faults = 0
        while True:
            try:
                return ch.get(shape, seq,
                              timeout_s=self.spec.barrier_wait_s)
            except TimeoutError:
                self._check_epoch()
            except (ConnectionError, RuntimeError) as e:
                faults += 1
                self._wire_fault(e, faults=faults)

    # ---- PS-resident stage state (version-gated double buffer) ----
    def _pull_state(self, step: int):
        # hot path pulls the CURRENT buffer + version row only; the
        # prev buffer is fetched in the rare replay branch (this stage
        # is its table's sole writer, so the second pull is consistent)
        D = self.spec.width
        rows = self.table.sparse_pull(
            np.concatenate([np.arange(2 * D), [4 * D]]))
        ver = int(rows[2 * D, 0])
        if ver == step:
            return rows[0:D].copy(), rows[D:2 * D].copy()
        if ver == step + 1:
            # this step's update already applied (a previous incarnation
            # died between its write and the commit barrier): replay the
            # step from the PREVIOUS buffer — the recompute is bitwise
            # identical and the re-write idempotent
            prev = self.table.sparse_pull(np.arange(2 * D, 4 * D))
            return prev[0:D].copy(), prev[D:2 * D].copy()
        raise RuntimeError(
            f"stage {self.spec.stage}: table version {ver} incompatible "
            f"with step {step} (expected {step} or {step + 1})")

    def _write_state(self, step: int, w, mom, new_w, new_m) -> None:
        D = self.spec.width
        ver_row = np.zeros((1, D), np.float32)
        ver_row[0, 0] = float(step + 1)
        payload = np.concatenate(
            [new_w, new_m, w, mom, ver_row], axis=0).astype(np.float32)
        # ONE sparse_set frame: the van applies it atomically, so a kill
        # can never leave weights and version out of sync
        self.table.sparse_set(np.arange(stage_table_rows(D)), payload)

    # ---- one pipeline step ----
    def _run_step(self, step: int) -> dict:
        spec = self.spec
        s, S, M, D = spec.stage, spec.n_stages, spec.n_microbatches, \
            spec.width
        mbsz = self.mb_size
        first, last = s == 0, s == S - 1
        t0 = time.perf_counter()
        w, mom = self._pull_state(step)
        pull_s = time.perf_counter() - t0
        X = Y = None
        if first or last:
            X, Y = step_batch(spec, step)
        stash: dict = {}
        gy_stash: dict = {}
        loss_sum = 0.0
        gsum = np.zeros((D, D), np.float32)
        busy_s = 0.0
        peak = 0
        ops = schedule_ops(spec.schedule, stage=s, n_stages=S,
                           n_microbatches=M,
                           stash_limit=spec.stash_limit)
        for op, m in ops:
            if op == "F":
                if first:
                    x = X[m * mbsz:(m + 1) * mbsz]
                else:
                    x = self._mail_get(s - 1, False, (mbsz, D))
                tc = time.perf_counter()
                y = np.tanh(x @ w)
                if spec.compute_sleep_s > 0:
                    time.sleep(spec.compute_sleep_s)
                busy_s += time.perf_counter() - tc
                stash[m] = (x, y)
                peak = max(peak, len(stash))
                if last:
                    t = Y[m * mbsz:(m + 1) * mbsz]
                    loss_sum += float(np.mean((y - t) ** 2))
                    gy_stash[m] = ((2.0 / y.size) * (y - t)).astype(
                        np.float32)
                else:
                    self._mail_put(s, False, y)
            else:
                if last:
                    gy = gy_stash.pop(m)
                else:
                    gy = self._mail_get(s, True, (mbsz, D))
                x, y = stash.pop(m)
                tc = time.perf_counter()
                gz = (gy * (1.0 - y * y)).astype(np.float32)
                gw = x.T @ gz
                if not first:
                    gx = gz @ w.T
                if spec.compute_sleep_s > 0:
                    time.sleep(spec.compute_sleep_s)
                busy_s += time.perf_counter() - tc
                if not first:
                    self._mail_put(s - 1, True, gx)
                # backwards run in ascending microbatch order under BOTH
                # schedules, so this accumulation is schedule-invariant
                gsum += gw
        grad = gsum / np.float32(M)
        new_m = np.float32(spec.momentum) * mom + grad
        new_w = w - np.float32(spec.lr) * new_m
        tw = time.perf_counter()
        self._write_state(step, w, mom, new_w, new_m)
        write_s = time.perf_counter() - tw
        return {"loss": loss_sum / M if last else None,
                "busy_s": busy_s, "pull_s": pull_s, "write_s": write_s,
                "peak_stash": peak}

    # ---- main loop ----
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
                # PREPARE: freeze at this step boundary, ack with the
                # frozen committed step (the controller computes the
                # exact resume from these rows)
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
                # the controller's re-freeze before re-running it
                if self._stop.wait(0.02):
                    break
                continue
            if e != self.epoch:
                self.epoch = e
                self.acked = max(self.acked, e)
                step = resume
            if spec.stage not in _mb.MembershipService.slots_of(mask):
                if self._stop.wait(0.05):
                    break
                continue
            if step >= spec.steps:
                break
            bar_sync, bar_commit = self._epoch_barriers(spec.n_stages)
            try:
                t0 = time.perf_counter()
                self._await_barrier(bar_sync)
                t1 = time.perf_counter()
                rep = self._run_step(step)
                t2 = time.perf_counter()
                self._await_barrier(bar_commit)
                t3 = time.perf_counter()
            except _EpochChanged:
                continue  # step void; re-runs after the new epoch
            except Exception as e:
                # a table op mid-step hit the durable-tier failover
                # (VanFailover after the dance, or a raw wire error the
                # dance can absorb): void the step exactly like an
                # epoch change.  The re-run replays from the version-
                # gated double buffer — a half-applied step recomputes
                # bitwise identical and re-writes idempotently, so van
                # chaos preserves this plane's byte-identity contract.
                try:
                    self._wire_fault(e)
                except _EpochChanged:
                    pass
                continue
            self._work_ms = (rep["pull_s"] + rep["busy_s"] +
                             rep["write_s"]) * 1e3
            self.committed = step
            try:
                self._sync_row()
            except Exception:
                pass  # the beat thread re-writes it within hb_ms
            wire = {"logical": self._wire_totals["logical"] +
                    sum(m.bytes_logical for m in self._mail.values()),
                    "wire": self._wire_totals["wire"] +
                    sum(m.bytes_wire for m in self._mail.values())}
            self._log.write(json.dumps(
                {"step": step, "epoch": self.epoch, "stage": spec.stage,
                 "loss": rep["loss"], "peak_stash": rep["peak_stash"],
                 "busy_ms": round(rep["busy_s"] * 1e3, 3),
                 "wall_ms": round((t2 - t1) * 1e3, 3),
                 "wire_bytes": wire,
                 "ms": {"bar_sync": round((t1 - t0) * 1e3, 3),
                        "pull": round(rep["pull_s"] * 1e3, 3),
                        "write": round(rep["write_s"] * 1e3, 3),
                        "bar_commit": round((t3 - t2) * 1e3, 3)}}) + "\n")
            self._log.flush()
            step += 1
            if spec.step_sleep_s > 0:
                self._stop.wait(spec.step_sleep_s)
        self.close()

    def close(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        try:
            self._sync_row()
            self.member.leave()
        except Exception:
            pass
        for mbx in self._mail.values():
            try:
                mbx.close()
            except Exception:
                pass
        self._log.close()
        self.table.close()
        self._close_control_plane()


def stage_main(config_path: str) -> int:
    spec = StageSpec.from_json(open(config_path).read())
    # crash-durable span stream in the run workdir: the pipeline
    # stage's flight recorder (a SIGKILLed stage keeps its evidence)
    trace.open_process_stream(Path(config_path).resolve().parent,
                              f"stage_s{spec.stage}_p{os.getpid()}")
    worker = PipelineStageProcess(spec)
    # the READY line says whether the stage loaded jax or torch
    # (neither: numpy over the van)
    print("READY", spec.stage, f"jax={int('jax' in sys.modules)}",
          f"torch={int('torch' in sys.modules)}", flush=True)
    worker.run()
    return 0


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------

class MPMDPipelineSupervisor:
    """Membership authority over S pipeline-stage PROCESSES.

    Owns the van, the per-stage weight tables (where the model lives —
    what makes a stage process stateless-but-for-activations), the
    blackboard, and the lease machine.  A ``lost`` stage is answered by
    a ``pipeline.stage_replace`` span: PREPARE-freeze the survivors,
    spawn a replacement, wait for its join + everyone's frozen-progress
    acks, publish the exact resume.  ``procs`` holds the live ``Popen``
    handles the ``stage_kill`` chaos fault targets.
    """

    def __init__(self, n_stages: int, *, workdir, steps: int,
                 n_microbatches: int = 4, width: int = 8,
                 batch: int = 8, schedule: str = "1f1b",
                 stash_limit: int = 0, wire: str = "f32",
                 data_seed: int = 0, lr: float = 0.05,
                 momentum: float = 0.9, hb_ms: int = 60,
                 lease_s: float = 0.6, suspect_grace_s: float = 0.4,
                 deaf_ack_s: Optional[float] = None,
                 compute_sleep_s: float = 0.0, step_sleep_s: float = 0.0,
                 ctrl_lease_s: float = 0.0,
                 injector=None, spawn_timeout_s: float = 120.0,
                 straggler_factor: float = 4.0,
                 straggler_slow_ms: int = 120, port: int = 0,
                 own_van: bool = True,
                 van_spec: Optional[dict] = None,
                 _takeover_spec: Optional[StageSpec] = None):
        from hetu_tpu_torch.ps import van
        if n_stages < 2:
            raise ValueError("a pipeline needs at least two stages")
        if batch % n_microbatches:
            raise ValueError(f"batch {batch} must divide into "
                             f"{n_microbatches} microbatches")
        self._van = van
        self._own_van = bool(own_van)
        if not van_spec and _takeover_spec is not None:
            van_spec = getattr(_takeover_spec, "van", None) or None
        # replicated durable tier: stage weights + blackboard dual-write
        # over a primary+backup van pair (see ps/replica.py); the model
        # then survives the van process itself
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
            # a van promotion re-freezes from poll(): stages converge on
            # the re-keyed barriers/mailboxes themselves, but the fresh
            # epoch gives any still-parked stage a control-row edge and
            # records the event
            self._van_failover_pending = False
            self._replica.register(
                lambda _rep: setattr(self, "_van_failover_pending",
                                     True))
        if own_van:
            self.port = van.serve(port)
        else:
            # attach to an EXTERNAL van process: the durable tier
            # (stage tables, blackboard) must outlive the controller
            # for its death to be survivable
            if not port:
                raise ValueError("own_van=False needs the running "
                                 "van's port")
            self.port = int(port)
        self.workdir = Path(workdir)
        self.steps = int(steps)
        self.n_stages = int(n_stages)
        self.injector = injector
        self._spawn_timeout_s = float(spawn_timeout_s)
        self._incarnations = 0
        self.epoch = 0
        self.resume_step = 0
        self.replacements: list = []
        self.counters = defaultdict(int)
        self.log_paths: list = []
        self._fired_through = 0
        self._committed_hw = -1
        self.straggler_factor = float(straggler_factor)
        self.straggler_slow_ms = int(straggler_slow_ms)
        D = int(width)
        self.tables: list = []
        self.procs: list = [None] * self.n_stages
        self._member_pids: dict = {}    # takeover-adopted pids (no Popen)
        from hetu_tpu_torch.resilience.straggler import SupervisorStragglerPlane
        if _takeover_spec is not None:
            # ---- takeover: adopt a running pipeline whose controller
            # died.  Everything re-derives from the van: the control
            # row (epoch/resume/phase), lease rows (alive stages,
            # frozen committed), stage tables (the model), and spawn
            # configs on disk (every id).
            self.spec = StageSpec(**{**asdict(_takeover_spec),
                                     "stage": -1, "log_path": ""})
            # the whole attach sequence is guarded: a blackboard/claim
            # failure after some tables connected must close them, not
            # leak van connections for the process's life
            try:
                from hetu_tpu_torch.ps.replica import open_table
                for s in range(self.n_stages):
                    self.tables.append(open_table(
                        self._replica, "127.0.0.1", self.port,
                        stage_table_rows(D), D,
                        table_id=self.spec.table_base + s, create=False))
                self._bb = _mb.attach_blackboard(
                    "127.0.0.1", self.port,
                    table_id=self.spec.membership_table,
                    n_slots=self.n_stages, replica=self._replica)
                self.svc = _mb.MembershipService(
                    self._bb, self.n_stages, lease_s=lease_s,
                    suspect_grace_s=suspect_grace_s,
                    deaf_ack_s=deaf_ack_s)
                self._stragglers = SupervisorStragglerPlane(
                    self.svc, factor=self.straggler_factor,
                    subject="stage", policy="wait",
                    slow_ms=self.straggler_slow_ms)
                self.log_paths = sorted(
                    str(p) for p in self.workdir.glob("stage_*_*.jsonl")
                    # the stages' telemetry span streams live in the
                    # same workdir and match the stem — they are NOT
                    # recompute/commit logs
                    if not p.name.endswith(".trace.jsonl"))
                self._incarnations = len(
                    list(self.workdir.glob("stage_*_*.json")))
                self._adopt()
            except Exception:
                self.close()
                raise
            return
        # ---- normal bring-up ----
        membership_table = _mb.fresh_table_id()
        table_base = _mb.fresh_table_id()
        mail_base = _mb.fresh_table_id()
        barrier_base = PIPE_BARRIER_BASE + (_mb.fresh_table_id() << 8)
        self.spec = StageSpec(
            port=self.port, stage=-1, n_stages=self.n_stages,
            steps=self.steps, n_microbatches=int(n_microbatches),
            width=int(width), batch=int(batch), data_seed=int(data_seed),
            lr=float(lr), momentum=float(momentum),
            schedule=str(schedule), stash_limit=int(stash_limit),
            wire=str(wire), hb_ms=int(hb_ms),
            membership_table=membership_table, table_base=table_base,
            mail_base=mail_base, barrier_base=barrier_base,
            compute_sleep_s=float(compute_sleep_s),
            step_sleep_s=float(step_sleep_s),
            ctrl_lease_s=float(ctrl_lease_s), van=self._van_spec)
        # everything after van.serve is guarded: a table/blackboard/
        # spawn failure must stop the in-process van server (and close
        # what was created) instead of leaking it for the process's life
        try:
            from hetu_tpu_torch.ps.replica import open_table
            # per-stage weight tables, seeded — the model lives HERE
            for s in range(self.n_stages):
                t = open_table(
                    self._replica, "127.0.0.1", self.port,
                    stage_table_rows(D), D,
                    table_id=table_base + s, create=True, init="zeros",
                    optimizer="sgd", lr=0.0)
                self.tables.append(t)
                w0 = stage_init_weights(self.spec, s)
                zeros = np.zeros_like(w0)
                ver = np.zeros((1, D), np.float32)
                t.sparse_set(np.arange(stage_table_rows(D)),
                             np.concatenate([w0, zeros, w0, zeros,
                                             ver]))
            self._bb = _mb.create_blackboard(
                "127.0.0.1", self.port, table_id=membership_table,
                n_slots=self.n_stages, replica=self._replica)
            self.svc = _mb.MembershipService(
                self._bb, self.n_stages, lease_s=lease_s,
                suspect_grace_s=suspect_grace_s, deaf_ack_s=deaf_ack_s)
            self._stragglers = SupervisorStragglerPlane(
                self.svc, factor=self.straggler_factor, subject="stage",
                policy="wait", slow_ms=self.straggler_slow_ms)
            for s in range(self.n_stages):
                self._spawn(s)
            self._wait_joined(range(self.n_stages))
            # epoch numbering starts at 1: a zeroed control row must
            # not read as a published membership
            self.epoch = 1
            self.svc.publish_control(
                epoch=1, width=self.n_stages,
                alive_mask=_mb.MembershipService.mask_of(
                    range(self.n_stages)),
                resume_step=0)
        except Exception:
            self.close()
            raise

    @classmethod
    def takeover(cls, *, workdir, port, lease_s: float = 0.6,
                 suspect_grace_s: float = 0.4,
                 deaf_ack_s: Optional[float] = None,
                 spawn_timeout_s: float = 120.0,
                 injector=None, **kw) -> "MPMDPipelineSupervisor":
        """Become the pipeline's NEW controller after the old one died:
        re-derive everything from the stage spawn configs under
        ``workdir`` and the still-running van at ``port``, claim the
        controller row with a higher incarnation, and re-freeze the
        fleet (PREPARE → frozen acks → exact resume) under a
        ``ctrl.takeover`` span."""
        cfgs = sorted(Path(workdir).glob("stage_*_*.json"),
                      key=lambda p: p.stat().st_mtime)
        if not cfgs:
            raise FileNotFoundError(
                f"no stage spawn configs under {workdir}")
        spec = StageSpec.from_json(cfgs[-1].read_text())
        return cls(spec.n_stages, workdir=workdir, steps=spec.steps,
                   n_microbatches=spec.n_microbatches, width=spec.width,
                   batch=spec.batch, schedule=spec.schedule,
                   stash_limit=spec.stash_limit, wire=spec.wire,
                   data_seed=spec.data_seed, lr=spec.lr,
                   momentum=spec.momentum, hb_ms=spec.hb_ms,
                   lease_s=lease_s, suspect_grace_s=suspect_grace_s,
                   deaf_ack_s=deaf_ack_s,
                   compute_sleep_s=spec.compute_sleep_s,
                   step_sleep_s=spec.step_sleep_s,
                   ctrl_lease_s=spec.ctrl_lease_s, injector=injector,
                   spawn_timeout_s=spawn_timeout_s, port=port,
                   own_van=False, _takeover_spec=spec, **kw)

    def _adopt(self) -> None:
        """Adopt the pipeline: the control row carries the epoch (and a
        possibly half-open PREPARE the old controller died inside), the
        lease rows carry frozen progress — a fresh two-phase re-freeze
        supersedes whatever was in flight and resumes at the exact
        step."""
        ctrl = self.svc.read_control_row()
        self.epoch = int(ctrl["epoch"])
        self.resume_step = int(ctrl["resume_step"])
        # carry the predecessor's straggler injection forward: the
        # takeover republish must not silently heal an injected slow
        # link (the same rule every epoch transition honors)
        self.svc.adopt_slow(ctrl["slow_slot"], ctrl["slow_ms"])
        self.svc.wait_present(self._spawn_timeout_s)
        # stage pids off the lease rows: these processes are the DEAD
        # controller's children — the pid is the only handle
        # close()/_replace_stages have on them
        self._member_pids.update(self.svc.member_pids())
        self._committed_hw = max(
            self._committed_hw,
            max((self.svc.state_of(s).committed
                 for s in range(self.n_stages)), default=-1))
        with trace.span("ctrl.takeover", cat="ctrl") as sp:
            sp.set("plane", "mpmd")
            sp.set("incarnation", self.svc.ctrl_incarnation)
            sp.set("epoch_adopted", self.epoch)
            sp.set("phase_at_death", int(ctrl["phase"]))
            # refreeze whenever ANY stage is present — even a finished
            # fleet: a stage parked under a mid-takeover hold only
            # resumes (and exits) once the new incarnation republishes
            if self.svc.present_slots():
                self._refreeze()
            sp.set("epoch", self.epoch)
            sp.set("resume_step", self.resume_step)
        # a stage that died AROUND the controller kill: its one-shot
        # "lost" event was consumed by the nested polls above
        # (wait_present, the refreeze ack-wait) and will never re-fire
        # for the run loop — the same consumed-event case
        # _replace_stages re-checks by STATE; without this sweep the
        # pipeline runs a stage short until the deadline
        stranded = [s for s in range(self.n_stages)
                    if self.svc.state_of(s).state == "lost"]
        if stranded and self._committed_hw < self.steps - 1:
            self._replace_stages(stranded)
        self.takeover_report = {
            "incarnation": self.svc.ctrl_incarnation,
            "epoch": self.epoch, "resume_step": self.resume_step,
            "present": sorted(self.svc.present_slots()),
        }

    def _refreeze(self) -> None:
        """The takeover republish: a FRESH epoch's PREPARE supersedes
        any half-open transition the dead controller left behind,
        frozen acks are collected from every live stage, and the exact
        resume is published — the same two-phase contract as a stage
        replacement, minus the spawn."""
        full_mask = _mb.MembershipService.mask_of(range(self.n_stages))
        self.epoch += 1
        self.svc.publish_control(epoch=self.epoch, width=self.n_stages,
                                 alive_mask=full_mask, phase=1)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            self.svc.poll()
            if all(self.svc.state_of(s).epoch_ack >= self.epoch
                   for s in range(self.n_stages)
                   if self.svc.state_of(s).state not in
                   ("left", "lost", "empty")):
                break
            time.sleep(0.02)
        else:
            raise TimeoutError(
                f"takeover epoch {self.epoch} prepare not acked within "
                f"30s: "
                f"{[(m.slot, m.state, m.epoch_ack) for m in self.svc.members]}")
        frozen = [m.committed for m in self.svc.members
                  if m.state != "empty"]
        self.resume_step = max(max(frozen), self._committed_hw) + 1
        self.svc.publish_control(epoch=self.epoch, width=self.n_stages,
                                 alive_mask=full_mask,
                                 resume_step=self.resume_step)

    # ---- spawning ----
    def _spawn(self, stage: int) -> None:
        from hetu_tpu_torch.resilience.shardproc import spawn_module
        self._incarnations += 1
        tag = f"stage_{stage}_{self._incarnations}"
        if self._replica is not None:
            # spawn configs carry the CURRENT pair membership: after a
            # failover + re-silver the original endpoints may both be
            # dead, and a fresh process has no other rendezvous
            self.spec = StageSpec(**{**asdict(self.spec),
                                     "van": self._replica.current_spec()})
        spec = StageSpec(**{**asdict(self.spec), "stage": int(stage),
                            "log_path": str(self.workdir /
                                            f"{tag}.jsonl")})
        cfg = self.workdir / f"{tag}.json"
        cfg.write_text(spec.to_json())
        self.log_paths.append(spec.log_path)
        self.procs[stage] = spawn_module(
            self.workdir, tag, "hetu_tpu_torch.parallel.mpmd_elastic",
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
        raise TimeoutError(f"stages {sorted(want)} did not join in time")

    # ---- stage replacement (the tentpole recovery path) ----
    def _replace_stages(self, slots) -> None:
        t0 = time.perf_counter()
        with trace.span("pipeline.stage_replace") as sp:
            sp.set("stage", int(sorted(slots)[0]))
            sp.set("stages", sorted(int(s) for s in slots))
            pending = {int(s) for s in slots}
            full_mask = _mb.MembershipService.mask_of(
                range(self.n_stages))
            while True:
                # PREPARE first, spawn second: survivors freeze before
                # the replacement's first control read, so it can never
                # adopt a runnable stale epoch (and run from step 0
                # against a mid-run table)
                self.epoch += 1
                self.svc.publish_control(
                    epoch=self.epoch, width=self.n_stages,
                    alive_mask=full_mask, phase=1)
                for sl in sorted(pending):
                    p = self.procs[sl]
                    if p is not None and p.poll() is None:
                        p.kill()
                        p.wait()
                    elif sl in self._member_pids:
                        # a takeover-adopted stage (the dead
                        # controller's child): the pid is the only
                        # handle — without the kill a SIGSTOPped-then-
                        # resumed old stage and its replacement both
                        # heartbeat the same slot
                        try:
                            os.kill(self._member_pids[sl],
                                    _signal.SIGKILL)
                        except OSError:
                            pass
                    self._member_pids.pop(sl, None)
                    self._spawn(sl)
                self._wait_joined(pending)
                pending.clear()
                deadline = time.monotonic() + 30.0
                while time.monotonic() < deadline:
                    for k, sl in self.svc.poll():
                        if k == "lost":
                            pending.add(int(sl))  # a second death
                    # a loss whose event was consumed by a nested poll
                    # (e.g. inside _wait_joined) still shows as state
                    # "lost" — it would never ack, so re-prepare
                    pending |= {s for s in range(self.n_stages)
                                if self.svc.state_of(s).state == "lost"}
                    if pending:
                        break
                    # a stage that finished-and-LEFT will never ack a
                    # later epoch; only live membership gates the
                    # publish (its frozen committed still counts below)
                    if all(self.svc.state_of(s).epoch_ack >= self.epoch
                           for s in range(self.n_stages)
                           if self.svc.state_of(s).state != "left"):
                        break
                    time.sleep(0.02)
                else:
                    raise TimeoutError(
                        f"epoch {self.epoch} prepare not acked by all "
                        f"stages within 30s")
                if pending:
                    continue  # re-prepare around the newest death
                # every row is frozen: survivors carry the committed
                # step (barrier-atomic, so they agree), the replacement
                # -1 — the high-water mark guards the all-dead corner
                frozen = [m.committed for m in self.svc.members
                          if m.state != "empty"]
                self.resume_step = max(max(frozen), self._committed_hw) \
                    + 1
                self.svc.publish_control(
                    epoch=self.epoch, width=self.n_stages,
                    alive_mask=full_mask,
                    resume_step=self.resume_step)
                rec = {"stages": sorted(int(s) for s in slots),
                       "epoch": self.epoch,
                       "resume_step": self.resume_step,
                       "downtime_s": round(
                           time.perf_counter() - t0, 3)}
                self.replacements.append(rec)
                sp.set("epoch", self.epoch)
                sp.set("resume_step", self.resume_step)
                return

    # ---- straggler plane (the shared detector, wait policy: a pipeline
    # stage is not redundant, so eviction is not an option — the
    # lockstep barriers already pace the fleet) ----
    def inject_stage_slow(self, slot: int, duration_s: float,
                          slow_ms: Optional[int] = None) -> None:
        self._stragglers.inject(slot, duration_s, slow_ms)

    @property
    def straggle_records(self) -> list:
        return self._stragglers.records

    def _check_stragglers(self) -> None:
        slots = [s for s in self.svc.present_slots()
                 if self.svc.state_of(s).state == "alive"]
        # wait policy only (evict_after=0): the shared plane opens/
        # closes the train.straggler spans; a pipeline has no redundant
        # member to reshard around, so crossing never evicts
        self._stragglers.observe(slots)

    # ---- driving ----
    def poll(self) -> list:
        """One membership sweep: drives the injector by observed
        committed step, answers losses with stage replacement, applies
        stage_slow injections, and runs the straggler detector."""
        if self.injector is not None:
            cur = max((self.svc.state_of(s).committed
                       for s in range(self.n_stages)), default=-1)
            for t in range(self._fired_through + 1, cur + 1):
                self.injector.on_step(t)
            self._fired_through = max(self._fired_through, cur)
            for _, idx, dur in self.injector.pop_net_events(
                    kinds=("stage_slow",)):
                self.inject_stage_slow(int(idx) % self.n_stages, dur)
        # serialized with every other control-row write (the shared
        # SupervisorStragglerPlane's heal-in-poll rule)
        self._stragglers.maybe_heal()
        if self._replica is not None and self._van_failover_pending:
            self._van_failover_pending = False
            self.counters["van_failover"] += 1
            with trace.span("pipeline.van_failover") as sp:
                sp.set("van_incarnation", self._replica.incarnation)
                if self.svc.present_slots() and \
                        self._committed_hw < self.steps - 1:
                    self._refreeze()
                sp.set("epoch", self.epoch)
        events = self.svc.poll()
        self._committed_hw = max(
            self._committed_hw,
            max((self.svc.state_of(s).committed
                 for s in range(self.n_stages)), default=-1))
        for kind, slot in events:
            self.counters[kind] += 1
        lost = [int(slot) for kind, slot in events if kind == "lost"]
        if lost:
            if self._committed_hw >= self.steps - 1:
                # commits are barrier-atomic, so ANY stage at steps-1
                # means the WHOLE run committed its final step: a stage
                # dying between that commit and its leave() needs no
                # replacement (one would adopt resume==steps, do
                # nothing, and leave with committed=-1 — unfinishable)
                self.counters["lost_after_finish"] += len(lost)
            else:
                # one replace epoch covers every loss in the batch: a
                # per-slot replace would park the first epoch's ack
                # wait on a stage known dead
                self._replace_stages(lost)
        self._check_stragglers()
        return events

    def run(self, *, deadline_s: float = 300.0,
            poll_s: float = 0.05) -> dict:
        """Poll until every stage committed the final step (or left
        after doing so).  Returns a report dict with the final per-stage
        params (pulled from the PS tables — the byte-identity
        evidence)."""
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            self.poll()
            states = [self.svc.state_of(s)
                      for s in range(self.n_stages)]
            present = [m for m in states
                       if m.state in ("alive", "suspect")]
            if present and all(m.committed >= self.steps - 1
                               for m in present):
                break
            # nobody live: done iff the final step COMMITTED fleet-wide
            # (barrier-atomic, so the high-water mark is the fleet's) —
            # covers both an all-left finish and a stage lost between
            # its final commit and its leave()
            if not present and self._committed_hw >= self.steps - 1:
                break
            time.sleep(poll_s)
        else:
            raise TimeoutError(
                f"pipeline did not finish {self.steps} steps within "
                f"{deadline_s}s: "
                f"{[(m.slot, m.state, m.committed) for m in states]}")
        self._stragglers.close_all(resolution="run_end")
        return {
            "steps": self.steps,
            "epochs": self.epoch,
            "replacements": list(self.replacements),
            "counters": dict(self.counters),
            "straggle_records": list(self.straggle_records),
            "final_params": self.final_params(),
            "log_paths": list(self.log_paths),
        }

    def wait_stages_left(self, timeout_s: float = 30.0) -> None:
        """Poll until no stage is present (every one finished and left, or
        was lost); raise ``TimeoutError`` after ``timeout_s``.  A caller
        that must not kill the stages it adopted waits here before
        :meth:`close`.  (A port addition.)"""
        deadline = time.monotonic() + float(timeout_s)
        while True:
            self.svc.poll()
            if not self.svc.present_slots():
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"stages {self.svc.present_slots()} still present "
                    f"{timeout_s}s after the run")
            time.sleep(0.05)

    def final_params(self) -> dict:
        """``{stage: w}`` from each stage table's CURRENT buffer.
        Meaningful after :meth:`run` returned; mid-run it reads
        whatever step the fleet is on."""
        D = self.spec.width
        out = {}
        for s, t in enumerate(self.tables):
            rows = t.sparse_pull(np.arange(stage_table_rows(D)))
            out[s] = rows[0:D].copy()
        return out

    def close(self) -> None:
        # a FENCED controller no longer owns the fleet: its close()
        # must not kill stage processes the new incarnation adopted
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
        # takeover-adopted stages have no Popen handle — the pid off
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
        for t in (*getattr(self, "tables", ()),
                  getattr(self, "_bb", None)):
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
    """Entry point for a spawned CONTROLLER process over an EXTERNAL
    van: drive the pipeline and print the progress markers the chaos
    harness keys on (``STEP k`` per committed-high-water advance,
    ``ALLDONE``, ``FENCED``)."""
    cfg = json.loads(open(config_path).read())
    trace.open_process_stream(cfg["workdir"],
                              f"controller_p{os.getpid()}")
    sup = MPMDPipelineSupervisor(
        int(cfg["n_stages"]), workdir=cfg["workdir"],
        steps=int(cfg["steps"]),
        n_microbatches=int(cfg.get("n_microbatches", 4)),
        width=int(cfg.get("width", 8)), batch=int(cfg.get("batch", 8)),
        schedule=cfg.get("schedule", "1f1b"),
        wire=cfg.get("wire", "f32"),
        data_seed=int(cfg.get("data_seed", 0)),
        lease_s=float(cfg.get("lease_s", 0.6)),
        suspect_grace_s=float(cfg.get("suspect_grace_s", 0.4)),
        step_sleep_s=float(cfg.get("step_sleep_s", 0.0)),
        ctrl_lease_s=float(cfg.get("ctrl_lease_s", 0.0)),
        hb_ms=int(cfg.get("hb_ms", 60)),
        port=int(cfg["port"]), own_van=False)

    def done():
        states = [sup.svc.state_of(s) for s in range(sup.n_stages)]
        present = [m for m in states
                   if m.state in ("alive", "suspect")]
        return bool((present and all(m.committed >= sup.steps - 1
                                     for m in present)) or
                    (not present and
                     sup._committed_hw >= sup.steps - 1))

    rc = drive_controller_harness(
        sup.poll, lambda: sup._committed_hw, done,
        deadline_s=float(cfg.get("deadline_s", 300.0)),
        ready_words=(f"jax={int('jax' in sys.modules)}",
                     f"torch={int('torch' in sys.modules)}"))
    return 0 if rc is None else rc


if __name__ == "__main__":
    if sys.argv[1] == "--controller":
        sys.exit(controller_main(sys.argv[2]))
    sys.exit(stage_main(sys.argv[1]))
