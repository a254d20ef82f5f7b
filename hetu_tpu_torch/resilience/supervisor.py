"""Fault-tolerant training supervisor over ``train.executor.Executor``
(counterpart of ``hetu_tpu/resilience/supervisor.py``).

Closes the recovery contracts the lower layers leave to the caller:

* ``ps/van.py`` (``PartitionedPSTable``): a killed PS shard that restarts
  blank is re-created with fresh-init rows and ``recovered`` counts it;
  :class:`PSShardGuard` snapshots the table on the checkpoint cadence and
  replays the recovered shard's rows and optimizer slots, so a resurrected
  shard carries what it had learned.
* ``train/checkpoint.py``: atomic single-file save and load, but no
  retention and no corrupt-file fallback; :class:`CheckpointManager` adds
  keep-K, a CRC32 sidecar and newest-valid-wins restore.
* ``train/executor.py``: the ``train_guarded`` step keeps the pre-step
  tensors when a step comes out nonfinite; :class:`Supervisor` counts the
  skips and aborts after N in a row.

The supervisor's loop, a step at a time: injected faults (the chaos
harness, optional) -> the resize hook -> shard-guard poll and repair ->
batch fetch (retried) -> the injector's batch corruption -> guarded train
step -> post-step hook (retried; skipped on a nonfinite step, so poisoned
gradients never reach the PS) -> cadence checkpoint -> preemption check.
Retries back off exponentially with jitter drawn from
``np.random.default_rng(seed)`` (the reference's draws, so the same
delays) and retry only what :func:`default_is_transient` (or the
caller's predicate) calls transient: van and PS transport failures and
injected faults retry, real bugs raise at once.

SIGTERM (preemption) is cooperative: the handler only sets a flag; at the
end of the step in flight the supervisor checkpoints (parameters,
optimizer slots, the rng words and the global (seed, seqnum), and the PS
snapshots) and returns with ``preempted=True``.  A later ``run()`` with
the same ``ckpt_dir`` resumes at that step with that rng state.

Departures from the reference: :class:`CheckpointManager` and
:class:`Supervisor` take the model's ``config`` and pass it to
``checkpoint.save``/``load`` (a port ``TrainState`` is converted to the
reference's layout through it; ``None`` for a plain nested dict);
:class:`NonFiniteAbort` carries the live state, since the port's guarded
step restores the tensors in place and nothing is donated; and
:meth:`PSShardGuard.snapshot` skips a shard that awaits repair, whose live
rows are a blank re-create and not data.
"""

from __future__ import annotations

import signal
import threading
import time
import zlib
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np

from hetu_tpu_torch.telemetry import trace


class NonFiniteAbort(RuntimeError):
    """Too many consecutive nonfinite (NaN/Inf) steps: the run diverged,
    and aborting beats skipping forever.

    ``state``/``step`` carry the last finite training state: the guarded
    step put the pre-step tensors back in place, so ``state`` is the
    caller's own state object; with a ``ckpt_dir`` the supervisor also
    checkpoints it before raising."""

    def __init__(self, msg: str, *, state=None, step: int = -1):
        super().__init__(msg)
        self.state = state
        self.step = step


def default_is_transient(exc: BaseException) -> bool:
    """Errors worth retrying: transport-level van/PS failures (a dead
    shard mid-restart, a dropped connection, an injected fault) and flaky
    data.  Everything else (shape errors, out of memory, real bugs) is
    not."""
    from hetu_tpu_torch.resilience.faults import TransientDataError
    if isinstance(exc, (ConnectionError, TimeoutError, TransientDataError)):
        return True  # TransientFault subclasses ConnectionError
    # the native layer raises every failed wire op as
    # RuntimeError("hetu_ps <op> failed with rc=..."); during a shard
    # restart these clear once the group reconnects
    return isinstance(exc, RuntimeError) and "hetu_ps" in str(exc)


# ---------------------------------------------------------------------------
# checkpoint retention
# ---------------------------------------------------------------------------

class CheckpointManager:
    """Atomic keep-K checkpoint directory with CRC sidecars.

    ``save`` publishes ``ckpt-<step>.npz`` (``checkpoint.save`` is atomic:
    tmp + fsync + ``os.replace``) plus a ``.crc`` sidecar holding ``crc32
    nbytes`` of the published file, then prunes to the newest ``keep``.
    ``restore`` walks newest to oldest, skipping any candidate whose CRC
    mismatches or whose load raises
    :class:`~hetu_tpu_torch.train.checkpoint.CheckpointCorruptError`: a
    preemption mid-save or bit rot costs at most one checkpoint interval.

    ``config`` is the model's configuration that ``checkpoint.save`` and
    ``load`` take for a port ``TrainState``; ``None`` saves and restores
    a nested dict of arrays or tensors.
    """

    def __init__(self, directory, *, keep: int = 3, prefix: str = "ckpt",
                 config=None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = int(keep)
        self.prefix = prefix
        self.config = config
        self.skipped: list[str] = []  # corrupt candidates seen by restore
        self.last_restored: Optional[str] = None  # path restore() used

    def _path(self, step: int) -> Path:
        return self.dir / f"{self.prefix}-{int(step):08d}.npz"

    def steps(self) -> list[int]:
        out = []
        for p in self.dir.glob(f"{self.prefix}-*.npz"):
            try:
                out.append(int(p.stem.split("-")[-1]))
            except ValueError:
                continue
        return sorted(out)

    @staticmethod
    def _crc_file(path: Path) -> tuple[int, int]:
        """Streamed (crc32, nbytes): never the whole archive in memory."""
        crc = 0
        n = 0
        with open(path, "rb") as f:
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    return crc, n
                crc = zlib.crc32(chunk, crc)
                n += len(chunk)

    def save(self, state, step: int, *, extra: Optional[dict] = None) -> Path:
        from hetu_tpu_torch.train import checkpoint as ckpt
        path = self._path(step)
        ckpt.save(path, state, self.config, extra=extra)
        crc, n = self._crc_file(path)
        crc_tmp = path.with_suffix(".crc.tmp")
        crc_tmp.write_text(f"{crc:08x} {n}\n")
        crc_tmp.replace(path.with_suffix(".crc"))
        self._prune()
        return path

    def _prune(self) -> None:
        for s in self.steps()[:-self.keep]:
            self._path(s).unlink(missing_ok=True)
            self._path(s).with_suffix(".crc").unlink(missing_ok=True)

    def _crc_ok(self, path: Path) -> bool:
        side = path.with_suffix(".crc")
        if not side.exists():
            return True  # no sidecar: load() still checks the archive
        try:
            want_crc, want_n = side.read_text().split()
            crc, n = self._crc_file(path)
            return n == int(want_n) and crc == int(want_crc, 16)
        except (OSError, ValueError):
            return False

    def restore(self, template, *, restore_rng: bool = True):
        """Newest valid checkpoint -> ``(state, step)``; None if none.

        Only corruption falls back to an older checkpoint; one that loads
        but does not fit (another architecture, a newer format) raises.
        A port ``TrainState`` template is loaded into in place."""
        from hetu_tpu_torch.train import checkpoint as ckpt
        for step in reversed(self.steps()):
            path = self._path(step)
            if not self._crc_ok(path):
                self.skipped.append(str(path))
                continue
            try:
                state = ckpt.load(path, template, self.config,
                                  restore_rng=restore_rng)
            except ckpt.CheckpointCorruptError:
                self.skipped.append(str(path))
                continue
            self.last_restored = str(path)
            return state, step
        return None


# ---------------------------------------------------------------------------
# PS shard snapshot / repair
# ---------------------------------------------------------------------------

class PSShardGuard:
    """Snapshot and repair for one ``PartitionedPSTable``.

    ``snapshot()`` (on the supervisor's checkpoint cadence) pulls each live
    shard's row range into host memory, and with ``snapshot_path`` also
    writes it to disk, so a preempted and resumed worker can still repair.
    ``poll()`` watches ``table.alive`` and ``table.recovered``: when a
    shard that died comes back and the group re-created it blank, the guard
    replays that shard's snapshot rows through ``sparse_set``; only the
    recovered shard is touched, live shards never rewind.

    Durable optimizer slots: when the table has ``slots_get`` /
    ``slots_set``, snapshots also capture each live shard's server-side
    optimizer state (s1: velocity, adagrad accumulator or Adam m; s2: Adam
    v; the per-row Adam step), and repair replays them after the weights,
    so a resurrected shard resumes with its accumulators bitwise.
    ``slots=False`` snapshots the weights only.

    Limits: repair restores weights and slots as of the last snapshot;
    updates since then are lost, bounded by the checkpoint cadence.  An
    alive-flicker without a blank re-create (``recovered`` unchanged) is
    left alone.
    """

    def __init__(self, table, *, snapshot_path=None, name: str = "pstable",
                 slots: bool = True):
        self.table = table
        self.name = name
        self.snapshot_path = Path(snapshot_path) if snapshot_path else None
        self.slots = bool(slots) and hasattr(table, "slots_get") \
            and hasattr(table, "slots_set")
        self._snap = None              # [rows, dim] f32, made on first use
        self._snap_s1 = None           # [rows, dim] f32 optimizer slot 1
        self._snap_s2 = None           # [rows, dim] f32 optimizer slot 2
        self._snap_step = None         # [rows] u64 per-row Adam step
        self._have: set[int] = set()   # shards with valid snapshot rows
        self._have_slots: set[int] = set()  # shards with a slot snapshot
        self._pending: set[int] = set()  # shards seen dead, awaiting repair
        self._seen_recovered = int(table.recovered)
        self.repairs = 0
        if self.snapshot_path is not None and self.snapshot_path.exists():
            z = np.load(self.snapshot_path)
            self._snap = z["values"]
            self._have = {int(i) for i in z["have"]}
            if "s1" in z.files:  # a weights-only snapshot file loads too
                self._snap_s1 = z["s1"]
                self._snap_s2 = z["s2"]
                self._snap_step = z["step"]
                self._have_slots = {int(i) for i in z["have_slots"]}

    def shard_rows(self, i: int) -> np.ndarray:
        starts = self.table.shard_starts
        hi = (starts[i + 1] if i + 1 < self.table.n_servers
              else self.table.rows)
        return np.arange(starts[i], hi, dtype=np.int64)

    def snapshot(self) -> int:
        """Snapshot every live shard; returns how many shards it captured.
        A dead shard, or one awaiting repair, keeps its previous snapshot
        rows (the data its repair needs) and is queued for repair."""
        if self._snap is None:
            self._snap = np.zeros((self.table.rows, self.table.dim),
                                  np.float32)
        if self.slots and self._snap_s1 is None:
            self._snap_s1 = np.zeros_like(self._snap)
            self._snap_s2 = np.zeros_like(self._snap)
            self._snap_step = np.zeros(self.table.rows, np.uint64)
        captured = 0
        alive = self.table.alive
        for i, a in enumerate(alive):
            if not a or i in self._pending:
                self._pending.add(i)
                continue
            rows = self.shard_rows(i)
            try:
                # pull into locals and commit only after every read
                # succeeded: a shard dying between the weight pull and the
                # slot pull must not pair new weights with the previous
                # snapshot's accumulators
                vals = self.table.sparse_pull(rows)
                if self.slots:
                    s1, s2, st = self.table.slots_get(rows)
            except (RuntimeError, ConnectionError, TimeoutError):
                self._pending.add(i)  # died between the mask and the pull
                continue
            self._snap[rows] = vals
            if self.slots:
                self._snap_s1[rows] = s1
                self._snap_s2[rows] = s2
                self._snap_step[rows] = st
                self._have_slots.add(i)
            self._have.add(i)
            captured += 1
        if self.snapshot_path is not None and captured:
            tmp = self.snapshot_path.with_name(self.snapshot_path.name
                                               + ".tmp")
            arrays = {"values": self._snap,
                      "have": np.asarray(sorted(self._have), np.int64)}
            if self.slots:
                arrays.update(
                    s1=self._snap_s1, s2=self._snap_s2,
                    step=self._snap_step,
                    have_slots=np.asarray(sorted(self._have_slots),
                                          np.int64))
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
            tmp.replace(self.snapshot_path)
        return captured

    def poll(self) -> int:
        """Detect died -> alive shards; replay snapshots into any the group
        re-created blank.  Returns the repairs made now.

        Attribution: ``recovered`` is one global counter, so each blank
        re-create is claimed by exactly one pending shard: a bump seen
        across a shard's own probe belongs to that shard; an unclaimed
        earlier bump (a training op reached the resurrected shard between
        polls) is claimed by the first pending shard that probes clean.
        An alive-flicker whose incarnation never changed claims nothing
        and is left alone."""
        t = self.table
        alive = t.alive
        for i, a in enumerate(alive):
            if not a:
                self._pending.add(i)
        done = 0
        seen = self._seen_recovered  # re-creates already claimed
        for i in sorted(self._pending):
            if not alive[i]:
                continue
            rows = self.shard_rows(i)
            rec_before = int(t.recovered)
            try:
                # the probe forces the group's lazy shard re-create (a
                # blank restarted server answers 'no table' until then)
                t.sparse_pull(rows[:1])
            except (RuntimeError, ConnectionError, TimeoutError):
                continue  # still coming up: next poll
            rec_after = int(t.recovered)
            if rec_after > rec_before:
                recreated = True           # this probe triggered it
                seen += rec_after - rec_before
            elif rec_before > seen:
                recreated = True           # claim one unattributed bump
                seen += 1
            else:
                recreated = False          # flicker: data intact
            if recreated and i in self._have:
                t.sparse_set(rows, self._snap[rows])
                if self.slots and i in self._have_slots:
                    # after the weights: sparse_set leaves slots alone, so
                    # the restored accumulators land bitwise
                    t.slots_set(rows, self._snap_s1[rows],
                                self._snap_s2[rows], self._snap_step[rows])
                done += 1
                self.repairs += 1
            self._pending.discard(i)
        if self._pending:
            self._seen_recovered = max(seen, self._seen_recovered)
        else:
            # nothing left to claim a bump: fold fully forward, so that a
            # death and restart entirely between polls (never seen dead,
            # re-created by a training op) cannot be pinned on a later
            # flicker
            self._seen_recovered = max(self._seen_recovered,
                                       int(t.recovered))
        return done


# ---------------------------------------------------------------------------
# supervisor
# ---------------------------------------------------------------------------

@dataclass
class SupervisorReport:
    """What a ``run()`` did: the final state, where it stopped, whether a
    preemption cut it short, and the resilience counters."""

    state: Any
    step: int
    preempted: bool
    counters: dict = field(default_factory=dict)
    last_metrics: dict = field(default_factory=dict)


class Supervisor:
    """Wraps an :class:`~hetu_tpu_torch.train.executor.Executor` with
    checkpoint retention, per-step retry, a nonfinite guard, PS shard
    repair and cooperative preemption.  See the module docstring for the
    loop.

    ``run(state, batch_fn, steps)`` drives ``batch_fn(step_index)`` ->
    ``executor.run('train_guarded', ...)`` until ``state.step == steps``;
    ``post_step(step, state, metrics, batch)`` (optional) carries hybrid
    PS work (the rows' gradient pushes) inside the retry envelope.
    ``config`` goes to the :class:`CheckpointManager`.
    """

    def __init__(self, executor, *, ckpt_dir=None, ckpt_every: int = 0,
                 keep: int = 3, retries: int = 8,
                 backoff_base_s: float = 0.05, backoff_max_s: float = 2.0,
                 backoff_jitter: float = 0.25, seed: int = 0,
                 nonfinite_limit: int = 3, injector=None, guards=(),
                 logger=None, is_transient: Optional[Callable] = None,
                 preempt_signals=(signal.SIGTERM,), config=None):
        self.executor = executor
        self.manager = (CheckpointManager(ckpt_dir, keep=keep, config=config)
                        if ckpt_dir is not None else None)
        self.ckpt_every = int(ckpt_every)
        self.retries = int(retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.backoff_jitter = float(backoff_jitter)
        self.nonfinite_limit = int(nonfinite_limit)
        self.injector = injector
        self.guards = list(guards)
        self.logger = logger
        self.preempt_signals = tuple(preempt_signals)
        self._is_transient = is_transient or default_is_transient
        self._jitter_rng = np.random.default_rng(seed)
        self.counters: dict = defaultdict(int)
        self._preempt = threading.Event()

    # ---- retry envelope ----
    def _with_retries(self, fn, what: str):
        attempt = 0
        t_first_fail = 0.0  # tracing: first failure -> eventual success
        while True:
            try:
                out = fn()
                if attempt:
                    # only a retried envelope leaves a recovery span
                    trace.complete("recovery.retry", t_first_fail,
                                   {"what": what, "attempts": attempt})
                return out
            except Exception as e:
                if not self._is_transient(e) or attempt >= self.retries:
                    raise
                if attempt == 0:
                    t_first_fail = trace.now_us()
                delay = min(self.backoff_base_s * (2.0 ** attempt),
                            self.backoff_max_s)
                delay *= 1.0 + self.backoff_jitter * float(
                    self._jitter_rng.random())
                self.counters["retries"] += 1
                self.counters[f"retries_{what}"] += 1
                self._log_inc("retries")
                trace.instant("supervisor.retry",
                              {"what": what, "attempt": attempt,
                               "error": type(e).__name__,
                               "delay_s": round(delay, 4)})
                time.sleep(delay)
                attempt += 1

    def _log_inc(self, name: str, n: int = 1) -> None:
        if self.logger is not None and hasattr(self.logger, "inc"):
            self.logger.inc(name, n)

    # ---- preemption ----
    def _on_signal(self, signum, frame) -> None:
        # only set a flag: the step in flight finishes, then we checkpoint
        self._preempt.set()
        self.counters["preempt_signals"] += 1

    # ---- subclass hooks (the elastic supervisor overrides them) ----
    def _maybe_resize(self, state, step_i: int):
        """Membership hook, called at the top of every step after injected
        faults land: the base supervisor's device set is fixed for the
        life of the run, so this is the identity."""
        return state

    def _trains_here(self) -> bool:
        """Whether this process runs the step's batch fetch, train step
        and post-step hook: the elastic supervisor's ranks outside the
        mesh skip them (and still count the step); here always."""
        return True

    def _ckpt_extra(self) -> Optional[dict]:
        """Extra JSON recorded in every checkpoint header (None: none)."""
        return None

    # ---- checkpoint + snapshots ----
    def _checkpoint(self, state, step: int, *,
                    reason: str = "cadence") -> None:
        t0 = time.perf_counter()
        with trace.span("supervisor.checkpoint") as sp:
            sp.set("step", int(step))
            sp.set("reason", reason)
            if self.manager is not None:
                with trace.span("supervisor.checkpoint_write"):
                    self.manager.save(state, step, extra=self._ckpt_extra())
            for g in self.guards:
                try:
                    with trace.span("supervisor.shard_snapshot"):
                        g.snapshot()
                    self.counters["shard_snapshots"] += 1
                except (RuntimeError, ConnectionError, TimeoutError):
                    self.counters["shard_snapshot_errors"] += 1
        dt = time.perf_counter() - t0
        self.counters["checkpoints"] += 1
        self.counters["checkpoint_latency_s_last"] = dt
        self._log_inc("checkpoints")
        if self.logger is not None:
            self.logger.log({"checkpoint_latency_s": dt}, step=step)

    # ---- the loop ----
    def run(self, state, batch_fn: Callable[[int], Any], steps: int, *,
            post_step: Optional[Callable] = None,
            resume: bool = True) -> SupervisorReport:
        self._preempt.clear()  # a prior run's preemption must not leak in
        if self.injector is not None:
            batch_fn = self.injector.wrap_batch_fn(batch_fn)
            self.injector.install()

        step_i = int(state.step)
        if resume and self.manager is not None:
            got = self.manager.restore(state)
            if self.manager.skipped:
                # recorded even when nothing restored: "found checkpoints
                # and rejected every one" must never be silent
                self.counters["corrupt_checkpoints_skipped"] = \
                    len(self.manager.skipped)
                self._log_inc("corrupt_checkpoints_skipped",
                              len(self.manager.skipped))
            if got is not None:
                state, step_i = got
                self.counters["resumed_from_step"] = step_i

        old_handlers = {}
        try:
            for sg in self.preempt_signals:
                old_handlers[sg] = signal.signal(sg, self._on_signal)
        except ValueError:
            old_handlers = {}  # not the main thread: preemption then needs
            # a handler installed by the caller

        nonfinite_run = 0
        preempted = False
        metrics: dict = {}
        try:
            while step_i < int(steps):
                if self.injector is not None:
                    self.injector.on_step(step_i)
                state = self._maybe_resize(state, step_i)
                for g in self.guards:
                    t_poll = trace.now_us()
                    repaired = self._with_retries(g.poll, "guard")
                    if repaired:
                        # retroactive span: only a poll that repaired a
                        # shard is a recovery worth a track slot
                        trace.complete("recovery.shard_repair", t_poll,
                                       {"repaired": repaired,
                                        "step": step_i})
                        self.counters["shard_repairs"] += repaired
                        self._log_inc("shard_repairs", repaired)
                if self._trains_here():
                    with trace.span("train.data_wait"):
                        batch = self._with_retries(lambda: batch_fn(step_i),
                                                   "data")
                    if self.injector is not None:
                        batch = self.injector.corrupt_batch(step_i, batch)
                    state, metrics = self.executor.run("train_guarded", state,
                                                       batch)
                    nonfinite = int(metrics.get("nonfinite", 0))
                    if nonfinite:
                        nonfinite_run += 1
                        self.counters["nonfinite_steps_skipped"] += 1
                        self._log_inc("nonfinite_steps_skipped")
                        trace.instant("recovery.nonfinite_skip",
                                      {"step": step_i, "run": nonfinite_run})
                        if nonfinite_run >= self.nonfinite_limit:
                            # keep the last finite state: checkpoint it if we
                            # can, and always hand it over on the exception
                            if self.manager is not None:
                                self._checkpoint(state, step_i,
                                                 reason="nonfinite")
                            raise NonFiniteAbort(
                                f"{nonfinite_run} consecutive nonfinite "
                                f"steps ending at step {step_i}: the loss "
                                "diverged or the data is poisoned; aborting "
                                "(the "
                                "exception's .state holds the last finite "
                                "values)", state=state, step=step_i)
                    else:
                        nonfinite_run = 0
                        if post_step is not None:
                            self._with_retries(
                                lambda: post_step(step_i, state, metrics,
                                                  batch), "post_step")
                step_i += 1
                self.counters["steps"] += 1
                if (self.ckpt_every and step_i % self.ckpt_every == 0
                        and step_i < int(steps)):
                    self._checkpoint(state, step_i)
                if self._preempt.is_set():
                    self._checkpoint(state, step_i, reason="preempt")
                    preempted = True
                    break
        finally:
            for sg, h in old_handlers.items():
                signal.signal(sg, h)
            if self.injector is not None:
                self.injector.uninstall()
                for k, v in self.injector.counters.items():
                    self.counters[k] = v
            if self.logger is not None:
                snap = {k: float(v) for k, v in self.counters.items()}
                self.logger.log(snap, step=step_i)
        if not preempted and self.ckpt_every and self.manager is not None:
            # final: a resume of a finished run is the finished run
            self._checkpoint(state, step_i, reason="final")
        return SupervisorReport(state=state, step=step_i,
                                preempted=preempted,
                                counters=dict(self.counters),
                                last_metrics=metrics)
