"""Elastic mesh resharding: survive permanent data-parallel worker loss
(and rejoin) by reforming the mesh at the surviving width instead of
aborting (counterpart of ``hetu_tpu/resilience/elastic.py``).

:class:`~hetu_tpu_torch.resilience.supervisor.Supervisor` retries, guards
and checkpoints, but its mesh is fixed for the life of the run.
:class:`ElasticSupervisor` makes membership a runtime input.  Each step,
before the guard polls and the batch fetch, it drains membership events:
injected ``worker_loss``/``worker_join`` faults (authoritative) and
:class:`MembershipMonitor` promotions of repeated PS-shard-guard
failures.  When the alive set changed it reshards:

1. snapshot the live ``TrainState``: the local copy of each replicated
   DTensor (parameters, optimizer slots, state buffers), cloned, and the
   step and rng words;
2. reform the mesh at the surviving width
   (:func:`~hetu_tpu_torch.parallel.mesh.elastic_mesh`: a survivor keeps
   its own ranks);
3. after a grow, broadcast the snapshot from the lowest surviving rank
   over the new mesh's ``dp`` group, so a rejoining rank's stale state is
   replaced bitwise;
4. place the snapshot on the new mesh (``host_to_device(...,
   replicated(mesh))``), rebinding the model's own parameters and state
   buffers, and point the executor at it (``Executor.set_mesh``);
5. re-partition the data: with an ``ElasticBatchSchedule`` the GLOBAL
   batch sequence is a pure function of (seed, step), so a 4 → 3 → 4 run
   consumes the same global batches in the same order as a run that never
   resized.  In ``fixed_per_worker`` mode the gradient is rescaled by
   nominal / current width (``Executor.set_grad_scale``).

The reference is one controller over a device mesh; here every rank of
the nominal world is a process that runs the supervisor, so every rank
must take the same decisions at the same step.  Each step every rank
all-reduces its view of the step's membership events and its guards'
failure evidence over the nominal world (the events must agree; the
evidence is the union of what any rank saw) before anyone acts on them,
so the collectives run in the same order everywhere.  A lost worker's
ranks stay in the world: they join that all-reduce every step and call
``elastic_mesh`` on every resize (its groups are made collectively), but
run no train step until a join names them.  Checkpoints are written by
the lowest alive rank from its local copy (every rank waits for the
write) and record the live width (``extra``: ``dp_width``, ``alive``,
``nominal_dp``); a checkpoint restores at any width, since its leaves
are whole values.

``config`` is the :class:`~hetu_tpu_torch.parallel.mesh.MeshConfig`, as
in the reference; the model configuration the port's checkpoints carry
(the base supervisor's ``config``) goes under ``model_config``.
"""

from __future__ import annotations

import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from hetu_tpu_torch.layers.base import state_buffers
from hetu_tpu_torch.parallel.mesh import (
    AXIS_DP, MeshConfig, elastic_mesh, host_to_device, replicated,
)
from hetu_tpu_torch.parallel.spec import is_dtensor
from hetu_tpu_torch.resilience.supervisor import CheckpointManager, Supervisor
from hetu_tpu_torch.telemetry import trace


class ElasticReshardError(RuntimeError):
    """The mesh cannot be reformed at the requested membership — every
    worker lost, a join for a worker that is present, or a global batch
    that does not divide by the surviving width."""


@dataclass
class ResizeEvent:
    """One completed resize, for reports and benches: the detect →
    resharded wall time ``downtime_s`` excludes the next step."""

    step: int
    kind: str                   # "shrink" | "grow"
    worker: int
    width: int                  # width AFTER the resize
    downtime_s: float
    alive: tuple = field(default_factory=tuple)


class MembershipMonitor:
    """Promotes failure evidence into resize decisions.

    * :meth:`inject` — an AUTHORITATIVE membership event (the chaos
      harness's seeded ``worker_loss``/``worker_join``, or a cluster
      scheduler's notification): decided immediately.
    * :meth:`report_failure` / :meth:`report_ok` — circumstantial
      evidence (a PS shard guard's shard staying dead).
      ``fail_threshold`` CONSECUTIVE failure reports with no intervening
      ok promote to a loss decision — one flaky poll never reshapes the
      fleet.

    The monitor tracks the alive set itself, so a double loss or a double
    join is rejected here, once, instead of in every caller.
    """

    def __init__(self, nominal_dp: int, *, fail_threshold: int = 3):
        if nominal_dp < 1:
            raise ValueError("nominal_dp must be >= 1")
        self.nominal_dp = int(nominal_dp)
        self.fail_threshold = int(fail_threshold)
        self.alive: set[int] = set(range(self.nominal_dp))
        self._fails: dict[int, int] = defaultdict(int)
        self._decisions: deque = deque()

    def inject(self, kind: str, worker: int) -> None:
        worker = int(worker)
        if kind == "loss":
            if worker in self.alive:
                self.alive.discard(worker)
                self._decisions.append(("loss", worker))
        elif kind == "join":
            if not 0 <= worker < self.nominal_dp:
                raise ElasticReshardError(
                    f"worker {worker} outside the nominal fleet "
                    f"[0, {self.nominal_dp})")
            if worker not in self.alive:
                self.alive.add(worker)
                self._fails.pop(worker, None)
                self._decisions.append(("join", worker))
        else:
            raise ValueError(f"unknown membership event kind {kind!r}")

    def report_failure(self, worker: int) -> None:
        worker = int(worker)
        if worker not in self.alive:
            return  # already decided lost
        self._fails[worker] += 1
        if self._fails[worker] >= self.fail_threshold:
            self.inject("loss", worker)

    def report_ok(self, worker: int) -> None:
        self._fails.pop(int(worker), None)

    def pop_decisions(self) -> list:
        out = list(self._decisions)
        self._decisions.clear()
        return out


def _local(t):
    return t.to_local() if is_dtensor(t) else t


class _WriterCheckpointManager(CheckpointManager):
    """A checkpoint directory written by one rank: ``save`` writes the
    writer's local copy of a replicated state, and every rank of the
    nominal world waits for the write."""

    def __init__(self, base: CheckpointManager, is_writer):
        super().__init__(base.dir, keep=base.keep, prefix=base.prefix,
                         config=base.config)
        self._is_writer = is_writer

    def save(self, state, step: int, *, extra: Optional[dict] = None):
        path = self._path(step)
        try:
            if self._is_writer():
                path = super().save(_local_state(state), step, extra=extra)
        finally:
            dist.barrier()
        return path


def _local_state(state):
    """``state`` with every DTensor replaced by this rank's local copy
    (the whole value, for a replicated state)."""
    from hetu_tpu_torch.train.executor import TrainState
    opt = state.opt_state
    if opt:
        opt = dict(opt, slots={k: {n: _local(t) for n, t in v.items()}
                               for k, v in opt["slots"].items()})
    return TrainState(params={n: _local(p) for n, p in state.params.items()},
                      opt_state=opt, rng=state.rng, step=state.step,
                      model_state={n: _local(t) for n, t in
                                   state.model_state.items()})


class ElasticSupervisor(Supervisor):
    """:class:`Supervisor` whose mesh membership is a runtime input; every
    rank of the nominal world (``config.num_devices`` ranks) runs one.

    Usage, in each rank::

        config = MeshConfig(dp=4)
        ex = Executor(loss_fn, opt)             # the supervisor sets the mesh
        state = ex.init_state(model)
        schedule = ElasticBatchSchedule((X, Y), global_batch, seed=0)
        sup = ElasticSupervisor(ex, config=config, schedule=schedule,
                                injector=FaultInjector(faults))
        rep = sup.run(state, lambda i: dict_batch(schedule.global_batch(i)),
                      steps)

    ``data_mode``: ``"fixed_global_batch"`` (default): every step consumes
    the same global batch whatever the width (an
    ``ElasticBatchSchedule``), which must divide by every reachable width
    (validated at construction against ``min_width..nominal_dp`` when a
    schedule is given, else at each resize); ``"fixed_per_worker"``: the
    global batch is per-worker × width, and gradients are rescaled by
    nominal / current width unless ``rescale_grads=False``.

    ``shard_workers`` maps a PS shard guard's shard index to the dp worker
    hosting it: a shard that stays pending ``fail_threshold`` consecutive
    steps (on any rank's guards) promotes that worker's loss.
    ``device``/``backend`` are ``make_mesh``'s; ``model_config`` is the
    model configuration the checkpoints carry (the base supervisor's
    ``config``).  The executor's state must come from
    ``executor.init_state(model)``: a reshard rebinds that model's own
    parameters and state buffers.  The state must be replicated over the
    mesh (data parallelism)."""

    def __init__(self, executor, *, config: MeshConfig,
                 device: str = "cuda", backend: Optional[str] = None,
                 schedule=None, data_mode: str = "fixed_global_batch",
                 rescale_grads: bool = True,
                 monitor: Optional[MembershipMonitor] = None,
                 fail_threshold: int = 3,
                 shard_workers: Optional[dict] = None,
                 min_width: int = 1, model_config=None, **kw):
        super().__init__(executor, config=model_config, **kw)
        if data_mode not in ("fixed_global_batch", "fixed_per_worker"):
            raise ValueError(f"unknown data_mode {data_mode!r}")
        self.config = config
        self.device = device
        self.backend = backend
        self.schedule = schedule
        self.data_mode = data_mode
        self.rescale_grads = bool(rescale_grads)
        self.min_width = int(min_width)
        self.monitor = monitor or MembershipMonitor(
            config.dp, fail_threshold=fail_threshold)
        self.shard_workers = dict(shard_workers or {})
        self.resizes: list[ResizeEvent] = []
        if schedule is not None and data_mode == "fixed_global_batch":
            for w in range(max(self.min_width, 1), config.dp + 1):
                schedule.check_width(w)
        # each worker's ranks in the nominal layout (make_mesh lays the
        # world out as arange over the axes, in the config's order)
        order = tuple(config.axis_order)
        sizes = config.sizes()
        layout = torch.arange(config.num_devices).reshape(
            [sizes[a] for a in order])
        dp_dim = order.index(AXIS_DP)
        self._worker_ranks = [
            sorted(layout.select(dp_dim, w).flatten().tolist())
            for w in range(config.dp)]
        # install the nominal mesh (every rank; its groups are collective)
        # or adopt a caller-installed one, so step 0 runs under elastic
        # management
        if executor.mesh is None:
            executor.set_mesh(self._remesh())
        self._rank = dist.get_rank()
        self._worker = next(w for w, r in enumerate(self._worker_ranks)
                            if self._rank in r)
        if self.manager is not None:
            self.manager = _WriterCheckpointManager(
                self.manager, lambda: self._rank == self._writer())
        self.counters["elastic_width"] = len(self.monitor.alive)

    # ---- membership → resharding ----
    @property
    def width(self) -> int:
        return len(self.monitor.alive)

    def rank_of(self, worker: int) -> int:
        """Worker's slot in the CURRENT mesh (its dp coordinate) — the
        rank survivors use for ``ElasticBatchSchedule.local_slice``."""
        alive = sorted(self.monitor.alive)
        if worker not in alive:
            raise ElasticReshardError(f"worker {worker} is not alive")
        return alive.index(worker)

    def _writer(self) -> int:
        """The rank that writes checkpoints: the lowest of the lowest
        alive worker's ranks."""
        return self._worker_ranks[min(self.monitor.alive)][0]

    def _trains_here(self) -> bool:
        return self._worker in self.monitor.alive

    def _remesh(self):
        return elastic_mesh(self.config, sorted(self.monitor.alive),
                            device=self.device, backend=self.backend)

    def _agree(self, events: list) -> tuple:
        """The step's membership events and shard-guard evidence, agreed
        over the nominal world: one all-reduce (max) on every rank, every
        step.  The events (the same seeded schedule on every rank) must
        match rank for rank; a shard counts as pending if any rank's
        guards hold it pending.  Returns ``(events, pending shards)``."""
        dp = self.config.dp
        cap = 4 * dp
        if len(events) > cap:
            raise ElasticReshardError(
                f"{len(events)} membership events in one step (at most "
                f"{cap})")
        code = np.zeros(cap)
        for j, (kind, worker) in enumerate(events):
            if not 0 <= int(worker) < dp:
                # outside the fleet: the monitor ignores a loss and
                # refuses a join, as in the reference
                self.monitor.inject(kind, worker)
                continue
            code[j] = 1 + (dp if kind == "join" else 0) + int(worker)
        shards = sorted(self.shard_workers)
        pending = set()
        for g in self.guards:
            pending |= set(getattr(g, "_pending", ()))
        evidence = [1.0 if s in pending else 0.0 for s in shards]
        dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
        vec = torch.tensor(np.concatenate([code, -code, evidence]),
                           dtype=torch.float64, device=dev)
        dist.all_reduce(vec, op=dist.ReduceOp.MAX)
        vec = vec.cpu().numpy()
        hi, lo = vec[:cap], -vec[cap:2 * cap]
        if not np.array_equal(hi, lo):
            raise ElasticReshardError(
                "the ranks disagree on this step's membership events: "
                "every rank must run the same fault schedule")
        agreed = [("join" if c > dp else "loss", int(c - 1) % dp)
                  for c in hi if c > 0]
        return agreed, {s for s, x in zip(shards, vec[2 * cap:]) if x > 0}

    def _promote_guard_failures(self, pending: set) -> None:
        """Shard-guard evidence: a shard pending repair is one failure
        strike against the worker hosting it; a shard no longer pending
        clears its worker's strikes."""
        for shard, worker in self.shard_workers.items():
            if shard in pending:
                self.monitor.report_failure(worker)
            else:
                self.monitor.report_ok(worker)

    def _maybe_resize(self, state, step_i: int):
        events = []
        if self.injector is not None and \
                hasattr(self.injector, "pop_worker_events"):
            events = self.injector.pop_worker_events()
        events, pending = self._agree(events)
        for kind, worker in events:
            self.monitor.inject(kind, worker)
        self._promote_guard_failures(pending)
        decisions = self.monitor.pop_decisions()
        if not decisions:
            return state
        # ONE reshard for the whole batch of decisions: monitor.alive
        # already reflects every one; each still gets its ResizeEvent
        t0 = time.perf_counter()
        with trace.span("elastic.reshard") as sp:
            sp.set("step", int(step_i))
            sp.set("width", self.width)
            sp.set("decisions", [f"{k}:{w}" for k, w in decisions])
            state = self._reshard(state, decisions)
        dt = time.perf_counter() - t0
        self.counters["resizes"] += 1
        self.counters["elastic_width"] = self.width
        self.counters["resize_downtime_s_last"] = dt
        self._log_inc("resizes")
        if self.logger is not None:
            self.logger.log({"elastic_width": self.width,
                             "resize_downtime_s": dt}, step=step_i)
        for kind, worker in decisions:
            ev = ResizeEvent(
                step=step_i, kind="shrink" if kind == "loss" else "grow",
                worker=int(worker), width=self.width, downtime_s=dt,
                alive=tuple(sorted(self.monitor.alive)))
            self.resizes.append(ev)
            self.counters[f"resizes_{ev.kind}"] += 1
        return state

    def _snapshot(self, state) -> dict:
        """This rank's local copy of every tensor of ``state``, cloned:
        nothing references the old mesh's tensors afterwards."""
        with torch.no_grad():
            return {
                "params": {n: _local(p).detach().clone()
                           for n, p in state.params.items()},
                "slots": {k: {n: _local(t).detach().clone()
                              for n, t in v.items()}
                          for k, v in state.opt_state.get("slots",
                                                          {}).items()},
                "model_state": {n: _local(t).detach().clone()
                                for n, t in state.model_state.items()},
                "ints": torch.tensor(
                    [int(state.step), int(state.opt_state.get("step", 0))]
                    + [int(w) for w in np.asarray(state.rng)],
                    dtype=torch.int64)}

    @staticmethod
    def _broadcast(snap: dict, src: int, group) -> None:
        """``snap``'s tensors from global rank ``src`` to every rank of
        ``group``, in place: one broadcast a dtype (staged through host
        memory under gloo, which does not run every collective on CUDA
        tensors)."""
        tensors = [*snap["params"].values(),
                   *(t for v in snap["slots"].values() for t in v.values()),
                   *snap["model_state"].values(), snap["ints"]]
        host = dist.get_backend(group) == "gloo"
        by_dtype: dict = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            if host:
                flat = flat.cpu()
            dist.broadcast(flat, src=src, group=group)
            off = 0
            for t in ts:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()

    def _place(self, snap: dict, mesh):
        """A new ``TrainState`` of ``snap`` replicated on ``mesh``: the
        model's own parameters and state buffers rebound to it."""
        from hetu_tpu_torch.train.executor import TrainState
        model = getattr(self.executor, "model", None)
        if model is None:
            raise ElasticReshardError(
                "the elastic supervisor re-places the model's own "
                "parameters: build the state with executor.init_state("
                "model)")
        pl = replicated(mesh)

        def put(t):
            return host_to_device(t, mesh, pl)
        with trace.span("elastic.replace"):
            for name, p in list(model.named_parameters()):
                owner, _, leaf = name.rpartition(".")
                setattr(model.get_submodule(owner), leaf,
                        nn.Parameter(put(snap["params"][name]),
                                     requires_grad=p.requires_grad))
            for name, t in snap["model_state"].items():
                owner, _, leaf = name.rpartition(".")
                setattr(model.get_submodule(owner), leaf, put(t))
            ints = snap["ints"].tolist()
            opt = {} if self.executor.optimizer is None else {
                "step": ints[1],
                "slots": {k: {n: put(t) for n, t in v.items()}
                          for k, v in snap["slots"].items()}}
            return TrainState(params=dict(model.named_parameters()),
                              opt_state=opt,
                              rng=np.asarray(ints[2:], np.uint32),
                              step=ints[0], model_state=state_buffers(model))

    def _reshard(self, state, decisions):
        """Snapshot → reform the mesh → (after a grow) broadcast →
        re-place; on a rank outside the new mesh only the mesh is
        reformed."""
        alive = sorted(self.monitor.alive)
        if len(alive) < max(self.min_width, 1):
            raise ElasticReshardError(
                f"only {len(alive)} of {self.config.dp} workers alive "
                f"(min_width={self.min_width}); cannot reform the mesh")
        width = len(alive)
        if self.schedule is not None and \
                self.data_mode == "fixed_global_batch":
            self.schedule.check_width(width)
        joined = {w for k, w in decisions if k == "join"}
        before = (set(alive) - joined) | {w for k, w in decisions
                                           if k == "loss"}
        survivors = sorted(set(alive) & (before - joined))
        if joined and not survivors:
            raise ElasticReshardError(
                f"workers {sorted(joined)} join a fleet none of whose "
                "workers survived: no rank holds the state to hand over")
        with trace.span("elastic.snapshot"):
            # a rank leaving the fleet keeps its state as it is; a
            # rejoining one's is the broadcast's buffer
            snap = self._snapshot(state) if self._worker in alive else None
        with trace.span("elastic.remesh") as sp:
            sp.set("width", width)
            mesh = self._remesh()
            self.executor.set_mesh(mesh)
            if self.data_mode == "fixed_per_worker" and self.rescale_grads:
                self.executor.set_grad_scale(self.config.dp / width)
        if mesh is None:
            return state  # out of the fleet: idle until a join names us
        if joined:
            # a rejoining rank's state is stale: the lowest survivor's
            # goes to every rank of the new mesh's dp group
            group = mesh.get_group(AXIS_DP)
            src = dist.get_global_rank(group, alive.index(survivors[0]))
            with trace.span("elastic.broadcast"):
                self._broadcast(snap, src, group)
        return self._place(snap, mesh)

    def _ckpt_extra(self) -> dict:
        return {"dp_width": self.width,
                "alive": sorted(self.monitor.alive),
                "nominal_dp": self.config.dp}

    def run(self, state, batch_fn, steps, **kw):
        if batch_fn is None and self.schedule is not None:
            batch_fn = self.schedule.global_batch
        # place the caller's state (the restore TEMPLATE too: a checkpoint
        # loads into it in place) replicated on the CURRENT mesh, so a
        # width-3 checkpoint restoring into a width-4 run lands on the
        # width-4 mesh
        if self.executor.mesh is not None:
            state = self._place(self._snapshot(state), self.executor.mesh)
        rep = super().run(state, batch_fn, steps, **kw)
        rep.counters.setdefault("elastic_width", self.width)
        return rep
