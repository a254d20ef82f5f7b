"""Rank bodies of the port's partial-reduce, distributed-GCN, elastic and
1F1B/HetPipe tests (``tests/test_torch_preduce_distgcn.py``,
``tests/test_torch_elastic.py``, ``tests/test_torch_pipedream.py``).

Each function runs in every rank process of a ``gloo`` world started by
``hetu_tpu_torch.parallel.ranks.run`` (through :func:`run_cases`).  This
module imports neither ``jax`` nor ``hetu_tpu``; the test files build the
references in their own process and compare."""

from __future__ import annotations

import sys

import numpy as np
import torch


def run_cases(rank, world, cases):
    """Every case of ``cases`` (``{id: (function name, spec)}``) in turn;
    ``{id: result}``, and whether jax was loaded in this rank."""
    out = {cid: globals()[name](rank, world, spec)
           for cid, (name, spec) in cases.items()}
    out["_jax_loaded"] = "jax" in sys.modules or any(
        m == "hetu_tpu" or m.startswith("hetu_tpu.") for m in sys.modules)
    return out


def _np(t):
    if hasattr(t, "to_local"):
        t = t.to_local()
    return t.detach().float().cpu().numpy().copy()


def _mesh(**axes):
    from hetu_tpu_torch.parallel import make_mesh
    return make_mesh(device="cpu", **axes)


# ---------------------------------------------------------------- preduce

def preduce(rank, world, spec):
    """``preduce_step_fn`` at dp = world on the reference test's three
    problems: the parameters (and the momentum slot) after each step and
    each step's group loss."""
    from hetu_tpu_torch.optim import MomentumOptimizer, SGDOptimizer
    from hetu_tpu_torch.parallel.preduce import preduce_step_fn
    mesh = _mesh(dp=world)
    out = {}

    # (a) every worker a member: the all-reduce data-parallel step
    x, y = (torch.tensor(spec["x"]), torch.tensor(spec["y"]))

    def lsq(params, batch):
        bx, by = batch
        return (((bx @ params["w"])[:, 0] - by) ** 2).mean()
    step, n = preduce_step_fn(lsq, SGDOptimizer(0.1), mesh)
    params = {"w": torch.zeros(4, 1, requires_grad=True)}
    opt = SGDOptimizer(0.1)
    params, _, loss = step(params, opt.init_state(params), (x, y),
                           np.ones(world))
    out["full"] = dict(n=n, w=_np(params["w"]), loss=float(loss))

    # (b) a partial group, then an empty one (SGD 1.0)
    def lin(params, batch):
        return (params["w"] * batch).mean()
    batch = torch.tensor(spec["const_batch"])
    for name, mask in (("partial", spec["mask"]),
                       ("empty", np.zeros(world))):
        step, _ = preduce_step_fn(lin, SGDOptimizer(1.0), mesh)
        params = {"w": torch.zeros((), requires_grad=True)}
        params, _, loss = step(params, SGDOptimizer(1.0).init_state(params),
                               batch, mask)
        out[name] = dict(w=_np(params["w"]), loss=float(loss))

    # (c) momentum: real step, empty round, real step
    opt = MomentumOptimizer(1.0, 0.9)
    step, _ = preduce_step_fn(lin, opt, mesh)
    params = {"w": torch.zeros((), requires_grad=True)}
    state = opt.init_state(params)
    ones = torch.ones(world)
    seq = []
    for mask in (np.ones(world), np.zeros(world), np.ones(world)):
        params, state, loss = step(params, state, ones, mask)
        seq.append(dict(w=_np(params["w"]),
                        v=_np(state["slots"]["velocity"]["w"]),
                        step=state["step"], loss=float(loss)))
    out["momentum"] = seq
    return out


# ---------------------------------------------------------------- distgcn

def distgcn(rank, world, spec):
    """``dist_gcn_aggregate`` at dp = world on this rank's rows and edge
    slice, both routes: its output rows and dL/dh of ``sum(out * cot)``."""
    from hetu_tpu_torch.ops.distgcn import (
        dist_gcn_aggregate, shard_edges_by_dst,
    )
    mesh = _mesh(dp=world)
    N = spec["h"].shape[0]
    ss, dd, ww = shard_edges_by_dst(spec["src"], spec["dst"], spec["w"], N,
                                    world)
    e = ss.shape[0] // world
    sl = slice(rank * e, (rank + 1) * e)
    rows = slice(rank * N // world, (rank + 1) * N // world)
    out = {"layout": [ss.copy(), dd.copy(), ww.copy()]}
    for ring in (False, True):
        h = torch.tensor(spec["h"][rows]).requires_grad_(True)
        y = dist_gcn_aggregate(h, torch.tensor(ss[sl]), torch.tensor(dd[sl]),
                               torch.tensor(ww[sl]), mesh, ring=ring)
        (y * torch.tensor(spec["cot"][rows])).sum().backward()
        out[ring] = dict(y=_np(y), dh=_np(h.grad))
    return out


# ---------------------------------------------------------------- elastic

def _elastic_problem(spec, mesh=None, seed=1):
    """The reference test's problem in the port: Linear(6, 16) - Relu -
    Linear(16, 3) from the reference's initial tree, Adam 0.03, an
    Executor on ``mesh`` (None: the supervisor installs one)."""
    from hetu_tpu_torch import interop, layers
    from hetu_tpu_torch.optim import AdamOptimizer
    from hetu_tpu_torch.train import Executor
    g = torch.Generator().manual_seed(0)
    model = layers.Sequential(layers.Linear(6, 16, generator=g),
                              layers.Relu(),
                              layers.Linear(16, 3, generator=g))
    model.load_state_dict(interop.params_from_jax(spec["init"], model))

    def loss_fn(params, model_state, batch, gen, train):
        pred = model(torch.as_tensor(batch["x"]))
        return ((pred - torch.as_tensor(batch["y"])) ** 2).mean(), \
            ({}, model_state)
    ex = Executor(loss_fn, AdamOptimizer(0.03), mesh=mesh, seed=seed)
    return model, ex, ex.init_state(model)


def _sched(spec):
    from hetu_tpu_torch.data.dataloader import ElasticBatchSchedule
    return ElasticBatchSchedule((spec["X"], spec["Y"]), 24, seed=3)


def _batch_fn(sched):
    def fn(i):
        x, y = sched.global_batch(i)
        return {"x": x, "y": y}
    return fn


def _state_np(state):
    return dict(params={n: _np(p) for n, p in state.params.items()},
                slots={k: {n: _np(t) for n, t in v.items()}
                       for k, v in state.opt_state["slots"].items()},
                step=int(state.step), opt_step=int(state.opt_state["step"]),
                rng=np.asarray(state.rng).copy())


def elastic(rank, world, spec):
    """The elastic supervisor's cases in a world of ``world`` ranks, one
    dp worker a rank (``MeshConfig(dp=world)``)."""
    from hetu_tpu_torch.parallel import MeshConfig, make_mesh
    from hetu_tpu_torch.resilience import (
        CheckpointManager, FaultEvent, FaultInjector, FaultSchedule,
        Supervisor,
    )
    from hetu_tpu_torch.resilience.elastic import (
        ElasticReshardError, ElasticSupervisor,
    )
    from hetu_tpu_torch.telemetry import trace
    from hetu_tpu_torch.train import checkpoint as ckpt
    cfg = MeshConfig(dp=world)
    out = {}

    # 4 -> 3 -> 4 against a fault-free run on the same schedule
    sched = _sched(spec)
    faults = FaultSchedule.generate(**spec["faults"])
    out["schedule_json"] = faults.to_json()
    model, ex, st = _elastic_problem(spec)
    sup = ElasticSupervisor(ex, config=cfg, device="cpu", schedule=sched,
                            injector=FaultInjector(faults),
                            model_config=model)
    tr = trace.enable()
    try:
        rep = sup.run(st, _batch_fn(sched), spec["steps"])
    finally:
        trace.disable()
    names = [e["name"] for e in tr.events]
    state = rep.state
    tensors = list(state.params.values()) + [
        t for v in state.opt_state["slots"].values() for t in v.values()]
    out["434"] = dict(
        spans={n: names.count(n) for n in (
            "elastic.reshard", "elastic.snapshot", "elastic.remesh",
            "elastic.broadcast", "elastic.replace")},
        # the state lives on the current mesh, in the model's own tensors
        meshes=sorted({tuple(t.device_mesh.mesh.flatten().tolist())
                       for t in tensors}),
        own=all(p is q for p, q in zip(state.params.values(),
                                       model.parameters())),
        downtime_last=rep.counters.get("resize_downtime_s_last"),
        resizes=[(e.kind, e.worker, e.width, e.step, e.alive)
                 for e in sup.resizes],
        downtime=[e.downtime_s for e in sup.resizes],
        counters={k: rep.counters.get(k) for k in (
            "worker_losses_injected", "worker_joins_injected",
            "elastic_width", "resizes", "resizes_shrink", "resizes_grow")},
        step=rep.step, state=_state_np(rep.state),
        config_is_mesh=sup.config is cfg,
        manager_config_is_model=(sup.manager is None or
                                 sup.manager.config is model))
    _, ex0, st0 = _elastic_problem(spec, make_mesh(cfg, device="cpu"))
    rep0 = Supervisor(ex0).run(st0, _batch_fn(sched), spec["steps"])
    out["fault_free"] = _state_np(rep0.state)

    # every worker lost: raises on every rank
    model, ex, st = _elastic_problem(spec)
    lose_all = FaultSchedule([FaultEvent(1, "worker_loss", float(w))
                              for w in range(world)])
    sup = ElasticSupervisor(ex, config=cfg, device="cpu",
                            injector=FaultInjector(lose_all))
    zeros = {"x": np.zeros((8, 6), np.float32),
             "y": np.zeros((8, 3), np.float32)}
    try:
        sup.run(st, lambda i: zeros, 4)
        out["all_lost"] = None
    except ElasticReshardError as e:
        out["all_lost"] = str(e)

    # fixed_per_worker: a shrink rescales the gradient by nominal/width
    model, ex, st = _elastic_problem(spec)
    sup = ElasticSupervisor(
        ex, config=cfg, device="cpu", data_mode="fixed_per_worker",
        injector=FaultInjector(FaultSchedule([FaultEvent(1, "worker_loss",
                                                         0.0)])))

    def per_worker(i):
        w = sup.width
        return {"x": np.zeros((4 * w, 6), np.float32),
                "y": np.zeros((4 * w, 3), np.float32)}
    rep = sup.run(st, per_worker, 3)
    out["per_worker"] = dict(step=rep.step, scale=ex.grad_scale,
                             trained=sup._trains_here(),
                             rank_of=[sup.rank_of(w) for w in
                                      range(1, world)])
    try:
        sup.rank_of(0)
        out["per_worker"]["lost_rank_of"] = None
    except ElasticReshardError as e:
        out["per_worker"]["lost_rank_of"] = str(e)

    # min_width: a loss below it refuses to reform the mesh
    model, ex, st = _elastic_problem(spec)
    sup = ElasticSupervisor(
        ex, config=cfg, device="cpu", min_width=world,
        injector=FaultInjector(FaultSchedule([FaultEvent(1, "worker_loss",
                                                         1.0)])))
    try:
        sup.run(st, lambda i: zeros, 3)
        out["min_width"] = None
    except ElasticReshardError as e:
        out["min_width"] = str(e)

    # guard evidence only this rank's guards see
    class FakeGuard:
        _pending = {1}

        def poll(self):
            return 0

        def snapshot(self):
            return 0
    model, ex, st = _elastic_problem(spec)
    g = np.random.default_rng(0)
    batch = {"x": g.standard_normal((12, 6)).astype(np.float32),
             "y": g.standard_normal((12, 3)).astype(np.float32)}
    guards = [FakeGuard()] if rank == spec["guard_rank"] else []
    sup = ElasticSupervisor(ex, config=cfg, device="cpu", guards=guards,
                            shard_workers={1: world - 1}, fail_threshold=3)
    rep = sup.run(st, lambda i: batch, 6)
    out["guard"] = dict(step=rep.step, resizes=[
        (e.kind, e.worker, e.width, e.step) for e in sup.resizes],
        width=sup.width)

    # a checkpoint taken at width 3 restores at width 4
    ckdir = spec["ckpt_dir"]
    model, ex, st = _elastic_problem(spec)
    sup1 = ElasticSupervisor(
        ex, config=cfg, device="cpu", schedule=sched, ckpt_dir=ckdir,
        ckpt_every=2, model_config=model,
        injector=FaultInjector(FaultSchedule([FaultEvent(1, "worker_loss",
                                                         2.0)])))
    sup1.run(st, _batch_fn(sched), 6)
    newest = CheckpointManager(ckdir).steps()[-1]
    hdr = ckpt.read_header(f"{ckdir}/ckpt-{newest:08d}.npz")
    model, ex, st = _elastic_problem(spec)
    sup2 = ElasticSupervisor(ex, config=cfg, device="cpu", schedule=sched,
                             ckpt_dir=ckdir, ckpt_every=2,
                             model_config=model)
    rep2 = sup2.run(st, _batch_fn(sched), 10)
    out["ckpt"] = dict(width1=sup1.width, newest=newest,
                       extra=hdr["extra"],
                       resumed=rep2.counters.get("resumed_from_step"),
                       step=rep2.step, width2=sup2.width,
                       mesh_dp=dict(zip(ex.mesh.mesh_dim_names,
                                        ex.mesh.shape))["dp"])
    return out


# ------------------------------------------------------------- pipedream

def _tanh_block(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _layers(case):
    return {k: torch.tensor(v) for k, v in case["layers"].items()}


def pipedream(rank, world, spec):
    """``PipeDream1F1B`` at pp = world on the tanh block: each case's
    outputs (loss), and this rank's stage gradients; a training case's
    losses over Adam steps."""
    from hetu_tpu_torch.optim import AdamOptimizer
    from hetu_tpu_torch.parallel.pipedream import PipeDream1F1B
    mesh = _mesh(pp=world)
    out = {}
    for cid, case in spec["cases"].items():
        pipe = PipeDream1F1B(_tanh_block, mesh, n_microbatches=case["M"])
        stage = pipe.local_stage(pipe.stack_params(_layers(case)))
        h = torch.tensor(case["h"])
        if case["kind"] == "direct":
            y, grads = pipe.forward_and_grad(stage, h,
                                             torch.tensor(case["cot"]))
            out[cid] = dict(y=_np(y), grads={k: _np(v)
                                             for k, v in grads.items()})
        elif case["kind"] == "loss":
            target = torch.tensor(case["y"])
            loss, grads = pipe.value_and_grad(
                stage, h, lambda o: ((o - target) ** 2).mean())
            out[cid] = dict(loss=float(loss),
                            grads={k: _np(v) for k, v in grads.items()})
        else:  # train
            target = torch.tensor(case["y"])
            params = {k: v.clone() for k, v in stage.items()}
            opt = AdamOptimizer(case["lr"])
            state = opt.init_state(params)
            losses = []
            for _ in range(case["steps"]):
                loss, grads = pipe.value_and_grad(
                    params, h, lambda o: ((o - target) ** 2).mean())
                params, state = opt.update(grads, state, params)
                losses.append(float(loss))
            out[cid] = dict(losses=losses,
                            params={k: _np(v) for k, v in params.items()})
    return out


# --------------------------------------------------------------- hetpipe

def _table(spec, stacked, create, lr, optimizer="sgd"):
    from hetu_tpu_torch.parallel.hetpipe import make_weight_table
    return make_weight_table(stacked, optimizer=optimizer, lr=lr,
                             remote=("127.0.0.1", spec["port"]),
                             table_id=spec["table_id"], create=create)


def _shared_table(spec, stacked, lr, first: bool, group=None):
    """One van table for the ranks of ``group`` (all of the world by
    default): ``first`` creates it, the others attach once it exists."""
    import torch.distributed as dist
    t = _table(spec, stacked, True, lr) if first else None
    dist.barrier(group=group)
    return t if first else _table(spec, stacked, False, lr)


def hetpipe(rank, world, spec):
    """``HetPipeWorker`` cases: one virtual worker at pp = world (every
    wave synced, or every other), and a staleness trip against a peer
    that never clocks; each case's losses and this rank's stage
    parameters (as their flat table rows)."""
    import torch.distributed as dist

    from hetu_tpu_torch.parallel.hetpipe import (
        HetPipeWorker, flatten_params,
    )
    from hetu_tpu_torch.parallel.pipedream import PipeDream1F1B
    from hetu_tpu_torch.ps.van import RemoteSSP
    mesh = _mesh(pp=world)
    out = {}
    for cid, case in spec["cases"].items():
        pipe = PipeDream1F1B(_tanh_block, mesh, n_microbatches=case["M"])
        stacked = pipe.stack_params(_layers(case))
        cspec = dict(spec, table_id=case["table_id"])
        table = _shared_table(cspec, stacked, case["lr"], rank == 0)
        ssp = None
        if case.get("ssp_id") is not None:
            ssp = RemoteSSP("127.0.0.1", spec["port"], case["ssp_id"], 2,
                            case["staleness"])
        worker = HetPipeWorker(pipe, stacked, table, publish_init=True,
                               sync_every=case["sync_every"],
                               local_lr=case.get("local_lr", 0.01),
                               ssp=ssp, ssp_timeout_ms=50)
        h = torch.tensor(case["h"])
        target = torch.tensor(case["y"])

        def lf(o):
            return ((o - target) ** 2).mean()
        res = dict(losses=[], params=[], server=[], rows=worker.rows.copy(),
                   error=None)
        for _ in range(case["waves"]):
            try:
                res["losses"].append(worker.step(h, lf))
            except RuntimeError as e:
                res["error"] = str(e)
                break
            res["params"].append(flatten_params(worker.params))
            res["server"].append(np.asarray(
                table.sparse_pull(worker.rows), np.float32).ravel())
        dist.barrier()
        out[cid] = res
        table.close()
        if ssp is not None:
            ssp.close()
    return out


def hetpipe_two_workers(rank, world, spec):
    """Two virtual workers (dp = 2 × pp = 2) share one van table and a
    ``RemoteSSP``: each worker's losses, and both clocks at the end."""
    import torch.distributed as dist

    from hetu_tpu_torch.parallel.hetpipe import HetPipeWorker
    from hetu_tpu_torch.parallel.pipedream import PipeDream1F1B
    from hetu_tpu_torch.ps.van import RemoteSSP
    mesh = _mesh(dp=2, pp=2)
    dp_rank = dict(zip(mesh.mesh_dim_names,
                       mesh.get_coordinate()))["dp"]
    pipe = PipeDream1F1B(_tanh_block, mesh, n_microbatches=spec["M"])
    stacked = pipe.stack_params(_layers(spec))
    table = _shared_table(spec, stacked, spec["lr"], rank == 0)
    ssp = RemoteSSP("127.0.0.1", spec["port"], spec["ssp_id"], 2,
                    spec["staleness"])
    worker = HetPipeWorker(pipe, stacked, table,
                           publish_init=dp_rank == 0, sync_every=1,
                           worker_id=dp_rank, ssp=ssp,
                           ssp_timeout_ms=60_000)
    dist.barrier()  # the table is whole before worker 1 pulls
    if dp_rank == 1:
        worker.pull_weights()
    h = torch.tensor(spec["h"][dp_rank])
    target = torch.tensor(spec["y"][dp_rank])
    losses = [worker.step(h, lambda o: ((o - target) ** 2).mean())
              for _ in range(spec["waves"])]
    dist.barrier()
    clocks = [ssp.clock(0), ssp.clock(1)]
    dist.barrier()
    table.close()
    ssp.close()
    return dict(worker=dp_rank, losses=losses, clocks=clocks)
