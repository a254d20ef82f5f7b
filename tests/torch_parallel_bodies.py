"""Rank bodies of the port's data- and tensor-parallel tests.

Each function runs in every rank process of a ``gloo`` world started by
``hetu_tpu_torch.parallel.ranks.run`` from a ``tests/test_torch_parallel_*``
file.  This module imports neither ``jax`` nor ``hetu_tpu`` (the rank
processes load only it and the port); the test files build the JAX
references in their own process and compare."""

from __future__ import annotations

import sys

import numpy as np
import torch


def run_cases(rank, world, cases):
    """Every case of ``cases`` (``{id: (function name, spec)}``) in turn;
    ``{id: result}``, and whether jax was loaded in this rank."""
    out = {}
    for cid, (name, spec) in cases.items():
        out[cid] = globals()[name](rank, world, spec)
    out["_jax_loaded"] = "jax" in sys.modules or any(
        m == "hetu_tpu" or m.startswith("hetu_tpu.") for m in sys.modules)
    return out


def _whole(t):
    t = t.detach()
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    return t.float().numpy().copy()


def _placement(t):
    return str(tuple(t.placements)) if hasattr(t, "placements") else ""


def _mesh(spec):
    from hetu_tpu_torch.parallel import make_mesh
    return make_mesh(device="cpu", **spec["mesh"]) if spec.get("mesh") \
        else None


def _gpt(spec):
    from hetu_tpu_torch.models import GPTConfig, GPTModel
    cfg = GPTConfig(**spec["cfg"])
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict({k: torch.tensor(v)
                           for k, v in spec["params"].items()})
    return model


class Zero1:
    """A ZeRO-1 strategy: parameters replicated, optimizer slots split
    over dp on dim 0 where it divides."""

    def __new__(cls):
        from hetu_tpu_torch.parallel.spec import P
        from hetu_tpu_torch.parallel.strategies import DataParallel

        class _Zero1(DataParallel):
            def slot_spec(self, path, leaf):
                return P("dp")
        return _Zero1()


def _strategy(name):
    if name is None:
        return None
    if name == "zero1":
        return Zero1()
    from hetu_tpu_torch.parallel import strategies
    return getattr(strategies, name)()


def _optimizer(opt):
    from hetu_tpu_torch import optim
    kind, lr = opt[0], opt[1]
    if kind == "sgd":
        return optim.SGDOptimizer(lr)
    if kind == "adam":
        return optim.AdamOptimizer(lr, eps=opt[2] if len(opt) > 2 else 1e-7)
    raise ValueError(kind)


def train_gpt(rank, world, spec):
    """Train the port's GPT from ``spec["params"]`` on ``spec["batches"]``;
    losses, whole parameters (and slots), their placements."""
    from hetu_tpu_torch.train import Executor, checkpoint
    torch.manual_seed(0)
    model = _gpt(spec)
    mesh = _mesh(spec)
    ex = Executor(model.lm_loss_fn(), _optimizer(spec["opt"]), mesh=mesh,
                  dist_strategy=_strategy(spec.get("strategy")),
                  grad_sync=spec.get("grad_sync", "exact"), seed=0)
    state = ex.init_state(model)
    if spec.get("load"):
        state = checkpoint.load(spec["load"], state, model.c)
    losses = []
    for ids in spec["batches"]:
        state, m = ex.run("train", state, (torch.tensor(ids),))
        losses.append(float(m["loss"]))
    if spec.get("save"):
        checkpoint.save(spec["save"], state, model.c)
    out = dict(losses=losses,
               params={n: _whole(p) for n, p in state.params.items()},
               placements={n: _placement(p)
                           for n, p in state.params.items()})
    if state.opt_state:
        out["slot_placements"] = {
            k: {n: _placement(t) for n, t in v.items()}
            for k, v in state.opt_state["slots"].items()}
        out["slots"] = {k: {n: _whole(t) for n, t in v.items()}
                        for k, v in state.opt_state["slots"].items()}
    return out


def train_resnet(rank, world, spec):
    """ResNet-18 (``spec["params"]``/``spec["state"]``) under
    ``spec["strategy"]``: its losses."""
    from hetu_tpu_torch.models import ResNet18
    from hetu_tpu_torch.train import Executor
    model = ResNet18(num_classes=10, device="cpu")
    sd = {k: torch.tensor(v) for k, v in spec["params"].items()}
    sd.update({k: torch.tensor(v) for k, v in spec["state"].items()})
    model.load_state_dict(sd, strict=False)
    ex = Executor(model.loss_fn(), _optimizer(spec["opt"]),
                  mesh=_mesh(spec),
                  dist_strategy=_strategy(spec.get("strategy")), seed=0)
    state = ex.init_state(model)
    losses = []
    for x, y in spec["batches"]:
        state, m = ex.run("train", state, (torch.tensor(x), torch.tensor(y)))
        losses.append(float(m["loss"]))
    return dict(losses=losses, placements={
        n: _placement(p) for n, p in state.params.items()})


def vocab_ce(rank, world, spec):
    """``lm_head_cross_entropy`` on a table split over tp by vocabulary
    rows (MegatronLM's ``tok_emb``) and rows whole on every rank: the
    loss, the whole gradients, and the placement of the table's."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from hetu_tpu_torch import ops
    from hetu_tpu_torch.parallel.mesh import active_mesh
    mesh = active_mesh(_mesh(spec))
    h = distribute_tensor(torch.tensor(spec["h"]), mesh, [Replicate()],
                          src_data_rank=None).requires_grad_(True)
    w = distribute_tensor(torch.tensor(spec["w"]), mesh, [Shard(0)],
                          src_data_rank=None).requires_grad_(True)
    y = distribute_tensor(torch.tensor(spec["labels"]), mesh, [Replicate()],
                          src_data_rank=None)
    loss = ops.lm_head_cross_entropy(h, w, y, row_chunk=spec["row_chunk"])
    loss.full_tensor().backward()
    return dict(loss=float(loss.full_tensor()), gh=_whole(h.grad),
                gw=_whole(w.grad), w_grad=_placement(w.grad),
                w_local_rows=int(w.to_local().shape[0]))


class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(16, 1))
        self.b = torch.nn.Parameter(torch.zeros(1))


def linear_loss_fn(model):
    def fn(params, state, batch, generator, train):
        pred = batch["x"] @ model.w + model.b
        loss = torch.mean((pred - batch["y"]) ** 2)
        return loss, ({"mse": loss}, state)
    return fn


def grad_sync(rank, world, spec):
    """The reference's ``TestExecutorGradSync`` regression over dp: every
    step's loss, the final parameters, and the grad-sync byte counters'
    growth."""
    from hetu_tpu_torch import optim
    from hetu_tpu_torch.telemetry import default_registry as reg
    from hetu_tpu_torch.train import Executor
    gs = spec["grad_sync"]
    if gs == "per_param":
        def gs(p):
            return "int8" if "w" in p else "f32"
    model = _Linear()
    ex = Executor(linear_loss_fn(model), optim.SGDOptimizer(0.1),
                  mesh=_mesh(spec), grad_sync=gs)
    st = ex.init_state(model)
    batch = {k: torch.tensor(v) for k, v in spec["batch"].items()}
    c0 = reg.counter("train.grad_sync.bytes_wire").value
    losses = []
    for _ in range(spec["steps"]):
        st, m = ex.run("train", st, batch)
        losses.append(float(m["loss"]))
    return dict(loss=losses[-1], losses=losses,
                params={n: _whole(p) for n, p in st.params.items()},
                wire=reg.counter("train.grad_sync.bytes_wire").value - c0)


def collectives(rank, world, spec):
    """Each collective on this rank's block of ``spec["x"]`` (dim 0 split
    over the ranks): the output and the gradient of ``sum(out * w)``."""
    from hetu_tpu_torch.parallel import collectives as C
    from hetu_tpu_torch.parallel import make_mesh
    mesh = make_mesh(device="cpu", **spec["mesh"])
    out = {}
    for cid, (name, kw, xg, wg) in spec["cases"].items():
        x = torch.tensor(np.split(xg, world)[rank]).requires_grad_(True)
        fn = getattr(C, name)
        if name == "grouped_allreduce":
            y = fn(mesh, kw["axis"])(x)
        else:
            y = fn(x, mesh=mesh, **kw)
        w = torch.tensor(np.split(wg, world)[rank]) if wg is not None \
            else None
        g = None
        if w is not None:
            (g,) = torch.autograd.grad((y * w.reshape(y.shape)).sum(), x)
            g = g.numpy()
        out[cid] = (y.detach().numpy(), g)
    out["staged"] = dict(C.STAGED)
    return out


def spec_counts(rank, world, spec):
    """For each ``(src, dst)`` spec pair: the collectives DTensor's
    ``redistribute`` issues, counted under ``CommDebugMode``, and whether
    the values survived."""
    from torch.distributed.tensor.debug import CommDebugMode

    from hetu_tpu_torch.parallel import make_mesh
    from hetu_tpu_torch.parallel.mesh import active_mesh
    from hetu_tpu_torch.parallel.spec import ShardSpec
    mesh = make_mesh(device="cpu", **spec["mesh"])
    am = active_mesh(mesh)
    out = {}
    for cid, (src, dst) in spec["cases"].items():
        src, dst = ShardSpec(*src), ShardSpec(*dst)
        full = torch.arange(16.0).reshape(4, 4)
        from torch.distributed.tensor import distribute_tensor
        x = distribute_tensor(full, am, ShardSpec(src.dims).placements(mesh),
                              src_data_rank=None)
        if src.partial:
            from torch.distributed.tensor import DTensor
            x = DTensor.from_local(x.to_local() / 2.0, am,
                                   src.placements(mesh))
        cm = CommDebugMode()
        with cm:
            y = x.redistribute(am, dst.placements(mesh))
        counts = {str(k).split(".")[-1]: v
                  for k, v in cm.get_comm_counts().items()}
        out[cid] = (counts, bool(torch.equal(y.full_tensor(), full)))
    return out


def serve(rank, world, spec):
    """Greedy tokens of the port's engine over ``spec["params"]`` on a tp
    mesh."""
    from hetu_tpu_torch.models import (
        GPTConfig, GPTModel, LlamaConfig, LlamaModel,
    )
    from hetu_tpu_torch.serve import (
        ContinuousBatchingScheduler, PagedServeEngine, Request, ServeEngine,
    )
    mesh = _mesh(spec)
    if spec["model"] == "llama":
        model = LlamaModel(LlamaConfig(**spec["cfg"]), device="cpu")
    else:
        model = GPTModel(GPTConfig(**spec["cfg"]), device="cpu")
    model.load_state_dict({k: torch.tensor(v)
                           for k, v in spec["params"].items()})
    kw = dict(spec["engine"])
    engine = (PagedServeEngine if kw.pop("paged") else ServeEngine)(
        model, device="cpu", mesh=mesh, **kw)
    sched = ContinuousBatchingScheduler(engine)
    req = Request(prompt=list(spec["prompt"]), max_tokens=spec["n"])
    sched.submit(req)
    while sched.has_work():
        sched.step()
    return dict(tokens=list(req.tokens),
                cache_heads=int(engine.cache.k.shape[-2]))


def mesh_helpers(rank, world, spec):
    """``local_mesh``, ``elastic_mesh`` and ``constrain`` in a world of
    4: the shapes and placements each rank sees."""
    from torch.distributed.tensor import distribute_tensor

    from hetu_tpu_torch.parallel import MeshConfig, elastic_mesh, local_mesh
    from hetu_tpu_torch.parallel.mesh import active_mesh
    from hetu_tpu_torch.parallel.spec import ShardSpec, constrain
    loc = local_mesh("dp", device="cpu")
    el = elastic_mesh(MeshConfig(dp=2, tp=2), [1], device="cpu")
    full = torch.arange(32.0).reshape(8, 4)
    a = constrain(full, loc, ShardSpec(dims=("dp", None)))
    b = constrain(a, loc, ShardSpec.replicated(2))
    return dict(local=dict(zip(loc.mesh_dim_names, loc.shape)),
                elastic=None if el is None else dict(
                    zip(el.mesh_dim_names, el.shape)),
                elastic_ranks=None if el is None else el.mesh.flatten()
                .tolist(),
                a=(str(tuple(a.placements)), a.to_local().numpy().copy()),
                b=(str(tuple(b.placements)), b.to_local().numpy().copy()))
