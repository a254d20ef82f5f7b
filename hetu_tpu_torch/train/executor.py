"""Executor — the training engine (counterpart of
``hetu_tpu/train/executor.py``).

Named subexecutors over one :class:`TrainState`: ``"train"`` (loss,
gradients by autograd, optimizer update), ``"train_guarded"`` (the same,
keeping the pre-step parameters and optimizer state when the loss or a
parameter comes out non-finite) and ``"validate"`` (the loss without
gradients).  PyTorch runs eagerly, so where the reference traces and
compiles one function per name, the port calls the step directly.

The model owns its parameters and its state: ``TrainState.params`` holds
the model's own tensors and the optimizer writes them in place (the
reference returns new arrays and donates the old);
``TrainState.model_state`` holds the model's own state buffers (the batch
norms' running statistics), which a train step's forward writes in place.

Spans: ``train.host_to_device`` around moving the batch to the
parameters' device, ``train.step.<name>`` around the step.  Kernels run
asynchronously, so while tracing is on the step span ends with a device
synchronisation; with tracing off nothing synchronises.

On a mesh (:func:`~hetu_tpu_torch.parallel.make_mesh`, one process a rank)
every rank runs the same calls with the same global batch.
:meth:`Executor.init_state` makes the model's parameters DTensors, placed
by ``dist_strategy`` (replicated without one) and the optimizer slots by
its ``slot_spec`` (ZeRO-1 shards them over dp); each rank keeps its piece
of the batch's dim 0 over ``dp_axis``.  With ``grad_sync="exact"`` the loss
is the global batch's (DTensor sums and counts across the shards) and
each gradient is reduced to its parameter's placement (the reference's
SPMD psum).  With ``"int8"``/``"bf16"`` (or a callable choosing per
parameter) the parameters stay plain replicated tensors, the loss runs on
each rank's own shard, and every gradient crosses
:func:`~hetu_tpu_torch.parallel.collectives.quantized_pmean` over dp: the
reference's ``shard_map`` step, per shard by contract.  The profiler
option belongs to the profiler slice and is refused here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from hetu_tpu_torch import rng as hrng
from hetu_tpu_torch.layers.base import state_buffers
from hetu_tpu_torch.optim.optimizer import Optimizer
from hetu_tpu_torch.parallel.spec import is_dtensor, mesh_context
from hetu_tpu_torch.telemetry import trace

_SUBEXECUTORS = ("train", "train_guarded", "validate")


def gradients(loss_fn: Callable, argnums=0, has_aux: bool = False):
    """The reference's ``gradients``: reverse-mode autodiff of a scalar
    loss, ``torch.func.grad`` (the same ``argnums`` and ``has_aux``)."""
    return torch.func.grad(loss_fn, argnums=argnums, has_aux=has_aux)

_STEP_SPAN = {name: "train.step." + name for name in _SUBEXECUTORS}


@dataclass
class TrainState:
    """Carried training state.

    params: name → the model's own parameters (float32 master weights),
        updated in place by each train step.
    opt_state: ``{"step": int, "slots": {slot: {name: f32 tensor}}}``, or
        ``{}`` without an optimizer.
    rng: two uint32 words from which each step's dropout generator is
        derived together with ``step`` (the slot of the reference's PRNG
        key, saved in its place in a checkpoint).
    step: train steps taken, skipped guarded steps included.
    model_state: name → the model's own state buffers (float32), updated
        in place by each train step; ``{}`` for a model without state.
    """

    params: dict
    opt_state: dict
    rng: np.ndarray
    step: int = 0
    model_state: dict = field(default_factory=dict)


class Executor:
    """``loss_fn(params, model_state, batch, generator, train) -> (loss,
    (metrics_dict, new_model_state))``, as the reference's, with a
    ``torch.Generator`` in place of its PRNG key.

    Usage::

        ex = Executor(model.lm_loss_fn(), AdamWOptimizer(1e-4), seed=0)
        state = ex.init_state(model)
        state, metrics = ex.run("train", state, (input_ids,))
        metrics = ex.run("validate", state, (input_ids,))
    """

    def __init__(self, loss_fn: Callable,
                 optimizer: Optional[Optimizer] = None, *,
                 mesh: Any = None, dp_axis: str = "dp",
                 param_sharding: Optional[dict] = None,
                 dist_strategy: Any = None, grad_sync: Any = "exact",
                 grad_sync_block: int = 256, seed: Optional[int] = None):
        """``mesh``: a ``DeviceMesh`` from ``parallel.make_mesh``;
        ``dist_strategy``: a ``parallel.strategies.Strategy`` placing the
        parameters and slots (needs a mesh); ``param_sharding``: name ->
        placements, for the parameters it names, without a strategy;
        ``grad_sync``: ``"exact"`` (default), ``"int8"``, ``"bf16"`` or a
        callable ``name -> wire`` for the data-parallel gradient sync,
        ``grad_sync_block`` the int8 block (one f32 scale a block).
        Quantized sync needs a mesh and replicated parameters."""
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.mesh = mesh
        self.dp_axis = dp_axis
        self.param_sharding = param_sharding
        self.dist_strategy = dist_strategy
        if dist_strategy is not None and mesh is None:
            raise ValueError("dist_strategy requires a mesh")
        if isinstance(grad_sync, str) and grad_sync not in (
                "exact", "f32", "bf16", "int8"):
            raise ValueError(f"unknown grad_sync {grad_sync!r}; expected "
                             f"'exact'/'f32'/'bf16'/'int8' or a callable")
        self.grad_sync = grad_sync
        self.grad_sync_block = int(grad_sync_block)
        if self._quant_sync():
            if mesh is None:
                raise ValueError("quantized grad_sync requires a mesh")
            if dist_strategy is not None or param_sharding is not None:
                raise ValueError(
                    "quantized grad_sync supports replicated parameters "
                    "only (plain data parallelism); it cannot combine "
                    "with dist_strategy/param_sharding")
        self._grad_sync_bytes = None  # (logical, wire) per step, lazy
        self.grad_scale = 1.0
        self.model = None  # the model init_state placed its state on
        if seed is not None:
            hrng.set_random_seed(seed)

    def set_mesh(self, mesh: Any) -> None:
        """Point the executor at a (re)formed mesh.  The caller places the
        live state on it (``dist_strategy.place`` or
        :func:`~hetu_tpu_torch.train.checkpoint.load` into a placed
        template) before the next :meth:`run`."""
        self.mesh = mesh

    def _quant_sync(self) -> bool:
        return callable(self.grad_sync) or self.grad_sync in ("int8",
                                                              "bf16")

    def _wire_for(self, name: str) -> str:
        gs = self.grad_sync
        return gs(name) if callable(gs) else gs

    def set_grad_scale(self, scale: float) -> None:
        """Multiply every gradient by ``scale`` before the optimizer
        update, from the next step on (1.0: no product)."""
        self.grad_scale = float(scale)

    def init_state(self, model: nn.Module) -> TrainState:
        """The state over ``model``'s own parameters and state buffers
        (:func:`~hetu_tpu_torch.layers.base.state_buffers`), with fresh
        optimizer slots on their device and rng words drawn from the global
        (seed, seqnum) stream.  The executor keeps ``model`` (a reshard of
        the elastic supervisor rebinds its parameters)."""
        self.model = model
        if self.mesh is not None and not self._quant_sync():
            _place(model, self.mesh, self.dist_strategy,
                   self.param_sharding)
        params = dict(model.named_parameters())
        opt_state = (self.optimizer.init_state(params)
                     if self.optimizer is not None else {})
        if self.dist_strategy is not None and opt_state:
            # slots follow slot_spec: under ZeRO-1 they shard over dp
            # while the parameters they mirror stay replicated
            from hetu_tpu_torch.parallel.mesh import active_mesh
            slot_sh = self.dist_strategy.slot_shardings(params, self.mesh)
            opt_state["slots"] = {
                k: {n: t.redistribute(active_mesh(self.mesh), slot_sh[n])
                    for n, t in v.items()}
                for k, v in opt_state["slots"].items()}
        return TrainState(params=params, opt_state=opt_state,
                          rng=hrng.np_rng().integers(0, 2 ** 32, 2,
                                                     dtype=np.uint32),
                          model_state=state_buffers(model))

    def run(self, name: str, state: TrainState, batch):
        """One step of subexecutor ``name``: ``(new_state, metrics)`` for
        the train steps, ``metrics`` for ``"validate"``.  Metric values are
        tensors on the device (reading one synchronises)."""
        if name not in _STEP_SPAN:
            raise KeyError(f"unknown subexecutor {name!r}; expected one of "
                           f"{list(_SUBEXECUTORS)}")
        if name != "validate" and self.optimizer is None:
            raise ValueError(f"{name} subexecutor needs an optimizer")
        device = next(iter(state.params.values())).device
        if self._quant_sync() and name != "validate":
            self._record_grad_sync_bytes(state)
        with trace.span("train.host_to_device"):
            batch = _device_batch(batch, device)
            if self.mesh is not None:
                batch = _shard_batch(batch, self.mesh, self.dp_axis,
                                     local=self._quant_sync())
        with trace.span(_STEP_SPAN[name]), mesh_context(self.mesh):
            if name == "train":
                out = self._train_step(state, batch)
            elif name == "train_guarded":
                out = self._train_step_guarded(state, batch)
            else:
                out = self._eval_step(state, batch)
            if trace.enabled() and device.type == "cuda":
                torch.cuda.synchronize(device)
            return out

    def _record_grad_sync_bytes(self, state: TrainState) -> None:
        """One step's gradient-sync traffic on the
        ``train.grad_sync.bytes_logical`` / ``bytes_wire`` counters of
        ``telemetry.default_registry`` (sizes are static: computed once)."""
        from hetu_tpu_torch.quantwire import (block_wire_bytes,
                                              record_wire_bytes)
        from hetu_tpu_torch.telemetry import default_registry
        if self._grad_sync_bytes is None:
            logical = wire = 0
            for n, p in state.params.items():
                w = self._wire_for(n)
                logical += p.numel() * 4
                wire += block_wire_bytes(p.numel(),
                                         "f32" if w == "exact" else w,
                                         self.grad_sync_block)
            self._grad_sync_bytes = (logical, wire)
        record_wire_bytes(default_registry, "train.grad_sync",
                          *self._grad_sync_bytes)

    def save(self, path, state: TrainState, config, *,
             extra: Optional[dict] = None) -> None:
        """:func:`~hetu_tpu_torch.train.checkpoint.save` of ``state`` (the
        model of ``config``), with the global (seed, seqnum)."""
        from hetu_tpu_torch.train import checkpoint
        checkpoint.save(path, state, config, extra=extra)

    def load(self, path, state: TrainState, config) -> TrainState:
        """:func:`~hetu_tpu_torch.train.checkpoint.load` into ``state``'s
        own tensors."""
        from hetu_tpu_torch.train import checkpoint
        return checkpoint.load(path, state, config)

    def profile(self, *args, **kwargs):
        raise NotImplementedError(
            "Executor.profile belongs to the profiler slice of "
            "hetu_tpu_torch, which is not ported yet")

    # ---- steps ----
    def _step_generator(self, state: TrainState, device) -> torch.Generator:
        """This step's dropout generator: seeded from the state's rng words
        and its step, as the reference folds the step into its key."""
        return torch.Generator(device=device).manual_seed(
            hrng.derive_seed(*(int(w) for w in state.rng), state.step))

    def _train_step(self, state: TrainState, batch):
        params = state.params
        device = next(iter(params.values())).device
        loss, (metrics, model_state) = self.loss_fn(
            params, state.model_state, batch,
            self._step_generator(state, device), True)
        # a parameter the loss does not reach gets zeros, as under jax.grad
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()), allow_unused=True,
            materialize_grads=True)))
        if self.mesh is not None:
            if self._quant_sync():
                loss, metrics, model_state, grads = self._quant_reduce(
                    loss, metrics, model_state, grads)
            else:
                # the exact sync: each gradient reduced to its parameter's
                # placement (an all-reduce of a replicated parameter's
                # partial sums, a reduce-scatter of a sharded one's)
                grads = {n: g.redistribute(params[n].device_mesh,
                                           params[n].placements)
                         for n, g in grads.items()}
        if self.grad_scale != 1.0:
            grads = {n: g * self.grad_scale for n, g in grads.items()}
        params, opt_state = self.optimizer.update(grads, state.opt_state,
                                                  params)
        metrics = _whole(dict(metrics))
        metrics["loss"] = _whole(loss.detach())
        return TrainState(params=params, opt_state=opt_state, rng=state.rng,
                          step=state.step + 1,
                          model_state=model_state), metrics

    def _quant_reduce(self, loss, metrics, model_state, grads):
        """The quantized step's reductions over dp: every gradient through
        ``quantized_pmean`` in its wire dtype; the loss and float metrics
        ``pmean``, integer metrics ``psum`` (counts); float model state
        ``pmean`` (written in place), other model state as the rank has
        it."""
        from hetu_tpu_torch.parallel.collectives import (pmean, psum,
                                                         quantized_pmean)
        dp, mesh = self.dp_axis, self.mesh
        grads = {n: quantized_pmean(g, dp, wire=self._wire_for(n),
                                    block=self.grad_sync_block, mesh=mesh)
                 for n, g in grads.items()}

        def red(v):
            if not isinstance(v, torch.Tensor) or v.dtype == torch.bool:
                return v
            if v.is_floating_point():
                return pmean(v.detach(), dp, mesh=mesh)
            return psum(v, dp, mesh=mesh)
        with torch.no_grad():
            for t in model_state.values():
                if t.is_floating_point():
                    t.copy_(pmean(t, dp, mesh=mesh))
        return (red(loss), {k: red(v) for k, v in metrics.items()},
                model_state, grads)

    def _train_step_guarded(self, state: TrainState, batch):
        """The train step with a non-finite guard: a poisoned batch or an
        exploding update (NaN/Inf loss or parameters) leaves the pre-step
        parameters, optimizer state and model state in place and reports
        ``metrics["nonfinite"] = 1``.  The step counter still advances, so
        training moves past the batch instead of retrying it.  Costs one
        copy of the parameters, slots and state buffers, and one
        synchronisation."""
        before = _snapshot(state)
        new_state, metrics = self._train_step(state, batch)
        ok = torch.isfinite(metrics["loss"])
        for p in new_state.params.values():
            if p.is_floating_point():
                ok = ok & _whole(torch.isfinite(p).all())
        ok = bool(ok)
        if not ok:
            # the forward and the update wrote the tensors in place: put
            # the copies back, and keep the pre-step optimizer step
            _restore(state, before)
            new_state = TrainState(params=state.params,
                                   opt_state=state.opt_state, rng=state.rng,
                                   step=state.step + 1,
                                   model_state=state.model_state)
        metrics = dict(metrics)
        metrics["nonfinite"] = torch.tensor(int(not ok))
        return new_state, metrics

    def _eval_step(self, state: TrainState, batch):
        with torch.no_grad():
            loss, (metrics, _) = self.loss_fn(state.params, state.model_state,
                                              batch, None, False)
        metrics = _whole(dict(metrics))
        metrics["loss"] = _whole(loss)
        return metrics


def _place(model: nn.Module, mesh, strategy, param_sharding) -> None:
    """Make ``model``'s parameters and state buffers DTensors on ``mesh``:
    the parameters by ``strategy`` (or ``param_sharding``'s placements for
    the parameters it names; replicated otherwise), the state buffers
    replicated."""
    from hetu_tpu_torch.parallel.mesh import host_to_device, replicated
    from hetu_tpu_torch.parallel.strategies import DataParallel, Strategy

    if strategy is None and param_sharding:
        table = dict(param_sharding)

        class _Given(Strategy):
            def shardings(self, params, mesh_):
                return {n: list(table.get(n, replicated(mesh_)))
                        for n in params}
        strategy = _Given()
    (strategy or DataParallel()).place(model, mesh)
    for prefix, m in model.named_modules():
        for n in getattr(m, "state_names", ()):
            buf = getattr(m, n)
            if not is_dtensor(buf):
                setattr(m, n, host_to_device(buf.detach(), mesh,
                                             replicated(mesh)))


def _whole(v):
    """A metric as a plain tensor: a DTensor's whole value (every rank
    holds the same), a dict value by value."""
    if isinstance(v, dict):
        return {k: _whole(x) for k, x in v.items()}
    return v.full_tensor() if is_dtensor(v) else v


def _shard_batch(batch, mesh, dp_axis: str, *, local: bool):
    """The global batch on ``mesh``: each leaf's dim 0 split over
    ``dp_axis`` — as a DTensor (``local=False``), or as this rank's plain
    piece (``local=True``, the quantized step).  Every rank passes the
    same global batch."""
    from hetu_tpu_torch.parallel.mesh import batch_sharding, host_to_device
    dp = dict(zip(mesh.mesh_dim_names, mesh.shape)).get(dp_axis, 1)
    if batch is None:
        return None
    if isinstance(batch, (tuple, list)):
        return type(batch)(_shard_batch(b, mesh, dp_axis, local=local)
                           for b in batch)
    if isinstance(batch, dict):
        return {k: _shard_batch(v, mesh, dp_axis, local=local)
                for k, v in batch.items()}
    if batch.shape[0] % dp:
        raise ValueError(
            f"global batch dim {batch.shape[0]} not divisible by dp={dp}; "
            f"pad or drop the remainder (Dataloader(drop_last=True))")
    if local:
        return batch.chunk(dp)[mesh.get_local_rank(dp_axis)] if dp > 1 \
            else batch
    return host_to_device(batch, mesh, batch_sharding(mesh, dp_axis))


def _tensors(state: TrainState) -> list:
    """The parameters, optimizer slots and state buffers, in a fixed
    order."""
    return list(state.params.values()) + [
        t for d in state.opt_state.get("slots", {}).values()
        for t in d.values()] + list(state.model_state.values())


def _snapshot(state: TrainState) -> list:
    with torch.no_grad():
        return [t.detach().clone() for t in _tensors(state)]


def _restore(state: TrainState, snapshot: list) -> None:
    with torch.no_grad():
        for t, saved in zip(_tensors(state), snapshot):
            t.copy_(saved)


def _device_batch(batch, device):
    """Tensors and numpy arrays of a (nested) tuple, list or dict batch,
    moved to ``device``; ``None`` (an absent part, such as BERT's mask)
    stays ``None``, as an empty leaf of a JAX batch does."""
    if batch is None:
        return None
    if isinstance(batch, (tuple, list)):
        return type(batch)(_device_batch(b, device) for b in batch)
    if isinstance(batch, dict):
        return {k: _device_batch(v, device) for k, v in batch.items()}
    return torch.as_tensor(batch).to(device, non_blocking=True)
