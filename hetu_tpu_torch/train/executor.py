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

The mesh, gradient-sync, distribution-strategy and profiler options of the
reference belong to the multi-GPU and profiler slices of the port and are
refused here.
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
                 seed: Optional[int] = None, mesh: Any = None,
                 dist_strategy: Any = None, grad_sync: Any = "exact"):
        if mesh is not None or dist_strategy is not None \
                or grad_sync != "exact":
            raise NotImplementedError(
                "mesh, dist_strategy and grad_sync belong to the multi-GPU "
                "slice of hetu_tpu_torch, which is not ported yet; the "
                "Executor trains on one device")
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.grad_scale = 1.0
        if seed is not None:
            hrng.set_random_seed(seed)

    def set_grad_scale(self, scale: float) -> None:
        """Multiply every gradient by ``scale`` before the optimizer
        update, from the next step on (1.0: no product)."""
        self.grad_scale = float(scale)

    def init_state(self, model: nn.Module) -> TrainState:
        """The state over ``model``'s own parameters and state buffers
        (:func:`~hetu_tpu_torch.layers.base.state_buffers`), with fresh
        optimizer slots on their device and rng words drawn from the global
        (seed, seqnum) stream."""
        params = dict(model.named_parameters())
        opt_state = (self.optimizer.init_state(params)
                     if self.optimizer is not None else {})
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
        with trace.span("train.host_to_device"):
            batch = _device_batch(batch, device)
        with trace.span(_STEP_SPAN[name]):
            if name == "train":
                out = self._train_step(state, batch)
            elif name == "train_guarded":
                out = self._train_step_guarded(state, batch)
            else:
                out = self._eval_step(state, batch)
            if trace.enabled() and device.type == "cuda":
                torch.cuda.synchronize(device)
            return out

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
        if self.grad_scale != 1.0:
            grads = {n: g * self.grad_scale for n, g in grads.items()}
        params, opt_state = self.optimizer.update(grads, state.opt_state,
                                                  params)
        metrics = dict(metrics)
        metrics["loss"] = loss.detach()
        return TrainState(params=params, opt_state=opt_state, rng=state.rng,
                          step=state.step + 1,
                          model_state=model_state), metrics

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
                ok = ok & torch.isfinite(p).all()
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
        metrics = dict(metrics)
        metrics["loss"] = loss
        return metrics


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
