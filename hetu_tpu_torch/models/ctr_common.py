"""Shared CTR building blocks (counterpart of
``hetu_tpu/models/ctr_common.py``): the hidden-MLP tower and the PS-hybrid
train step that WideDeep, DeepFM, DeepCrossing and DCN share."""

from __future__ import annotations

from typing import Optional

import torch

from hetu_tpu_torch import ops
from hetu_tpu_torch.layers.base import Sequential
from hetu_tpu_torch.layers.linear import Linear
from hetu_tpu_torch.layers.misc import Relu


def default_generator(generator: Optional[torch.Generator]):
    """``generator``, or a CPU generator seeded 0, as the port's models
    default."""
    return generator if generator is not None \
        else torch.Generator().manual_seed(0)


def mlp_tower(in_dim: int, hidden, out_dim=None, *,
              generator: torch.Generator) -> Sequential:
    """Linear + Relu for each hidden width, then a linear head of
    ``out_dim`` if given; children ``"0"``, ``"1"``, ... as in the
    reference."""
    mods = []
    prev = in_dim
    for h in hidden:
        mods += [Linear(prev, h, generator=generator), Relu()]
        prev = h
    if out_dim is not None:
        mods.append(Linear(prev, out_dim, generator=generator))
    return Sequential(*mods)


def on_device(x, device, dtype=None):
    """A batch input (tensor, numpy array or list) as a tensor on
    ``device``; a pinned CPU tensor copies without blocking the host."""
    t = torch.as_tensor(x).to(device, non_blocking=True)
    return t if dtype is None else t.to(dtype)


def make_hybrid_step(model, optimizer, n_sparse_inputs: int = 1):
    """The PS-hybrid train step of a CTR model whose forward is
    ``(dense_x, *sparse_rows) -> logit [B]``: ``step(dense_x,
    *sparse_rows, labels) -> (loss, logit, *row_grads)``.

    The pulled rows come in as tensors (a CPU tensor, pinned or not, is
    copied to the model's device); the dense parameters are updated in
    place, with the optimizer state ``step.opt_state``; the rows'
    gradients ``d(mean BCE)/d(rows)`` go back for the host's push."""
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    state = optimizer.init_state(params)

    def step(dense_x, *rest):
        rows = [on_device(r, device, torch.float32).detach().requires_grad_()
                for r in rest[:n_sparse_inputs]]
        labels = on_device(rest[n_sparse_inputs], device, torch.float32)
        logit = model(on_device(dense_x, device, torch.float32), *rows)
        loss = ops.binary_cross_entropy_with_logits(logit, labels).mean()
        grads = torch.autograd.grad(loss, [*params.values(), *rows])
        state.update(optimizer.update(dict(zip(params, grads)), state,
                                      params)[1])
        return (loss.detach(), logit.detach(), *grads[len(params):])

    step.opt_state = state
    return step
