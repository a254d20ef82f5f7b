"""Per-method training flows of the compression zoo (counterpart of
``hetu_tpu/embedding_compress/recipes.py``).

Beyond the stage machine (``scheduler.py``), the VLDB'24 tool ships
per-method training recipes: AutoDim's bi-level architecture search
(alternating arch steps on validation batches with weight steps on train
batches) and OptEmbed's three-stage flow (supernet training with a
threshold regulariser, evolutionary mask search, masked retrain).  Each
trainer steps a dict of named parameters (the model's own tensors, e.g.
``dict(model.named_parameters())``) with two functional optimizers of
:mod:`hetu_tpu_torch.optim`, in place: the weights and the arch (or
threshold) parameters ride separate optimizer states, as the reference
splits its ``train_op`` list.  ``loss_fn(params, batch) -> scalar`` must
compute the loss from those tensors.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch


class MultiStageFlow:
    """Chain stage trainers, inheriting PARAMETERS but not optimizer state
    (reference multistage.py + optembed.py:12-13: "the parameters are
    inherited from the previous stage; but the optimizer states is new in
    every stage").

    ``stages``: ordered ``(name, fn)`` where ``fn(carry) -> carry``; the
    carry is whatever the stages agree on.  ``run`` executes from
    ``start_stage`` (reference --stage resume flag).
    """

    def __init__(self, stages: Sequence[Tuple[str, Callable]]):
        if not stages:
            raise ValueError("MultiStageFlow needs at least one stage")
        self.stages = list(stages)
        self.history: List[str] = []

    def run(self, carry, *, start_stage: int = 0):
        self.history = []  # per-run record, not a cross-run accumulator
        for name, fn in self.stages[start_stage:]:
            carry = fn(carry)
            self.history.append(name)
        return carry


class AutoDimBiLevelTrainer:
    """AutoDim's bi-level search (reference autodim.py AutoDimTrainer):
    the weights train on TRAIN batches, the architecture softmax
    (``params[f"{embed_key}.arch"]``) on VALIDATION batches with its own
    Adam — the first-order (``ignore_second``) DARTS approximation the
    reference defaults to.  In the weight step the arch's gradient is
    zero, and the weight optimizer steps it with that zero, as the
    reference's does."""

    def __init__(self, embed_module, loss_fn, *, embed_key: str = "embed",
                 weight_opt=None, alpha_lr: float = 1e-3):
        from hetu_tpu_torch import optim

        self.module = embed_module
        self.arch_name = f"{embed_key}.arch"
        self.weight_opt = weight_opt or optim.AdamOptimizer(1e-3)
        self.arch_opt = optim.AdamOptimizer(alpha_lr)
        self._loss_fn = loss_fn

    def _weight_step(self, params, wstate, batch):
        weights = [n for n in params if n != self.arch_name]
        loss = self._loss_fn(params, batch)
        grads = dict(zip(weights, torch.autograd.grad(
            loss, [params[n] for n in weights])))
        # the arch moves only on validation batches (below)
        grads[self.arch_name] = torch.zeros_like(params[self.arch_name])
        _, wstate = self.weight_opt.update(grads, wstate, params)
        return wstate, loss.detach()

    def _arch_step(self, params, astate, val_batch):
        arch = params[self.arch_name]
        loss = self._loss_fn(params, val_batch)
        (g,) = torch.autograd.grad(loss, [arch])
        _, astate = self.arch_opt.update({self.arch_name: g}, astate,
                                         {self.arch_name: arch})
        return astate, loss.detach()

    def init_states(self, params):
        return (self.weight_opt.init_state(params),
                self.arch_opt.init_state({self.arch_name:
                                          params[self.arch_name]}))

    def fit(self, params, train_batches, val_batches, *,
            arch_every: int = 1):
        """Alternate weight and arch steps (reference
        first_stage_train_step interleaving), updating ``params`` in
        place.  Returns ``(params, train_losses, val_losses)``."""
        wstate, astate = self.init_states(params)
        tl, vl = [], []
        vb = iter(val_batches)
        for i, batch in enumerate(train_batches):
            wstate, loss = self._weight_step(params, wstate, batch)
            tl.append(float(loss))
            if i % max(arch_every, 1) == 0:
                try:
                    val = next(vb)
                except StopIteration:
                    vb = iter(val_batches)
                    val = next(vb)
                astate, vloss = self._arch_step(params, astate, val)
                vl.append(float(vloss))
        return params, tl, vl

    def finalize(self):
        """Winner-take-all retrain conversion (AutoDimRetrainEmbedding):
        only the selected candidate's table and projection."""
        from hetu_tpu_torch.embedding_compress.layers import (
            autodim_to_retrain,
        )
        return autodim_to_retrain(self.module)


class OptEmbedFlow:
    """OptEmbed's three stages (reference optembed.py):

    1. ``train_supernet`` — train weights and per-row thresholds
       (``params[f"{embed_key}.t"]``) jointly; the loss carries the
       reference's ``alpha * sum(exp(-t))`` regulariser and the thresholds
       ride their OWN optimizer (SGD at ``thresh_lr``), the weights the
       weight optimizer.
    2. ``evolutionary_search`` — per-field dim-prefix masks evolve under
       mutation and crossover, ranked by a caller-supplied fitness
       (validation loss of the masked supernet).
    3. :meth:`finalize` — row-pruned weights plus the winning field mask,
       parameters inherited, optimizer fresh.
    """

    def __init__(self, embed_module, loss_fn, *, embed_key: str = "embed",
                 weight_opt=None, thresh_lr: float = 1e-2,
                 alpha: float = 1e-4):
        from hetu_tpu_torch import optim

        self.module = embed_module
        self.t_name = f"{embed_key}.t"
        self.alpha = alpha
        self.weight_opt = weight_opt or optim.AdamOptimizer(1e-3)
        self.thresh_opt = optim.SGDOptimizer(thresh_lr)
        self._loss_fn = loss_fn

    def _weights(self, params):
        return {n: p for n, p in params.items() if n != self.t_name}

    def _supernet_step(self, params, wstate, tstate, batch):
        t = params[self.t_name]
        loss = self._loss_fn(params, batch) \
            + self.alpha * torch.sum(torch.exp(-t))
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        # the thresholds ride their own optimizer: the weight optimizer
        # never touches them (the reference zeroes their leaf in its tree
        # and keeps the threshold optimizer's result)
        _, wstate = self.weight_opt.update(grads, wstate,
                                           self._weights(params))
        _, tstate = self.thresh_opt.update({self.t_name: grads[self.t_name]},
                                           tstate, {self.t_name: t})
        return wstate, tstate, loss.detach()

    def train_supernet(self, params, batches):
        """Stage 1 over ``batches``, updating ``params`` in place; returns
        ``(params, losses)``."""
        wstate = self.weight_opt.init_state(self._weights(params))
        tstate = self.thresh_opt.init_state({self.t_name:
                                             params[self.t_name]})
        losses = []
        for batch in batches:
            wstate, tstate, loss = self._supernet_step(params, wstate,
                                                       tstate, batch)
            losses.append(float(loss))
        return params, losses

    @staticmethod
    def evolutionary_search(fitness_fn, *, n_fields: int, dim: int,
                            population: int = 8, generations: int = 5,
                            parents: int = 4, mutate_prob: float = 0.2,
                            seed: int = 0):
        """Reference OptEmbedEvoTrainer: evolve per-field dim choices.

        A candidate assigns each field a kept-dim prefix in [1, dim];
        ``fitness_fn(cand) -> float`` (LOWER is better, e.g. validation
        loss).  Mutation redraws a field's dim; crossover takes fields
        from two parents.  Returns (best_candidate, best_fitness); the
        same seed draws the reference's candidates.
        """
        rng = np.random.default_rng(seed)
        pop = [rng.integers(1, dim + 1, n_fields) for _ in range(population)]
        best, best_fit = None, np.inf
        for _ in range(generations):
            scored = sorted(((float(fitness_fn(c)), c) for c in pop),
                            key=lambda t: t[0])
            if scored[0][0] < best_fit:
                best_fit, best = scored[0][0], scored[0][1].copy()
            keep = [c for _, c in scored[:parents]]
            children = []
            while len(children) < population - len(keep):
                pa, pb = rng.choice(len(keep), 2, replace=False)
                child = np.where(rng.random(n_fields) < 0.5,
                                 keep[pa], keep[pb])
                redraw = rng.random(n_fields) < mutate_prob
                child = np.where(redraw, rng.integers(1, dim + 1, n_fields),
                                 child)
                children.append(child)
            pop = keep + children
        return best, best_fit

    @staticmethod
    def field_mask(cand, dim: int, device="cuda") -> torch.Tensor:
        """``[n_fields, dim]`` 0/1 float32 mask keeping each field's dim
        prefix."""
        return (torch.arange(dim, device=device)[None, :] < torch.as_tensor(
            cand, device=device)[:, None]).float()

    def finalize(self, cand=None):
        """Stage-3 retrain form: the row-pruned weights (threshold mask
        baked), and the evolutionary winner's ``field_dims`` if given."""
        from hetu_tpu_torch.embedding_compress.layers import (
            optembed_row_pruned,
        )
        out = optembed_row_pruned(self.module)
        if cand is not None:
            out.add_state("field_dims", torch.as_tensor(
                np.asarray(cand), device=self.module.w.device))
        return out


class ServingRowCodec:
    """Lossy per-row compression for the SERVING cache's eviction tier.

    The training-time zoo compresses the TABLE (hashing, TT, masks);
    online serving needs something different — rows evicted from the hot
    f32 tier of a serving embedding cache kept around cheaply WITH their
    PS versions, so a re-access within the staleness bound decompresses
    locally instead of re-pulling the row.  Same trade as
    :class:`~hetu_tpu_torch.embedding_compress.layers.QuantizedEmbedding`
    rows: int8 + one f32 scale per row, 4x smaller, ~1e-2 relative error.

    Stateless and vectorised, on the host: ``compress``/``decompress``
    take/return ``[n, dim]`` f32 numpy batches, byte for byte the
    reference's.
    """

    bytes_per_value = 1

    def __init__(self, dim: int):
        self.dim = int(dim)

    def compress(self, rows: np.ndarray) -> tuple:
        rows = np.ascontiguousarray(rows, np.float32).reshape(-1, self.dim)
        scale = np.abs(rows).max(axis=1) / 127.0
        q = np.where(scale[:, None] > 0.0,
                     np.round(rows / np.maximum(scale, 1e-30)[:, None]),
                     0.0).astype(np.int8)
        return q, scale.astype(np.float32)

    def decompress(self, blob: tuple) -> np.ndarray:
        q, scale = blob
        return q.astype(np.float32) * scale[:, None]
