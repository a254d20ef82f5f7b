"""Pipeline parallelism over the ``pp`` mesh axis (counterpart of
``hetu_tpu/parallel/pipeline.py``).

The reference's collective pipelining, one rank a stage: stages hold
equal-structure block stacks (stacked on a leading dim, ``[n_stages,
L/n_stages, ...]``); :func:`pipeline_ticks` runs ``M + n_stages - 1``
ticks, and at every tick each rank applies its stage and sends its
activations to the next stage (``ppermute``).  Autograd's reversal of the
tick loop is the backward pipeline: all forwards, then all backwards
(GPipe).  ``remat=True`` recomputes each block in the backward pass
(``torch.utils.checkpoint``).

The masks of the reference (``where(stage == 0, ...)``, ``where(valid,
...)``) stay ``torch.where`` on every rank, so every rank builds the same
autograd graph and runs the same collectives backward in the same order;
no Python branch on the rank's place picks a tensor.

:func:`pipedream_schedule` is the 1F1B order (pure Python, for the
planner), as in the reference.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from hetu_tpu_torch.parallel import collectives


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def stack_stage_params(per_layer_params, n_stages: int):
    """``[L, ...]`` stacked layer params → ``[n_stages, L/n_stages, ...]``
    (shared by the GPipe and 1F1B executors)."""
    def reshape(leaf):
        L = leaf.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers not divisible by {n_stages} "
                             f"stages")
        return leaf.reshape(n_stages, L // n_stages, *leaf.shape[1:])
    return _tree_map(reshape, per_layer_params)


def pipedream_schedule(n_stages: int, n_microbatches: int):
    """1F1B order per stage: per-stage lists of ``("fwd"|"bwd",
    microbatch_id)``: a warm-up of ``n_stages - stage - 1`` forwards, then
    alternating 1F1B, then the drain."""
    out = []
    for s in range(n_stages):
        warmup = min(n_stages - s - 1, n_microbatches)
        order = []
        f = b = 0
        for _ in range(warmup):
            order.append(("fwd", f))
            f += 1
        while f < n_microbatches:
            order.append(("fwd", f))
            f += 1
            order.append(("bwd", b))
            b += 1
        while b < n_microbatches:
            order.append(("bwd", b))
            b += 1
        out.append(order)
    return out


def stage_index(group) -> int:
    """This rank's place on the axis of ``group`` (0 for no group)."""
    if group is None:
        return 0
    return dist.get_group_rank(group, dist.get_rank())


def pipeline_ticks(stage_fn: Callable, xs, *, group, n_stages: int):
    """The reference's tick loop on this rank.

    ``xs [M, ...]``: the microbatches (stage 0 injects microbatch ``t`` at
    tick ``t``); ``stage_fn(h) -> (h_out, side)`` applies this rank's
    stage, ``side`` a tuple of tensors (or None).  Returns ``(outs [M,
    ...], sides)``: the last stage's outputs in microbatch order (zeros on
    the other stages) and each side value summed over the ticks at which
    a microbatch is in flight on this stage.  ``group``: the ``pp`` axis'
    process group (None for one stage)."""
    M = xs.shape[0]
    n = n_stages
    s = stage_index(group)
    dev = xs.device
    first = torch.tensor(s == 0, device=dev)
    last = torch.tensor(s == n - 1, device=dev)
    buf = torch.zeros_like(xs[0])
    outs = [torch.zeros_like(xs[0]) for _ in range(M)]
    sides = None
    T = M + n - 1
    for t in range(T):
        inject = xs[min(t, M - 1)]
        h_in = inject if n == 1 else torch.where(first, inject, buf)
        h_out, side = stage_fn(h_in)
        if n > 1 and t < T - 1:  # the last tick's send reaches no one
            buf = collectives.ppermute_shift(h_out, group, 1)
        done = t - (n - 1)
        if done >= 0:
            outs[done] = h_out if n == 1 else torch.where(last, h_out,
                                                          outs[done])
        if side is not None:
            on = torch.tensor(t >= s and t - s < M, device=dev)
            side = tuple(torch.where(on, x, torch.zeros_like(x))
                         for x in side)
            sides = side if sides is None else tuple(
                a + b for a, b in zip(sides, side))
    return torch.stack(outs), sides


def checkpointed(fn):
    """``fn`` recomputed in the backward pass instead of keeping its
    activations (``torch.utils.checkpoint``; deterministic blocks, so no
    RNG state is kept): the reference's ``jax.checkpoint``."""
    from torch.utils.checkpoint import checkpoint

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return run


class GPipe:
    """GPipe over the ``pp`` axis for a homogeneous block stack.

    ``block_fn(block_params, h) -> h``: one block; stage ``s`` applies its
    slice of the stacked blocks in order.  Stacked params: each leaf
    ``[n_stages, layers_per_stage, ...]`` (every stage's, as
    :meth:`stack_params` gives them; this rank uses row ``s``) or ``[1,
    layers_per_stage, ...]`` (this rank's stage only).  ``h [B, ...]``,
    whole on every rank; its batch splits into ``n_microbatches``.

    Gradients are the global program's, as the reference's ``shard_map``
    gives them: every rank computes the same output, a loss every rank
    computes from it counts once, each rank's stage parameters get their
    gradient and ``h`` its whole gradient on every rank."""

    def __init__(self, block_fn: Callable, mesh=None, *, axis: str = "pp",
                 n_microbatches: int = 4, remat: bool = True):
        self.block_fn = block_fn
        self.mesh = mesh
        self.axis = axis
        self.n_stages = collectives.axis_size(axis, mesh)
        self.n_microbatches = n_microbatches
        self.remat = remat

    def stack_params(self, per_layer_params):
        """``[L, ...]`` stacked layer params → ``[n_stages, L/n_stages,
        ...]``."""
        return stack_stage_params(per_layer_params, self.n_stages)

    def stack_params_unequal(self, per_layer_params, stage_bounds):
        """Pack UNEQUAL stages (a searcher's ``Plan.stage_bounds``: the
        ascending end layer of each stage) by padding every stage to the
        longest: ``(stacked, layer_mask)`` with ``layer_mask [n_stages,
        L_max]`` 1 for a real layer slot, 0 for padding."""
        bounds = list(stage_bounds)
        if len(bounds) != self.n_stages:
            raise ValueError(f"{len(bounds)} stage bounds for "
                             f"{self.n_stages} stages")
        starts = [0] + bounds[:-1]
        sizes = [e - s for s, e in zip(starts, bounds)]
        l_max = max(sizes)
        mask = torch.tensor([[1.0] * n + [0.0] * (l_max - n) for n in sizes])

        def pack(leaf):
            segs = []
            for s, n in zip(starts, sizes):
                seg = leaf[s:s + n]
                if n < l_max:
                    pad = leaf.new_zeros((l_max - n, *leaf.shape[1:]))
                    seg = torch.cat([seg, pad], dim=0)
                segs.append(seg)
            return torch.stack(segs)

        return _tree_map(pack, per_layer_params), mask.to(
            _leaves(per_layer_params)[0].device)

    def __call__(self, stacked_params, h, *, layer_mask=None):
        """``layer_mask [n_stages, L_max]``: 1 = a real layer, 0 = a
        padding slot (the identity), as :meth:`stack_params_unequal`
        gives it."""
        M = self.n_microbatches
        B = h.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by {M} microbatches")
        n = self.n_stages
        group = collectives.axis_group(self.axis, self.mesh) if n > 1 \
            else None
        s = stage_index(group)
        params = _tree_map(lambda a: a[s] if a.shape[0] == n else a[0],
                           stacked_params)
        n_per = _leaves(params)[0].shape[0]
        mask = torch.ones(n_per, device=h.device) if layer_mask is None \
            else layer_mask[s].to(h.device)
        block = checkpointed(self.block_fn) if self.remat \
            else self.block_fn
        if n > 1:
            h = collectives.shard_map_input(h, group)

        def stage_fn(x):
            for i in range(n_per):
                out = block(_tree_map(lambda a: a[i], params), x)
                # padding slots pass activations through unchanged
                x = torch.where(mask[i] > 0, out, x)
            return x, None

        xs = h.reshape(M, B // M, *h.shape[1:])
        outs, _ = pipeline_ticks(stage_fn, xs, group=group, n_stages=n)
        if n > 1:
            # the last stage's outputs on every stage: zero elsewhere,
            # summed over the axis
            last = torch.tensor(s == n - 1, device=h.device)
            outs = collectives.psum(
                torch.where(last, outs, torch.zeros_like(outs)), group)
            outs = collectives.shard_map_output(outs, group)
        return outs.reshape(B, *h.shape[1:])
