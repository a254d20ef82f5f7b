"""PipeDream-style 1F1B pipeline runtime (counterpart of
``hetu_tpu/parallel/pipedream.py``).

Unlike GPipe (:mod:`~hetu_tpu_torch.parallel.pipeline`), whose autograd
reversal keeps every microbatch's stage activations, this runtime
interleaves forward and backward ticks explicitly, so a stage holds at
most ``2 * n_stages`` stashed microbatch INPUTS: the backward recomputes
the stage's forward from the stashed input (activation checkpointing at
stage granularity).  Memory: O(n_stages) stashes against GPipe's
O(n_microbatches).  Parameters are frozen for the whole call (the
gradients apply once, after it: the PipeDream-Flush variant), so a
forward and its delayed backward always see the same weights and the
stash holds only activations.

Schedule, one rank a stage over the ``pp`` axis: tick ``t`` runs the
forward of microbatch ``t - s`` and the backward of microbatch ``t - (2n -
2 - s)`` on stage ``s``, over ``2n - 2 + M`` ticks.  Each live forward
runs under ``no_grad``; each live backward recomputes the stage from its
stash slot under ``enable_grad`` and takes ``torch.autograd.grad`` for the
stage's parameters and its input, so no autograd graph lives from one
tick to the next.  A dead phase launches no kernel, but both hops (the
activations forward, the cotangents backward) run on every rank at every
tick, zeros where the phase is dead: every rank's collectives stay in the
same order.  The last stage's outputs reach every rank by a ``psum`` over
``pp``.
"""

from __future__ import annotations

from typing import Callable

import torch

from hetu_tpu_torch.parallel import collectives
from hetu_tpu_torch.parallel.pipeline import (
    _leaves, _tree_map, stack_stage_params, stage_index,
)


class PipeDream1F1B:
    """1F1B (flush) pipeline over a homogeneous block stack.

    ``block_fn(block_params, h) -> h`` is one block; stage ``s`` applies
    its ``L / n_stages`` blocks in order.  Stacked parameters are each
    leaf ``[n_stages, L / n_stages, ...]`` (every stage's, as
    :meth:`stack_params` gives them; this rank uses row ``s``) or ``[1, L
    / n_stages, ...]`` (this rank's stage only, :meth:`local_stage`).
    The gradients come back for this rank's stage, each leaf ``[1, L /
    n_stages, ...]``: the rank's piece of the reference's ``[n_stages,
    ...]`` tree.  Usage::

        pipe = PipeDream1F1B(block_fn, mesh, n_microbatches=8)
        stage = pipe.local_stage(pipe.stack_params(per_layer_params))
        out, grads = pipe.forward_and_grad(stage, h, cotangent)
        loss, grads = pipe.value_and_grad(stage, h, loss_fn)
    """

    def __init__(self, block_fn: Callable, mesh=None, *, axis: str = "pp",
                 n_microbatches: int = 4):
        self.block_fn = block_fn
        self.mesh = mesh
        self.axis = axis
        self.n_stages = collectives.axis_size(axis, mesh)
        self.n_microbatches = n_microbatches
        self.group = collectives.axis_group(axis, mesh) \
            if self.n_stages > 1 else None
        self.stage = stage_index(self.group)

    def stack_params(self, per_layer_params):
        """``[L, ...]`` stacked layer params → ``[n_stages, L/n_stages,
        ...]``."""
        return stack_stage_params(per_layer_params, self.n_stages)

    def local_stage(self, stacked_params):
        """This rank's stage of a stacked tree, each leaf ``[1, L /
        n_stages, ...]`` (a view; a tree that holds only this stage is
        returned as it is)."""
        n, s = self.n_stages, self.stage
        return _tree_map(lambda a: a[s:s + 1] if a.shape[0] == n else a,
                         stacked_params)

    def _stage_fwd(self, params, h):
        for i in range(_leaves(params)[0].shape[0]):
            h = self.block_fn(_tree_map(lambda a: a[i], params), h)
        return h

    # ---- core: forward outputs + parameter grads in ONE pipelined pass ----
    def _run(self, stacked_params, xs, gout, *, fwd_only: bool = False):
        """``xs [M, mb, ...]`` stage-0 inputs; ``gout [M, mb, ...]``
        cotangents of the last stage's outputs (None with ``fwd_only``).
        Returns ``(outs [M, mb, ...] on every rank, grads of this rank's
        stage, each leaf [1, ...])``."""
        M, n, s = self.n_microbatches, self.n_stages, self.stage
        group = self.group
        params = _tree_map(lambda a: a.detach()[0],
                           self.local_stage(stacked_params))
        dt = xs.dtype  # activations stay in the input's precision
        # ticks: forward of f on stage s at f + s; its backward at
        # 2n - 2 + f - s (the flush schedule)
        T = (n - 1 + M) if fwd_only else (2 * n - 2 + M)
        # stash depth 2n: stage s holds at most 2n - 2 - 2s in-flight
        # inputs, so slot f % 2n is reused only after f's backward
        stash = [None] * (2 * n)
        fwd_buf = torch.zeros_like(xs[0])
        bwd_buf = torch.zeros_like(xs[0])
        outs = [torch.zeros_like(xs[0]) for _ in range(M)]
        grads = _tree_map(torch.zeros_like, params)
        for t in range(T):
            # ---- forward phase of this tick ----
            f = t - s
            h_out = None
            if 0 <= f < M:
                h_in = xs[f] if s == 0 else fwd_buf
                with torch.no_grad():
                    h_out = self._stage_fwd(params, h_in).to(dt)
                stash[f % (2 * n)] = h_in
                if s == n - 1:
                    outs[f] = h_out
            # ---- backward phase of this tick ----
            gx = None
            if not fwd_only:
                b = t - (2 * n - 2 - s)
                if 0 <= b < M:
                    g_in = gout[b] if s == n - 1 else bwd_buf
                    x = stash[b % (2 * n)].detach().requires_grad_(True)
                    p = _tree_map(lambda a: a.detach().requires_grad_(True),
                                  params)
                    leaves = _leaves(p)
                    with torch.enable_grad():
                        out = self._stage_fwd(p, x)
                        got = torch.autograd.grad(
                            out, leaves + [x], g_in.to(out.dtype),
                            allow_unused=True, materialize_grads=True)
                    flat = iter(got[:-1])
                    grads = _tree_map(lambda acc: acc + next(flat), grads)
                    gx = got[-1].to(dt)
            # ---- hops: both, on every rank, at every tick but the last
            # (whose sends would reach no consumer) ----
            if group is not None and t < T - 1:
                if not fwd_only:
                    bwd_buf = collectives.ppermute_shift(
                        torch.zeros_like(xs[0]) if gx is None else gx,
                        group, -1)
                fwd_buf = collectives.ppermute_shift(
                    torch.zeros_like(xs[0]) if h_out is None else h_out,
                    group, 1)
        outs = torch.stack(outs)
        if group is not None:
            # the last stage's outputs on every stage: zeros elsewhere,
            # summed over the axis
            with torch.no_grad():
                outs = collectives.psum(outs, group)
        return outs, _tree_map(lambda g: g[None], grads)

    # ---- public API ----
    def forward_and_grad(self, stacked_params, h, cotangent):
        """``h [B, ...]`` stage-0 inputs and ``cotangent [B, ...]`` =
        dL/d(outputs), both whole on every rank.  Returns ``(outputs [B,
        ...] on every rank, gradients of this rank's stage)``."""
        M = self.n_microbatches
        B = h.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by {M} microbatches")
        xs = h.detach().reshape(M, B // M, *h.shape[1:])
        gs = cotangent.detach().reshape(M, B // M, *h.shape[1:])
        outs, grads = self._run(stacked_params, xs, gs)
        return outs.reshape(B, *h.shape[1:]), grads

    def value_and_grad(self, stacked_params, h, loss_fn):
        """``loss_fn(outputs [B, ...]) -> scalar``, computed on every rank
        from the last stage's outputs; returns ``(loss, gradients of this
        rank's stage)``.  Two pipelined passes, as in the reference: one
        for the outputs (the loss's cotangent), one interleaved forward
        and backward pass for the gradients."""
        M = self.n_microbatches
        B = h.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by {M} microbatches")
        xs = h.detach().reshape(M, B // M, *h.shape[1:])
        outs, _ = self._run(stacked_params, xs, None, fwd_only=True)
        outs = outs.reshape(B, *h.shape[1:]).requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(outs)
            (cot,) = torch.autograd.grad(loss, outs)
        _, grads = self.forward_and_grad(stacked_params, h, cot)
        return loss.detach(), grads
