"""Partial-reduce data parallelism: straggler-tolerant group averaging
(counterpart of ``hetu_tpu/parallel/preduce.py``).

A worker asks the matchmaking service for this round's ready group
(:class:`~hetu_tpu_torch.ps.client.PartialReduce`, or
:class:`~hetu_tpu_torch.ps.van.RemotePReduce` across processes) and the
gradients are averaged over that group only.  The reference runs the step
as one SPMD program under ``shard_map``; here every rank of the ``dp``
axis runs :func:`preduce_step_fn`'s step on its own shard of the batch,
and the group's mean is a MASKED mean over the whole axis: members add
``g · m`` with ``m = 1``, the others add zeros and receive the group's
mean, so the replicated parameters stay equal on every rank.  An empty
group changes nothing, the optimizer's slots and step included.
"""

from __future__ import annotations

import torch

from hetu_tpu_torch.parallel import collectives
from hetu_tpu_torch.parallel.pipeline import stage_index
from hetu_tpu_torch.train.executor import _shard_batch


def preduce_step_fn(loss_fn, optimizer, mesh, *, axis: str = "dp"):
    """A data-parallel train step whose gradient reduction averages only
    over the matched group (``member_mask[i] == 1``): the preduce and
    HetPipe data-parallel mode.

    ``loss_fn(params, batch_shard) -> scalar`` is the loss of ONE dp
    shard; ``params`` is a dict of leaf tensors every rank holds whole,
    which ``optimizer`` updates in place.  Returns ``(step, n)``, ``n``
    the axis size, and ``step(params, opt_state, batch, member_mask) ->
    (params, opt_state, group_loss)``: every rank passes the same global
    ``batch`` (a tensor, or a tuple, list or dict of them; dim 0 split
    over ``axis``, rank ``i`` taking piece ``i``, as the Executor splits)
    and the same ``member_mask`` of ``n`` zeros and ones.  One all-reduce
    a step carries every gradient, the loss and the member count."""
    n = collectives.axis_size(axis, mesh)
    group = collectives.axis_group(axis, mesh) if n > 1 else None

    def step(params, opt_state, batch, member_mask):
        i = stage_index(group)
        mask = torch.as_tensor(member_mask, dtype=torch.float32)
        if mask.shape != (n,):
            raise ValueError(f"member_mask has shape {tuple(mask.shape)}, "
                             f"the axis {n} ranks")
        m = float(mask[i])
        names = list(params)
        loss = loss_fn(params, _shard_batch(batch, mesh, axis, local=True))
        grads = torch.autograd.grad(loss, [params[k] for k in names],
                                    allow_unused=True,
                                    materialize_grads=True)
        with torch.no_grad():
            # psum(g · m), psum(loss · m) and psum(m) in one bucket
            flat = torch.cat([g.reshape(-1).float() * m for g in grads]
                             + [(loss.detach().float() * m).reshape(1),
                                loss.new_full((1,), m, dtype=torch.float32)])
            if group is not None:
                flat = collectives.psum(flat, group)
            members = flat[-1]
            denom = members.clamp_min(1.0)
            group_loss = flat[-2] / denom
            if float(members) == 0.0:
                # nobody pushed: no update, and stateful optimizers
                # (momentum, Adam's step) must not advance either.  Every
                # rank reads the same reduced count, so every rank takes
                # this branch or none, after the collective ran everywhere
                return params, opt_state, group_loss
            out, off = {}, 0
            for k, g in zip(names, grads):
                out[k] = (flat[off:off + g.numel()].reshape(g.shape)
                          / denom).to(g.dtype)
                off += g.numel()
        params, opt_state = optimizer.update(out, opt_state, params)
        return params, opt_state, group_loss

    return step, n

