"""HetPipe: pipelined virtual workers with PS-synced weights, Wave
Synchronous Parallel (counterpart of ``hetu_tpu/parallel/hetpipe.py``).

One *virtual worker* is one :class:`~hetu_tpu_torch.parallel.pipedream.
PipeDream1F1B` pipeline over a ``pp`` group of ranks, a stage a rank.  A
wave (the pipeline's microbatches) gives each stage its accumulated
gradients; between PS syncs the worker advances a local copy of its
weights with plain SGD (the reference's ``run_optimizer``: ``w -= lr ·
g``), and every ``sync_every`` waves it pushes the gradients accumulated
since the last sync to the PS weight table, whose server-side optimizer
applies them to the global weights, and pulls those weights back,
discarding the lookahead.  Staleness across virtual workers is bounded by
the PS's SSP clocks.

The table holds the whole model as one flat f32 column in the reference's
``ravel_pytree`` order (:func:`flatten_params`: sorted keys, each stacked
``[n_stages, L / n_stages, ...]`` leaf whole in C order), so a table one
package seeds reads the same in the other.  Where the reference's single
controller pushes and pulls the whole vector, each rank here holds only
its own stage and pushes and pulls its stage's row ranges (a leaf's
stage ``s`` is one contiguous range): every row is still updated exactly
once a sync, and the server's optimizer (SGD, momentum, Adam) applies
each row alike on either path.  SSP clocks count virtual workers: stage 0
of each worker clocks, after every stage of the worker has pushed, and
every rank of the worker learns the outcome, so a staleness trip raises
on all of them.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from hetu_tpu_torch.parallel import collectives
from hetu_tpu_torch.parallel.pipedream import PipeDream1F1B
from hetu_tpu_torch.parallel.pipeline import _tree_map

# the van server bounds one sparse op at 2^24 rows and a 1 GiB frame; stay
# comfortably under both for any dim
_PUBLISH_CHUNK = 1 << 20


def _sorted_leaves(tree) -> list:
    """The leaves of a nested dict in ``ravel_pytree``'s order: keys
    sorted, depth first."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    return [tree]


def _tree_zip(fn, a, b):
    if isinstance(a, dict):
        return {k: _tree_zip(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _np32(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().float().cpu().numpy()
    return np.asarray(leaf, np.float32)


def flatten_params(tree) -> np.ndarray:
    """A nested dict of tensors or arrays → one flat f32 vector in
    ``jax.flatten_util.ravel_pytree``'s order."""
    leaves = [_np32(a).ravel() for a in _sorted_leaves(tree)]
    return np.concatenate(leaves).astype(np.float32) if leaves else \
        np.zeros(0, np.float32)


def unflatten_params(flat, template):
    """The inverse of :func:`flatten_params` against a tree of the same
    structure: tensors of the template leaves' shapes, dtypes and
    devices (numpy arrays for numpy leaves)."""
    flat = np.asarray(flat, np.float32).ravel()
    pos = [0]

    def take(leaf):
        n = int(np.prod(leaf.shape))
        part = flat[pos[0]:pos[0] + n].reshape(leaf.shape)
        pos[0] += n
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(part.copy()).to(device=leaf.device,
                                                    dtype=leaf.dtype)
        return part.astype(np.asarray(leaf).dtype)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(tree[k]) for k in sorted(tree)}
        return take(tree)
    out = walk(template)
    if pos[0] != flat.size:
        raise ValueError(f"{flat.size} values for a tree of {pos[0]}")
    return out


def _set_rows(table, rows: np.ndarray, values: np.ndarray) -> None:
    """``table.sparse_set`` of a column of values, in chunks."""
    for off in range(0, rows.size, _PUBLISH_CHUNK):
        end = min(off + _PUBLISH_CHUNK, rows.size)
        table.sparse_set(rows[off:end],
                         values[off:end].reshape(end - off, 1))


def publish_weights(table, params) -> None:
    """Write a whole parameter tree (``[n_stages, ...]`` leaves) into a PS
    weight table, in chunks (models larger than the van's per-request row
    bound need several sets).  Also the caller's restore path after a
    server recovery."""
    flat = flatten_params(params)
    _set_rows(table, np.arange(flat.size, dtype=np.int64), flat)


def stage_rows(stage_params, n_stages: int, stage: int) -> np.ndarray:
    """The table rows of one stage: ``stage_params`` is that stage's tree
    (each leaf ``[1, L / n_stages, ...]``, or ``[L / n_stages, ...]``), in
    the flat layout of the whole ``[n_stages, ...]`` tree."""
    rows, off = [], 0
    for leaf in _sorted_leaves(stage_params):
        m = int(np.prod(leaf.shape))
        rows.append(np.arange(off + stage * m, off + (stage + 1) * m,
                              dtype=np.int64))
        off += n_stages * m
    return np.concatenate(rows) if rows else np.zeros(0, np.int64)


class HetPipeWorker:
    """One HetPipe virtual worker's rank: the 1F1B pipeline and the PS
    weight sync of this rank's stage.

    ``pipe``: the :class:`PipeDream1F1B` runtime (the wave is its
    ``n_microbatches``); ``params``: the stacked stage parameters, whole
    or this rank's stage (``pipe.local_stage``), of which the worker
    keeps this rank's stage.  ``table``: a PS table handle with
    ``sparse_push``/``sparse_pull``/``sparse_set`` and ``rows · dim`` =
    the whole model's parameter count (``ps.PSTable``,
    ``ps.van.RemotePSTable`` or ``ps.van.PartitionedPSTable``), whose
    server-side optimizer is the GLOBAL optimizer.  ``publish_init``: True
    on the ranks of exactly one worker, which seed the table with their
    stages.  ``sync_every``: waves between PS syncs; ``local_lr``: the
    SGD rate of the lookahead between syncs; ``ssp``: bounded-staleness
    clocks across virtual workers (``ps.SSPController`` or
    ``ps.van.RemoteSSP``), given on every rank of the worker or on none
    (only stage 0 clocks); ``worker_id`` indexes this worker's clock."""

    def __init__(self, pipe: PipeDream1F1B, params, table, *,
                 publish_init: bool = False, sync_every: int = 1,
                 local_lr: float = 0.01, worker_id: int = 0,
                 ssp=None, ssp_timeout_ms: int = 60_000):
        self.pipe = pipe
        self.params = _tree_map(lambda a: a.detach().clone(),
                                pipe.local_stage(params))
        self.table = table
        self.sync_every = max(1, sync_every)
        self.local_lr = local_lr
        self.worker_id = worker_id
        self.ssp = ssp
        self.ssp_timeout_ms = ssp_timeout_ms
        self.wave = 0
        self._accum = None
        n = pipe.n_stages
        self.rows = stage_rows(self.params, n, pipe.stage)
        total = n * self.rows.size
        if table.rows * table.dim != total:
            raise ValueError(
                f"PS table holds {table.rows * table.dim} floats but the "
                f"model has {total} parameters")
        if publish_init:
            _set_rows(table, self.rows, flatten_params(self.params))
        if pipe.group is not None:
            dist.barrier(group=pipe.group)

    def pull_weights(self) -> None:
        """Replace this stage's weights with the server's global ones."""
        vals = np.concatenate([
            np.asarray(self.table.sparse_pull(
                self.rows[off:off + _PUBLISH_CHUNK]), np.float32).ravel()
            for off in range(0, self.rows.size, _PUBLISH_CHUNK)])
        self.params = unflatten_params(vals, self.params)

    def _push(self, grads) -> None:
        flat = flatten_params(grads)
        for off in range(0, self.rows.size, _PUBLISH_CHUNK):
            end = min(off + _PUBLISH_CHUNK, self.rows.size)
            self.table.sparse_push(self.rows[off:end],
                                   flat[off:end].reshape(end - off, 1))

    def _clock(self) -> None:
        """Stage 0 clocks this worker's SSP clock once every stage has
        pushed; every rank of the worker raises if the bound was not
        restored within the timeout."""
        group = self.pipe.group
        if group is not None:
            dist.barrier(group=group)
        ok = 1.0
        if self.pipe.stage == 0:
            ok = float(self.ssp.clock_and_wait(self.worker_id,
                                               self.ssp_timeout_ms))
        if group is not None:
            flag = torch.tensor([ok])
            # stage 0's outcome on every rank: the others add 1
            flag = collectives.psum(flag, group) - (self.pipe.n_stages - 1)
            ok = float(flag[0])
        if ok < 1.0:
            raise RuntimeError(
                f"HetPipe worker {self.worker_id}: staleness bound not "
                "restored within timeout (straggler?)")

    def step(self, h, loss_fn: Callable) -> float:
        """Run one wave (M microbatches through the 1F1B pipeline) and
        the HetPipe weight protocol; returns the wave's loss."""
        loss, grads = self.pipe.value_and_grad(self.params, h, loss_fn)
        self._accum = grads if self._accum is None else _tree_zip(
            torch.add, self._accum, grads)
        self.wave += 1
        if self.wave % self.sync_every == 0:
            # the server's optimizer applies the accumulated wave
            # gradients to the global weights; the lookahead is dropped
            self._push(self._accum)
            self._accum = None
            self.pull_weights()
            if self.ssp is not None:
                self._clock()
        else:
            # the local lookahead between syncs (reference run_optimizer)
            self.params = _tree_zip(lambda w, g: w - self.local_lr * g,
                                    self.params, grads)
        return float(loss)


def make_weight_table(params, *, optimizer: str = "sgd", lr: float = 0.01,
                      remote=None, table_id: Optional[int] = None,
                      create: bool = True, **opt_kwargs):
    """The PS weight table of a HetPipe worker group, one f32 row a
    parameter of the whole tree ``params`` (``[n_stages, ...]`` leaves).

    Local (``ps.PSTable``, one process) by default; ``remote=(host,
    port)`` for a van server, or a list of ``(host, port)`` endpoints for
    a range-partitioned group.  Ranks of several processes share one van
    table: one creates it (``create=True``) and the others attach by its
    ``table_id`` with ``create=False`` (a departure: the reference's one
    controller always creates)."""
    from hetu_tpu_torch import ps
    n = int(sum(int(np.prod(a.shape)) for a in _sorted_leaves(params)))
    if remote is None:
        return ps.PSTable(n, 1, init="zeros", optimizer=optimizer, lr=lr,
                          **opt_kwargs)
    from hetu_tpu_torch.ps import van
    if isinstance(remote, list):
        return van.PartitionedPSTable(remote, n, 1, table_id=table_id,
                                      init="zeros", optimizer=optimizer,
                                      lr=lr, **opt_kwargs)
    host, port = remote
    return van.RemotePSTable(host, port, n, 1, table_id=table_id,
                             create=create, init="zeros",
                             optimizer=optimizer, lr=lr, **opt_kwargs)
