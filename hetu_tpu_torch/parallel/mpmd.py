"""MPMD pipeline pieces: unequal per-stage data parallelism over separate
processes (counterpart of ``hetu_tpu/parallel/mpmd.py``).

Stages with DIFFERENT data-parallel degrees exchange activations through
round-robin send/receive pairs (the reference system's
``pipeline_subexecutor.py`` and its context's round-robin target
assignment).  One SPMD program over one mesh cannot run two stages as
different programs at different dp degrees; this module is the MPMD
form:

* each (stage, replica) runs in its OWN process, with its own device and
  its own program (a stage may itself be a ``torch.distributed`` rank
  world, :mod:`hetu_tpu_torch.parallel.ranks`);
* activations and cotangents hop processes through :class:`VanMailbox`
  channels on the PS van: host-bridged transfers, f32-logical numpy
  payloads over an ``f32``, ``bf16`` or ``int8`` wire;
* :func:`round_robin_assignments` is the microbatch -> (sender replica,
  receiver replica) schedule, and :func:`schedule_ops` the per-stage
  GPipe or 1F1B op order.

:class:`MPMDStageRunner` is the worker: torch autograd on the stage's
device (CUDA unless the caller asks for the CPU).  The forward keeps each
microbatch's autograd graph, as the reference keeps its ``jax.vjp``; the
backward calls ``torch.autograd.grad`` on the received cotangent, sends
``gx`` upstream and sums the parameter gradients in ascending microbatch
order in f32; a stage with more than one replica reduces them through a
PS accumulator table and three van barriers, and every stage divides by
the global microbatch count.

The schedules, the codecs and the mailbox are numpy over the van: this
module imports ``torch`` only inside the runner and the int8 codec, so
a numpy stage process (``parallel/mpmd_elastic.py``) loads neither
``torch`` nor ``jax``.  Departures from the reference: the int8 codec is
the port's torch codec (:func:`hetu_tpu_torch.quantwire.q8_encode_axes`,
bitwise the reference's numpy one), so an int8 edge loads ``torch``;
the accumulator moves the flat gradient in one dense push and one dense
pull (the reference sends the same rows with an index array each way);
a stage with one replica divides by ``M`` on its device without a host
round trip; and the runner returns the gradients as tensors on the
stage's device, shaped like ``params``.
"""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np

from hetu_tpu_torch import quantwire  # numpy until a codec needs torch


def round_robin_assignments(n_microbatches: int, n_src: int,
                            n_dst: int) -> List[Tuple[int, int]]:
    """Microbatch i is produced by stage-A replica i % n_src and consumed
    by stage-B replica i % n_dst (the reference system's round-robin
    send/recv target computation)."""
    return [(i % n_src, i % n_dst) for i in range(n_microbatches)]


# ---------------------------------------------------------------------------
# microbatch schedules (the GPipe flush and the PipeDream-flush 1F1B
# order, as per-stage op lists)
# ---------------------------------------------------------------------------

PIPELINE_SCHEDULES = ("gpipe", "1f1b")


def schedule_ops(kind: str, *, stage: int, n_stages: int,
                 n_microbatches: int,
                 stash_limit: int = 0) -> List[Tuple[str, int]]:
    """The per-stage microbatch op order of a synchronous pipeline step,
    as ``[("F"|"B", microbatch), ...]``.

    ``gpipe``: all forwards then all backwards (the flush schedule).
    ``stash_limit`` bounds the activation stash by splitting the step
    into ceil(M/stash_limit) mini-flushes (an unbounded GPipe stashes
    all M microbatches; 1F1B never stashes more than ``n_stages -
    stage``).

    ``1f1b``: PipeDream-flush — stage s runs ``min(M, S-1-s)`` warmup
    forwards, then strict one-forward-one-backward, then drains.  Same
    per-step weight semantics as gpipe (one flush, update at the end);
    only the ORDER — and with it stash depth and bubble — differs.

    Both schedules emit backwards in ascending microbatch order, so the
    gradient accumulation order (and with it the summed f32 gradient,
    bitwise) does not depend on the schedule.
    """
    M, S, s = int(n_microbatches), int(n_stages), int(stage)
    if not 0 <= s < S:
        raise ValueError(f"stage {s} outside [0, {S})")
    if kind == "gpipe":
        chunk = M if not stash_limit else max(1, min(int(stash_limit), M))
        ops: List[Tuple[str, int]] = []
        for lo in range(0, M, chunk):
            mbs = range(lo, min(lo + chunk, M))
            ops += [("F", m) for m in mbs]
            ops += [("B", m) for m in mbs]
        return ops
    if kind == "1f1b":
        warmup = min(M, S - 1 - s)
        ops = [("F", m) for m in range(warmup)]
        f, b = warmup, 0
        while f < M:
            ops.append(("F", f))
            f += 1
            ops.append(("B", b))
            b += 1
        while b < M:
            ops.append(("B", b))
            b += 1
        return ops
    raise ValueError(f"unknown schedule {kind!r}; "
                     f"expected one of {PIPELINE_SCHEDULES}")


def peak_stash(ops) -> int:
    """Max number of microbatches whose forward activations are held at
    once under an op order (F stashes, B frees)."""
    live = peak = 0
    for op, _ in ops:
        live += 1 if op == "F" else -1
        peak = max(peak, live)
    return peak


# ---------------------------------------------------------------------------
# activation/cotangent wire codecs (f32-logical arrays over a non-f32 wire)
# ---------------------------------------------------------------------------

Q8_BLOCK = 64  # elements per int8 scale block on mailbox payloads


def encode_wire(arr, wire: str) -> tuple:
    """f32-logical array -> ``(payload bytes, logical_bytes)`` in the
    given wire dtype.  bf16 rounds to nearest-even; int8 is block-scaled
    (one f32 scale per :data:`Q8_BLOCK` elements, the quantwire clamp
    rules).  Both are pure functions of the input, so a quantized edge
    keeps the replay and byte-identity contracts; the bytes are the
    reference's."""
    quantwire.check_wire(wire)
    flat = np.ascontiguousarray(arr, np.float32).ravel()
    logical = flat.size * 4
    if wire == "f32":
        return flat.tobytes(), logical
    if wire == "bf16":
        u = flat.view(np.uint32).astype(np.uint64)
        r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
        nan = np.isnan(flat)
        if nan.any():
            # the rounding carry overflows a NaN's mantissa into the
            # exponent (0x7FFFFFFF would decode as -0.0): the canonical
            # quiet bf16 NaN instead, so a NaN activation propagates
            sign = ((u >> 16) & 0x8000).astype(np.uint16)
            r = np.where(nan, sign | np.uint16(0x7FC0), r)
        return r.tobytes(), logical
    import torch

    pad = (-flat.size) % Q8_BLOCK
    if pad:
        flat = np.pad(flat, (0, pad))
    q, scale = quantwire.q8_encode_axes(
        torch.from_numpy(flat.reshape(-1, Q8_BLOCK)), (1,))
    return q.numpy().tobytes() + scale.numpy().tobytes(), logical


def decode_wire(payload: bytes, n: int, wire: str) -> np.ndarray:
    """Inverse of :func:`encode_wire` back to ``n`` f32 elements (a copy
    the caller may write to)."""
    quantwire.check_wire(wire)
    if wire == "f32":
        a = np.frombuffer(payload, np.float32).copy()
        if a.size != n:
            raise ValueError(f"wire payload has {a.size} f32s, "
                             f"expected {n}")
        return a
    if wire == "bf16":
        u = np.frombuffer(payload, np.uint16)
        if u.size != n:
            raise ValueError(f"wire payload has {u.size} bf16s, "
                             f"expected {n}")
        return (u.astype(np.uint32) << 16).view(np.float32).copy()
    nblk = -(-int(n) // Q8_BLOCK)
    want = nblk * Q8_BLOCK + nblk * 4
    if len(payload) != want:
        raise ValueError(f"wire payload has {len(payload)} bytes, "
                         f"expected {want} for {n} int8-block elements")
    import torch

    q = np.frombuffer(payload[:nblk * Q8_BLOCK],
                      np.int8).reshape(nblk, Q8_BLOCK)
    scales = np.frombuffer(payload[nblk * Q8_BLOCK:],
                           np.float32).reshape(nblk, 1)
    out = quantwire.q8_decode_axes(torch.from_numpy(q.copy()),
                                   torch.from_numpy(scales.copy()))
    return out.numpy().ravel()[:n].copy()


class VanMailbox:
    """One-way ACKED channel between two processes over the van.

    Default transport (``impl="blob"``): the van's bulk-blob channel
    (:class:`~hetu_tpu_torch.ps.van.BlobChannel`) — one payload frame per
    message with a server-side blocking wait, so a message costs the
    sender ONE round trip and the reader two (get + ack), no polling.

    Legacy transport (``impl="sparse"``): the payload spread over f32
    table rows with seq/ack flag rows polled at ``poll_s`` — the baseline
    the blob path is measured against, needing nothing but table ops.
    Flag rows are f32, exact only to 2**24, so the wire flag wraps into
    [1, 2**20] (``_wire``); the ack lockstep (at most one message in
    flight) keeps wrapped flags unambiguous.

    ``wire`` (blob transport only) selects the payload encoding
    (:func:`encode_wire`); the mailbox counts ``bytes_logical`` and
    ``bytes_wire`` over both directions and, when ``metric_path`` is set,
    folds what it sends into the default registry's ``<path>.bytes_*``
    counters.
    """

    _SEQ_MOD = 1 << 20

    @classmethod
    def _wire(cls, seq: int) -> int:
        return (seq - 1) % cls._SEQ_MOD + 1 if seq > 0 else 0

    def __init__(self, host: str, port: int, channel_id: int,
                 capacity: int, *, impl: str = "blob", wire: str = "f32",
                 metric_path: str | None = None,
                 connect_timeout_s: float = 20.0):
        if impl not in ("blob", "sparse"):
            raise ValueError(f"unknown mailbox impl {impl!r}")
        if wire != "f32" and impl != "blob":
            raise ValueError("quantized wire needs the blob transport "
                             "(the sparse fallback is f32 rows)")
        self.capacity = capacity
        self.impl = impl
        self.wire = quantwire.check_wire(wire)
        self.metric_path = metric_path
        self.bytes_logical = 0
        self.bytes_wire = 0
        self._last_seq = 0
        if impl == "blob":
            from hetu_tpu_torch.ps.van import BlobChannel
            self._chan = BlobChannel(host, port, channel_id,
                                     connect_timeout_s=connect_timeout_s)
            return
        from hetu_tpu_torch.ps.van import RemotePSTable
        deadline = time.monotonic() + connect_timeout_s
        # both endpoints race to create; a refusal means the peer won
        while True:
            try:
                self.table = RemotePSTable(
                    host, port, capacity + 2, 1, table_id=channel_id,
                    create=True, init="zeros",
                    connect_timeout_s=connect_timeout_s)
                break
            except RuntimeError:
                try:
                    self.table = RemotePSTable(
                        host, port, capacity + 2, 1, table_id=channel_id,
                        create=False,
                        connect_timeout_s=connect_timeout_s)
                    break
                except RuntimeError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.05)

    def _flag(self, row: int) -> float:
        return float(self.table.sparse_pull([row])[0, 0])

    def put(self, arr, seq: int, *, timeout_s: float = 60.0,
            poll_s: float = 0.002) -> None:
        flat = np.ascontiguousarray(arr, np.float32).ravel()
        if flat.size > self.capacity:
            raise ValueError(f"message {flat.size} > capacity "
                             f"{self.capacity}")
        if self.impl == "blob":
            payload, logical = encode_wire(flat, self.wire)
            self._chan.put(payload, seq, timeout_s=timeout_s)
            self._last_seq = seq
            self.bytes_logical += logical
            self.bytes_wire += len(payload)
            if self.metric_path:
                from hetu_tpu_torch.telemetry import default_registry
                quantwire.record_wire_bytes(default_registry,
                                            self.metric_path, logical,
                                            len(payload))
            return
        deadline = time.monotonic() + timeout_s
        # wait for the reader's ack of the previous message
        while self._last_seq and \
                int(self._flag(self.capacity + 1)) != \
                self._wire(self._last_seq):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"mailbox: ack of seq {self._last_seq} not observed "
                    f"within {timeout_s}s")
            time.sleep(poll_s)
        self.table.sparse_set(np.arange(flat.size), flat.reshape(-1, 1))
        self.table.sparse_set(
            [self.capacity],
            np.asarray([[float(self._wire(seq))]], np.float32))
        self._last_seq = seq

    def get(self, shape, seq: int, *, timeout_s: float = 60.0,
            poll_s: float = 0.002) -> np.ndarray:
        n = int(np.prod(shape))
        if self.impl == "blob":
            data = self._chan.get(seq, timeout_s=timeout_s)
            a = decode_wire(data, n, self.wire)
            self.bytes_logical += n * 4
            self.bytes_wire += len(data)
            return a.reshape(shape)
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                flag = self._flag(self.capacity)
            except RuntimeError:
                flag = None  # table not created yet / transient
            if flag is not None and int(flag) == self._wire(seq):
                data = self.table.sparse_pull(np.arange(n))
                self.table.sparse_set(
                    [self.capacity + 1],
                    np.asarray([[float(self._wire(seq))]], np.float32))
                return data.ravel().reshape(shape)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"mailbox: seq {seq} not observed within {timeout_s}s "
                    f"(last flag: {flag})")
            time.sleep(poll_s)

    def close(self) -> None:
        if self.impl == "blob":
            self._chan.close()
        else:
            self.table.close()


def _leaves(params):
    """``params`` (a tensor or a dict of tensors) -> (names, tensors);
    names is None for a lone tensor."""
    if isinstance(params, dict):
        names = list(params)
        return names, [params[k] for k in names]
    return None, [params]


def _rebuild(names, leaves):
    return leaves[0] if names is None else dict(zip(names, leaves))


class MPMDStageRunner:
    """General N-stage, unequal-DP MPMD pipeline worker.

    Each PROCESS runs one (stage, replica) pair of a pipeline whose stage
    s has ``stage_dps[s]`` data-parallel replicas.  Microbatch i is
    produced by stage-s replica ``i % stage_dps[s]`` and consumed by
    stage-(s+1) replica ``i % stage_dps[s+1]``: activations and
    cotangents hop processes through acked :class:`VanMailbox` channels
    on a shared van server; cross-replica gradient reduction rides a PS
    accumulator table and a van barrier.

    ``stage_fn(params, x)`` is any differentiable torch function of the
    stage's parameters (a tensor or a dict of tensors on ``device``) and
    its input.  ``run_step(params, loss_fn=, data=)`` runs one
    GPipe-flush forward and backward over the microbatches this replica
    owns and returns ``(loss summed over the microbatches it owns,
    gradients)``; the gradients are the stage's microbatch mean over all
    ``M``, already reduced over its replicas, shaped like ``params`` on
    ``device`` in f32.
    """

    def __init__(self, stage_fn, *, stage: int, replica: int,
                 stage_dps: List[int], n_microbatches: int,
                 in_shape, out_shape, host: str, port: int,
                 base_channel: int = 5_000_000, grad_size: int,
                 wire: str = "f32", worker_uid: int | None = None,
                 device="cuda"):
        import torch

        self.fn = stage_fn
        self.wire = quantwire.check_wire(wire)
        self.stage, self.replica = stage, replica
        self.dps = list(stage_dps)
        self.S = len(stage_dps)
        self.M = n_microbatches
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.host, self.port = host, port
        self.base = base_channel
        self.grad_size = grad_size
        self.device = torch.device(device)
        self._torch = torch
        self._mail: dict = {}
        self._seq: dict = {}
        self._acc = None
        # the last reducing step's accumulator push and pull, in seconds
        self.acc_seconds = {"push": 0.0, "pull": 0.0}
        # unique worker id across ALL processes of this pipeline
        self.uid = worker_uid if worker_uid is not None else \
            sum(self.dps[:stage]) + replica

    # channel id for edge (s -> s+1), sender replica a, receiver replica
    # b; backward cotangents use the mirrored id space
    def _chan(self, edge: int, a: int, b: int, backward: bool):
        key = (edge, a, b, backward)
        if key not in self._mail:
            cid = (self.base + edge * (1 << 14) + a * (1 << 7) + b
                   + ((1 << 22) if backward else 0))
            # edge e carries stage e's output size: my out_shape on my
            # downstream edge, my in_shape on my upstream edge
            cap = int(np.prod(self.out_shape)) if edge == self.stage \
                else int(np.prod(self.in_shape))
            self._mail[key] = VanMailbox(
                self.host, self.port, cid, cap, wire=self.wire,
                metric_path=f"mpmd.edge{edge}."
                            f"{'bwd' if backward else 'fwd'}")
            self._seq[key] = 0
        return self._mail[key]

    def _next_seq(self, edge, a, b, backward):
        key = (edge, a, b, backward)
        self._seq[key] += 1
        return self._seq[key]

    def _my_microbatches(self):
        return [m for m in range(self.M)
                if m % self.dps[self.stage] == self.replica]

    def _grad_plumbing(self):
        """One REUSABLE accumulator table and one van barrier for this
        stage, made on the first reducing step (the barrier's server-side
        generation counter matches successive rounds; the table is
        cleared in place between steps, as per-step tables would leak
        server memory)."""
        if self._acc is not None:
            return self._acc, self._barrier_cli
        from hetu_tpu_torch.ps.van import RemoteBarrier, RemotePSTable
        tid = self.base + (1 << 23) + self.stage
        if self.replica == 0:
            self._acc = RemotePSTable(self.host, self.port, self.grad_size,
                                      1, table_id=tid, create=True,
                                      init="zeros", optimizer="sgd",
                                      lr=-1.0)  # push == add
        else:
            # wait until replica 0 made it (a connect with create=False
            # never probes; a 1-row pull does)
            self._acc = RemotePSTable(self.host, self.port, self.grad_size,
                                      1, table_id=tid, create=False)
            deadline = time.monotonic() + 20
            while True:
                try:
                    self._acc.sparse_pull([0])
                    break
                except RuntimeError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.05)
        self._barrier_cli = RemoteBarrier(
            self.host, self.port,
            barrier_id=self.base + (1 << 23) + 64 + self.stage,
            n_workers=self.dps[self.stage])
        return self._acc, self._barrier_cli

    def _barrier(self, cli):
        cli.wait(timeout_s=60.0)

    def _host(self, t) -> np.ndarray:
        """A tensor as an f32 numpy array (the mailbox's payload)."""
        return t.detach().to(self._torch.float32).cpu().numpy()

    def _dev(self, a, requires_grad=False):
        t = self._torch.from_numpy(np.ascontiguousarray(a, np.float32))
        return t.to(self.device).requires_grad_(requires_grad)

    def run_step(self, params, *, loss_fn=None, data=None):
        """One forward and backward over the microbatches this replica
        owns.

        data: stage 0 only — per-microbatch inputs indexed by GLOBAL
        microbatch id (entries of other replicas may be None); numpy
        arrays or tensors.  loss_fn: last stage only — scalar loss of one
        microbatch's output; the step optimizes the mean loss over all
        microbatches.
        """
        torch = self._torch
        s, dps = self.stage, self.dps
        first, last = s == 0, s == self.S - 1
        names, given = _leaves(params)
        # the parameters as autograd leaves (a tensor that already
        # requires grad is one; any other is taken as a detached alias)
        leaves = [p if p.requires_grad and p.is_leaf
                  else p.detach().requires_grad_(True) for p in given]
        stage_params = _rebuild(names, leaves)
        graphs, losses = {}, {}
        # ---- forward (microbatch order; per-channel seqs stay aligned
        # because both endpoints walk their shared microbatches in order)
        for m in self._my_microbatches():
            if first:
                x = data[m]
                x = x.to(self.device) if torch.is_tensor(x) else \
                    self._dev(x)
            else:
                src = m % dps[s - 1]
                ch = self._chan(s - 1, src, self.replica, False)
                x = self._dev(ch.get(
                    self.in_shape,
                    self._next_seq(s - 1, src, self.replica, False)),
                    requires_grad=True)
            with torch.enable_grad():
                y = self.fn(stage_params, x)
                if last:
                    y = loss_fn(y)
                    losses[m] = float(y.detach())
            graphs[m] = (x, y)
            if not last:
                dst = m % dps[s + 1]
                ch = self._chan(s, self.replica, dst, False)
                ch.put(self._host(y),
                       self._next_seq(s, self.replica, dst, False))
        # ---- backward (same order: the flush schedule)
        gsum = None
        for m in self._my_microbatches():
            x, y = graphs.pop(m)
            if last:
                gy = None  # d(loss)/d(loss) = 1
            else:
                dst = m % dps[s + 1]
                ch = self._chan(s, self.replica, dst, True)
                gy = self._dev(ch.get(
                    self.out_shape,
                    self._next_seq(s, self.replica, dst, True))).to(y.dtype)
            wrt = leaves if first else [*leaves, x]
            got = torch.autograd.grad(y, wrt, grad_outputs=gy,
                                      allow_unused=True)
            gp = [torch.zeros_like(p, dtype=torch.float32) if g is None
                  else g.to(torch.float32) for p, g in zip(leaves, got)]
            if not first:
                src = m % dps[s - 1]
                ch = self._chan(s - 1, src, self.replica, True)
                ch.put(self._host(got[-1]),
                       self._next_seq(s - 1, src, self.replica, True))
            # ascending microbatch order, in f32
            gsum = gp if gsum is None else [a + b for a, b in zip(gsum, gp)]
            del x, y, got
        if gsum is None:  # this replica owns no microbatch
            gsum = [torch.zeros_like(p, dtype=torch.float32)
                    for p in leaves]
        flat = torch.cat([g.reshape(-1) for g in gsum])
        # ---- cross-replica gradient reduction: PS accumulator + barrier
        if dps[s] > 1:
            if flat.numel() != self.grad_size:
                raise ValueError(f"stage {s}: {flat.numel()} gradient "
                                 f"elements, grad_size {self.grad_size}")
            acc, barrier = self._grad_plumbing()
            t0 = time.perf_counter()
            acc.dense_push(self._host(flat).reshape(-1, 1))
            self.acc_seconds["push"] = time.perf_counter() - t0
            self._barrier(barrier)   # every replica pushed
            t0 = time.perf_counter()
            flat = self._dev(acc.dense_pull().reshape(-1))
            self.acc_seconds["pull"] = time.perf_counter() - t0
            self._barrier(barrier)   # every replica pulled the sum
            if self.replica == 0:
                acc.clear()          # reused next step: no per-step tables
            self._barrier(barrier)   # the clear landed before a re-push
        # the mean over the GLOBAL microbatch count
        flat = flat / torch.full_like(flat, float(self.M))
        out, off = [], 0
        for p in leaves:
            n = p.numel()
            out.append(flat[off:off + n].reshape(p.shape))
            off += n
        return sum(losses.values()), _rebuild(names, out)

    def edge_bytes(self) -> dict:
        """``{"edge<e>.fwd"|"edge<e>.bwd": {"logical": n, "wire": n}}``
        over this runner's mailboxes (both directions it sent or read)."""
        out: dict = {}
        for (edge, _, _, backward), mb in self._mail.items():
            d = out.setdefault(f"edge{edge}.{'bwd' if backward else 'fwd'}",
                               {"logical": 0, "wire": 0})
            d["logical"] += mb.bytes_logical
            d["wire"] += mb.bytes_wire
        return out

    def close(self):
        for mb in self._mail.values():
            mb.close()
        if self._acc is not None:
            self._acc.close()
            self._barrier_cli.close()
