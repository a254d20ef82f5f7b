"""The van's blob channel: the message plane of the serving front end and
of the migration wire (counterpart of the blob-channel part of
``hetu_tpu/ps/van.py``).

The van is the C++ TCP server embedded in the PS library
(``csrc/hetu_ps_van.cpp``, built with the in-process tier by
:mod:`hetu_tpu_torch.ps.binding`).  A process calls :func:`serve` to run
it; clients open :class:`BlobChannel` s (single-slot acked mailboxes) and
:class:`RemoteBarrier` s against it, and :func:`stats` reads its transport
counters.  The wire format is the reference's: a port client talks to a
reference server and the other way round.

Every client op runs under :func:`_op_span`: the fault hook and the netem
hook fire first (a raise surfaces before the wire op), then the op is
timed into ``telemetry.default_registry`` (``van.<op>.calls`` /
``.bytes`` / ``.latency_s`` / ``.errors``) and, with tracing on, a
``van.<op>`` span.

Not here: the remote tables (``RemotePSTable``, ``PartitionedPSTable``,
``RemoteCacheTable``), SSP, PReduce, the scheduler map and the
heartbeats (``serve_and_register``) come with the remote tiers
(``ROADMAP.md`` Queue 1 item 5).

Deadlines use ``time.monotonic()``: a wall-clock jump must not expire or
extend a transport timeout (the native layer uses a steady clock too).
"""

from __future__ import annotations

import ctypes
import os
import socket
import struct
import time
from typing import Optional

import numpy as np

from hetu_tpu_torch.ps.binding import lib
from hetu_tpu_torch.telemetry import default_registry
from hetu_tpu_torch.telemetry import trace as _trace


def fresh_table_id() -> int:
    """A table or channel id drawn from the band above the local ids:
    random 30-bit ids make clashes between processes sharing one server
    negligible.  The server's registries outlive ``stop()``/``serve()``
    cycles in one process, so fixed ids collide on re-create."""
    return (1 << 24) + int.from_bytes(os.urandom(3), "little")


_fault_hook = None
_netem_hook = None

# ---- per-op client telemetry ----------------------------------------------
# metric objects cached per op name: the steady state is one dict hit and
# one histogram observe per RPC

_op_cache: dict = {}


def _op_metrics(op: str):
    m = _op_cache.get(op)
    if m is None:
        reg = default_registry
        m = (reg.counter(f"van.{op}.calls"),
             reg.counter(f"van.{op}.bytes"),
             reg.histogram(f"van.{op}.latency_s"),
             reg.counter(f"van.{op}.errors"),
             "van." + op)
        _op_cache[op] = m
    return m


class _OpSpan:
    __slots__ = ("op", "nbytes", "_t0", "_tr0", "_traced")

    def __init__(self, op: str, nbytes: int = 0):
        self.op = op
        self.nbytes = int(nbytes)

    def __enter__(self):
        _maybe_inject(self.op)
        _maybe_netem(self.op, self.nbytes)
        # a span only if tracing was on for the WHOLE op: one enabled
        # mid-call would start at the tracer's epoch
        self._traced = _trace.enabled()
        if self._traced:
            self._tr0 = _trace.now_us()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self._t0
        calls, nbytes, lat, errors, span_name = _op_metrics(self.op)
        calls.inc()
        if exc_type is not None:
            # a failed or timed-out op (a listener's idle poll too) must
            # not skew the latency of the ops that succeeded
            errors.inc()
            return False
        if self.nbytes:
            nbytes.inc(self.nbytes)
        lat.observe(dt)
        if self._traced and _trace.enabled():
            _trace.complete(span_name, self._tr0,
                            {"bytes": self.nbytes} if self.nbytes else None,
                            cat="van")
        return False


def _op_span(op: str, nbytes: int = 0) -> _OpSpan:
    return _OpSpan(op, nbytes)


def op_stats() -> dict:
    """Per-op client-side RPC stats from the process-default registry:
    ``{op: {calls, bytes, errors, latency: {count, sum, p50, p90, p99,
    ...}}}``."""
    out: dict = {}
    for name, m in default_registry.metrics().items():
        if not name.startswith("van."):
            continue
        parts = name.split(".", 2)
        if len(parts) != 3:
            continue  # not a per-op metric
        _, op, field = parts
        d = out.setdefault(op, {})
        if field == "latency_s":
            d["latency"] = m.snapshot()
        else:
            d[field] = m.value
    return out


def set_fault_hook(hook):
    """Install ``hook(op: str)``, called before every client-side wire op
    (blob put and get).  It may sleep (a delay) or raise (a
    transient error, surfacing to the caller as a real transport failure
    would, so retry paths run end to end).  Returns the hook it
    replaced."""
    global _fault_hook
    prev = _fault_hook
    _fault_hook = hook
    return prev


def set_netem_hook(hook):
    """Install ``hook(op: str, nbytes: int)``, called before every
    client-side wire op AFTER the fault hook; ``nbytes`` is the op's
    payload size where it is known before delivery (0 for a blob get), so
    the hook can model bandwidth as well as latency.  It may sleep or
    raise.  Returns the hook it replaced.  A bound method of an object
    with ``current_rate_mbps()`` also tells the migration wire's ``auto``
    codec the link's rate (``serve.migrate.known_link_mbps``)."""
    global _netem_hook
    prev = _netem_hook
    _netem_hook = hook
    return prev


def _maybe_inject(op: str) -> None:
    hook = _fault_hook
    if hook is not None:
        hook(op)


def _maybe_netem(op: str, nbytes: int) -> None:
    hook = _netem_hook
    if hook is not None:
        hook(op, nbytes)


def set_rcv_timeout(fd: int, timeout_s: float) -> None:
    """Arm ``SO_RCVTIMEO`` on a raw van connection (a copy of
    ``hetu_tpu/ps/replica.py``'s): the native client's ``recv`` otherwise
    blocks forever against a stopped (SIGSTOPped) server, whose kernel
    keeps the socket open; with it the op fails with the transport rc.
    Socket options are kernel state, so a dup'd descriptor sets them for
    the original."""
    if fd < 0:
        return
    s = socket.socket(fileno=os.dup(fd))
    try:
        tv = struct.pack("ll", int(timeout_s),
                         int((timeout_s % 1.0) * 1e6))
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVTIMEO, tv)
    finally:
        s.close()


def _connect_with_deadline(host: str, port: int, timeout_s: float,
                           rcv_timeout_s: Optional[float] = None) -> int:
    """Retry ``ps_van_connect`` until it succeeds or ``timeout_s`` passes
    (``ConnectionError``).  ``rcv_timeout_s`` arms ``SO_RCVTIMEO`` on the
    new connection before any op runs over it."""
    deadline = time.monotonic() + timeout_s
    fd = lib.ps_van_connect(host.encode(), port)
    while fd < 0:
        if time.monotonic() > deadline:
            raise ConnectionError(f"cannot reach PS van {host}:{port}")
        time.sleep(0.05)
        fd = lib.ps_van_connect(host.encode(), port)
    if rcv_timeout_s is not None and rcv_timeout_s > 0:
        try:
            set_rcv_timeout(fd, rcv_timeout_s)
        except OSError as e:
            # the connection died between connect and setsockopt: surface
            # the wire error it is (retry layers classify ConnectionError,
            # not EBADF) and do not leak the descriptor
            lib.ps_van_close(fd)
            raise ConnectionError(
                f"van connection to {host}:{port} died during "
                f"setup") from e
    return fd


def serve(port: int = 0) -> int:
    """Start this process's van server on ``port`` (0: a free one);
    returns the bound port.  Raises if it cannot start (already running,
    or the port is taken)."""
    bound = lib.ps_van_start(port)
    if bound == 0:
        raise RuntimeError("ps van failed to start (already running?)")
    return bound


def stop() -> None:
    """Stop this process's van server; its channels and barriers go with
    it (a later ``serve()`` starts empty)."""
    lib.ps_van_stop()


class BlobChannel:
    """One-way bulk-blob mailbox over the van: a single-slot acked server
    channel.

    ``put(bytes_like, seq)`` is ONE round trip (the server blocks it
    until the previous message is acked); ``get(seq)`` is one blocking
    round trip plus one ack frame.  All three wire ops are idempotent
    under a same-seq resend, so each retries after a transport failure on
    a fresh connection.

    Return codes of the native calls: -11 the slot still holds an unread
    message (put; retried until the deadline, then ``TimeoutError``), -12
    the seq is not delivered yet (get; likewise), -101 the transport
    failed (reconnect and resend), -102 the receive buffer is too small
    (grow it to the size the server reports and read again); any other
    code is a server-side refusal (``RuntimeError`` at once).
    """

    def __init__(self, host: str, port: int, channel_id: int, *,
                 connect_timeout_s: float = 20.0,
                 rcv_timeout_s: Optional[float] = None):
        self.host, self.port = host, port
        self.id = int(channel_id)
        self._timeout_s = connect_timeout_s
        self._rcv_timeout_s = rcv_timeout_s
        # the receive buffer outlives get(): a channel's messages are
        # usually of one size, so after one growth every get is a single
        # round trip
        self._rbuf = ctypes.create_string_buffer(1 << 20)
        self.fd = _connect_with_deadline(host, port, connect_timeout_s,
                                         rcv_timeout_s)

    def _reconnect(self) -> None:
        # op-shaped name: op_stats() shows it as
        # {"blob_channel": {"reconnects": n}}
        default_registry.counter("van.blob_channel.reconnects").inc()
        if self.fd >= 0:
            lib.ps_van_close(self.fd)
        self.fd = _connect_with_deadline(self.host, self.port,
                                         self._timeout_s,
                                         self._rcv_timeout_s)

    def reconnect(self) -> None:
        """Drop the connection and open a fresh one.  Safe at any message
        boundary: a caller that reconnects mid-stream (or lost its
        transport) resumes at the seq it was on."""
        self._reconnect()

    def put(self, data, seq: int, *, timeout_s: float = 60.0) -> None:
        buf = bytes(data) if isinstance(
            data, (bytes, bytearray, memoryview)) else \
            np.ascontiguousarray(data).tobytes()
        with _op_span("blob_put", len(buf)):
            deadline = time.monotonic() + timeout_s
            while True:
                wait_ms = max(1, int((deadline - time.monotonic()) * 1000))
                rc = lib.ps_van_blob_put(self.fd, self.id, seq, buf,
                                         len(buf), wait_ms)
                if rc == 0:
                    return
                if time.monotonic() > deadline:
                    if rc == -11:  # the previous message is still unread
                        raise TimeoutError(
                            f"blob put: ack of the previous message not "
                            f"observed within {timeout_s}s")
                    raise RuntimeError(f"blob put failed (rc={rc})")
                if rc == -101:  # transport: reconnect and resend
                    self._reconnect()
                elif rc != -11:
                    # a server-side refusal: resending it in a tight loop
                    # would hammer the van for the whole timeout
                    raise RuntimeError(f"blob put failed (rc={rc})")

    def get(self, seq: int, *, timeout_s: float = 60.0) -> bytes:
        cap = 1 << 28
        with _op_span("blob_get") as sp:
            deadline = time.monotonic() + timeout_s
            need = ctypes.c_int64(0)
            while True:
                wait_ms = max(1, int((deadline - time.monotonic()) * 1000))
                n = lib.ps_van_blob_get(self.fd, self.id, seq, self._rbuf,
                                        len(self._rbuf), wait_ms,
                                        ctypes.byref(need))
                if n >= 0:
                    self._ack(seq, deadline)
                    sp.nbytes = int(n)  # the size is known on delivery
                    return ctypes.string_at(self._rbuf, n)
                if n == -102 and need.value <= cap:
                    # grow to the reported size, with 2x headroom so a
                    # channel whose messages keep growing does not pay a
                    # re-transfer on every small increase
                    self._rbuf = ctypes.create_string_buffer(
                        min(cap, max(int(need.value), 2 * len(self._rbuf))))
                    continue
                if time.monotonic() > deadline:
                    if n == -12:
                        raise TimeoutError(
                            f"blob get: seq {seq} not delivered within "
                            f"{timeout_s}s")
                    raise RuntimeError(f"blob get failed (rc={n})")
                if n == -101:
                    self._reconnect()
                elif n != -12:
                    raise RuntimeError(f"blob get failed (rc={n})")

    def _ack(self, seq: int, deadline: float) -> None:
        """A lost ack wedges the slot (the writer's next put blocks until
        it lands), so it retries across reconnects like put and get."""
        while True:
            rc = lib.ps_van_blob_ack(self.fd, self.id, seq)
            if rc == 0:
                return
            if rc != -101 or time.monotonic() > deadline:
                raise RuntimeError(f"blob ack failed (rc={rc})")
            self._reconnect()

    def close(self) -> None:
        if self.fd >= 0:
            lib.ps_van_close(self.fd)
            self.fd = -1


class RemoteBarrier:
    """A worker barrier on the van: the ``n_workers``-th arrival releases
    everyone; reusable across rounds (a server-side generation count).  A
    waiter that times out withdraws its arrival."""

    def __init__(self, host: str, port: int, barrier_id: int,
                 n_workers: int, connect_timeout_s: float = 10.0):
        self.fd = _connect_with_deadline(host, port, connect_timeout_s)
        self.id = int(barrier_id)
        self.n = int(n_workers)

    def wait(self, timeout_s: float = 60.0) -> None:
        rc = lib.ps_van_barrier(self.fd, self.id, self.n,
                                int(timeout_s * 1000))
        if rc == -9:
            raise TimeoutError(
                f"barrier {self.id}: {self.n} workers did not all arrive "
                f"within {timeout_s}s")
        if rc != 0:
            raise RuntimeError(f"barrier failed (rc={rc})")

    def close(self) -> None:
        if self.fd >= 0:
            lib.ps_van_close(self.fd)
            self.fd = -1


def stats(host: str, port: int, timeout_s: float = 10.0) -> dict:
    """The server's transport counters since it started: frames handled
    and bytes received and sent (this query's frame included)."""
    fd = _connect_with_deadline(host, port, timeout_s)
    try:
        frames = ctypes.c_uint64()
        rx = ctypes.c_uint64()
        tx = ctypes.c_uint64()
        rc = lib.ps_van_stats(fd, ctypes.byref(frames), ctypes.byref(rx),
                              ctypes.byref(tx))
        if rc != 0:
            raise RuntimeError(f"stats query failed (rc={rc})")
        return {"frames": frames.value, "bytes_rx": rx.value,
                "bytes_tx": tx.value}
    finally:
        lib.ps_van_close(fd)


def stats_frames(host: str, port: int, timeout_s: float = 10.0) -> int:
    return stats(host, port, timeout_s)["frames"]
