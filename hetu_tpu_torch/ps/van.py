"""The van: the parameter server's message plane across processes and
hosts (counterpart of ``hetu_tpu/ps/van.py``).

The van is the C++ TCP server embedded in the PS library
(``csrc/hetu_ps_van.cpp``, built with the other tiers by
:mod:`hetu_tpu_torch.ps.binding`).  A process calls :func:`serve` (or
:func:`serve_and_register`, which also registers it with a scheduler and
keeps the registration alive) to run it.  Clients talk to it through:

* :class:`RemotePSTable` — one table on one server (dtype'd rows, the
  quantised gradient wire with error feedback, compare-and-set, slots);
* :class:`PartitionedPSTable` — one table key-range-partitioned over
  several servers, listed or resolved from a scheduler
  (:func:`scheduler_map`), recreating a shard whose server restarted;
* :class:`RemoteCacheTable` — the HET cache over such a table;
* :class:`RemoteSSP`, :class:`RemotePReduce` — SSP clocks and
  partial-reduce matchmaking held by a server;
* :class:`BlobChannel` s (single-slot acked mailboxes),
  :class:`RemoteBarrier` s and :func:`stats` (its transport counters).

The wire format is the reference's: a port client talks to a reference
server and the other way round.

Every client op runs under :func:`_op_span`: the fault hook and the netem
hook fire first (a raise surfaces before the wire op), then the op is
timed into ``telemetry.default_registry`` (``van.<op>.calls`` /
``.bytes`` / ``.latency_s`` / ``.errors``, and for a quantised op
``van.<op>.bytes_logical`` / ``.bytes_wire`` / ``.bytes_saved``) and,
with tracing on, a ``van.<op>`` span.

Deadlines use ``time.monotonic()``: a wall-clock jump must not expire or
extend a transport timeout (the native layer uses a steady clock too).
"""

from __future__ import annotations

import ctypes
import os
import socket
import struct
import threading
import time
from typing import Optional

import numpy as np

from hetu_tpu_torch.ps.binding import lib
from hetu_tpu_torch.ps.client import (
    _INIT_KINDS, _OPT_KINDS, _POLICIES, TABLE_DTYPES, WIRE_DTYPES,
    ErrorFeedback, _as_idx, _as_mat, _check, _f32p, _i64p, _out_rows,
    _u64p, cache_metrics,
)
from hetu_tpu_torch.quantwire import record_wire_bytes, row_wire_bytes
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
    __slots__ = ("op", "nbytes", "logical_nbytes", "_t0", "_tr0",
                 "_traced")

    def __init__(self, op: str, nbytes: int = 0, logical_nbytes: int = 0):
        self.op = op
        self.nbytes = int(nbytes)
        # nonzero only for a quantised op: nbytes is then the wire's count
        # and logical_nbytes the f32 payload's, recorded as the pair
        # van.<op>.bytes_logical / .bytes_wire (and .bytes_saved)
        self.logical_nbytes = int(logical_nbytes)

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
        if self.logical_nbytes:
            record_wire_bytes(default_registry, span_name,
                              self.logical_nbytes, self.nbytes)
        lat.observe(dt)
        if self._traced and _trace.enabled():
            _trace.complete(span_name, self._tr0,
                            {"bytes": self.nbytes} if self.nbytes else None,
                            cat="van")
        return False


def _op_span(op: str, nbytes: int = 0, logical_nbytes: int = 0) -> _OpSpan:
    return _OpSpan(op, nbytes, logical_nbytes)


class _WireUnsupported(Exception):
    """rc -100 from a quantised wire op (a server that predates it).
    Raised inside the op's span, so the refused attempt counts as a call
    and an error only; the f32 retry records the real transfer."""


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
    (pulls, pushes, sets, blob put and get).  It may sleep (a delay) or raise (a
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


_fd_lock = threading.Lock()


def _take_fd(conn) -> int:
    """Detach ``conn``'s descriptor (``fd`` becomes -1) and return it,
    for the one caller that then closes it.  Two threads that close one
    handle (both saw its transport fail), or a close after a reconnect
    that failed, would otherwise close the number twice, the second time
    after the kernel may have handed it to another connection."""
    with _fd_lock:
        fd, conn.fd = conn.fd, -1
    return fd


_beat_handles: list = []


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
    it (a later ``serve()`` starts empty).  Its scheduler heartbeats stop
    first: a beat that outlived the server would advertise a dead
    endpoint as alive."""
    while _beat_handles:
        lib.ps_sched_beat_stop(_beat_handles.pop())
    lib.ps_van_stop()


def serve_and_register(sched_host: str, sched_port: int, *,
                       port: int = 0, rank_hint: int = -1,
                       beat_ms: int = 1000,
                       register_timeout_s: float = 10.0) -> tuple:
    """Start this process's van server and register it with the scheduler
    at ``sched_host:sched_port`` (a van server too).  The scheduler
    assigns a rank, or honours ``rank_hint`` (a server rejoining, also at
    another port or host), and learns the endpoint from the registration's
    connection.  A native heartbeat thread keeps the registration alive
    until :func:`stop`.  Returns ``(bound_port, rank)``."""
    bound = serve(port)
    h = lib.ps_sched_beat_start(sched_host.encode(), sched_port, rank_hint,
                                bound, beat_ms, register_timeout_s)
    if h <= 0:
        stop()
        raise ConnectionError(
            f"cannot register with scheduler {sched_host}:{sched_port}")
    _beat_handles.append(h)
    return bound, int(lib.ps_sched_beat_rank(h))


def scheduler_map(host: str, port: int) -> list:
    """The scheduler's endpoint map: ``[{rank, alive, host, port}, ...]``."""
    fd = lib.ps_van_connect(host.encode(), port)
    if fd < 0:
        raise ConnectionError(f"cannot reach scheduler {host}:{port}")
    try:
        kmax = 64
        ranks = (ctypes.c_int32 * kmax)()
        alive = (ctypes.c_uint8 * kmax)()
        ports = (ctypes.c_int32 * kmax)()
        hosts = ctypes.create_string_buffer(kmax * 64)
        n = lib.ps_van_sched_map(fd, kmax, ranks, alive, ports, hosts)
        if n < 0:
            raise RuntimeError(f"scheduler map query failed rc={n}")
        return [{"rank": int(ranks[i]), "alive": bool(alive[i]),
                 "host": hosts.raw[i * 64:(i + 1) * 64].split(b"\0")[0]
                 .decode(), "port": int(ports[i])} for i in range(n)]
    finally:
        lib.ps_van_close(fd)


class RemotePSTable:
    """A :class:`~hetu_tpu_torch.ps.client.PSTable` held by the van server
    at ``host:port`` (the worker side of the reference's kvworker).

    ``dtype`` ("f32", "bf16", "int8") is the rows' storage and their
    encoding on the wire: a pull or set of a bf16 table moves half the
    bytes, of an int8 one a quarter (and a scale a row); gradients push
    in bf16 to a bf16 table and in f32 otherwise.  Callers see f32 arrays
    only.  Both ends of a shared table id must agree on its dtype.

    ``wire`` ("bf16", "int8"; None or "f32" for the f32 wire) quantises
    the gradient plane too (``dense_push``, ``sparse_push``,
    ``dense_pull``), whatever the storage; int8 keeps an
    :class:`~hetu_tpu_torch.ps.client.ErrorFeedback` residual unless
    ``error_feedback=False``.  Each message names its wire type, and a
    server that predates the quantised ops answers rc -100: the client
    then falls back to the f32 ops for the connection's life and counts
    it in ``van.wire_negotiation.fallbacks``.  The savings land in
    ``telemetry.default_registry`` as ``van.<op>.bytes_logical`` /
    ``.bytes_wire`` / ``.bytes_saved``.

    ``create=False`` attaches to a table that exists (``table_id`` then
    names it); otherwise the table is created with a fresh id unless
    ``table_id`` is given.

    ``reconnect=False`` makes a transport failure close the connection
    (``fd`` -1) and raise at once, where by default the handle first
    connects again (up to ``connect_timeout_s``): the replicated tier's
    handles (:mod:`hetu_tpu_torch.ps.replica`) must not wait out a
    connect deadline against a primary that died."""

    def __init__(self, host: str, port: int, rows: int, dim: int, *,
                 table_id: Optional[int] = None, create: bool = True,
                 init: str = "normal", init_a: float = 0.0,
                 init_b: float = 0.01, seed: int = 0,
                 optimizer: str = "sgd", lr: float = 0.01,
                 momentum: float = 0.9, eps: float = 1e-7,
                 beta1: float = 0.9, beta2: float = 0.999,
                 dtype: str = "f32", wire: Optional[str] = None,
                 error_feedback: bool = True,
                 connect_timeout_s: float = 10.0,
                 rcv_timeout_s: Optional[float] = None,
                 reconnect: bool = True):
        self.rows, self.dim = rows, dim
        self.dtype = dtype
        self._reconnect_on_loss = bool(reconnect)
        self._dt = TABLE_DTYPES[dtype]
        if wire is not None and wire not in WIRE_DTYPES:
            raise ValueError(f"unknown wire dtype {wire!r}; expected one "
                             f"of {sorted(WIRE_DTYPES)}")
        self.wire = None if wire == "f32" else wire
        self._wdt = WIRE_DTYPES[wire] if self.wire else 0
        self._ef = ErrorFeedback(dim) if (
            self.wire == "int8" and error_feedback) else None
        self.fd = _connect_with_deadline(host, port, connect_timeout_s,
                                         rcv_timeout_s)
        self._addr = (host, port, connect_timeout_s, rcv_timeout_s)
        self.id = table_id if table_id is not None else fresh_table_id()
        if create:
            try:
                _check(lib.ps_van_table_create_dt(
                    self.fd, self.id, rows, dim, _INIT_KINDS[init], init_a,
                    init_b, seed, self._dt), "van_table_create")
                _check(lib.ps_van_set_optimizer(
                    self.fd, self.id, _OPT_KINDS[optimizer], lr, momentum,
                    eps, beta1, beta2), "van_set_optimizer")
            except Exception:
                self.close()  # the connection must not outlive a failed
                raise         # create (a lost race, a server refusal)

    def ping(self) -> bool:
        return lib.ps_van_ping(self.fd) == 0

    def _wire_unsupported(self) -> None:
        """rc -100 from a quantised op: fall back to the f32 ops for the
        connection's life, and count it once."""
        default_registry.counter(
            "van.wire_negotiation.fallbacks",
            help="quantized-wire clients downgraded to f32 by an old "
                 "server").inc()
        self.wire = None
        self._ef = None

    def _wire(self, rc: int, what: str) -> None:
        """``_check`` for the ops the membership plane retries
        (``sparse_pull``, ``sparse_set``, ``row_cas``): a transport
        failure (rc -101) may leave the connection mid-frame, so it is
        replaced before the error surfaces and a retry runs on a clean
        stream (the table lives on the server, not in the
        connection)."""
        if rc == -101:
            fd = _take_fd(self)
            if fd >= 0:
                lib.ps_van_close(fd)
            if self._reconnect_on_loss:
                self.fd = _connect_with_deadline(*self._addr)
        _check(rc, what)

    def sparse_pull(self, indices) -> np.ndarray:
        idx = _as_idx(indices)
        out = np.empty((idx.shape[0], self.dim), np.float32)
        with _op_span("van_sparse_pull", out.nbytes):
            self._wire(lib.ps_van_sparse_pull_dt(
                self.fd, self.id, _i64p(idx), idx.shape[0], _f32p(out),
                self.dim, self._dt), "van_sparse_pull")
        return out

    def sparse_push(self, indices, grads) -> None:
        idx = _as_idx(indices)
        g = _as_mat(grads, idx.shape[0], self.dim)
        if self.wire:
            logical = g.nbytes
            if self._ef is not None:
                g = self._ef.fold_sparse(idx, g)
            rt = np.empty_like(g) if self._ef is not None else None
            n = idx.shape[0]
            try:
                with _op_span("van_sparse_push",
                              row_wire_bytes(self.wire, n, self.dim),
                              logical_nbytes=logical):
                    rc = lib.ps_van_sparse_push_w(
                        self.fd, self.id, _i64p(idx), _f32p(g), n,
                        self.dim, self._wdt, 0,
                        None if rt is None else _f32p(rt))
                    if rc == -100:
                        raise _WireUnsupported
                    _check(rc, "van_sparse_push_w")
            except _WireUnsupported:
                self._wire_unsupported()
                return self.sparse_push(idx, g)
            if self._ef is not None:
                self._ef.absorb_sparse(idx, g, rt)
            return
        with _op_span("van_sparse_push", g.nbytes):
            _check(lib.ps_van_sparse_push_dt(self.fd, self.id, _i64p(idx),
                                             _f32p(g), idx.shape[0],
                                             self.dim, self._dt),
                   "van_sparse_push")

    def dense_pull(self) -> np.ndarray:
        out = np.empty((self.rows, self.dim), np.float32)
        if self.wire:
            try:
                with _op_span("van_dense_pull",
                              row_wire_bytes(self.wire, self.rows, self.dim),
                              logical_nbytes=out.nbytes):
                    rc = lib.ps_van_dense_pull_w(
                        self.fd, self.id, _f32p(out), self.rows, self.dim,
                        self._wdt)
                    if rc == -100:
                        raise _WireUnsupported
                    _check(rc, "van_dense_pull_w")
            except _WireUnsupported:
                self._wire_unsupported()
                return self.dense_pull()
            return out
        with _op_span("van_dense_pull", out.nbytes):
            _check(lib.ps_van_dense_pull(self.fd, self.id, _f32p(out),
                                         self.rows * self.dim),
                   "van_dense_pull")
        return out

    def dense_push(self, grad) -> None:
        g = _as_mat(grad, self.rows, self.dim)
        if self.wire:
            logical = g.nbytes
            if self._ef is not None:
                g = self._ef.fold_dense(g)
            rt = np.empty_like(g) if self._ef is not None else None
            try:
                with _op_span("van_dense_push",
                              row_wire_bytes(self.wire, self.rows, self.dim),
                              logical_nbytes=logical):
                    rc = lib.ps_van_dense_push_w(
                        self.fd, self.id, _f32p(g), self.rows, self.dim,
                        self._wdt, 0, None if rt is None else _f32p(rt))
                    if rc == -100:
                        raise _WireUnsupported
                    _check(rc, "van_dense_push_w")
            except _WireUnsupported:
                self._wire_unsupported()
                return self.dense_push(g)
            if self._ef is not None:
                self._ef.absorb_dense(g, rt)
            return
        with _op_span("van_dense_push", g.nbytes):
            _check(lib.ps_van_dense_push(self.fd, self.id, _f32p(g),
                                         self.rows * self.dim),
                   "van_dense_push")

    def sparse_set(self, indices, values) -> None:
        idx = _as_idx(indices)
        v = _as_mat(values, idx.shape[0], self.dim)
        with _op_span("van_sparse_set", v.nbytes):
            self._wire(lib.ps_van_sparse_set_dt(
                self.fd, self.id, _i64p(idx), _f32p(v), idx.shape[0],
                self.dim, self._dt), "van_sparse_set")

    def row_cas(self, row: int, field: int, expected: float, desired):
        """Compare field ``field`` of ``row`` with ``expected`` and, if they
        match, write the whole ``desired`` row, atomically among CAS
        callers.  Returns ``(swapped, row after the op)``: a losing
        claimant reads the winner's row from the same round trip.  Raises
        ``NotImplementedError`` against a server without the op (rc
        -100)."""
        d = np.ascontiguousarray(np.asarray(desired, np.float32).reshape(-1))
        if d.shape[0] != self.dim:
            raise ValueError(f"desired row has {d.shape[0]} fields; "
                             f"table dim is {self.dim}")
        actual = np.empty(self.dim, np.float32)
        with _op_span("van_row_cas", d.nbytes):
            rc = lib.ps_van_row_cas(self.fd, self.id, int(row), int(field),
                                    float(expected), _f32p(d), self.dim,
                                    _f32p(actual))
        if rc == -100:
            raise NotImplementedError("van server does not speak OP_ROW_CAS")
        if rc not in (0, 1):
            self._wire(rc, "van_row_cas")
        return rc == 0, actual

    def clear(self) -> None:
        """Zero the table in place; bumps versions, so caches re-pull."""
        _check(lib.ps_van_table_clear(self.fd, self.id), "van_table_clear")

    def slots_get(self, indices):
        """The server-side optimizer's slots of ``indices``: ``(s1, s2,
        step)`` as ``PSTable.slots_get`` gives them; f32 on the wire
        whatever the row dtype."""
        idx = _as_idx(indices)
        n = idx.shape[0]
        s1 = np.empty((n, self.dim), np.float32)
        s2 = np.empty((n, self.dim), np.float32)
        step = np.empty(n, np.uint64)
        with _op_span("van_slots_get", s1.nbytes + s2.nbytes + step.nbytes):
            _check(lib.ps_van_table_slots_get(
                self.fd, self.id, _i64p(idx), n, self.dim, _f32p(s1),
                _f32p(s2), _u64p(step)), "van_slots_get")
        return s1, s2, step

    def slots_set(self, indices, s1, s2, step) -> None:
        idx = _as_idx(indices)
        n = idx.shape[0]
        s1 = _as_mat(s1, n, self.dim)
        s2 = _as_mat(s2, n, self.dim)
        step = np.ascontiguousarray(step, np.uint64).reshape(n)
        with _op_span("van_slots_set", s1.nbytes + s2.nbytes + step.nbytes):
            _check(lib.ps_van_table_slots_set(
                self.fd, self.id, _i64p(idx), n, self.dim, _f32p(s1),
                _f32p(s2), _u64p(step)), "van_slots_set")

    def save(self, path) -> None:
        _check(lib.ps_van_table_save(self.fd, self.id, str(path).encode()),
               "van_table_save")

    def load(self, path) -> None:
        _check(lib.ps_van_table_load(self.fd, self.id, str(path).encode()),
               "van_table_load")

    def close(self) -> None:
        fd = _take_fd(self)
        if fd >= 0:
            lib.ps_van_close(fd)


class PartitionedPSTable:
    """One table key-range-partitioned over N van servers: keys in
    ``[rows·i/n, rows·(i+1)/n)`` live on server i, at local row ids.  The
    range split, the fan-out, the heartbeats and the retries live in the
    native group (``csrc/hetu_ps_group.cpp``).

    A server that restarts blank gets its shard recreated (fresh init) by
    the next call that reaches it, and :attr:`recovered` counts it; the
    caller decides whether to restore rows (``sparse_set`` from a
    checkpoint).  ``endpoints``: ``"host:port,host:port"`` or
    ``[(host, port), ...]``."""

    def __init__(self, endpoints, rows: int, dim: int, *,
                 table_id: Optional[int] = None,
                 init: str = "normal", init_a: float = 0.0,
                 init_b: float = 0.01, seed: int = 0,
                 optimizer: str = "sgd", lr: float = 0.01,
                 momentum: float = 0.9, eps: float = 1e-7,
                 beta1: float = 0.9, beta2: float = 0.999,
                 dtype: str = "f32",
                 connect_timeout_s: float = 10.0,
                 heartbeat_ms: int = 0):
        if not isinstance(endpoints, str):
            endpoints = ",".join(f"{h}:{p}" for h, p in endpoints)
        self.rows, self.dim = rows, dim
        self.dtype = dtype
        self.id = table_id if table_id is not None else fresh_table_id()
        gid = lib.ps_group_create_dt(
            endpoints.encode(), self.id, rows, dim, _INIT_KINDS[init],
            init_a, init_b, seed, connect_timeout_s, heartbeat_ms,
            TABLE_DTYPES[dtype])
        if gid <= 0:
            raise ConnectionError(
                f"cannot establish PS group over {endpoints} (rc={gid})")
        self._finish_init(gid, optimizer, lr, momentum, eps, beta1, beta2)

    def _finish_init(self, gid, optimizer, lr, momentum, eps, beta1, beta2):
        self.gid = gid
        self.lr = lr
        try:
            _check(lib.ps_group_set_optimizer(
                gid, _OPT_KINDS[optimizer], lr, momentum, eps, beta1, beta2),
                "group_set_optimizer")
        except Exception:
            # the native group and its heartbeat thread must not leak
            self.gid = 0
            lib.ps_group_close(gid)
            raise

    @classmethod
    def from_scheduler(cls, sched_host: str, sched_port: int,
                       n_servers: int, rows: int, dim: int, *,
                       table_id: Optional[int] = None,
                       init: str = "normal", init_a: float = 0.0,
                       init_b: float = 0.01, seed: int = 0,
                       optimizer: str = "sgd", lr: float = 0.01,
                       momentum: float = 0.9, eps: float = 1e-7,
                       beta1: float = 0.9, beta2: float = 0.999,
                       dtype: str = "f32",
                       connect_timeout_s: float = 10.0,
                       heartbeat_ms: int = 0) -> "PartitionedPSTable":
        """The endpoints of ranks ``0..n_servers-1`` resolved from the
        scheduler (waiting until all are alive).  A shard whose direct
        reconnect fails re-resolves its endpoint there, so a server may
        rejoin at another address with no change on the client."""
        self = cls.__new__(cls)
        self.rows, self.dim = rows, dim
        self.dtype = dtype
        self.id = table_id if table_id is not None else fresh_table_id()
        gid = lib.ps_group_create_sched_dt(
            sched_host.encode(), sched_port, n_servers, self.id, rows, dim,
            _INIT_KINDS[init], init_a, init_b, seed, connect_timeout_s,
            heartbeat_ms, TABLE_DTYPES[dtype])
        if gid <= 0:
            raise ConnectionError(
                f"cannot establish PS group via scheduler "
                f"{sched_host}:{sched_port} (rc={gid})")
        self._finish_init(gid, optimizer, lr, momentum, eps, beta1, beta2)
        return self

    @property
    def n_servers(self) -> int:
        return int(lib.ps_group_n(self.gid))

    @property
    def shard_starts(self) -> list:
        return [int(lib.ps_group_start(self.gid, i))
                for i in range(self.n_servers)]

    @property
    def alive(self) -> list:
        mask = int(lib.ps_group_alive_mask(self.gid))
        return [bool(mask & (1 << i)) for i in range(self.n_servers)]

    @property
    def recovered(self) -> int:
        """How many times a shard of a server restarted blank was
        recreated."""
        return int(lib.ps_group_recovered(self.gid))

    def sparse_pull(self, indices, *, out=None) -> np.ndarray:
        """The rows of ``indices`` ``[n, dim]`` f32, into ``out`` where
        given."""
        idx = _as_idx(indices)
        out = _out_rows(out, idx.shape[0], self.dim)
        with _op_span("group_sparse_pull", out.nbytes):
            _check(lib.ps_group_sparse_pull(self.gid, _i64p(idx),
                                            idx.shape[0], _f32p(out)),
                   "group_sparse_pull")
        return out

    def sparse_push(self, indices, grads) -> None:
        idx = _as_idx(indices)
        g = _as_mat(grads, idx.shape[0], self.dim)
        with _op_span("group_sparse_push", g.nbytes):
            _check(lib.ps_group_sparse_push(self.gid, _i64p(idx), _f32p(g),
                                            idx.shape[0]),
                   "group_sparse_push")

    def sparse_set(self, indices, values) -> None:
        idx = _as_idx(indices)
        v = _as_mat(values, idx.shape[0], self.dim)
        with _op_span("group_sparse_set", v.nbytes):
            _check(lib.ps_group_sparse_set(self.gid, _i64p(idx), _f32p(v),
                                           idx.shape[0]),
                   "group_sparse_set")

    def dense_pull(self) -> np.ndarray:
        out = np.empty((self.rows, self.dim), np.float32)
        with _op_span("group_dense_pull", out.nbytes):
            _check(lib.ps_group_dense_pull(self.gid, _f32p(out)),
                   "group_dense_pull")
        return out

    def dense_push(self, grad) -> None:
        g = _as_mat(grad, self.rows, self.dim)
        with _op_span("group_dense_push", g.nbytes):
            _check(lib.ps_group_dense_push(self.gid, _f32p(g)),
                   "group_dense_push")

    def slots_get(self, indices):
        """The server-side optimizer's slots across the group: ``(s1, s2,
        step)``."""
        idx = _as_idx(indices)
        n = idx.shape[0]
        s1 = np.empty((n, self.dim), np.float32)
        s2 = np.empty((n, self.dim), np.float32)
        step = np.empty(n, np.uint64)
        with _op_span("group_slots_get",
                      s1.nbytes + s2.nbytes + step.nbytes):
            _check(lib.ps_group_slots_get(self.gid, _i64p(idx), n,
                                          _f32p(s1), _f32p(s2),
                                          _u64p(step)), "group_slots_get")
        return s1, s2, step

    def slots_set(self, indices, s1, s2, step) -> None:
        idx = _as_idx(indices)
        n = idx.shape[0]
        s1 = _as_mat(s1, n, self.dim)
        s2 = _as_mat(s2, n, self.dim)
        step = np.ascontiguousarray(step, np.uint64).reshape(n)
        with _op_span("group_slots_set",
                      s1.nbytes + s2.nbytes + step.nbytes):
            _check(lib.ps_group_slots_set(self.gid, _i64p(idx), _f32p(s1),
                                          _f32p(s2), _u64p(step), n),
                   "group_slots_set")

    def sync_pull(self, indices, cached_versions, bound: int = 0):
        """Version-bounded sync over the wire (HET's kSyncEmbedding):
        ``(positions, versions, rows)`` of the requested rows whose server
        version exceeds ``cached_versions + bound`` (every row of a shard
        recreated since: a new incarnation starts at a later base) or went
        back.  ``np.uint64(-1)`` means "not cached, always send".
        Versions are opaque monotonic counters."""
        idx = _as_idx(indices)
        vers = np.ascontiguousarray(cached_versions, np.uint64).reshape(-1)
        if vers.shape[0] != idx.shape[0]:
            raise ValueError("cached_versions must match indices length")
        n = idx.shape[0]
        sel = np.empty(n, np.uint32)
        vout = np.empty(n, np.uint64)
        rout = np.empty((n, self.dim), np.float32)
        m = lib.ps_group_sync_pull(
            self.gid, _i64p(idx), _u64p(vers), n, bound,
            sel.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            _u64p(vout), _f32p(rout))
        if m < 0:
            raise RuntimeError(f"hetu_ps group_sync_pull failed rc={m}")
        m = int(m)
        return sel[:m].copy(), vout[:m].copy(), rout[:m].copy()

    def save(self, path) -> None:
        """Each server saves ``<path>.shard<i>`` on its own host."""
        _check(lib.ps_group_save(self.gid, str(path).encode()), "group_save")

    def load(self, path) -> None:
        _check(lib.ps_group_load(self.gid, str(path).encode()), "group_load")

    def close(self) -> None:
        if getattr(self, "gid", 0) > 0:
            lib.ps_group_close(self.gid)
            self.gid = 0


class RemoteCacheTable:
    """The worker-side HET cache over a :class:`PartitionedPSTable`
    (``csrc/hetu_ps_rcache.cpp``): the surface of
    :class:`~hetu_tpu_torch.ps.client.CacheSparseTable`, with a miss or a
    stale row crossing the wire in one fused push-and-sync round trip a
    shard.  The native calls hold the cache's own mutex; the hit
    accounting takes ``_stats_lock``.  With a ``registry`` every lookup
    also sets its ``ps.cache.*`` metrics."""

    def __init__(self, table: PartitionedPSTable, capacity: int,
                 policy: str = "lfuopt", *, pull_bound: int = 0,
                 registry=None):
        self.table = table
        self.dim = table.dim
        self.pull_bound = pull_bound
        cid = lib.ps_rcache_create(table.gid, capacity, _POLICIES[policy],
                                   getattr(table, "lr", 0.01))
        if cid <= 0:
            raise RuntimeError(f"hetu_ps rcache_create failed rc={cid}")
        self.id = cid
        self._stats_lock = threading.Lock()
        self._metrics = cache_metrics(registry) if registry is not None \
            else None
        self.misses = 0
        self.lookups = 0

    def embedding_lookup(self, indices, *, out=None) -> np.ndarray:
        """The rows of ``indices`` ``[*indices.shape, dim]`` f32, into
        ``out`` (``[n, dim]``) where given."""
        idx = np.ascontiguousarray(indices, np.int64)
        flat = idx.reshape(-1)
        rows = _out_rows(out, flat.shape[0], self.dim)
        m = lib.ps_rcache_lookup(self.id, _i64p(flat), flat.shape[0],
                                 self.pull_bound, _f32p(rows))
        if m < 0:
            raise RuntimeError(f"hetu_ps rcache_lookup failed rc={m}")
        with self._stats_lock:
            self.misses += int(m)
            self.lookups += flat.shape[0]
            misses, lookups = self.misses, self.lookups
        if self._metrics is not None:
            c_lookups, c_misses, hit_rate, size = self._metrics
            c_lookups.inc(flat.shape[0])
            c_misses.inc(int(m))
            hit_rate.set(1.0 - misses / max(lookups, 1))
            size.set(self.size)
        return rows.reshape(*idx.shape, self.dim)

    def embedding_update(self, indices, grads) -> None:
        idx = _as_idx(indices)
        g = _as_mat(grads, idx.shape[0], self.dim)
        _check(lib.ps_rcache_update(self.id, _i64p(idx), _f32p(g),
                                    idx.shape[0]), "rcache_update")

    def flush(self) -> None:
        _check(lib.ps_rcache_flush(self.id), "rcache_flush")

    @property
    def size(self) -> int:
        return int(lib.ps_rcache_size(self.id))

    @property
    def hit_rate(self) -> float:
        with self._stats_lock:
            return 1.0 - self.misses / max(self.lookups, 1)

    def reset_stats(self) -> None:
        with self._stats_lock:
            self.misses = 0
            self.lookups = 0

    def close(self) -> None:
        if getattr(self, "id", 0) > 0:
            lib.ps_rcache_close(self.id)
            self.id = 0


class RemoteSSP:
    """SSP clocks held by the van server at ``host:port``: workers of
    several processes or hosts share one clock table ``ssp_id``."""

    def __init__(self, host: str, port: int, ssp_id: int, n_workers: int,
                 staleness: int, *, create: bool = True,
                 connect_timeout_s: float = 10.0):
        self.fd = _connect_with_deadline(host, port, connect_timeout_s)
        self.id = ssp_id
        self.n_workers = n_workers
        if create:
            rc = lib.ps_van_ssp_init(self.fd, ssp_id, n_workers, staleness)
            if rc not in (0, -2):  # -2: another worker created it first
                self.close()
                raise RuntimeError(f"remote ssp_init failed rc={rc}")

    def clock_and_wait(self, worker: int, timeout_ms: int = 10_000) -> bool:
        rc = lib.ps_van_ssp_clock(self.fd, self.id, worker, timeout_ms)
        if rc < 0:
            raise RuntimeError(f"remote ssp_clock failed rc={rc}")
        return rc == 0

    def clock(self, worker: int) -> int:
        clk = int(lib.ps_van_ssp_get(self.fd, self.id, worker))
        if clk < 0:
            raise RuntimeError(f"remote ssp_get failed rc={clk}")
        return clk

    def close(self) -> None:
        fd = _take_fd(self)
        if fd >= 0:
            lib.ps_van_close(fd)


class RemotePReduce:
    """Partial-reduce matchmaking held by the van server at
    ``host:port`` (pool ``pool_id``)."""

    def __init__(self, host: str, port: int, pool_id: int,
                 max_group: int = 8, wait_ms: int = 100,
                 connect_timeout_s: float = 10.0):
        self.fd = _connect_with_deadline(host, port, connect_timeout_s)
        self.id = pool_id
        self.max_group = max_group
        self.wait_ms = wait_ms

    def get_partner(self, worker: int) -> list:
        if not 0 <= worker < 64:
            raise ValueError("worker id must be in [0, 64) for mask encoding")
        mask = int(lib.ps_van_preduce(self.fd, self.id, worker,
                                      self.max_group, self.wait_ms))
        if mask == 0:
            # a group always holds the worker that asked, so 0 means the
            # transport or the server failed
            raise RuntimeError("remote preduce matchmaking failed "
                               "(van unreachable or server error)")
        return [i for i in range(64) if mask & (1 << i)]

    def close(self) -> None:
        fd = _take_fd(self)
        if fd >= 0:
            lib.ps_van_close(fd)


class BlobTransportError(RuntimeError):
    """A blob put, get or ack whose transport failed past its deadline.
    A ``RuntimeError`` like every other failed blob op (the reference's
    contract); a caller that can wait out a broken connection catches it
    by name."""


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

    With ``rcv_timeout_s``, a blocking put or get waits on the server in
    slices of half that timeout (a departure from the reference): a wait
    longer than the socket's receive timeout would read as a transport
    failure and resend the put, and the server, which parks the first
    copy until the slot is acked, would then store the message a second
    time after the reader acked it — an unread slot that wedges the
    channel for good.
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

    def _wait_ms(self, deadline: float) -> int:
        """One server-side wait: the time left, in slices shorter than
        the receive timeout (see the class docstring)."""
        left = max(1, int((deadline - time.monotonic()) * 1000))
        if self._rcv_timeout_s:
            left = min(left, max(1, int(self._rcv_timeout_s * 500)))
        return left

    def _reconnect(self) -> None:
        # op-shaped name: op_stats() shows it as
        # {"blob_channel": {"reconnects": n}}
        default_registry.counter("van.blob_channel.reconnects").inc()
        fd = _take_fd(self)  # a failed connect below leaves fd -1
        if fd >= 0:
            lib.ps_van_close(fd)
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
                rc = lib.ps_van_blob_put(self.fd, self.id, seq, buf,
                                         len(buf), self._wait_ms(deadline))
                if rc == 0:
                    return
                if time.monotonic() > deadline:
                    if rc == -11:  # the previous message is still unread
                        raise TimeoutError(
                            f"blob put: ack of the previous message not "
                            f"observed within {timeout_s}s")
                    if rc == -101:
                        self._transport_lost("put", rc)
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
                n = lib.ps_van_blob_get(self.fd, self.id, seq, self._rbuf,
                                        len(self._rbuf),
                                        self._wait_ms(deadline),
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
                    if n == -101:
                        self._transport_lost("get", n)
                    raise RuntimeError(f"blob get failed (rc={n})")
                if n == -101:
                    self._reconnect()
                elif n != -12:
                    raise RuntimeError(f"blob get failed (rc={n})")

    def _transport_lost(self, op: str, rc: int) -> None:
        """A transport failure that outlived the op's deadline (a stopped,
        then resumed, caller finds its blocking call broken only after
        the deadline): the connection may be mid-frame, so it is replaced
        before the failure is raised, and the next op on this channel
        runs on a clean stream."""
        self._reconnect()
        raise BlobTransportError(f"blob {op} failed (rc={rc})")

    def _ack(self, seq: int, deadline: float) -> None:
        """A lost ack wedges the slot (the writer's next put blocks until
        it lands), so it retries across reconnects like put and get."""
        while True:
            rc = lib.ps_van_blob_ack(self.fd, self.id, seq)
            if rc == 0:
                return
            if rc == -101 and time.monotonic() > deadline:
                # the message stays unacked in the slot: a get of the
                # same seq on the new connection reads it again
                self._transport_lost("ack", rc)
            if rc != -101:
                raise RuntimeError(f"blob ack failed (rc={rc})")
            self._reconnect()

    def close(self) -> None:
        fd = _take_fd(self)
        if fd >= 0:
            lib.ps_van_close(fd)


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
        fd = _take_fd(self)
        if fd >= 0:
            lib.ps_van_close(fd)


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
