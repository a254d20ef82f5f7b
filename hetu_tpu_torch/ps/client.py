"""Client objects over the parameter server's in-process C++ tier
(counterpart of ``hetu_tpu/ps/client.py``, copied with what it needs):
``PSTable``, ``CacheSparseTable``, the native int8 row codec
(:func:`q8_encode` / :func:`q8_decode`), the error feedback of a lossy
gradient wire (:class:`ErrorFeedback`), SSP clocks
(:class:`SSPController`) and partial-reduce matchmaking
(:class:`PartialReduce`).

Host-side and numpy: the tables live in host RAM, and
:class:`~hetu_tpu_torch.ps.embedding.PSEmbedding` turns their rows into
tensors.  A table id or cache id names native state in this process's
copy of the library, so the port's tables and the JAX package's never
meet.
"""

from __future__ import annotations

import ctypes
import itertools
import threading

import numpy as np

from hetu_tpu_torch.ps.binding import lib
from hetu_tpu_torch.quantwire import WIRE_CODES as WIRE_DTYPES

_table_ids = itertools.count(1)
_cache_ids = itertools.count(1)
_ssp_ids = itertools.count(1)
_preduce_ids = itertools.count(1)


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _i8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


def _as_idx(a) -> np.ndarray:
    """Indices as contiguous flat int64."""
    return np.ascontiguousarray(a, np.int64).reshape(-1)


def _as_mat(a, n, dim) -> np.ndarray:
    """Values as contiguous ``(n, dim)`` float32."""
    return np.ascontiguousarray(a, np.float32).reshape(n, dim)


def _out_rows(out, n, dim) -> np.ndarray:
    """``out`` (a caller's ``(n, dim)`` C-contiguous float32 buffer, e.g.
    a pinned tensor's ``.numpy()``) or a new array."""
    if out is None:
        return np.empty((n, dim), np.float32)
    if out.shape != (n, dim) or out.dtype != np.float32 \
            or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous float32 ({n}, {dim}) "
                         f"array, got {out.dtype} {out.shape}")
    return out


def _check(rc, what: str):
    """Raise on a native call's failure (not ``assert``: it vanishes under
    ``-O``)."""
    if rc != 0:
        raise RuntimeError(f"hetu_ps {what} failed with rc={rc}")
    return rc


_INIT_KINDS = {"zeros": 0, "constant": 1, "uniform": 2, "normal": 3}
TABLE_DTYPES = {"f32": 0, "bf16": 1, "int8": 2}  # row STORAGE types
# WIRE_DTYPES (imported above): the gradient push-pull wire's types
_OPT_KINDS = {"sgd": 0, "momentum": 1, "adagrad": 2, "adam": 3,
              "nesterov": 4}
_POLICIES = {"lru": 0, "lfu": 1, "lfuopt": 2}


def q8_encode(rows) -> tuple:
    """Symmetric int8 with one scale a row, by the native codec
    (``csrc/hetu_ps_dtype.h``), the scheme of every storage and wire path
    (NaN → 0, ±Inf → ±127).  ``rows [n, dim]`` → ``(q int8 [n, dim],
    scales f32 [n])``."""
    v = np.ascontiguousarray(rows, np.float32)
    if v.ndim != 2:
        raise ValueError(f"q8_encode wants [n, dim] rows, got {v.shape}")
    n, dim = v.shape
    q = np.empty((n, dim), np.int8)
    scales = np.empty(n, np.float32)
    _check(lib.ps_q8_encode(_f32p(v), n, dim, _i8p(q), _f32p(scales)),
           "q8_encode")
    return q, scales


def q8_decode(q, scales) -> np.ndarray:
    """Inverse of :func:`q8_encode`: f32 rows."""
    q = np.ascontiguousarray(q, np.int8)
    if q.ndim != 2:
        raise ValueError(f"q8_decode wants [n, dim] codes, got {q.shape}")
    n, dim = q.shape
    s = np.ascontiguousarray(scales, np.float32).reshape(n)
    out = np.empty((n, dim), np.float32)
    _check(lib.ps_q8_decode(_i8p(q), _f32p(s), n, dim, _f32p(out)),
           "q8_decode")
    return out


class ErrorFeedback:
    """The residual of a lossy (int8) gradient wire, kept by the client:
    each push sends ``grad + residual`` and keeps ``residual = intended -
    what the server decoded``, so the quantisation error is applied on a
    later step instead of lost.

    The wire calls return the server's decode of the payload they sent
    (``roundtrip``), so the residual needs no copy of the codec.  Sparse
    residuals are kept a row, by index, at most ``max_rows`` of them
    (the oldest dropped past it: a dropped residual loses less than one
    quantum of gradient, what a plain quantised push loses every step)."""

    def __init__(self, dim: int, *, max_rows: int = 1 << 20):
        self.dim = int(dim)
        self.max_rows = int(max_rows)
        self._dense = None           # [rows, dim] f32
        self._sparse: dict = {}      # index -> [dim] f32 residual

    def fold_dense(self, grad: np.ndarray) -> np.ndarray:
        """``grad`` plus the carried residual (a new array)."""
        if self._dense is None:
            return np.array(grad, np.float32, copy=True)
        return grad + self._dense

    def absorb_dense(self, intended: np.ndarray,
                     roundtrip: np.ndarray) -> None:
        self._dense = intended - roundtrip

    def fold_sparse(self, idx: np.ndarray, grads: np.ndarray) -> np.ndarray:
        """Each row's gradient plus its carried residual (a new array).  An
        index repeated within one push gets its residual once, at its first
        occurrence: the server sums duplicates."""
        out = np.array(grads, np.float32, copy=True)
        if self._sparse:
            uniq, first = np.unique(np.asarray(idx), return_index=True)
            get = self._sparse.get
            for j, ii in zip(first, uniq.tolist()):
                r = get(ii)
                if r is not None:
                    out[j] += r
        return out

    def absorb_sparse(self, idx: np.ndarray, intended: np.ndarray,
                      roundtrip: np.ndarray) -> None:
        uniq, inv = np.unique(np.asarray(idx), return_inverse=True)
        acc = np.zeros((uniq.shape[0], intended.shape[1]), np.float32)
        np.add.at(acc, inv, intended - roundtrip)
        sp = self._sparse
        for j, ii in enumerate(uniq.tolist()):
            sp.pop(ii, None)  # re-insert: rows touched last live longest
            sp[ii] = acc[j]
        while len(sp) > self.max_rows:
            sp.pop(next(iter(sp)))


class PSTable:
    """A parameter table held by the server, with a server-side optimizer
    (the native ``optimizer``: sgd, momentum, adagrad, adam, nesterov).

    ``dtype`` selects the row STORAGE only: "f32" (default), "bf16" or
    "int8" (with a per-row scale).  The optimizer's arithmetic, its slots
    and every pulled row are f32.  The initial rows are drawn by the
    native code from ``seed``, so a table equals the JAX package's table
    of the same arguments bit for bit."""

    def __init__(self, rows: int, dim: int, *, init: str = "normal",
                 init_a: float = 0.0, init_b: float = 0.01, seed: int = 0,
                 optimizer: str = "sgd", lr: float = 0.01,
                 momentum: float = 0.9, eps: float = 1e-7,
                 beta1: float = 0.9, beta2: float = 0.999,
                 dtype: str = "f32"):
        self.id = next(_table_ids)
        self.rows, self.dim = rows, dim
        self.dtype = dtype
        _check(lib.ps_table_create_ex(self.id, rows, dim, _INIT_KINDS[init],
                                      init_a, init_b, seed,
                                      TABLE_DTYPES[dtype]), "table_create")
        _check(lib.ps_table_set_optimizer(self.id, _OPT_KINDS[optimizer], lr,
                                          momentum, eps, beta1, beta2),
               "set_optimizer")

    # ---- dense plane ----
    def dense_pull(self) -> np.ndarray:
        out = np.empty((self.rows, self.dim), np.float32)
        _check(lib.ps_dense_pull(self.id, _f32p(out)), "dense_pull")
        return out

    def dense_push(self, grad) -> None:
        grad = _as_mat(grad, self.rows, self.dim)
        _check(lib.ps_dense_push(self.id, _f32p(grad)), "dense_push")

    # ---- sparse plane ----
    def sparse_pull(self, indices, *, with_versions: bool = False,
                    out=None):
        """The rows of ``indices`` ``[n, dim]`` f32, into ``out`` where
        given; with ``with_versions`` also their version counters."""
        idx = _as_idx(indices)
        out = _out_rows(out, idx.shape[0], self.dim)
        ver = np.empty(idx.shape[0], np.uint64) if with_versions else None
        _check(lib.ps_sparse_pull(self.id, _i64p(idx), idx.shape[0],
                                  _f32p(out),
                                  _u64p(ver) if with_versions else None),
               "sparse_pull")
        return (out, ver) if with_versions else out

    def sparse_push(self, indices, grads) -> None:
        """Apply the server-side optimizer to the rows of ``indices``
        (duplicates summed first)."""
        idx = _as_idx(indices)
        g = _as_mat(grads, idx.shape[0], self.dim)
        _check(lib.ps_sparse_push(self.id, _i64p(idx), _f32p(g),
                                  idx.shape[0]), "sparse_push")

    def sparse_set(self, indices, values) -> None:
        idx = _as_idx(indices)
        v = _as_mat(values, idx.shape[0], self.dim)
        _check(lib.ps_sparse_set(self.id, _i64p(idx), _f32p(v),
                                 idx.shape[0]), "sparse_set")

    def sync_pull(self, indices, cached_versions, bound: int = 0):
        """Version-bounded sync (HET's kSyncEmbedding): ``(positions,
        versions, rows)`` of the requested rows whose server version
        exceeds ``cached_versions + bound`` (or went back).
        ``np.uint64(-1)`` means "not cached, always send"."""
        idx = _as_idx(indices)
        vers = np.ascontiguousarray(cached_versions, np.uint64).reshape(-1)
        if vers.shape[0] != idx.shape[0]:
            raise ValueError("cached_versions must match indices length")
        n = idx.shape[0]
        sel = np.empty(n, np.uint32)
        vout = np.empty(n, np.uint64)
        rout = np.empty((n, self.dim), np.float32)
        m = lib.ps_sync_pull(
            self.id, _i64p(idx), _u64p(vers), n, bound,
            sel.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            _u64p(vout), _f32p(rout))
        if m < 0:
            raise RuntimeError(f"hetu_ps sync_pull failed rc={m}")
        m = int(m)
        return sel[:m].copy(), vout[:m].copy(), rout[:m].copy()

    def clear(self) -> None:
        """Zero the table; bumps versions so caches re-pull."""
        _check(lib.ps_table_clear(self.id), "table_clear")

    # ---- server-side optimizer slots ----
    def slots_get(self, indices):
        """``(s1 [n, dim], s2 [n, dim], step [n])`` of the server-side
        optimizer (velocity / accumulator / Adam m; Adam v; Adam's per-row
        step); slots the optimizer lacks read as zeros."""
        idx = _as_idx(indices)
        n = idx.shape[0]
        s1 = np.empty((n, self.dim), np.float32)
        s2 = np.empty((n, self.dim), np.float32)
        step = np.empty(n, np.uint64)
        _check(lib.ps_table_slots_get(self.id, _i64p(idx), n, _f32p(s1),
                                      _f32p(s2), _u64p(step)),
               "table_slots_get")
        return s1, s2, step

    def slots_set(self, indices, s1, s2, step) -> None:
        """Import what :meth:`slots_get` exported; row versions stay."""
        idx = _as_idx(indices)
        n = idx.shape[0]
        s1 = _as_mat(s1, n, self.dim)
        s2 = _as_mat(s2, n, self.dim)
        step = np.ascontiguousarray(step, np.uint64).reshape(n)
        _check(lib.ps_table_slots_set(self.id, _i64p(idx), n, _f32p(s1),
                                      _f32p(s2), _u64p(step)),
               "table_slots_set")

    # ---- checkpoint ----
    def save(self, path) -> None:
        _check(lib.ps_table_save(self.id, str(path).encode()), "table_save")

    def load(self, path) -> None:
        _check(lib.ps_table_load(self.id, str(path).encode()), "table_load")


def cache_metrics(registry):
    """The ``ps.cache.*`` metrics of ``registry`` (a
    :class:`~hetu_tpu_torch.telemetry.MetricsRegistry`), the reference's
    names: ``(lookups, misses, hit_rate, size)``."""
    return (registry.counter("ps.cache.lookups",
                             help="HET-cache rows looked up"),
            registry.counter("ps.cache.misses",
                             help="HET-cache rows missed/re-pulled"),
            registry.gauge("ps.cache.hit_rate",
                           help="lifetime hit rate of the last-updated "
                                "cache"),
            registry.gauge("ps.cache.size",
                           help="entries held by the last-updated cache"))


class CacheSparseTable:
    """The worker-side HET cache over a :class:`PSTable`: a lookup pulls
    what is missing or more than ``pull_bound`` versions stale; an update
    accumulates the gradient and applies it locally, and the server sees
    it on eviction or :meth:`flush`.  ``policy`` evicts by "lru", "lfu" or
    "lfuopt".

    The native calls hold the cache's own mutex; the hit accounting takes
    ``_stats_lock``.  With a ``registry`` every lookup also sets its
    ``ps.cache.*`` metrics (:func:`cache_metrics`)."""

    def __init__(self, table: PSTable, capacity: int,
                 policy: str = "lfuopt", *, pull_bound: int = 0,
                 registry=None):
        self.table = table
        self.dim = table.dim
        self.pull_bound = pull_bound
        self.id = next(_cache_ids)
        _check(lib.ps_cache_create(self.id, table.id, capacity,
                                   _POLICIES[policy]), "cache_create")
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
        m = lib.ps_cache_lookup(self.id, _i64p(flat), flat.shape[0],
                                self.pull_bound, _f32p(rows))
        if m < 0:
            raise RuntimeError(f"hetu_ps cache_lookup failed with rc={m}")
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
        _check(lib.ps_cache_update(self.id, _i64p(idx), _f32p(g),
                                   idx.shape[0]), "cache_update")

    def flush(self) -> None:
        _check(lib.ps_cache_flush(self.id), "cache_flush")

    @property
    def size(self) -> int:
        return int(lib.ps_cache_size(self.id))

    @property
    def hit_rate(self) -> float:
        with self._stats_lock:
            return 1.0 - self.misses / max(self.lookups, 1)

    def reset_stats(self) -> None:
        """Zero the hit accounting; the native entries stay."""
        with self._stats_lock:
            self.misses = 0
            self.lookups = 0


class SSPController:
    """Bounded-staleness clocks of ``n_workers`` workers, in this
    process's library (its own clock table: controllers are
    independent)."""

    def __init__(self, n_workers: int, staleness: int):
        self.id = next(_ssp_ids)
        _check(lib.ps_ssp_init(self.id, n_workers, staleness), "ssp_init")
        self.n_workers = n_workers

    def clock_and_wait(self, worker: int, timeout_ms: int = 10_000) -> bool:
        """Advance ``worker``'s clock; True once it is within the bound,
        False if ``timeout_ms`` passed first."""
        rc = lib.ps_ssp_clock_and_wait(self.id, worker, timeout_ms)
        if rc < 0:
            raise RuntimeError(f"hetu_ps ssp_clock_and_wait rc={rc}")
        return rc == 0

    def clock(self, worker: int) -> int:
        return int(lib.ps_ssp_get_clock(self.id, worker))


class PartialReduce:
    """Straggler-tolerant reduce groups: :meth:`get_partner` waits up to
    ``wait_ms`` for at most ``max_group`` workers and returns the ids of
    this round's group (the caller then reduces over them)."""

    def __init__(self, max_group: int = 8, wait_ms: int = 100):
        self.id = next(_preduce_ids)
        self.max_group = max_group
        self.wait_ms = wait_ms

    def get_partner(self, worker: int) -> list[int]:
        if not 0 <= worker < 64:
            raise ValueError("worker id must be in [0, 64) for mask encoding")
        mask = int(lib.ps_preduce_get_partner(self.id, worker,
                                              self.max_group, self.wait_ms))
        return [i for i in range(64) if mask & (1 << i)]
