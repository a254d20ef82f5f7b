"""Online CTR recommendation serving with a staleness-bounded
hot-embedding cache tier (counterpart of ``hetu_tpu/serve/recsys.py``).

The second serving workload: online CTR inference over
``models/wdl.py`` / ``models/ctr_zoo.py``, whose profile inverts the LLM
one — tiny dense compute, huge sparse state, and cache hit rate, not
FLOPs, as the latency lever.

Pieces:

* :class:`ServingEmbeddingCache` — read-through host cache over the
  versioned ``sync_pull`` wire op (HET kSyncEmbedding): a configurable
  staleness bound (``pull_bound`` versions), thread-safe
  hit/miss/staleness accounting into a metrics registry, a
  negative/cold-row policy, an optional COMPRESSED eviction tier
  (``embedding_compress.ServingRowCodec``), and a degraded-stale mode —
  when the PS stops answering (shard killed), lookups serve the cached
  rows regardless of staleness and the outage is recorded as a
  ``serve.recsys_degrade`` recovery span that ``telemetry.timeline``
  pairs with the injected ``fault.kill_shard``.  Numpy and locks, the
  reference's logic line for line.
* :class:`RecsysEngine` — the bucketed-batch CTR forward on the card
  (``device="cuda"`` unless the caller asks for the CPU): request
  batches are right-padded to power-of-two buckets; the host-side lookup
  goes through the caches; ``gather_launch`` / ``finish`` split the step
  so the NEXT batch's gather overlaps the previous batch's device work.
* :class:`RecsysBatcher` — micro-batching scheduler: coalesces single
  requests into batched forwards under a latency budget
  (``max_delay_s``), with the pool-compatible scheduler surface
  (submit/export/adopt/requeue), so CTR members ride the same
  health-routed routing and failover as LLM members.
* :class:`RecsysServer` / :class:`RecsysClient` — the van blob-channel
  front end (``serve/server.py``'s listeners, idempotent resubmission,
  dedup) speaking ``{dense, sparse} -> {score}`` instead of tokens.
* :class:`RecsysPool` — :class:`~hetu_tpu_torch.serve.pool.ServingPool`
  with CTR members (``member_factory``): least-loaded healthy routing,
  ``serve_engine_kill`` failover, planned drain, revive.

Freshness contract: with ``pull_bound=0`` cached serving is bitwise
identical to cache-less PS pulls, and under a concurrent trainer every
served row is at most ``pull_bound`` versions stale.

Departures from the reference:

* ``RecsysEngine(model, caches, ...)`` takes the port's module, whose
  parameters it snapshots (``detach().clone()`` of every parameter and
  buffer onto the engine's device), instead of ``(model, variables)``:
  the port's optimizers update in place, so an engine sharing a module
  with a live trainer would otherwise score with weights that change
  under it.
* Nothing is jitted: ``compiled_executables()`` counts the distinct
  buckets served (the shapes a later CUDA-graph capture would need), as
  the port's LLM engines count step shapes; ``max_executables`` is still
  ``len(buckets)``.
* On the card the padded inputs are staged in pinned host buffers (two
  sets a bucket, each guarded by an event so a set is never rewritten
  while its copy is in flight) and copied with ``non_blocking=True``;
  ``finish`` is the one synchronisation, a device-to-host copy of the
  bucket's probabilities.  cuBLAS may pick a different GEMM for another
  batch size, so a request's score can differ in its last bits between
  buckets.
* The cache's metrics, the ``ps.cache.*`` aggregate included, go to the
  caller's registry (the port's departure for ``ps.cache.*``).
* :class:`RecsysBatcher` has ``yield_to_control`` (a no-op: its step
  holds the lock for one batch) since the port's engine loop calls it.
"""

from __future__ import annotations

import copy
import itertools
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from hetu_tpu_torch.ps.client import cache_metrics
from hetu_tpu_torch.serve.engine import _pow2_buckets
from hetu_tpu_torch.serve.metrics import ServeMetrics
from hetu_tpu_torch.serve.scheduler import finish_request
from hetu_tpu_torch.serve.server import InferenceClient, InferenceServer
from hetu_tpu_torch.telemetry import trace
from hetu_tpu_torch.telemetry.registry import DEFAULT_LATENCY_BUCKETS

NOT_CACHED = np.uint64(0xFFFFFFFFFFFFFFFF)

# version-lag buckets for the staleness histogram (powers of two: a lag
# of 0 means the refresh raced a push; big lags mean a cold/returning row)
STALENESS_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 1024, 1 << 20)

_req_ids = itertools.count(1)
_cache_ids = itertools.count(0)


# ---------------------------------------------------------------------------
# the serving cache
# ---------------------------------------------------------------------------

class ServingEmbeddingCache:
    """Read-through bounded-staleness host cache for ONLINE SERVING.

    The training tiers (``CacheSparseTable`` / ``RemoteCacheTable``)
    are read-write; serving is read-mostly — the trainer pushes through
    ITS tier while serving threads only read — so this cache keeps a
    host-side hot set ``{key: (row, version)}`` and revalidates each
    batch with ONE versioned ``sync_pull`` (the cached versions go out,
    only rows newer than ``pull_bound`` versions come back).  Rows the
    server does not re-send are hits served from host memory
    (``ps_bytes_saved``).

    ``table``: a ``ps.PSTable`` or ``ps.van.PartitionedPSTable`` —
    anything exposing ``sync_pull``/``rows``/``dim`` — or a training
    cache (``CacheSparseTable``/``RemoteCacheTable``), whose underlying
    ``.table`` is shared.

    ``capacity=0`` disables caching (every row re-pulled — the
    cache-less baseline).  ``policy``: ``"lru"`` (default) or ``"lfu"``.

    ``codec`` (e.g. ``embedding_compress.ServingRowCodec(dim)``): rows
    evicted from the hot f32 tier are kept compressed WITH their PS
    version in an L2 of ``l2_capacity`` entries (default 4x capacity); a
    re-access still within the staleness bound decompresses locally
    instead of re-pulling.  Lossy — leave ``codec=None`` for bitwise
    parity.

    ``negative``: policy for ids outside ``[0, rows)``: ``"zeros"``
    (serve a zero row, count it, never touch the PS) or ``"error"``
    (raise KeyError).

    Degraded-stale mode: when ``sync_pull`` RAISES (PS shard dead), the
    lookup serves what it has — hot rows regardless of staleness, L2
    rows decompressed, zeros for unknown keys.  While degraded the PS is
    re-probed at most once per ``probe_interval_s``; between probes
    lookups serve from host memory without touching the PS.  The first
    failing lookup opens a ``serve.recsys_degrade`` window; the first
    succeeding one closes it as a retroactive recovery span.
    ``close()`` records a still-open window with ``error="unrecovered"``
    so a never-recovered outage is not mis-paired as a recovery.

    ``registry``: where the metrics go (``telemetry.default_registry``
    when None), the ``ps.cache.*`` aggregate included.

    Thread safety: every lookup (and the stats) holds ``_lock``.
    """

    def __init__(self, table, capacity: int, *, pull_bound: int = 0,
                 policy: str = "lru", codec=None,
                 l2_capacity: Optional[int] = None,
                 negative: str = "zeros", probe_interval_s: float = 0.5,
                 registry=None, name: Optional[str] = None):
        # unwrap a training cache: share its underlying table
        if hasattr(table, "embedding_lookup") and hasattr(table, "table"):
            table = table.table
        if not hasattr(table, "sync_pull"):
            raise TypeError(
                "table must expose sync_pull (PSTable / "
                "PartitionedPSTable, or a cache tier wrapping one)")
        if policy not in ("lru", "lfu"):
            raise ValueError(f"unknown policy {policy!r}; use lru|lfu")
        if negative not in ("zeros", "error"):
            raise ValueError(
                f"unknown negative policy {negative!r}; use zeros|error")
        self.table = table
        self.rows = int(table.rows)
        self.dim = int(table.dim)
        self.capacity = int(capacity)
        self.pull_bound = int(pull_bound)
        self.policy = policy
        self.codec = codec
        self.l2_capacity = int(l2_capacity if l2_capacity is not None
                               else 4 * max(self.capacity, 1))
        self.negative = negative
        self._lock = threading.Lock()
        self._l1: OrderedDict = OrderedDict()  # key -> [row f32[dim], ver]
        self._freq: dict = {}                  # key -> hits (lfu)
        self._l2: OrderedDict = OrderedDict()  # key -> (blob, ver)
        self.probe_interval_s = float(probe_interval_s)
        self._degraded = False
        self._degrade_start_us = 0.0
        self._degrade_n = 0
        self._next_probe = 0.0
        if registry is None:
            from hetu_tpu_torch.telemetry import default_registry as registry
        self.registry = registry
        if name is None:
            # per-instance default: metric objects are shared by NAME
            # within a registry, and two caches pooling their hit
            # counters would misreport both
            n = next(_cache_ids)
            name = "serve.recsys.cache" + (str(n) if n else "")
        self._name = name
        c = registry.counter
        self._c_lookups = c(f"{name}.lookups",
                            help="in-vocab rows looked up (positions; "
                                 "negative_rows counted separately)")
        self._c_hits = c(f"{name}.hits", help="rows served from the hot "
                         "tier within the staleness bound")
        self._c_l2_hits = c(f"{name}.l2_hits", help="rows decompressed "
                            "from the evicted tier instead of re-pulled")
        self._c_cold = c(f"{name}.cold_misses", help="rows pulled with no "
                         "cached version")
        self._c_stale = c(f"{name}.stale_refreshes", help="cached rows "
                          "re-pulled past the staleness bound")
        self._c_negative = c(f"{name}.negative_rows", help="out-of-vocab "
                             "ids served as zeros without touching the PS")
        self._c_degraded = c(f"{name}.degraded_lookups", help="lookups "
                             "served stale while the PS was unreachable")
        self._c_unknown = c(f"{name}.degraded_unknown_rows", help="rows "
                            "served as zeros during degrade (never cached)")
        self._c_saved = c(f"{name}.ps_bytes_saved", help="row bytes NOT "
                          "re-pulled thanks to the cache")
        self._c_pulled = c(f"{name}.ps_bytes_pulled", help="row bytes "
                           "actually pulled from the PS")
        self._g_hit_rate = registry.gauge(f"{name}.hit_rate")
        self._g_size = registry.gauge(f"{name}.size")
        registry.gauge(f"{name}.pull_bound").set(self.pull_bound)
        self._h_staleness = registry.histogram(
            f"{name}.staleness_versions", STALENESS_BUCKETS,
            help="version lag observed when a cached row was refreshed "
                 "(served hits are <= pull_bound by construction)")
        self._ps_cache = cache_metrics(registry)

    # ---- internals (caller holds _lock) ----
    def _touch(self, key: int) -> None:
        if self.policy == "lru":
            self._l1.move_to_end(key)
        else:
            self._freq[key] = self._freq.get(key, 0) + 1

    def _store_l1(self, key: int, row: np.ndarray, ver: int) -> None:
        if self.capacity <= 0:
            return
        self._l1[key] = [row, int(ver)]
        self._touch(key)

    def _evict_locked(self) -> None:
        excess = len(self._l1) - self.capacity
        if excess <= 0:
            return
        if self.policy == "lru":
            # OrderedDict iteration order IS recency order (oldest first)
            it = iter(self._l1)
            victims = [next(it) for _ in range(excess)]
        else:
            scored = sorted(self._l1, key=lambda k: self._freq.get(k, 0))
            victims = scored[:excess]
        if self.codec is not None and victims:
            vrows = np.stack([self._l1[k][0] for k in victims])
            q, scale = self.codec.compress(vrows)
            for i, k in enumerate(victims):
                self._l2[k] = ((q[i], scale[i:i + 1]), self._l1[k][1])
                self._l2.move_to_end(k)
            while len(self._l2) > self.l2_capacity:
                self._l2.popitem(last=False)
        for k in victims:
            del self._l1[k]
            self._freq.pop(k, None)

    def _l2_row(self, key: int):
        """Decompressed row + version for an L2 entry, or None."""
        ent = self._l2.get(key)
        if ent is None:
            return None
        (q, scale), ver = ent
        row = self.codec.decompress((q[None, :], scale))[0]
        return row, ver

    def _recovered_locked(self) -> None:
        if not self._degraded:
            return
        self._degraded = False
        trace.complete("serve.recsys_degrade", self._degrade_start_us,
                       {"degraded_lookups": self._degrade_n}, cat="serve")
        self._degrade_n = 0

    def _degraded_lookup_locked(self, keys, counts, exc) -> np.ndarray:
        """Serve what we have: hot rows (any staleness), L2, else zeros.
        ``counts``: per-key position counts — degraded accounting stays
        PER POSITION like every other counter here."""
        if not self._degraded:
            self._degraded = True
            self._degrade_start_us = trace.now_us()
            self._degrade_n = 0
            trace.instant("serve.recsys.degrade_enter",
                          {"error": type(exc).__name__}, cat="serve")
        self._degrade_n += 1
        rows = np.zeros((keys.shape[0], self.dim), np.float32)
        unknown = 0
        for i in range(keys.shape[0]):
            k = int(keys[i])
            ent = self._l1.get(k)
            if ent is not None:
                rows[i] = ent[0]
                self._touch(k)
                continue
            l2 = self._l2_row(k) if self.codec is not None else None
            if l2 is not None:
                rows[i] = l2[0]
            else:
                unknown += int(counts[i])
        self._c_degraded.inc(int(counts.sum()))
        self._c_unknown.inc(unknown)
        return rows

    def _expand(self, keys, vmask, inverse, rows_valid, shape):
        full = np.zeros((keys.shape[0], self.dim), np.float32)
        full[vmask] = rows_valid
        return full[inverse].reshape(*shape, self.dim)

    # ---- the lookup ----
    def lookup(self, indices) -> np.ndarray:
        """rows for ``indices`` (any shape): ``[*indices.shape, dim]``
        f32, every row at most ``pull_bound`` versions stale (or best
        effort while degraded)."""
        idx = np.ascontiguousarray(indices, np.int64)
        flat = idx.reshape(-1)
        with self._lock:
            keys, inverse, counts = np.unique(flat, return_inverse=True,
                                              return_counts=True)
            inverse = inverse.reshape(-1)
            valid = (keys >= 0) & (keys < self.rows)
            n_invalid_pos = int((~valid[inverse]).sum())
            if n_invalid_pos and self.negative == "error":
                bad = keys[~valid]
                raise KeyError(f"ids outside [0, {self.rows}): "
                               f"{bad[:8].tolist()}")
            self._c_negative.inc(n_invalid_pos)
            vmask = valid
            vkeys = keys[vmask]
            # hit/miss accounting is PER POSITION (a batch repeating one
            # hot key 26x counts 26 served rows), wire-byte accounting is
            # per UNIQUE key (one pull feeds every duplicate)
            vcounts = counts[vmask]
            vers = np.full(vkeys.shape[0], NOT_CACHED, np.uint64)
            if self.capacity > 0:
                for i, k in enumerate(vkeys):
                    k = int(k)
                    ent = self._l1.get(k)
                    if ent is not None:
                        vers[i] = ent[1]
                    elif self.codec is not None and k in self._l2:
                        vers[i] = self._l2[k][1]
            rows_valid = np.zeros((vkeys.shape[0], self.dim), np.float32)
            if vkeys.shape[0]:
                if self._degraded and \
                        time.monotonic() < self._next_probe:
                    # between probes: serve from host memory without
                    # paying the dead PS's connect/retry latency again
                    rows_valid = self._degraded_lookup_locked(
                        vkeys, vcounts, None)
                    return self._expand(keys, vmask, inverse, rows_valid,
                                        idx.shape)
                try:
                    sel, svers, srows = self.table.sync_pull(
                        vkeys, vers, bound=self.pull_bound)
                except Exception as e:
                    self._next_probe = time.monotonic() + \
                        self.probe_interval_s
                    rows_valid = self._degraded_lookup_locked(
                        vkeys, vcounts, e)
                    return self._expand(keys, vmask, inverse, rows_valid,
                                        idx.shape)
                self._recovered_locked()
                refreshed = np.zeros(vkeys.shape[0], bool)
                refreshed[sel] = True
                cold = stale = 0
                for j, pos in enumerate(sel):
                    pos = int(pos)
                    k = int(vkeys[pos])
                    old_v = vers[pos]
                    if old_v != NOT_CACHED:
                        # lag can read "negative" across a shard
                        # recreation (fresh incarnations start at a later
                        # base) — clamp: the meaningful signal is "how
                        # stale was the copy we replaced"
                        lag = max(int(svers[j]) - int(old_v), 0)
                        self._h_staleness.observe(lag)
                        stale += int(vcounts[pos])
                    else:
                        cold += int(vcounts[pos])
                    rows_valid[pos] = srows[j]
                    self._store_l1(k, srows[j].copy(), int(svers[j]))
                    self._l2.pop(k, None)
                n_hit = 0
                n_l2 = 0
                for pos in np.nonzero(~refreshed)[0]:
                    pos = int(pos)
                    k = int(vkeys[pos])
                    ent = self._l1.get(k)
                    if ent is not None:
                        rows_valid[pos] = ent[0]
                        self._touch(k)
                        n_hit += int(vcounts[pos])
                        continue
                    l2 = self._l2_row(k)
                    if l2 is None:  # pragma: no cover - server contract
                        raise RuntimeError(
                            f"sync_pull withheld row {k} that is cached "
                            f"nowhere (version bookkeeping bug)")
                    row, ver = l2
                    rows_valid[pos] = row
                    del self._l2[k]
                    self._store_l1(k, row, ver)
                    n_l2 += int(vcounts[pos])
                self._evict_locked()
                row_bytes = self.dim * 4
                n_valid_pos = int(vcounts.sum())
                self._c_lookups.inc(n_valid_pos)
                self._c_hits.inc(n_hit)
                self._c_l2_hits.inc(n_l2)
                self._c_cold.inc(cold)
                self._c_stale.inc(stale)
                # wire bytes: one pull serves every duplicate position
                self._c_saved.inc(
                    (int(vkeys.shape[0]) - len(sel)) * row_bytes)
                self._c_pulled.inc(len(sel) * row_bytes)
                self._g_hit_rate.set(self.hit_rate_locked())
                self._g_size.set(len(self._l1))
                # the shared ps.cache.* aggregate — PER-POSITION deltas,
                # the unit the training tiers export
                lookups, misses, hit_rate, size = self._ps_cache
                lookups.inc(n_valid_pos)
                misses.inc(cold + stale)
                hit_rate.set(self.hit_rate_locked())
                size.set(len(self._l1))
            return self._expand(keys, vmask, inverse, rows_valid, idx.shape)

    # ---- introspection ----
    def hit_rate_locked(self) -> float:
        total = self._c_lookups.value
        miss = self._c_cold.value + self._c_stale.value
        return 1.0 - miss / max(total, 1)

    @property
    def hit_rate(self) -> float:
        with self._lock:
            return self.hit_rate_locked()

    @property
    def size(self) -> int:
        with self._lock:
            return len(self._l1)

    @property
    def degraded(self) -> bool:
        with self._lock:
            return self._degraded

    def stats(self) -> dict:
        with self._lock:
            return {
                "lookups": self._c_lookups.value,
                "hits": self._c_hits.value,
                "l2_hits": self._c_l2_hits.value,
                "cold_misses": self._c_cold.value,
                "stale_refreshes": self._c_stale.value,
                "negative_rows": self._c_negative.value,
                "degraded_lookups": self._c_degraded.value,
                "ps_bytes_saved": self._c_saved.value,
                "ps_bytes_pulled": self._c_pulled.value,
                "hit_rate": self.hit_rate_locked(),
                "size": len(self._l1),
                "l2_size": len(self._l2),
                "staleness": self._h_staleness.snapshot(),
            }

    def invalidate(self) -> None:
        """Drop every cached row (both tiers) — e.g. after a checkpoint
        load replaced the table wholesale."""
        with self._lock:
            self._l1.clear()
            self._l2.clear()
            self._freq.clear()

    def close(self) -> None:
        with self._lock:
            if self._degraded:
                # an outage that never recovered is NOT a recovery: tag
                # the span error so the chaos timeline refuses to pair it
                trace.complete("serve.recsys_degrade",
                               self._degrade_start_us,
                               {"degraded_lookups": self._degrade_n,
                                "error": "unrecovered"}, cat="serve")
                self._degraded = False


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class _Staging:
    """One pinned host set of a bucket's padded inputs and the event that
    marks the end of the copies that read it."""

    def __init__(self, shapes):
        self.host = [torch.zeros(s, dtype=torch.float32, pin_memory=True)
                     for s in shapes]
        self.views = [h.numpy() for h in self.host]
        self.event = None

    def wait(self) -> None:
        """Block until the copies of this set's last use have read it."""
        if self.event is not None:
            self.event.synchronize()


class RecsysEngine:
    """Bucketed-batch CTR forward over a cache-backed lookup path.

    ``model``: the port's ``WideDeep`` (one sparse input), ``DeepFM``
    (two: the latent vectors and the first-order weights) or any module
    whose ``forward(dense_x, *sparse_rows)`` returns logits ``[B]``.
    The engine scores with a snapshot of its parameters and buffers on
    ``device`` (the card unless the caller asks for the CPU), taken at
    construction: a trainer that keeps updating ``model`` in place never
    reaches a member's forward.

    Request batches are right-padded to power-of-two BUCKETS (up to
    ``max_batch``); ``compiled_executables()`` counts the buckets
    served, at most ``max_executables``.

    ``caches``: one :class:`ServingEmbeddingCache` per sparse input,
    each looked up with the SAME ``[B, fields]`` ids.

    Overlap: :meth:`gather_launch` runs the host-side cache gather,
    stages the padded batch and launches the copies and the forward on
    the current CUDA stream without waiting; :meth:`finish` copies the
    probabilities back (the one synchronisation).  The batcher launches
    batch k then resolves batch k-1, so the gather of one batch hides
    under the previous batch's device work.
    """

    def __init__(self, model, caches, *, max_batch: int = 256,
                 min_bucket: int = 8, dense_dim: Optional[int] = None,
                 fields: Optional[int] = None,
                 metrics: Optional[ServeMetrics] = None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "RecsysEngine: CUDA is not available; pass device='cpu' "
                "to serve on the CPU")
        self.caches = tuple(caches) if isinstance(caches, (tuple, list)) \
            else (caches,)
        if not self.caches:
            raise ValueError("need at least one serving cache")
        self.metrics = metrics or ServeMetrics()
        self.model = self._snapshot(model)
        self.max_batch = int(max_batch)
        self.buckets = _pow2_buckets(min(int(min_bucket), self.max_batch),
                                     self.max_batch)
        self._seen_buckets: set = set()
        self._staging: dict = {}   # bucket -> [_Staging, _Staging]
        self._turn: dict = {}      # bucket -> index of the next set
        # per-request feature dims, for INTAKE validation: a request
        # with a wrong-length feature vector must be rejected at the
        # door, not blow up the whole batch (which would strike the
        # member's engine loop out and hand the poison to every
        # surviving peer in turn).  Explicit kwargs win; else the
        # model's own attributes; else learned from the first batch.
        self.dense_dim = int(dense_dim) if dense_dim is not None else \
            getattr(model, "dense_dim", None)
        self.fields = int(fields) if fields is not None else \
            getattr(model, "num_sparse_fields",
                    getattr(model, "fields", None))

    def _snapshot(self, model):
        """A copy of ``model`` on the engine's device that shares no
        storage with it: every parameter and buffer ``detach().clone()``d
        (a trainer's in-place update leaves the copy as it was)."""
        memo = {}
        for p in model.parameters():
            memo[id(p)] = torch.nn.Parameter(
                p.detach().to(self.device, copy=True), requires_grad=False)
        for b in model.buffers():
            memo[id(b)] = b.detach().to(self.device, copy=True)
        snap = copy.deepcopy(model, memo)
        for t in (*snap.parameters(), *snap.buffers()):
            if t.device.type != self.device.type or (
                    self.device.index is not None
                    and t.device.index != self.device.index):
                raise RuntimeError(
                    f"RecsysEngine on {self.device}: a model tensor stayed "
                    f"on {t.device}")
        return snap.eval()

    # ---- executable accounting (the serve/engine.py contract) ----
    def compiled_executables(self) -> int:
        return len(self._seen_buckets)

    @property
    def max_executables(self) -> int:
        return len(self.buckets)

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"batch of {n} requests exceeds max_batch "
                         f"{self.max_batch}")

    def _stage(self, s: int, shapes):
        """The next staging set of bucket ``s``, free to write: on the
        card a pinned set (two a bucket, alternating; each waits for its
        previous copies), on the CPU plain arrays."""
        if self.device.type != "cuda":
            return None, [np.zeros(sh, np.float32) for sh in shapes]
        sets = self._staging.get(s)
        if sets is None:
            sets = self._staging[s] = [_Staging(shapes), _Staging(shapes)]
            self._turn[s] = 0
        st = sets[self._turn[s]]
        self._turn[s] ^= 1
        st.wait()
        return st, st.views

    # ---- the split step ----
    def gather_launch(self, dense, sparse):
        """Host-side cache gather + asynchronous launch for one batch.
        ``dense``: [B, dense_dim] f32; ``sparse``: [B, fields] int64.
        Returns an opaque handle for :meth:`finish`."""
        dense = np.ascontiguousarray(dense, np.float32)
        sparse = np.ascontiguousarray(sparse, np.int64)
        B = dense.shape[0]
        if B < 1:
            raise ValueError("empty batch")
        if self.dense_dim is None:
            self.dense_dim = int(dense.shape[1])
        if self.fields is None:
            self.fields = int(sparse.shape[1])
        s = self.bucket_for(B)
        if s not in self._seen_buckets:
            self._seen_buckets.add(s)
            self.metrics.inc("recsys_compiles")
            trace.instant("serve.recompile", {"kind": "recsys",
                                              "bucket": s})
        with trace.span("serve.recsys.gather") as sp:
            sp.set("batch", B)
            rows = [c.lookup(sparse) for c in self.caches]
        shapes = [(s, dense.shape[1])] + [(s,) + r.shape[1:] for r in rows]
        st, bufs = self._stage(s, shapes)
        for buf, a in zip(bufs, [dense, *rows]):
            buf[:B] = a
            buf[B:] = 0.0
        with trace.span("serve.recsys.dispatch") as sp:
            sp.set("bucket", s)
            with torch.inference_mode():
                if st is None:
                    args = [torch.from_numpy(b) for b in bufs]
                else:
                    args = [h.to(self.device, non_blocking=True)
                            for h in st.host]
                    st.event = torch.cuda.Event()
                    st.event.record()
                probs = torch.sigmoid(self.model(*args))
        return (probs, B)

    def finish(self, handle) -> np.ndarray:
        """Wait for a :meth:`gather_launch` handle; ``[B]`` f32 CTR
        probabilities."""
        probs, B = handle
        with trace.span("serve.recsys.device_wait"):
            out = probs.cpu().numpy()
        self.metrics.inc("recsys_batches")
        self.metrics.inc("recsys_scored", B)
        return out[:B]

    def score(self, dense, sparse) -> np.ndarray:
        """Synchronous convenience: gather + forward + fetch."""
        return self.finish(self.gather_launch(dense, sparse))

    def close(self) -> None:
        for c in self.caches:
            c.close()


class EngineKilledError(RuntimeError):
    """The pool's kill switch fired for a CTR member's engine."""


class _GuardedRecsysEngine:
    """Kill-switch proxy over a :class:`RecsysEngine` — the CTR analog
    of ``pool._GuardedEngine`` (chaos runs SIGKILL-alike a member
    deterministically; every verb then raises)."""

    def __init__(self, inner):
        self.inner = inner
        self.killed = False

    @property
    def caches(self):
        return self.inner.caches

    @property
    def metrics(self):
        return self.inner.metrics

    @property
    def max_batch(self):
        return self.inner.max_batch

    @property
    def dense_dim(self):
        return self.inner.dense_dim

    @property
    def fields(self):
        return self.inner.fields

    def kill(self) -> None:
        self.killed = True

    def _check(self) -> None:
        if self.killed:
            raise EngineKilledError("pool member engine killed")

    def gather_launch(self, dense, sparse):
        self._check()
        return self.inner.gather_launch(dense, sparse)

    def finish(self, handle):
        self._check()
        return self.inner.finish(handle)

    def score(self, dense, sparse):
        self._check()
        return self.inner.score(dense, sparse)

    def close(self):
        # deliberately NOT kill-guarded: closing a killed member must
        # still record its caches' open degrade spans
        self.inner.close()


# ---------------------------------------------------------------------------
# requests + the micro-batching scheduler
# ---------------------------------------------------------------------------

@dataclass(eq=False)
class RecsysRequest:
    """One CTR scoring request (identity semantics, like serve Request)."""

    dense: np.ndarray = None     # [dense_dim] f32
    sparse: np.ndarray = None    # [fields] int64
    timeout_s: Optional[float] = None
    rid: int = field(default_factory=lambda: next(_req_ids))

    score: Optional[float] = None
    state: str = "new"           # new|queued|running|done
    status: str = ""             # ok|timeout|cancelled|error|shutdown
    requeues: int = 0
    rejected: bool = False       # intake-closed reject: the pool re-routes
    owner: object = field(default=None, repr=False)
    _term_lock: threading.Lock = field(default_factory=threading.Lock,
                                       repr=False)
    # finish_request compatibility (generated_tokens counter): always []
    tokens: list = field(default_factory=list)
    slot: Optional[int] = None   # scheduler-surface compat; always None
    submitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    done: threading.Event = field(default_factory=threading.Event)

    @property
    def ttfr_s(self) -> Optional[float]:
        """Time to first (and only) response."""
        if self.finished_at is None or self.submitted_at is None:
            return None
        return self.finished_at - self.submitted_at


class RecsysBatcher:
    """Micro-batching scheduler over a (guarded) :class:`RecsysEngine`.

    Queued requests COALESCE into one bucketed forward per step, bounded
    by a latency budget: a batch launches when it is full
    (``max_batch``), when its oldest request has waited ``max_delay_s``,
    or immediately when the device is idle (an unloaded server adds zero
    coalescing latency; under load the in-flight batch IS the
    coalescing window).

    Pipelining: step k launches batch k BEFORE waiting for batch k-1's
    result, so the embedding gather overlaps the previous device step.

    The scheduler surface matches ``ContinuousBatchingScheduler`` where
    the pool and the van server touch it (submit / load / export /
    adopt / requeue / drain / cancel / stop_intake / replace_engine /
    yield_to_control), so :class:`RecsysServer` IS an
    ``InferenceServer`` and CTR members ride ``ServingPool`` unchanged.
    CTR requests are STATELESS (no KV slots): exports carry
    ``slot=None`` pairs only and failover is a plain re-queue on the
    peer.
    """

    def __init__(self, engine, *, max_batch: Optional[int] = None,
                 max_delay_s: float = 0.002, metrics=None,
                 max_requeues: int = 3):
        self.engine = engine
        self.metrics = metrics or engine.metrics
        self.max_batch = int(max_batch or engine.max_batch)
        self.max_delay_s = float(max_delay_s)
        self.max_requeues = int(max_requeues)
        self._lock = threading.Lock()
        self._queue = deque()
        self._inflight: list = []      # requests of the launched batch
        self._handle = None            # engine handle for _inflight
        self._accepting = True
        self._reject_status = "shutdown"
        self._ttfr = self.metrics.registry.histogram(
            "recsys.ttfr_s", DEFAULT_LATENCY_BUCKETS,
            help="request submit to scored response")

    # ---- intake ----
    def _shape_mismatch(self, request: RecsysRequest) -> Optional[str]:
        """Feature-dim validation against what the engine serves: a
        wrong-length vector admitted into a batch would blow up the
        WHOLE forward — an engine-level strike for a request-level
        mistake, which under a pool would poison every surviving peer in
        turn."""
        dd = getattr(self.engine, "dense_dim", None)
        ff = getattr(self.engine, "fields", None)
        if dd is not None and request.dense.reshape(-1).shape[0] != dd:
            return (f"dense vector has {request.dense.reshape(-1).shape[0]}"
                    f" features, engine serves {dd}")
        if ff is not None and request.sparse.reshape(-1).shape[0] != ff:
            return (f"sparse vector has "
                    f"{request.sparse.reshape(-1).shape[0]} fields, "
                    f"engine serves {ff}")
        return None

    def submit(self, request: RecsysRequest, *,
               resolve_on_reject: bool = True) -> RecsysRequest:
        request.submitted_at = time.monotonic()
        if self._shape_mismatch(request) is not None:
            # charged to the REQUEST (like the LLM scheduler's overflow
            # admissions), never to the engine
            finish_request(request, "overflow", self.metrics)
            return request
        with self._lock:
            if not self._accepting:
                # same contract as the LLM scheduler: flag the reject for
                # the pool's re-route; only resolve when nobody re-routes
                request.rejected = True
                if resolve_on_reject:
                    finish_request(request, self._reject_status, None)
                self.metrics.inc("requests_rejected")
                return request
            request.state = "queued"
            request.owner = self
            self._queue.append(request)
            self.metrics.inc("requests_submitted")
            self.metrics.set_gauge("queue_depth", len(self._queue))
        return request

    # ---- pool-facing signals ----
    @property
    def load(self) -> int:
        """Lock-free routing signal (see LLM scheduler ``load``)."""
        return len(self._queue) + len(self._inflight)

    @property
    def running_count(self) -> int:
        return len(self._inflight)

    def has_work(self) -> bool:
        with self._lock:
            return bool(self._queue or self._inflight)

    def owns(self, request) -> bool:
        with self._lock:
            return request in self._queue or request in self._inflight

    def yield_to_control(self) -> bool:
        """The engine loop's hand-off point between steps: a step holds
        the lock for one batch only, so nothing waits to be handed it."""
        return False

    # ---- the micro-batching step ----
    def _take_locked(self, now: float) -> list:
        """Form a batch if the latency budget says so (caller holds the
        lock); expires over-deadline queue heads as it goes."""
        while self._queue:
            head = self._queue[0]
            if head.timeout_s is not None and \
                    now - head.submitted_at > head.timeout_s:
                self._queue.popleft()
                self._finish(head, "timeout")
                continue
            break
        if not self._queue:
            return []
        ripe = (len(self._queue) >= self.max_batch
                or not self._inflight
                or now - self._queue[0].submitted_at >= self.max_delay_s)
        if not ripe:
            return []
        batch = []
        while self._queue and len(batch) < self.max_batch:
            req = self._queue.popleft()
            req.state = "running"
            batch.append(req)
        return batch

    def step(self) -> list:
        """Launch the next ripe batch, then resolve the previous one.
        Returns the requests completed this step."""
        completed = []
        with self._lock, trace.span("serve.recsys.step") as sp:
            now = time.monotonic()
            batch = self._take_locked(now)
            if batch:
                try:
                    handle = self.engine.gather_launch(
                        np.stack([r.dense for r in batch]),
                        np.stack([r.sparse for r in batch]))
                except Exception:
                    # engine-level failure: nothing ran — requests go
                    # back to the head unchanged modulo a requeue charge
                    # (a deterministically-poisonous batch must not kill
                    # every engine incarnation forever); the raise feeds
                    # the server loop's strike counter
                    for req in reversed(batch):
                        self._requeue_locked(req, completed)
                    raise
                try:
                    completed += self._resolve_locked()
                except Exception:
                    # the PREVIOUS batch's resolve blew up after this
                    # batch launched: the just-launched requests are in
                    # neither the queue nor _inflight — requeue them or
                    # they strand with done never set
                    for req in reversed(batch):
                        self._requeue_locked(req, completed)
                    raise
                self._inflight = batch
                self._handle = handle
            else:
                completed += self._resolve_locked()
            self.metrics.set_gauge("queue_depth", len(self._queue))
            sp.set("completed", len(completed))
        return completed

    def _resolve_locked(self) -> list:
        if not self._inflight:
            return []
        reqs, handle = self._inflight, self._handle
        try:
            probs = self.engine.finish(handle)
        except Exception:
            self._inflight, self._handle = [], None
            for req in reversed(reqs):
                self._requeue_locked(req, [])
            raise
        self._inflight, self._handle = [], None
        out = []
        now = time.monotonic()
        for i, req in enumerate(reqs):
            req.score = float(probs[i])
            if not req.done.is_set():
                self._ttfr.observe(now - req.submitted_at)
                self.metrics.observe_ttft(now - req.submitted_at)
            self._finish(req, req.status or "ok")
            out.append(req)
        return out

    def _requeue_locked(self, req: RecsysRequest, completed: list) -> bool:
        req.requeues += 1
        if req.requeues > self.max_requeues:
            self._finish(req, "error")
            completed.append(req)
            return False
        req.state = "queued"
        self._queue.appendleft(req)
        self.metrics.inc("requests_requeued")
        return True

    def requeue_inflight(self, *, max_requeues: Optional[int] = None) -> int:
        """Engine-failure path (the server loop calls this on a step
        exception): put the launched batch back at the queue head."""
        with self._lock:
            n = 0
            reqs, self._inflight, self._handle = self._inflight, [], None
            for req in reversed(reqs):
                if self._requeue_locked(req, []):
                    n += 1
            self.metrics.set_gauge("queue_depth", len(self._queue))
            return n

    # ---- migration / failover hand-off (pool surface) ----
    def _export_locked(self, fold: bool) -> list:
        out = []
        reqs, self._inflight, self._handle = self._inflight, [], None
        for req in reqs:
            if fold:
                # the batch was mid-flight when the member died: charge a
                # requeue so a poisonous batch cannot bounce forever
                req.requeues += 1
                if req.requeues > self.max_requeues:
                    self._finish(req, "error")
                    continue
            req.state = "queued"
            out.append((req, None))
        while self._queue:
            out.append((self._queue.popleft(), None))
        for req, _ in out:
            req.owner = None
        self.metrics.set_gauge("queue_depth", 0)
        return out

    def export_inflight(self, *, fold: bool = False) -> list:
        with self._lock:
            pairs = self._export_locked(fold)
            self.metrics.inc("requests_exported", len(pairs))
            return pairs

    def export_inflight_with_slots(self) -> tuple:
        """Pool-drain surface: CTR requests carry no KV slots, so the
        snapshot half is always empty (``migrate_inflight`` then skips
        the wire and re-queues on the peer)."""
        with self._lock:
            return self._export_locked(fold=False), []

    def adopt_inflight(self, pairs, snapshots=None, *,
                       return_count: bool = False):
        pairs = list(pairs)
        if snapshots:
            raise RuntimeError(
                "CTR members hold no KV slots; nothing can adopt "
                "snapshots")
        n = 0
        with self._lock:
            if not self._accepting:
                raise RuntimeError(
                    "scheduler is drained; cannot adopt migrated requests")
            for req, slot in pairs:
                if slot is not None:
                    raise RuntimeError(
                        f"CTR request {req.rid} carries slot {slot}")
                if req.done.is_set():
                    continue  # finished in transit (cancel race)
                req.state = "queued"
                req.owner = self
                self._queue.append(req)
                n += 1
            self.metrics.inc("requests_adopted", n)
            self.metrics.set_gauge("queue_depth", len(self._queue))
        if return_count:
            return {}, n
        return {}

    # ---- lifecycle ----
    def replace_engine(self, engine) -> None:
        with self._lock:
            self._accepting = True
            self._reject_status = "shutdown"
        self.requeue_inflight()
        with self._lock:
            self.engine = engine

    def cancel(self, request, status: str = "cancelled") -> None:
        with self._lock:
            already = request.done.is_set()
            if request in self._queue:
                self._queue.remove(request)
            # a request in the launched batch cannot be un-launched; the
            # resolve's finish_request no-ops against the settled status
            if not already:
                self._finish(request, status)

    def stop_intake(self, status: str = "shutdown") -> None:
        with self._lock:
            self._accepting = False
            self._reject_status = status

    def drain(self, status: str = "shutdown", *,
              stop_accepting: bool = False) -> None:
        with self._lock:
            if stop_accepting:
                self._accepting = False
                self._reject_status = status
            while self._queue:
                self._finish(self._queue.popleft(), status)
            reqs, self._inflight, self._handle = self._inflight, [], None
            for req in reqs:
                self._finish(req, status)

    def _finish(self, req: RecsysRequest, status: str) -> None:
        finish_request(req, status, self.metrics)

    # ---- convenience runner (tests / bench) ----
    def run(self, requests, *, max_steps: int = 100_000) -> dict:
        for r in requests:
            self.submit(r)
        for _ in range(max_steps):
            if not self.has_work():
                break
            self.step()
        return {r.rid: r.score for r in requests}


# ---------------------------------------------------------------------------
# the van front end
# ---------------------------------------------------------------------------

class RecsysServer(InferenceServer):
    """The blob-channel front end speaking CTR scoring instead of
    generation: ``{dense: [...], sparse: [...]} -> {score: p}``.  The
    listener/dedup/engine-loop/failover machinery is inherited from
    :class:`~hetu_tpu_torch.serve.server.InferenceServer` — only the
    wire-format hooks differ."""

    def _build_request(self, msg: dict) -> RecsysRequest:
        dense = np.asarray(msg["dense"], np.float32).reshape(-1)
        sparse = np.asarray(msg["sparse"], np.int64).reshape(-1)
        if sparse.shape[0] == 0:
            raise ValueError("empty sparse feature vector")
        # wrong-length features answer 'bad_request' at the wire when the
        # engine's dims are known (a pool front door validates at the
        # member's intake instead — 'overflow' there)
        eng = getattr(self.scheduler, "engine", None)
        for have, want, what in (
                (dense.shape[0], getattr(eng, "dense_dim", None), "dense"),
                (sparse.shape[0], getattr(eng, "fields", None), "sparse")):
            if want is not None and have != want:
                raise ValueError(f"{what} vector has {have} features, "
                                 f"engine serves {want}")
        return RecsysRequest(
            dense=dense, sparse=sparse,
            timeout_s=min(float(msg.get("timeout_s",
                                        self.request_timeout_s)),
                          self.request_timeout_s))

    def _build_response(self, msg: dict, req: RecsysRequest) -> dict:
        return {"id": msg.get("id"), "status": req.status or "ok",
                "score": req.score, "ttfr_s": req.ttfr_s}

    def _bad_request(self, err: Exception) -> dict:
        return {"id": None, "status": "bad_request", "error": str(err),
                "score": None}


class RecsysClient(InferenceClient):
    """Blocking CTR client for one channel pair (same idempotent
    resubmission/dedup contract as the generation client)."""

    def score(self, dense, sparse, *, timeout_s: float = 30.0,
              deadline_s=None, wire_retries: int = 1) -> dict:
        self._rid += 1
        msg = {"id": self._rid, "cn": self._nonce,
               "dense": [float(x) for x in np.asarray(dense).reshape(-1)],
               "sparse": [int(x) for x in np.asarray(sparse).reshape(-1)],
               "timeout_s": timeout_s if deadline_s is None
               else float(deadline_s)}
        return self._roundtrip(msg, timeout_s, wire_retries)


class _PoolFrontDoor:
    """Scheduler-shaped shim that routes a listener's submit through the
    POOL (least-loaded healthy member) instead of one local queue — the
    glue that puts wire listeners in front of a :class:`RecsysPool`.
    The engine-loop half of the server surface is inert (members run
    their own loops)."""

    def __init__(self, pool: "RecsysPool"):
        self.pool = pool
        self.metrics = pool.metrics

    def submit(self, request, **kw):
        return self.pool.submit(request)

    def cancel(self, request, status: str = "cancelled") -> None:
        self.pool._cancel(request, status)

    def has_work(self) -> bool:
        return False

    def step(self) -> list:  # pragma: no cover - loop idles on has_work
        return []

    def requeue_inflight(self, **kw) -> int:
        return 0

    def drain(self, status: str = "shutdown", *,
              stop_accepting: bool = False) -> None:
        return None

    def replace_engine(self, engine) -> None:  # pragma: no cover
        return None


# ---------------------------------------------------------------------------
# pool membership
# ---------------------------------------------------------------------------

def recsys_member_factory(pool, name: str, factory):
    """``ServingPool`` ``member_factory`` building a CTR member: guarded
    engine + micro-batching scheduler + listener-less RecsysServer."""
    from hetu_tpu_torch.serve.pool import PoolMember
    engine = _GuardedRecsysEngine(factory())
    sched = RecsysBatcher(engine, max_requeues=pool._max_requeues)
    srv = RecsysServer(
        sched, port=pool.port, own_van=False, max_clients=0,
        request_timeout_s=pool.request_timeout_s,
        max_loop_errors=pool._max_loop_errors,
        failover_grace_s=pool._failover_grace_s)
    return PoolMember(name, factory, sched, srv,
                      fresh_engine=lambda: _GuardedRecsysEngine(factory()))


class RecsysPool:
    """:class:`~hetu_tpu_torch.serve.pool.ServingPool` whose members
    serve CTR scores: same health poll, least-loaded routing,
    ``serve_engine_kill`` failover, planned drain and revive — requests
    are stateless so every hand-off is a re-queue (no KV wire transfer).

    Composition (not subclassing) keeps the pool's own surface intact;
    everything not overridden here delegates.
    """

    def __init__(self, engine_factories, **kwargs):
        from hetu_tpu_torch.serve.pool import ServingPool
        kwargs.setdefault("member_factory", recsys_member_factory)
        self._pool = ServingPool(engine_factories, **kwargs)

    def __getattr__(self, name):
        if name == "_pool":
            # __init__ raised before assigning it: a plain AttributeError
            # (not infinite __getattr__ recursion) lets the caller's
            # cleanup see the REAL construction failure
            raise AttributeError(name)
        return getattr(self._pool, name)

    def frontend(self, *, max_clients: int = 4,
                 request_timeout_s: Optional[float] = None) -> RecsysServer:
        """Start wire listeners on the pool's van: clients connect with
        :class:`RecsysClient` and their requests route through the pool
        (the caller closes the returned server before the pool)."""
        return RecsysServer(
            _PoolFrontDoor(self), port=self._pool.port, own_van=False,
            max_clients=int(max_clients),
            request_timeout_s=float(request_timeout_s
                                    if request_timeout_s is not None
                                    else self._pool.request_timeout_s))

    def score(self, dense, sparse, *,
              timeout_s: Optional[float] = None) -> dict:
        """Blocking convenience: route one request to the healthiest
        member and wait; the response dict matches the wire shape."""
        pool = self._pool
        req = RecsysRequest(
            dense=np.asarray(dense, np.float32).reshape(-1),
            sparse=np.asarray(sparse, np.int64).reshape(-1),
            timeout_s=float(timeout_s if timeout_s is not None
                            else pool.request_timeout_s))
        pool.submit(req)
        if not req.done.wait(timeout=req.timeout_s + 15.0):
            pool._cancel(req, "timeout")
        return {"id": req.rid, "status": req.status or "ok",
                "score": req.score, "ttfr_s": req.ttfr_s}


__all__ = [
    "ServingEmbeddingCache", "RecsysEngine", "RecsysBatcher",
    "RecsysRequest", "RecsysServer", "RecsysClient", "RecsysPool",
    "recsys_member_factory", "EngineKilledError", "NOT_CACHED",
    "STALENESS_BUCKETS",
]
