"""Serving metrics: TTFT, tokens/sec, queue depth, occupancy, recompiles.

A copy of ``hetu_tpu/serve/metrics.py`` (pure Python) with the same metric
names, so the two packages' serving runs report alike.  In this package
``prefill_compiles`` / ``decode_compiles`` count NEW SHAPES seen (a new
prompt bucket, the first decode): PyTorch runs eagerly, but the bucket set
is what bounds the shapes a later CUDA-graph capture needs.

Host-side counters shared by the engine, the scheduler (admission and
eviction, queue depth, occupancy) and request outcomes.  Thread-safe.
``report()`` passes a snapshot to any logger with a ``log(dict, step=)``
method.

Backed by a :class:`~hetu_tpu_torch.telemetry.registry.MetricsRegistry`:
counters/gauges are typed metrics, and TTFT is BOTH an exact bounded ring
(``collections.deque(maxlen=window)``) and a fixed-bucket
:class:`~hetu_tpu_torch.telemetry.registry.Histogram`.  ``snapshot()``
reports avg/max AND p50/p90/p99 from the ring — all WINDOWED and mutually
consistent — while the cumulative histogram feeds ``prometheus_text()``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from hetu_tpu_torch.telemetry.registry import (
    DEFAULT_LATENCY_BUCKETS, MetricsRegistry,
)


class ServeMetrics:
    def __init__(self, *, window: int = 512,
                 registry: Optional[MetricsRegistry] = None):
        self._lock = threading.Lock()
        self.registry = registry if registry is not None else MetricsRegistry()
        self._ttft = deque(maxlen=int(window))  # seconds, bounded ring
        self._ttft_hist = self.registry.histogram(
            "ttft_s", DEFAULT_LATENCY_BUCKETS,
            help="request admission to first generated token")
        self._window = int(window)
        self._decode_tokens = 0  # since last snapshot window start
        self._decode_t0 = None

    # ---- counters / gauges ----
    def inc(self, name: str, n: int = 1) -> None:
        self.registry.counter(name).inc(n)

    def set_gauge(self, name: str, value) -> None:
        self.registry.gauge(name).set(value)

    def count(self, name: str) -> int:
        return self.registry.counter(name).value

    # ---- per-tenant accounting (SLO-class groundwork) ----
    @staticmethod
    def _tenant_slug(tenant) -> str:
        """Tenant tags are FREE-FORM caller input but become metric
        name segments: anything outside [A-Za-z0-9_.-] (a space, a
        brace, a newline) would produce an invalid Prometheus
        exposition line — a hostile tag could even inject extra metric
        lines — so non-name characters collapse to '_' and the slug is
        length-capped.  (Cardinality bounding — a cap on DISTINCT
        tenants — belongs to the SLO-class admission layer, not here.)"""
        s = "".join(c if (c.isalnum() or c in "_.-") else "_"
                    for c in str(tenant))
        return s[:64] or "_"

    def note_tenant(self, tenant, event: str, n: int = 1) -> None:
        """Per-tenant counter (``tenant.<t>.<event>``): requests, sheds,
        status outcomes — the accounting surface per-tenant SLO classes
        will be enforced against.  No-op for untagged traffic."""
        if tenant:
            self.registry.counter(
                f"tenant.{self._tenant_slug(tenant)}.{event}").inc(n)

    # ---- latency / throughput ----
    def observe_ttft(self, seconds: float, *, tenant=None) -> None:
        """Time-to-first-token: request admission → prefill's first token.
        A ``tenant`` tag ALSO records into that tenant's own histogram
        (``tenant.<t>.ttft_s``) so per-tenant TTFT rides the same fleet
        scrape as the counters."""
        s = float(seconds)
        with self._lock:
            self._ttft.append(s)
        # outside the ring lock: the histogram has its own lock and its
        # only reader is the prometheus exposition — snapshot() derives
        # every ttft_* key from the ring alone
        self._ttft_hist.observe(s)
        if tenant:
            self.registry.histogram(
                f"tenant.{self._tenant_slug(tenant)}.ttft_s",
                DEFAULT_LATENCY_BUCKETS,
                help="per-tenant TTFT").observe(s)

    def observe_decode(self, n_tokens: int) -> None:
        """One decode step produced ``n_tokens`` (tokens/sec derives from
        the wall clock between the first and latest observation)."""
        with self._lock:
            now = time.perf_counter()
            if self._decode_t0 is None:
                self._decode_t0 = now
            self._decode_tokens += int(n_tokens)
            self._decode_now = now

    # ---- reporting ----
    def snapshot(self) -> dict:
        from hetu_tpu_torch.telemetry.registry import Counter, Gauge
        out = {}
        for name, m in self.registry.metrics().items():
            if isinstance(m, (Counter, Gauge)):
                out[name] = m.value
        with self._lock:
            ring = list(self._ttft)
            decode_t0 = self._decode_t0
            decode_tokens = self._decode_tokens
            decode_now = getattr(self, "_decode_now", None)
        if ring:
            # snapshot stats are all WINDOWED (the last `window`
            # observations, like the pre-histogram implementation): avg,
            # max AND the percentiles come from the same ring, so the
            # numbers in one snapshot are mutually consistent and track
            # current latency.  The cumulative histogram feeds the
            # Prometheus exposition (where lifetime _bucket counts are
            # the convention), not these keys.
            ts = sorted(ring)
            n = len(ts)
            out["ttft_avg_s"] = sum(ts) / n
            out["ttft_p50_s"] = ts[min(n // 2, n - 1)]
            out["ttft_p90_s"] = ts[min(int(0.90 * n), n - 1)]
            out["ttft_p99_s"] = ts[min(int(0.99 * n), n - 1)]
            out["ttft_max_s"] = ts[-1]
        if decode_t0 is not None and decode_now is not None:
            dt = max(decode_now - decode_t0, 1e-9)
            if dt > 0 and decode_tokens:
                out["tokens_per_sec"] = decode_tokens / dt
        # paged-engine derived rate: what fraction of prompt tokens were
        # served from the prefix cache instead of prefilled (the dedup
        # telemetry the paged A/B bench and dashboards read)
        hit = out.get("prefix_hit_tokens", 0)
        miss = out.get("prefix_miss_tokens", 0)
        if hit or miss:
            out["prefix_hit_rate"] = hit / (hit + miss)
        return out

    def report(self, logger, step=None) -> dict:
        """Log the snapshot through utils/logger.MetricLogger."""
        snap = self.snapshot()
        logger.log(snap, step=step)
        return snap

    def prometheus_text(self) -> str:
        return self.registry.prometheus_text()
