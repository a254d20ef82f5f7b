"""Typed metrics: Counter, Gauge, fixed-bucket Histogram, one registry.

A copy of the part of ``hetu_tpu/telemetry/registry.py`` that serving uses
(pure Python); the fleet dump/merge surface waits for the fleet planes.

* :class:`Counter` — monotonic (fault injected, retry, tokens served);
* :class:`Gauge`   — last-write-wins level (queue depth, elastic width);
* :class:`Histogram` — fixed upper-bound buckets plus an exact count and
  sum.

Exposition: :meth:`MetricsRegistry.prometheus_text` (the text format a
file-based scrape or a pushgateway ingests).

Thread safety: every mutation takes the metric's own lock; exposition
reads under it.  All clocks are the caller's business — the registry
stores what it is told.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Optional

# Default latency buckets (seconds): 100 µs .. 60 s, roughly x2.5 steps —
# wide enough for a van RPC and a full elastic reshard in one schema.
DEFAULT_LATENCY_BUCKETS = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _prom_name(name: str) -> str:
    """Prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]* — dots and
    dashes (our namespacing) become underscores."""
    out = name.replace(".", "_").replace("-", "_").replace("/", "_")
    if out and out[0].isdigit():
        out = "_" + out
    return out


class Counter:
    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n=1):
        with self._lock:
            self._value += n
            return self._value

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge:
    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram.  ``buckets`` are INCLUSIVE upper bounds
    (``le``), ascending; an implicit +inf bucket catches the overflow."""

    __slots__ = ("name", "help", "buckets", "_lock", "_counts", "_sum",
                 "_count", "_min", "_max")

    def __init__(self, name: str, buckets=DEFAULT_LATENCY_BUCKETS,
                 help: str = ""):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError("buckets must be a non-empty ascending sequence")
        self.name = name
        self.help = help
        self.buckets = tuple(float(b) for b in buckets)
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # +1: the +inf bucket
        self._sum = 0.0
        self._count = 0
        self._min = None
        self._max = None

    def observe(self, value) -> None:
        v = float(value)
        i = bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    def _percentile_locked(self, q: float) -> Optional[float]:
        """Caller holds self._lock."""
        if self._count == 0:
            return None
        rank = q * self._count
        cum = 0
        for i, c in enumerate(self._counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i] if i < len(self.buckets) \
                    else self._max
                # position inside the bucket, linearly interpolated
                est = lo + (hi - lo) * (rank - cum) / c
                return min(max(est, self._min), self._max)
            cum += c
        return self._max

    def snapshot(self) -> dict:
        """count, sum, min, max and p50/p90/p99, all under one lock
        acquisition (one set of observations)."""
        with self._lock:
            if self._count == 0:
                return {"count": 0, "sum": 0.0}
            return {"count": self._count, "sum": self._sum,
                    "min": self._min, "max": self._max,
                    "p50": self._percentile_locked(0.50),
                    "p90": self._percentile_locked(0.90),
                    "p99": self._percentile_locked(0.99)}


class MetricsRegistry:
    """Name → typed metric, get-or-create.  A name registered as one type
    cannot be re-registered as another (that is a bug, not a merge)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}

    def _get(self, name, cls, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, lambda: Counter(name, help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, lambda: Gauge(name, help))

    def histogram(self, name: str, buckets=DEFAULT_LATENCY_BUCKETS,
                  help: str = "") -> Histogram:
        return self._get(name, Histogram,
                         lambda: Histogram(name, buckets, help))

    def metrics(self) -> dict:
        with self._lock:
            return dict(self._metrics)

    def prometheus_text(self) -> str:
        """Prometheus text exposition (0.0.4): counters/gauges one sample
        each, histograms as cumulative ``_bucket{le=...}`` + ``_sum`` +
        ``_count`` — write it to a file and scrape with node_exporter's
        textfile collector (no HTTP endpoint required)."""
        lines = []
        for name, m in sorted(self.metrics().items()):
            pname = _prom_name(name)
            if m.help:
                lines.append(f"# HELP {pname} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {m.value}")
            elif isinstance(m, Histogram):
                lines.append(f"# TYPE {pname} histogram")
                with m._lock:
                    counts = list(m._counts)
                    total = m._count
                    s = m._sum
                cum = 0
                for b, c in zip(m.buckets, counts):
                    cum += c
                    lines.append(f'{pname}_bucket{{le="{b}"}} {cum}')
                lines.append(f'{pname}_bucket{{le="+Inf"}} {total}')
                lines.append(f"{pname}_sum {s}")
                lines.append(f"{pname}_count {total}")
        return "\n".join(lines) + "\n"
