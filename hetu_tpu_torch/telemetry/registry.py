"""Typed metrics: Counter, Gauge, fixed-bucket Histogram, one registry
(counterpart of ``hetu_tpu/telemetry/registry.py``, copied whole: pure
Python).

* :class:`Counter` — monotonic (fault injected, retry, tokens served);
* :class:`Gauge`   — last-write-wins level (queue depth, elastic width);
* :class:`Histogram` — fixed upper-bound buckets with p50/p90/p99 read
  out by linear interpolation inside the bucket (the Prometheus
  ``histogram_quantile`` estimator, computed client-side) plus exact
  count/sum/min/max.

Exposition: :meth:`MetricsRegistry.snapshot` (a JSON-able dict),
:meth:`MetricsRegistry.prometheus_text` (the text format a file-based
scrape or a pushgateway ingests) and :meth:`MetricsRegistry.dump` (the
lossless form :meth:`MetricsRegistry.merge` folds, e.g. a member's
registry shipped to a controller: counters sum, gauges take the last
write, histograms add bucket by bucket).

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

    def reset(self) -> None:
        with self._lock:
            self._value = 0


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
    (``le``), ascending; an implicit +inf bucket catches the overflow.
    Percentiles interpolate linearly within the winning bucket (clamped
    by the exact observed min/max, so a single-value histogram reports
    that value, not a bucket edge)."""

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

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

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
                frac = (rank - cum) / c
                est = lo + (hi - lo) * frac
                return min(max(est, self._min), self._max)
            cum += c
        return self._max

    def percentile(self, q: float) -> Optional[float]:
        """q in [0, 1] → estimated quantile; None with no observations."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        with self._lock:
            return self._percentile_locked(q)

    def snapshot(self) -> dict:
        # everything under ONE lock acquisition: count/sum/min/max and the
        # three percentiles must describe the same set of observations
        # (a scrape racing a burst of observes must never report p50>p99)
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

    # ---- fleet aggregation ----
    def dump(self) -> dict:
        """Full-state, JSON-able export: unlike :meth:`snapshot` (which
        collapses histograms to percentiles), this keeps raw bucket
        counts — the form :meth:`merge` can fold LOSSLESSLY, which is
        what lets a controller aggregate member registries shipped over
        a wire into one fleet registry whose percentiles are computed
        from the SUMMED buckets, not averaged member percentiles."""
        out = {}
        for name, m in sorted(self.metrics().items()):
            if isinstance(m, Counter):
                out[name] = {"type": "counter", "value": m.value,
                             "help": m.help}
            elif isinstance(m, Gauge):
                out[name] = {"type": "gauge", "value": m.value,
                             "help": m.help}
            elif isinstance(m, Histogram):
                with m._lock:
                    out[name] = {"type": "histogram",
                                 "buckets": list(m.buckets),
                                 "counts": list(m._counts),
                                 "sum": m._sum, "count": m._count,
                                 "min": m._min, "max": m._max,
                                 "help": m.help}
        return out

    @classmethod
    def from_dump(cls, dump: dict) -> "MetricsRegistry":
        reg = cls()
        reg.merge(dump)
        return reg

    def merge(self, other, *, prefix: str = "") -> "MetricsRegistry":
        """Fold another registry (or a :meth:`dump` dict, e.g. one that
        crossed a process boundary as JSON) into this one: counters SUM,
        gauges LAST-WRITE-WINS, histograms add BUCKET-WISE — the bucket
        schemas must match exactly (mismatched buckets cannot be merged
        losslessly, so that is an error, not a best-effort).  ``prefix``
        namespaces every merged name (``prefix="m0."``) so same-named
        metrics from different processes can coexist when the caller
        wants per-source attribution instead of a fleet sum."""
        dump = other.dump() if isinstance(other, MetricsRegistry) else other
        for raw_name, rec in dump.items():
            name = prefix + raw_name
            kind = rec["type"]
            if kind == "counter":
                self.counter(name, rec.get("help", "")).inc(rec["value"])
            elif kind == "gauge":
                self.gauge(name, rec.get("help", "")).set(rec["value"])
            elif kind == "histogram":
                want = tuple(float(b) for b in rec["buckets"])
                h = self.histogram(name, want, rec.get("help", ""))
                if h.buckets != want:
                    raise ValueError(
                        f"histogram {name!r}: incompatible buckets "
                        f"{list(h.buckets)} vs {list(want)} — bucket-wise "
                        f"merge needs one schema")
                counts = rec["counts"]
                if len(counts) != len(h._counts):
                    raise ValueError(
                        f"histogram {name!r}: {len(counts)} counts for "
                        f"{len(h._counts)} buckets")
                with h._lock:
                    for i, c in enumerate(counts):
                        h._counts[i] += int(c)
                    h._sum += float(rec["sum"])
                    h._count += int(rec["count"])
                    for attr, pick in (("_min", min), ("_max", max)):
                        v = rec.get(attr.lstrip("_"))
                        if v is not None:
                            cur = getattr(h, attr)
                            setattr(h, attr, float(v) if cur is None
                                    else pick(cur, float(v)))
            else:
                raise ValueError(f"unknown metric type {kind!r} "
                                 f"for {name!r}")
        return self

    # ---- exposition ----
    def snapshot(self) -> dict:
        """JSON-able flat dict: counters/gauges → scalar, histograms →
        {count, sum, min, max, p50, p90, p99}."""
        out = {}
        for name, m in sorted(self.metrics().items()):
            if isinstance(m, Histogram):
                out[name] = m.snapshot()
            else:
                out[name] = m.value
        return out

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

    def write_prometheus(self, path) -> str:
        from pathlib import Path
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(self.prometheus_text())
        return str(p)
