"""Telemetry (counterpart of ``hetu_tpu/telemetry``): the span tracer and
the typed metrics registry that serving records into."""

from hetu_tpu_torch.telemetry import trace
from hetu_tpu_torch.telemetry.registry import (
    DEFAULT_LATENCY_BUCKETS, Counter, Gauge, Histogram, MetricsRegistry,
)

__all__ = ["trace", "DEFAULT_LATENCY_BUCKETS", "Counter", "Gauge",
           "Histogram", "MetricsRegistry"]
