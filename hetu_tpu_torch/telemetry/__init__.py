"""Telemetry (counterpart of ``hetu_tpu/telemetry``): the span tracer and
the typed metrics registry.

``default_registry`` is the process-wide registry that the van's client
ops (``van.<op>.calls`` / ``.bytes`` / ``.latency_s`` / ``.errors``, the
blob channel's ``van.blob_channel.reconnects``) and the migration wire's
link-rate gauge (``migrate.wire.mbps_last``) record into, as the
reference's do; ``prometheus_text()`` snapshots it.  Serving and the PS
cache record into a registry their caller passes.
"""

from hetu_tpu_torch.telemetry import trace
from hetu_tpu_torch.telemetry.registry import (
    DEFAULT_LATENCY_BUCKETS, Counter, Gauge, Histogram, MetricsRegistry,
)

# the process-default metrics registry: the van and the migration wire
# record here; scrape with prometheus_text()
default_registry = MetricsRegistry()


def prometheus_text() -> str:
    return default_registry.prometheus_text()


__all__ = ["trace", "DEFAULT_LATENCY_BUCKETS", "Counter", "Gauge",
           "Histogram", "MetricsRegistry", "default_registry",
           "prometheus_text"]
