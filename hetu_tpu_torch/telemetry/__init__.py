"""Telemetry (counterpart of ``hetu_tpu/telemetry``): span tracing, typed
metrics, chaos timelines and the fleet plane, under the reference's names.

* :mod:`trace`    — thread-safe span tracer on monotonic clocks;
  Chrome-trace/Perfetto JSON and append-only JSONL export (one stream a
  process through :func:`open_process_stream`, with wall-clock anchors);
  a true no-op when disabled;
* :mod:`registry` — Counter / Gauge / fixed-bucket Histogram with
  p50/p90/p99, JSON snapshot, Prometheus text, and the lossless
  ``dump``/``merge`` a fleet aggregates;
* :mod:`timeline` — pairs injected-fault instants with the recovery
  spans that answer them → per-fault-kind detection/recovery SLOs;
* :mod:`fleet`    — N process streams aligned onto one clock, per-request
  flows across processes, latency breakdowns, merged registry dumps;
* :mod:`costs`    — measured per-op costs from spans or histograms;
* :mod:`health`   — the live tail of the streams, windowed metrics, alert
  rules and the fleet doctor.

``default_registry`` is the process-wide registry that the van's client
ops (``van.<op>.calls`` / ``.bytes`` / ``.latency_s`` / ``.errors``, the
blob channel's ``van.blob_channel.reconnects``) and the migration wire's
link-rate gauge (``migrate.wire.mbps_last``) record into, as the
reference's do; ``prometheus_text()`` snapshots it.  Serving and the PS
cache record into a registry their caller passes.
"""

from hetu_tpu_torch.telemetry import (
    costs, fleet, health, registry, timeline, trace,
)
from hetu_tpu_torch.telemetry.costs import (
    calibration_ratio, measured_op_costs,
)
from hetu_tpu_torch.telemetry.health import (
    AlertRule, BurnRateRule, HealthMonitor, MetricWindows, diagnose,
    slo_burn_rules, tail_streams,
)
from hetu_tpu_torch.telemetry.registry import (
    DEFAULT_LATENCY_BUCKETS, Counter, Gauge, Histogram, MetricsRegistry,
)
from hetu_tpu_torch.telemetry.trace import (
    Tracer, complete, disable, enable, enabled, get_tracer, instant,
    load_jsonl, now_us, open_process_stream, span,
)

# the process-default metrics registry: the van and the migration wire
# record here; scrape with prometheus_text()
default_registry = MetricsRegistry()


def prometheus_text() -> str:
    return default_registry.prometheus_text()


__all__ = [
    "trace", "registry", "timeline", "fleet", "costs", "health",
    "tail_streams", "MetricWindows", "AlertRule", "BurnRateRule",
    "HealthMonitor", "slo_burn_rules", "diagnose",
    "Tracer", "enable", "disable", "enabled", "get_tracer",
    "span", "instant", "complete", "now_us", "load_jsonl",
    "open_process_stream", "measured_op_costs", "calibration_ratio",
    "DEFAULT_LATENCY_BUCKETS", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "default_registry", "prometheus_text",
]
