"""Measured per-op costs from telemetry, in a cost-model's table form
(counterpart of ``hetu_tpu/telemetry/costs.py``, copied whole).

A cost model that prices plans takes a ``calibration`` knob, a
measured/predicted time ratio.  This module extracts that currency from
what a REAL run already recorded — span timings in a tracer, a
crash-durable JSONL stream, or latency histograms in a registry.

Cost-table form (one entry per op/span name, all times in SECONDS)::

    {name: {"count": n, "total_s": t, "mean_s": m, "p50_s": p, "max_s": x}}

``mean_s`` is the value a calibration consumes
(:func:`calibration_ratio`); the rest is the evidence an operator reads.
"""

from __future__ import annotations

from typing import Optional


def _costs_from_events(events, prefix: Optional[str]) -> dict:
    durs: dict = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        name = ev.get("name", "")
        if prefix and not name.startswith(prefix):
            continue
        durs.setdefault(name, []).append(float(ev.get("dur", 0.0)) / 1e6)
    out = {}
    for name, ds in sorted(durs.items()):
        ds.sort()
        n = len(ds)
        out[name] = {"count": n, "total_s": sum(ds),
                     "mean_s": sum(ds) / n,
                     "p50_s": ds[n // 2 if n % 2 else n // 2 - 1],
                     "max_s": ds[-1]}
    return out


def _costs_from_registry(reg, prefix: Optional[str]) -> dict:
    from hetu_tpu_torch.telemetry.registry import Histogram
    out = {}
    for name, m in sorted(reg.metrics().items()):
        if not isinstance(m, Histogram) or not m.count:
            continue
        if prefix and not name.startswith(prefix):
            continue
        snap = m.snapshot()
        out[name] = {"count": snap["count"], "total_s": snap["sum"],
                     "mean_s": snap["sum"] / snap["count"],
                     "p50_s": snap["p50"], "max_s": snap["max"]}
    return out


def measured_op_costs(source, *, prefix: Optional[str] = None) -> dict:
    """Summarize per-op span timings into the cost-table form above.

    ``source`` is any of the places a run's timings live:

    * a :class:`~hetu_tpu_torch.telemetry.trace.Tracer` (its ``events``);
    * a path to a JSONL span stream (crash-durable flight recorder) or a
      Chrome-trace export;
    * an already-loaded event list (e.g. the merged fleet stream from
      :func:`hetu_tpu_torch.telemetry.fleet.merge_streams`);
    * a :class:`~hetu_tpu_torch.telemetry.registry.MetricsRegistry`, whose
      latency :class:`Histogram` entries summarize from bucket state
      (``p50_s`` is then the interpolated estimate, ``total_s`` exact).

    ``prefix`` filters names (``prefix="serve."``).
    """
    from hetu_tpu_torch.telemetry.fleet import _load_source
    from hetu_tpu_torch.telemetry.registry import MetricsRegistry
    if isinstance(source, MetricsRegistry):
        return _costs_from_registry(source, prefix)
    # every other source shape (Tracer / stream path / export path /
    # event list) goes through the ONE loader fleet.py maintains
    return _costs_from_events(_load_source(source), prefix)


def calibration_ratio(costs: dict, name: str, predicted_s: float) -> float:
    """measured/predicted for one op — the scalar
    a cost model's ``calibration`` consumes.  Raises KeyError when the
    op was never measured (a silent 1.0 would defeat the point)."""
    if predicted_s <= 0:
        raise ValueError("predicted_s must be positive")
    return costs[name]["mean_s"] / float(predicted_s)
