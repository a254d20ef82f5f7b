"""Training metric logger (counterpart of ``hetu_tpu/utils/logger.py``).

Host-side bookkeeping: running means of the scalars a step logs, step
timing, an optional JSONL log file and an optional wandb passthrough when
the package is installed.  A thin facade over a
:class:`~hetu_tpu_torch.telemetry.registry.MetricsRegistry`: ``inc``
counters are typed :class:`Counter` objects and ``log`` scalars mirror
into gauges, so a run's metrics come out as ``means()`` /
``counters_snapshot()`` / the log file, or as a Prometheus text
exposition (``prometheus_text()``).
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Optional

from hetu_tpu_torch.telemetry.registry import (
    Counter, MetricsRegistry, _prom_name,
)


class MetricLogger:
    def __init__(self, log_path: Optional[str] = None, *,
                 use_wandb: bool = False, wandb_kwargs: Optional[dict] = None,
                 registry: Optional[MetricsRegistry] = None):
        # counters and log() scalars are separate namespaces: the
        # supervisor both inc()s "checkpoints" and log()s a "checkpoints"
        # scalar in its final counter snapshot, so they get separate
        # registries and prometheus_text() merges them (counters render
        # with the _total suffix, so names never clash)
        self.registry = registry if registry is not None else MetricsRegistry()
        self._scalar_registry = MetricsRegistry()
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.step = 0
        self.t0 = time.perf_counter()
        self.log_file = None
        if log_path:
            p = Path(log_path)
            # a log path in a run directory not made yet must not crash
            # the run it was meant to observe
            p.parent.mkdir(parents=True, exist_ok=True)
            self.log_file = open(p, "a")
        self.wandb = None
        if use_wandb:  # pragma: no cover - optional dependency
            try:
                import wandb
                wandb.init(**(wandb_kwargs or {}))
                self.wandb = wandb
            except Exception:
                self.wandb = None

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        self.step = step if step is not None else self.step + 1
        for k, v in metrics.items():
            v = float(v)
            self.totals[k] += v
            self.counts[k] += 1
            self._scalar_registry.gauge(k).set(v)
        if self.wandb is not None:  # pragma: no cover
            self.wandb.log({k: float(v) for k, v in metrics.items()},
                           step=self.step)
        if self.log_file:
            rec = {"step": self.step,
                   "t": round(time.perf_counter() - self.t0, 3),
                   **{k: float(v) for k, v in metrics.items()}}
            self.log_file.write(json.dumps(rec) + "\n")
            self.log_file.flush()

    def inc(self, name: str, n: int = 1) -> int:
        """Bump a monotonic event counter (fault injected, retry, shard
        repair, ...); unlike ``log`` scalars these are never averaged."""
        return self.registry.counter(name).inc(int(n))

    def counters_snapshot(self) -> dict:
        return {name: m.value for name, m in self.registry.metrics().items()
                if isinstance(m, Counter)}

    @property
    def counters(self) -> dict:
        """The live counter values by name."""
        return self.counters_snapshot()

    def means(self) -> dict:
        return {k: self.totals[k] / max(self.counts[k], 1)
                for k in self.totals}

    def reset(self, counters: bool = False) -> None:
        """Clear the running means.  Monotonic counters survive unless
        ``counters=True``."""
        self.totals.clear()
        self.counts.clear()
        if counters:
            for m in self.registry.metrics().values():
                if isinstance(m, Counter):
                    m.reset()

    def prometheus_text(self) -> str:
        """Text exposition of everything this logger holds: counters
        (``inc``, with the conventional ``_total`` suffix) plus gauges for
        the latest ``log`` scalars.  A shared registry (``registry=``) may
        hold other metrics; those render with their own types."""
        lines = []
        others = MetricsRegistry()
        for name, m in sorted(self.registry.metrics().items()):
            if isinstance(m, Counter):
                pname = _prom_name(name) + "_total"
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {m.value}")
            else:
                others._metrics[name] = m
        return "\n".join(lines) + ("\n" if lines else "") \
            + others.prometheus_text() \
            + self._scalar_registry.prometheus_text()

    def close(self) -> None:
        if self.log_file:
            self.log_file.close()
