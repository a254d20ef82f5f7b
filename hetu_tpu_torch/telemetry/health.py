"""Live fleet health: streaming tail, windowed aggregates, SLO burn-rate
alerts, and an automated fleet doctor (counterpart of
``hetu_tpu/telemetry/health.py``, copied whole).

The JSONL span streams are stitched post hoc by
:mod:`~hetu_tpu_torch.telemetry.fleet`.  This module is the LIVE half of
the same contract, four layers deep:

* **streaming tail** — :func:`tail_streams` incrementally follows every
  process's ``*.trace.jsonl`` stream in a run directory with the same
  torn-tail tolerance as :func:`~hetu_tpu_torch.telemetry.trace.load_jsonl`
  (a partial final line is buffered, never mangled, and delivered once
  its newline lands) and the same clock-anchor alignment as
  :func:`~hetu_tpu_torch.telemetry.fleet.merge_streams` — applied
  RETROACTIVELY: events read before a stream's first ``clock_sync``
  anchor are held and released wall-aligned the moment it arrives;
* **windowed aggregates** — :class:`MetricWindows` turns the cumulative
  counter / gauge / histogram dumps that ride the streams (and
  ``fleet_metrics()``) into rolling rates, deltas, and quantiles over
  arbitrary windows, so the autoscaler, benches, and dashboards stop
  each re-implementing counter-delta windowing;
* **declarative alerts** — :class:`AlertRule` (metric expression,
  window, threshold, severity) plus :class:`BurnRateRule`, the
  multi-window SLO burn-rate form compiled from the scheduler's
  ``slo_classes`` by :func:`slo_burn_rules`: a tenant's rule fires only
  when BOTH the short and the long window burn the ``ttft_slo_s`` error
  budget faster than ``threshold``× — the Google-SRE fast-burn pair
  (short catches the spike, long suppresses the blip).
  :class:`HealthMonitor` evaluates the rules on a cadence and emits
  ``health.alert`` instants into the very stream it watches (alerts are
  themselves telemetry), exposing :meth:`~HealthMonitor.active_alerts`
  for programmatic consumers (an autoscaler's SLO scale-up trigger is
  "a burn-rate alert is firing", not a hand-coded p99 threshold);
* **fleet doctor** — when an alert fires, :func:`diagnose` correlates
  it against the recent tail: injected ``fault.*`` instants (paired
  with their recovery spans via
  :data:`~hetu_tpu_torch.telemetry.timeline.RECOVERY_FOR`), structured
  ``membership.event`` / ``route.park`` forensics, van failovers, and
  link-degrade windows, and ranks root-cause verdicts into a
  ``health.diagnosis`` instant — "bronze shed spike ← netem_degrade on
  member 2 ← serve.link_degraded open 4.2s" as a record, not a stderr
  scrollback.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

from hetu_tpu_torch.telemetry import trace
from hetu_tpu_torch.telemetry.fleet import _offset_at, discover_streams
from hetu_tpu_torch.telemetry.timeline import RECOVERY_FOR


# ---------------------------------------------------------------------------
# streaming tail
# ---------------------------------------------------------------------------

class StreamTail:
    """Incremental follower of ONE JSONL span stream.

    Each :meth:`poll` reads whatever bytes the writer appended since the
    last poll, parses the COMPLETE lines, and returns the events with
    ``ts`` rebased onto the wall clock (microseconds since the epoch)
    via the stream's ``clock_sync`` anchors.  Two invariants carried
    over from the post-hoc loaders:

    * a torn final line (the writer was mid-``write`` — or SIGKILLed —
      when we read) is buffered, not parsed; it is delivered intact on
      the poll after its newline lands;
    * events read BEFORE the stream's first anchor are held and
      released retroactively aligned once the anchor arrives — a tail
      must never hand out a raw-track timestamp that a later merge
      would place seconds away.
    """

    def __init__(self, path):
        self.path = Path(path)
        self.pid: Optional[int] = None
        self.process_name: Optional[str] = None
        self._pos = 0
        self._buf = b""
        self._anchors: list = []   # [(track_ts_us, wall_us)] sorted
        self._held: list = []      # events predating the first anchor

    def _read_lines(self) -> list:
        try:
            with open(self.path, "rb") as f:
                f.seek(self._pos)
                chunk = f.read()
        except OSError:
            return []
        if not chunk:
            return []
        self._pos += len(chunk)
        data = self._buf + chunk
        head, sep, tail = data.rpartition(b"\n")
        self._buf = tail  # torn tail: kept until its newline arrives
        if not sep:
            return []
        out = []
        for ln in head.split(b"\n"):
            if not ln.strip():
                continue
            try:
                out.append(json.loads(ln))
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue  # a corrupt interior line loses one event,
                # never the stream
        return out

    def poll(self) -> list:
        """New wall-aligned events since the last poll (possibly [])."""
        fresh = self._read_lines()
        out: list = []
        for ev in fresh:
            if self.pid is None and "pid" in ev:
                self.pid = ev.get("pid")
            if ev.get("ph") == "M":
                name = ev.get("name")
                if name == "process_name":
                    self.process_name = (ev.get("args") or {}).get("name")
                    continue  # pure metadata, no timeline position
                if name == "clock_sync":
                    wall_ns = (ev.get("args") or {}).get("wall_ns")
                    if wall_ns is not None:
                        first = not self._anchors
                        self._anchors.append((float(ev.get("ts", 0.0)),
                                              float(wall_ns) / 1000.0))
                        self._anchors.sort()
                        if first and self._held:
                            # the retroactive release: everything held
                            # realigns against the anchor that finally
                            # defined this stream's wall offset
                            held, self._held = self._held, []
                            out.extend(self._align(e) for e in held)
                    continue
            if not self._anchors:
                self._held.append(ev)
                continue
            out.append(self._align(ev))
        return out

    def _align(self, ev: dict) -> dict:
        ts = float(ev.get("ts", 0.0))
        ev["ts"] = ts + _offset_at(self._anchors, ts)
        return ev


class FleetTail:
    """Tail every process stream under one run directory as a fleet.

    New streams (a revived member, a takeover controller) are picked up
    on the poll after their file appears.  Colliding pids across
    streams (pid reuse between incarnations) are remapped exactly like
    :func:`~hetu_tpu_torch.telemetry.fleet.merge_streams` (+1e6 per
    collision) so per-process attribution survives the reuse.
    """

    def __init__(self, run_dir):
        self.run_dir = Path(run_dir)
        self._tails: dict = {}       # path -> StreamTail
        self._pid_map: dict = {}     # path -> final pid
        self._used_pids: set = set()
        self.processes: dict = {}    # final pid -> process name

    def poll(self) -> list:
        """All new events across the fleet, wall-aligned, ts-sorted."""
        for p in discover_streams(self.run_dir):
            if p not in self._tails:
                self._tails[p] = StreamTail(p)
        out: list = []
        for p, tail in self._tails.items():
            evs = tail.poll()
            if tail.pid is not None and p not in self._pid_map:
                new = tail.pid
                while new in self._used_pids:
                    new += 1_000_000
                self._used_pids.add(new)
                self._pid_map[p] = new
            final = self._pid_map.get(p)
            if final is not None:
                for ev in evs:
                    if "pid" in ev:
                        ev["pid"] = final
                self.processes[final] = tail.process_name \
                    or f"pid{tail.pid}"
            out.extend(evs)
        out.sort(key=lambda e: e.get("ts", 0.0))
        return out


def tail_streams(run_dir) -> FleetTail:
    """Follow every ``*.trace.jsonl`` stream under ``run_dir`` live;
    returns a :class:`FleetTail` whose :meth:`~FleetTail.poll` yields
    new wall-aligned events."""
    return FleetTail(run_dir)


# ---------------------------------------------------------------------------
# rolling windowed aggregates
# ---------------------------------------------------------------------------

def _quantile_from_counts(buckets, counts, q: float) -> Optional[float]:
    """Conservative quantile from raw bucket counts (upper bound of the
    winning bucket) — shared with the autoscaler's p99 reads."""
    total = sum(counts)
    if total <= 0:
        return None
    target = q * total
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= target:
            return float(buckets[i]) if i < len(buckets) \
                else float(buckets[-1])
    return float(buckets[-1])


class MetricWindows:
    """Rolling windows over cumulative registry dumps, per source.

    Feed it successive ``MetricsRegistry.dump()`` dicts — from
    ``fleet_metrics()`` (:meth:`ingest`), or straight off a stream tail
    (:meth:`ingest_events` extracts the ``hetu_metrics`` black-box
    records, one series per pid).  Queries answer over a trailing
    window: ``window_s=None`` means "since the previous sample" (the
    tick-delta the autoscaler always wanted); a number means "against
    the newest sample at or before now − window" (falling back to the
    oldest retained sample for young series — a counter born inside the
    window contributes everything it has ever counted).

    Counters and gauges SUM across sources (per-member gauges arrive
    pre-namespaced ``m<slot>.`` from the fleet merge, so a same-name
    gauge across sources is a level worth summing, e.g. raw
    ``queue_depth`` off member streams); histograms sum bucket-wise.
    """

    def __init__(self, horizon_s: float = 3900.0):
        self.horizon_s = float(horizon_s)
        self._series: dict = {}  # source -> deque[(t, dump)]

    def ingest(self, dump: dict, t: Optional[float] = None,
               source=None) -> None:
        t = time.time() if t is None else float(t)
        q = self._series.setdefault(source, deque())
        q.append((t, dump))
        while len(q) > 2 and q[0][0] < t - self.horizon_s:
            q.popleft()

    def ingest_events(self, events) -> None:
        """Pull every ``hetu_metrics`` black-box record out of a batch
        of (wall-aligned) tail events, one series per pid."""
        for ev in events:
            if ev.get("ph") == "M" and ev.get("name") == "hetu_metrics":
                dump = (ev.get("args") or {}).get("metrics")
                if dump:
                    self.ingest(dump, t=float(ev.get("ts", 0.0)) / 1e6,
                                source=ev.get("pid"))

    def sources(self) -> list:
        return list(self._series)

    def _pairs(self, window_s, source):
        """(latest, baseline) dump pairs per matching source."""
        keys = [source] if source is not None else list(self._series)
        for key in keys:
            q = self._series.get(key)
            if not q:
                continue
            t_new, new = q[-1]
            if window_s is None:
                base = q[-2][1] if len(q) >= 2 else {}
                t_base = q[-2][0] if len(q) >= 2 else t_new
            elif q[0][0] > t_new - float(window_s):
                # young series, fully inside the window: everything it
                # ever counted is recent
                t_base, base = q[0][0], {}
            else:
                # newest sample at or before the window cut
                cut = t_new - float(window_s)
                t_base, base = q[0]
                for t_i, d_i in q:
                    if t_i <= cut:
                        t_base, base = t_i, d_i
                    else:
                        break
            yield (t_new, new), (t_base, base)

    def value(self, name: str, source=None) -> Optional[float]:
        """Latest counter/gauge value, summed across sources."""
        total, seen = 0.0, False
        for (t_new, new), _ in self._pairs(None, source):
            rec = new.get(name)
            if rec is not None and "value" in rec:
                total += float(rec["value"])
                seen = True
        return total if seen else None

    def delta(self, name: str, window_s: Optional[float] = None,
              source=None) -> float:
        """Counter increase over the window (clamped ≥ 0 per source —
        a restarted incarnation's reset never reads as negative load)."""
        total = 0.0
        for (_, new), (_, base) in self._pairs(window_s, source):
            cur = float(new.get(name, {}).get("value", 0.0))
            prev = float(base.get(name, {}).get("value", 0.0))
            total += max(cur - prev, 0.0)
        return total

    def rate(self, name: str, window_s: float,
             source=None) -> float:
        """Counter increase per second over the window; young series
        divide by their real observed span, not the nominal window."""
        total, span = 0.0, 0.0
        for (t_new, new), (t_base, base) in self._pairs(window_s, source):
            cur = float(new.get(name, {}).get("value", 0.0))
            prev = float(base.get(name, {}).get("value", 0.0))
            total += max(cur - prev, 0.0)
            span = max(span, t_new - t_base)
        eff = min(float(window_s), span) if span > 0 else float(window_s)
        return total / max(eff, 1e-9)

    def hist_delta(self, name: str, window_s: Optional[float] = None,
                   source=None):
        """(buckets, counts-delta) over the window, summed bucket-wise
        across sources; ``None`` if no source carries the histogram."""
        buckets, counts = None, None
        for (_, new), (_, base) in self._pairs(window_s, source):
            rec = new.get(name)
            if rec is None or rec.get("type") != "histogram":
                continue
            cur = list(rec.get("counts", ()))
            prev = list(base.get(name, {}).get("counts", ()))
            if len(prev) != len(cur):
                prev = [0] * len(cur)
            d = [max(c - p, 0) for c, p in zip(cur, prev)]
            if buckets is None:
                buckets = list(rec.get("buckets", ()))
                counts = d
            elif len(d) == len(counts):
                counts = [a + b for a, b in zip(counts, d)]
        if buckets is None:
            return None
        return buckets, counts

    def quantile(self, name: str, q: float = 0.99,
                 window_s: Optional[float] = None,
                 source=None) -> Optional[float]:
        hd = self.hist_delta(name, window_s, source)
        if hd is None:
            return None
        return _quantile_from_counts(hd[0], hd[1], q)

    def frac_over(self, name: str, threshold: float,
                  window_s: Optional[float] = None,
                  source=None) -> Optional[float]:
        """Fraction of the window's histogram observations above
        ``threshold`` — the burn-rate numerator.  Bucket-resolution
        conservative: the bucket CONTAINING the threshold counts as
        over (an SLO sitting mid-bucket reads its whole bucket as
        breaching — alerts err toward paging, never toward silence)."""
        hd = self.hist_delta(name, window_s, source)
        if hd is None:
            return None
        buckets, counts = hd
        total = sum(counts)
        if total <= 0:
            return None
        over = 0
        for i, c in enumerate(counts):
            upper = buckets[i] if i < len(buckets) else float("inf")
            if upper > float(threshold):
                over += c
        return over / total


# ---------------------------------------------------------------------------
# declarative alert rules
# ---------------------------------------------------------------------------

@dataclass
class AlertRule:
    """One declarative health rule.

    ``expr`` is either a callable ``(MetricWindows) -> float|None`` or
    a string evaluated against a tiny windowed namespace —
    ``rate('requests_shed')``, ``delta('ctrl.links_degraded')``,
    ``value('fleet.members_alive')``, ``p99('tenant.gold.ttft_s')``,
    ``frac_over('ttft_s', 0.25)`` — each implicitly bound to this
    rule's ``window_s``.  The rule breaches when the expression exceeds
    ``threshold``; it FIRES after ``for_ticks`` consecutive breaching
    evaluations (the pending state Prometheus calls ``for:``).

    ``fault_kinds`` names the injected-fault kinds this alert is the
    natural symptom of — the doctor uses it to boost matching evidence
    when ranking root causes.
    """

    name: str
    expr: object = None
    threshold: float = 0.0
    window_s: float = 60.0
    severity: str = "warn"         # "warn" | "page"
    for_ticks: int = 1
    fault_kinds: tuple = ()
    labels: dict = field(default_factory=dict)

    def evaluate(self, win: MetricWindows) -> Optional[float]:
        if callable(self.expr):
            try:
                return self.expr(win)
            except Exception:
                return None
        w = self.window_s
        env = {
            "rate": lambda n, ww=w: win.rate(n, ww),
            "delta": lambda n, ww=w: win.delta(n, ww),
            "value": lambda n: win.value(n) or 0.0,
            "p99": lambda n, ww=w: win.quantile(n, 0.99, ww),
            "quantile": lambda n, q, ww=w: win.quantile(n, q, ww),
            "frac_over": lambda n, t, ww=w: win.frac_over(n, t, ww),
            "min": min, "max": max, "abs": abs,
        }
        try:
            v = eval(self.expr, {"__builtins__": {}}, env)  # noqa: S307
            # the namespace is closed: windowed readers + min/max/abs
        except Exception:
            return None
        return None if v is None else float(v)


@dataclass
class BurnRateRule(AlertRule):
    """Multi-window SLO burn rate for one tenant's TTFT budget.

    ``budget`` is the allowed breach fraction (0.01 = "99% of requests
    first-token within ``slo_s``"); burn rate = measured breach
    fraction / budget.  The rule's value is ``min(burn_short,
    burn_long)``, so it exceeds ``threshold`` (the burn factor — 14.4
    is the SRE fast-burn default: a 2%-of-monthly-budget hour) only
    when BOTH windows are burning."""

    tenant: str = ""
    metric: str = ""
    slo_s: float = 1.0
    budget: float = 0.01
    short_s: float = 300.0
    long_s: float = 3600.0

    def evaluate(self, win: MetricWindows) -> Optional[float]:
        fs = win.frac_over(self.metric, self.slo_s, self.short_s)
        fl = win.frac_over(self.metric, self.slo_s, self.long_s)
        if fs is None or fl is None:
            return None
        return min(fs, fl) / max(self.budget, 1e-9)


def slo_burn_rules(slo_classes: Optional[dict], *,
                   budget: float = 0.01, factor: float = 14.4,
                   windows: tuple = (300.0, 3600.0),
                   for_ticks: int = 1) -> list:
    """Compile the scheduler's ``slo_classes`` into fast-burn rules —
    one per tenant class that declares a ``ttft_slo_s`` (a class with
    ``None`` has no latency budget to burn).  ``windows`` is the
    (short, long) pair; scale it down for tests and benches whose whole
    run is shorter than five minutes."""
    from hetu_tpu_torch.serve.metrics import ServeMetrics
    rules = []
    short_s, long_s = float(windows[0]), float(windows[1])
    for tenant, spec in sorted((slo_classes or {}).items()):
        slo = (spec or {}).get("ttft_slo_s")
        if slo is None:
            continue
        slug = ServeMetrics._tenant_slug(tenant)
        rules.append(BurnRateRule(
            name=f"slo_burn.{slug}", threshold=float(factor),
            window_s=short_s, severity="page", for_ticks=int(for_ticks),
            fault_kinds=("netem_degrade", "netem_partition",
                         "member_kill"),
            labels={"tenant": str(tenant)},
            tenant=str(tenant), metric=f"tenant.{slug}.ttft_s",
            slo_s=float(slo), budget=float(budget),
            short_s=short_s, long_s=long_s))
    return rules


def default_fleet_rules(slo_classes: Optional[dict] = None, *,
                        burn_budget: float = 0.01,
                        burn_factor: float = 14.4,
                        burn_windows: tuple = (300.0, 3600.0),
                        window_s: float = 10.0,
                        shed_rate_high: float = 0.5) -> list:
    """The controller's stock rule set: per-tenant burn rates plus the
    structural symptoms every fleet fault presents with — a durable-tier
    failover (``ctrl.van.replica.failovers``), a link entering its
    degrade window (``ctrl.links_degraded``), requests parking with no
    routable member (``ctrl.requests_routing_deferred``), and a fleet
    shed-rate spike."""
    rules = slo_burn_rules(slo_classes, budget=burn_budget,
                           factor=burn_factor, windows=burn_windows)
    rules += [
        AlertRule("van_failover",
                  "delta('ctrl.van.replica.failovers')", 0.0,
                  window_s=window_s, severity="page",
                  fault_kinds=("van_kill",)),
        AlertRule("link_degraded", "delta('ctrl.links_degraded')", 0.0,
                  window_s=window_s, severity="warn",
                  fault_kinds=("netem_degrade", "netem_partition")),
        AlertRule("route_stall",
                  "delta('ctrl.requests_routing_deferred')", 0.0,
                  window_s=window_s, severity="warn",
                  fault_kinds=("van_kill", "member_kill")),
        AlertRule("shed_spike", "rate('requests_shed')",
                  float(shed_rate_high), window_s=window_s,
                  severity="warn",
                  fault_kinds=("netem_degrade", "member_kill")),
    ]
    return rules


# ---------------------------------------------------------------------------
# the fleet doctor
# ---------------------------------------------------------------------------

# organic evidence (no fault.* instant needed): span/instant name ->
# (imputed cause kind, base weight)
_ORGANIC_EVIDENCE = {
    "serve.link_degraded": ("netem_degrade", 2.0),
    "van.promote": ("van_kill", 2.0),
    "serve.failover": ("member_kill", 2.0),
    "serve.member_suspect": ("member_suspect", 1.5),
}


def _ev_member(ev: dict):
    a = ev.get("args") or {}
    for k in ("member", "slot", "van"):
        if k in a:
            return a[k]
    return None


def diagnose(events, *, alert=None, now_us: Optional[float] = None,
             lookback_s: float = 30.0) -> Optional[dict]:
    """Rank root-cause candidates for ``alert`` against the recent
    timeline.  ``events`` is a (wall-aligned) event list — typically the
    monitor's tail buffer.  Returns ``None`` when the window holds no
    evidence at all; otherwise ``{"alert", "verdicts", "top"}`` with
    verdicts scored by evidence class (an injected ``fault.*`` instant
    beats an organic recovery span beats a membership wobble beats a
    routing symptom), recency, and affinity to the alert's declared
    ``fault_kinds``."""
    if now_us is None:
        now_us = max((float(e.get("ts", 0.0)) for e in events),
                     default=0.0)
    cut = now_us - float(lookback_s) * 1e6
    recent = [e for e in events if float(e.get("ts", 0.0)) >= cut]
    want = tuple(getattr(alert, "fault_kinds", ()) or ()) \
        if alert is not None else ()
    cands = []
    for ev in recent:
        name = str(ev.get("name", ""))
        ts = float(ev.get("ts", 0.0))
        a = ev.get("args") or {}
        if name.startswith("fault."):
            kind = str(a.get("kind") or name[len("fault."):])
            # is the paired recovery already on the timeline?
            rec_names = RECOVERY_FOR.get(kind, ())
            answered = next(
                (r for r in recent
                 if r.get("name") in rec_names
                 and float(r.get("ts", 0.0)) >= ts), None)
            if answered is not None:
                dur = (float(answered.get("ts", 0.0))
                       + float(answered.get("dur", 0.0)) - ts) / 1e6
                ev_str = (f"{answered['name']} closed "
                          f"{max(dur, 0.0):.1f}s after injection")
            else:
                ev_str = "recovery still open"
            cands.append((3.0, kind, _ev_member(ev), ts,
                          f"fault.{kind} injected", ev_str))
        elif name in _ORGANIC_EVIDENCE:
            kind, w = _ORGANIC_EVIDENCE[name]
            dur = float(ev.get("dur", 0.0)) / 1e6
            ev_str = f"{name} open {dur:.1f}s" if dur else name
            cands.append((w, kind, _ev_member(ev), ts, name, ev_str))
        elif name == "membership.event":
            kind = str(a.get("kind", ""))
            if kind in ("suspect", "lost"):
                cands.append((1.5, f"member_{kind}", _ev_member(ev), ts,
                              name, f"member {_ev_member(ev)} {kind}"))
        elif name in ("route.park", "route.send_fail"):
            cands.append((1.0, "routing_stall", _ev_member(ev), ts,
                          name, name))
    if not cands:
        return None
    alert_name = getattr(alert, "name", None) or \
        (str(alert) if alert is not None else "?")
    verdicts = []
    for w, kind, member, ts, evidence, ev_str in cands:
        age_s = max((now_us - ts) / 1e6, 0.0)
        score = w * (4.0 if kind in want else 1.0) / (1.0 + age_s / 10.0)
        where = f" on member {member}" if member is not None else ""
        verdicts.append({
            "kind": kind, "member": member,
            "age_s": round(age_s, 3), "score": round(score, 4),
            "evidence": evidence,
            "text": f"{alert_name} ← {kind}{where} ← {ev_str}",
        })
    verdicts.sort(key=lambda v: -v["score"])
    # one verdict per cause kind: repeated route.park noise must not
    # crowd the actual fault out of the top ranks
    seen, ranked = set(), []
    for v in verdicts:
        if v["kind"] in seen:
            continue
        seen.add(v["kind"])
        ranked.append(v)
    return {"alert": alert_name, "verdicts": ranked[:5],
            "top": ranked[0]}


# ---------------------------------------------------------------------------
# the monitor loop
# ---------------------------------------------------------------------------

class HealthMonitor:
    """Evaluate alert rules on a cadence; emit alerts AS telemetry.

    Feeds :class:`MetricWindows` from ``source`` (a callable returning
    a ``fleet_metrics().dump()``-shaped dict — the controller wiring)
    and/or a :class:`FleetTail` (``tail`` — a run directory path is
    accepted and tailed).  Every state transition lands on the span
    stream as a ``health.alert`` instant (firing and resolved), every
    firing runs the doctor over the recent tail into a
    ``health.diagnosis`` instant, and the aggregate health gauges ride
    ``registry`` — pass the controller's own registry and the alerts
    surface in ``fleet_metrics()`` under ``ctrl.health.*``.
    """

    def __init__(self, rules, *, source: Optional[Callable] = None,
                 tail=None, interval_s: float = 0.5,
                 history_s: float = 120.0, registry=None,
                 clock: Callable[[], float] = time.time):
        self.rules = list(rules)
        self.source = source
        if tail is not None and not isinstance(tail, FleetTail):
            tail = tail_streams(tail)
        self.tail = tail
        self.interval_s = float(interval_s)
        self.history_s = float(history_s)
        self.registry = registry
        self.clock = clock
        self.windows = MetricWindows(
            horizon_s=max((r.window_s for r in self.rules),
                          default=60.0) * 1.5 + history_s)
        self.last_diagnosis: Optional[dict] = None
        self._recent: deque = deque()   # tail events for the doctor
        self._alerts: dict = {}         # rule name -> state dict
        self._thread = None
        self._stop = threading.Event()

    # ---- one evaluation round ----
    def tick(self, now: Optional[float] = None) -> dict:
        now = self.clock() if now is None else float(now)
        if self.tail is not None:
            evs = self.tail.poll()
            if evs:
                self._recent.extend(evs)
                self.windows.ingest_events(evs)
                cut = (now - self.history_s) * 1e6
                while self._recent and \
                        float(self._recent[0].get("ts", 0.0)) < cut:
                    self._recent.popleft()
        if self.source is not None:
            try:
                dump = self.source()
            except Exception:
                dump = None
            if dump:
                self.windows.ingest(dump, t=now)
        fired, resolved = [], []
        for rule in self.rules:
            v = rule.evaluate(self.windows)
            st = self._alerts.setdefault(
                rule.name, {"rule": rule, "state": "ok", "streak": 0,
                            "value": None, "since": None})
            breaching = v is not None and v > rule.threshold
            st["value"] = v
            if breaching:
                st["streak"] += 1
                if st["state"] != "firing" and \
                        st["streak"] >= rule.for_ticks:
                    st["state"], st["since"] = "firing", now
                    fired.append(rule.name)
                    self._emit_alert(rule, "firing", v, now)
                    self._run_doctor(rule, now)
            else:
                st["streak"] = 0
                if st["state"] == "firing":
                    st["state"] = "resolved"
                    resolved.append(rule.name)
                    self._emit_alert(rule, "resolved", v, now)
        if self.registry is not None:
            self.registry.gauge(
                "health.alerts_active",
                help="alert rules currently firing").set(
                float(len(self.active_alerts())))
        return {"t": now, "fired": fired, "resolved": resolved,
                "active": [a["rule"] for a in self.active_alerts()]}

    def _emit_alert(self, rule: AlertRule, state: str,
                    value: Optional[float], now: float) -> None:
        rec = {"rule": rule.name, "state": state,
               "severity": rule.severity,
               "threshold": rule.threshold,
               "window_s": rule.window_s, **rule.labels}
        if value is not None:
            rec["value"] = round(float(value), 4)
        trace.instant("health.alert", rec, cat="health")
        if self.registry is not None:
            self.registry.counter(
                f"health.alerts_{'fired' if state == 'firing' else 'resolved'}",
                help="alert state transitions").inc()

    def _run_doctor(self, rule: AlertRule, now: float) -> None:
        if not self._recent:
            return
        diag = diagnose(list(self._recent), alert=rule,
                        lookback_s=self.history_s)
        if diag is None:
            return
        self.last_diagnosis = diag
        trace.instant("health.diagnosis",
                      {"alert": rule.name, "top": diag["top"]["text"],
                       "kind": diag["top"]["kind"],
                       "verdicts": [v["text"]
                                    for v in diag["verdicts"]]},
                      cat="health")
        if self.registry is not None:
            self.registry.counter(
                "health.diagnoses",
                help="doctor verdicts emitted on alert firings").inc()

    def active_alerts(self) -> list:
        """Currently-firing alerts, page severity first."""
        out = []
        for name, st in self._alerts.items():
            if st["state"] != "firing":
                continue
            rule = st["rule"]
            out.append({"rule": name, "severity": rule.severity,
                        "value": st["value"],
                        "threshold": rule.threshold,
                        "since": st["since"],
                        "labels": dict(rule.labels),
                        "fault_kinds": tuple(rule.fault_kinds)})
        out.sort(key=lambda a: (a["severity"] != "page", a["rule"]))
        return out

    # ---- loop lifecycle ----
    def start(self) -> "HealthMonitor":
        if self._thread is not None:
            raise RuntimeError("health monitor already running")
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick()
                except Exception:
                    import traceback
                    traceback.print_exc()  # a failed tick must not
                    # kill the watcher — next scrape may succeed

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="health-monitor")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)


__all__ = [
    "StreamTail", "FleetTail", "tail_streams", "MetricWindows",
    "AlertRule", "BurnRateRule", "slo_burn_rules",
    "default_fleet_rules", "HealthMonitor", "diagnose",
]
