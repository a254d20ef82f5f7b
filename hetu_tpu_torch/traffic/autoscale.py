"""Measured-load autoscaler over a cross-process serving pool
(counterpart of ``hetu_tpu/traffic/autoscale.py``; host Python).

The pool already has every primitive elasticity needs — a spawn harness
that brings a member up on a parked slot (``revive_member``), a
zero-re-prefill drain that hands a member's live KV to a peer before
the process exits (``drain_member(close=True)``), and a fleet-wide
metrics merge (``fleet_metrics``).  What it lacks is the loop that
connects them to MEASURED load.  :class:`Autoscaler` is that loop: each
tick it scrapes the fleet registry and reads three signals —

* **queue depth** — mean of the per-member ``m<slot>.queue_depth``
  gauges over the active set (level, not rate: the backlog that exists
  right now);
* **shed rate** — windowed ``requests_shed`` / ``requests_submitted``
  counter deltas between this tick and the last (cumulative fleet
  counters diff cleanly because dead incarnations stay folded into the
  merge — the pool's retired-incarnation accumulator this loop leans
  on);
* **SLO breach** — when a :class:`~hetu_tpu_torch.telemetry.health.
  HealthMonitor` is wired (``monitor=`` or the pool's own
  ``health_monitor``), the trigger is its multi-window BURN-RATE
  alerts: a tenant-labelled alert firing (e.g. ``slo_burn.gold``)
  votes scale-up, so the loop shares one alerting definition with
  dashboards and pagers instead of a private threshold.  Without a
  monitor, the legacy fallback compares the windowed per-tenant TTFT
  p99 from ``tenant.<slug>.ttft_s`` histogram bucket deltas against
  each tenant's declared budget (``ttft_slos``) —

and votes scale-up / scale-down / hold.  Votes become actions only
through hysteresis (``up_ticks``/``down_ticks`` consecutive agreeing
ticks) and per-direction cooldowns, with hard ``min_members``/
``max_members`` bounds: a control loop over a noisy sensor must be
deliberately harder to move than the load it measures, or it oscillates
and every oscillation is a drain.

Every decision (including holds that broke a streak) lands in
``decisions`` and actions emit a ``traffic.scale`` span with the
signals that justified them — the fleet trace shows WHY the fleet
resized, not just that it did.

The loop's RAM is journaled: after every tick the streaks, cooldown
elapsed times (relative — monotonic clocks do not compare across
processes), and active-set bookkeeping export into the pool's
``DeltaLedger`` alongside accepts (synchronously on action ticks,
coalesced on holds), and a controller takeover resumes the loop WARM —
a successor constructed over a taken-over pool adopts the journaled
state instead of re-deriving streaks from zero, so it neither repeats
a just-landed scale action nor forgets a cooldown mid-window.

Departure from the reference: a scale-down's ``traffic.scale`` span
carries its reason (``idle``) as a scale-up's does, so every action on
the fleet timeline names why it was taken.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from hetu_tpu_torch.serve.metrics import ServeMetrics
from hetu_tpu_torch.telemetry import trace
from hetu_tpu_torch.telemetry.health import (MetricWindows,
                                             _quantile_from_counts)

_tenant_slug = ServeMetrics._tenant_slug  # same sanitization both ways:
# the slug this loop reads MUST be the slug the scheduler wrote


@dataclass
class AutoscalePolicy:
    """Knobs for :class:`Autoscaler` — thresholds are in signal units
    (queue depth in requests/member, shed rate as a fraction of the
    window's submits)."""

    min_members: int = 1
    max_members: int = 4
    interval_s: float = 1.0
    # scale-up triggers (ANY of them, up_ticks consecutive ticks)
    queue_high: float = 4.0
    shed_high: float = 0.02
    # scale-down requires ALL low-watermarks, down_ticks consecutive
    # ticks (down is deliberately slower than up: adding capacity late
    # costs latency, removing it early costs a drain AND latency)
    queue_low: float = 0.5
    shed_low: float = 0.001
    up_ticks: int = 2
    down_ticks: int = 5
    up_cooldown_s: float = 3.0
    down_cooldown_s: float = 6.0


@dataclass
class _Signals:
    queue_depth: float = 0.0
    shed_rate: float = 0.0
    submitted_delta: int = 0
    shed_delta: int = 0
    slo_breaches: dict = field(default_factory=dict)  # tenant -> p99/burn
    burn_driven: bool = False  # breaches came from a HealthMonitor
    # burn-rate alert, not the legacy hand-coded p99 threshold


def _p99_from_counts(buckets, counts, q: float = 0.99) -> Optional[float]:
    """Conservative quantile from raw bucket counts — the shared
    implementation lives with the windowing library now
    (:func:`hetu_tpu_torch.telemetry.health._quantile_from_counts`);
    this name stays for callers of the reference's surface."""
    return _quantile_from_counts(buckets, counts, q)


class Autoscaler:
    """Scale ``pool`` between ``policy.min_members`` and
    ``policy.max_members`` from measured load.

    ``pool`` needs the :class:`~hetu_tpu_torch.serve.crosshost.
    CrossProcessServingPool` surface this loop touches:
    ``fleet_metrics(scrape=...)`` → registry with ``.dump()``,
    ``revive_member(slot)``, ``drain_member(slot, close=True)``,
    ``n_members`` — a fake with those four is a fine unit-test double.

    ``ttft_slos`` maps tenant name → TTFT p99 budget in seconds; a
    tenant's windowed p99 over budget votes scale-up.  ``monitor``
    (or, lazily, the pool's ``health_monitor`` attribute) replaces
    that hand-coded threshold with the monitor's tenant-labelled
    burn-rate alerts.  ``clock`` is injectable for deterministic
    tests.
    """

    def __init__(self, pool, policy: AutoscalePolicy, *,
                 ttft_slos: Optional[dict] = None,
                 active: Optional[set] = None,
                 clock: Callable[[], float] = time.monotonic,
                 state: Optional[dict] = None,
                 journal=None, monitor=None):
        if policy.min_members < 1:
            raise ValueError("min_members must be >= 1")
        if policy.max_members < policy.min_members:
            raise ValueError("max_members must be >= min_members")
        if policy.max_members > int(pool.n_members):
            raise ValueError(
                f"max_members {policy.max_members} exceeds the pool's "
                f"slot count {pool.n_members} — the pool is constructed "
                f"at max geometry and scaling parks/revives slots")
        self.pool = pool
        self.policy = policy
        self.ttft_slos = dict(ttft_slos or {})
        self.clock = clock
        # the slots this loop believes are serving; everything else is
        # parked (drained-and-closed, or never started).  Own
        # bookkeeping, not a lease read: a drain's lease takes time to
        # lapse and the loop must not double-drain in that window.
        self.active = set(range(int(pool.n_members))) \
            if active is None else {int(s) for s in active}
        self.decisions: list = []     # every tick's verdict, in order
        self.monitor = monitor
        # one windowing implementation fleet-wide: the same
        # MetricWindows the HealthMonitor and dashboards read — with
        # window_s=None its baseline is the previous ingested sample,
        # which is exactly the old per-tick counter/hist delta
        self._windows = MetricWindows()
        self._up_streak = 0
        self._down_streak = 0
        self._last_up = -float("inf")
        self._last_down = -float("inf")
        self._actions_prior = 0  # predecessor incarnations' actions
        self._thread = None
        self._stop = threading.Event()
        # ---- warm takeover wiring ----
        # `journal` defaults to the pool's ledger hook; `state`
        # defaults to the pool's journaled record — present exactly
        # when the pool came from takeover() and the predecessor's
        # loop journaled at least one tick, so a successor over a
        # taken-over pool resumes WARM with no extra plumbing.
        self.journal = journal if journal is not None \
            else getattr(pool, "journal_autoscaler", None)
        if state is None and active is None:
            getter = getattr(pool, "autoscaler_state", None)
            if callable(getter):
                state = getter()
        if state:
            self.restore(state)

    # ---- warm takeover (journaled streaks / cooldowns / active set) ----
    def export_state(self) -> dict:
        """This loop's RAM as a journalable record.  Cooldown anchors
        export as ELAPSED seconds (monotonic clocks do not compare
        across processes); absent keys mean 'never fired'."""
        now = self.clock()
        st = {"active": sorted(self.active),
              "up_streak": int(self._up_streak),
              "down_streak": int(self._down_streak),
              "actions": self._actions_prior + self.scale_ups
              + self.scale_downs}
        if self._last_up != -float("inf"):
            st["up_elapsed_s"] = round(min(now - self._last_up, 1e6), 3)
        if self._last_down != -float("inf"):
            st["down_elapsed_s"] = round(
                min(now - self._last_down, 1e6), 3)
        return st

    def restore(self, state: dict) -> None:
        """Adopt a predecessor's exported state: the successor's first
        ticks honor the predecessor's cooldown windows and streaks —
        no immediate duplicate scale action after a takeover."""
        now = self.clock()
        if state.get("active") is not None:
            self.active = {int(s) for s in state["active"]}
        self._up_streak = int(state.get("up_streak", 0))
        self._down_streak = int(state.get("down_streak", 0))
        up_e = state.get("up_elapsed_s")
        down_e = state.get("down_elapsed_s")
        self._last_up = now - float(up_e) if up_e is not None \
            else -float("inf")
        self._last_down = now - float(down_e) if down_e is not None \
            else -float("inf")
        self._actions_prior = int(state.get("actions", 0))

    @property
    def actions_total(self) -> int:
        """Scale actions across ALL incarnations of this loop (journal
        lineage included)."""
        return self._actions_prior + self.scale_ups + self.scale_downs

    # ---- sensing ----
    def read_signals(self, dump: dict) -> _Signals:
        """One tick's view of the fleet from a ``fleet_metrics`` dump —
        split out so tests can feed canned dumps."""
        win = self._windows
        win.ingest(dump, t=self.clock(), source="fleet")
        sig = _Signals()
        depths = []
        for slot in self.active:
            rec = dump.get(f"m{slot}.queue_depth")
            if rec is not None:
                depths.append(float(rec.get("value", 0.0)))
        sig.queue_depth = sum(depths) / max(len(self.active), 1)
        # window_s=None → delta against the PREVIOUS ingested sample:
        # the since-last-tick semantics this loop has always used
        sig.submitted_delta = int(win.delta("requests_submitted"))
        sig.shed_delta = int(win.delta("requests_shed"))
        if sig.submitted_delta > 0:
            sig.shed_rate = sig.shed_delta / sig.submitted_delta
        mon = self.monitor if self.monitor is not None \
            else getattr(self.pool, "health_monitor", None)
        if mon is not None:
            # the shared alerting definition IS the trigger: any firing
            # tenant-labelled alert (slo_burn.<slug> from slo_classes)
            # votes scale-up with its burn factor as the magnitude
            sig.burn_driven = True
            for alert in mon.active_alerts():
                tenant = (alert.get("labels") or {}).get("tenant")
                if tenant:
                    sig.slo_breaches[tenant] = float(
                        alert.get("value") or 0.0)
        else:
            for tenant, budget in self.ttft_slos.items():
                name = f"tenant.{_tenant_slug(tenant)}.ttft_s"
                p99 = win.quantile(name, 0.99, None, "fleet")
                if p99 is not None and p99 > float(budget):
                    sig.slo_breaches[tenant] = p99
        return sig

    # ---- deciding / actuating ----
    def _parked(self) -> list:
        return sorted(set(range(int(self.pool.n_members))) - self.active)

    def _pick_victim(self, dump: dict) -> int:
        """Scale-down victim: the active slot with the shallowest queue
        (cheapest drain), highest slot id on ties (revive order then
        tends to repopulate low slots first — stable, boring)."""
        return max(self.active,
                   key=lambda s: (-float(
                       dump.get(f"m{s}.queue_depth", {}).get("value", 0.0)),
                       s))

    def tick(self) -> dict:
        """One sense → decide → (maybe) actuate round.  Returns the
        decision record (also appended to ``decisions``)."""
        pol = self.policy
        dump = self.pool.fleet_metrics(scrape=True).dump()
        sig = self.read_signals(dump)
        now = self.clock()
        overloaded = (sig.queue_depth >= pol.queue_high
                      or sig.shed_rate >= pol.shed_high
                      or bool(sig.slo_breaches))
        underloaded = (sig.queue_depth <= pol.queue_low
                       and sig.shed_rate <= pol.shed_low
                       and not sig.slo_breaches)
        self._up_streak = self._up_streak + 1 if overloaded else 0
        self._down_streak = self._down_streak + 1 if underloaded else 0
        rec = {"t": now, "action": "hold",
               "active": sorted(self.active),
               "queue_depth": round(sig.queue_depth, 3),
               "shed_rate": round(sig.shed_rate, 4),
               "slo_breaches": dict(sig.slo_breaches)}
        if overloaded and self._up_streak >= pol.up_ticks \
                and len(self.active) < pol.max_members \
                and now - self._last_up >= pol.up_cooldown_s \
                and self._parked():
            slot = self._parked()[0]
            rec.update(action="up", slot=slot,
                       reason=self._reason(sig, pol))
            with trace.span("traffic.scale", {
                    "action": "up", "slot": slot,
                    "queue_depth": rec["queue_depth"],
                    "shed_rate": rec["shed_rate"],
                    "reason": rec["reason"]}, cat="traffic"):
                try:
                    self.pool.revive_member(slot)
                    self.active.add(slot)
                    self._last_up = now
                    self._up_streak = 0
                    self._bump("autoscale_up")
                except Exception as e:
                    rec.update(action="up_failed", error=repr(e))
        elif underloaded and self._down_streak >= pol.down_ticks \
                and len(self.active) > pol.min_members \
                and now - self._last_down >= pol.down_cooldown_s \
                and now - self._last_up >= pol.down_cooldown_s:
            slot = self._pick_victim(dump)
            rec.update(action="down", slot=slot, reason="idle")
            with trace.span("traffic.scale", {
                    "action": "down", "slot": slot,
                    "queue_depth": rec["queue_depth"],
                    "shed_rate": rec["shed_rate"],
                    "reason": rec["reason"]}, cat="traffic"):
                try:
                    # zero-re-prefill: live KV migrates to a peer, the
                    # victim exits, no accepted request is lost
                    self.pool.drain_member(slot, close=True)
                    self.active.discard(slot)
                    self._last_down = now
                    self._down_streak = 0
                    self._bump("autoscale_down")
                except Exception as e:
                    rec.update(action="down_failed", error=repr(e))
        self.decisions.append(rec)
        if self.journal is not None:
            try:
                self.journal(self.export_state(),
                             sync=rec["action"] in ("up", "down"))
            except Exception:
                pass  # journaling is durability, not control: a
                # wedged ledger (mid van-failover) must not stall the
                # loop — the next tick re-exports the full state
        return rec

    @staticmethod
    def _reason(sig: _Signals, pol: AutoscalePolicy) -> str:
        if sig.slo_breaches:
            prefix = "slo_burn:" if sig.burn_driven else "slo_breach:"
            return prefix + ",".join(sorted(sig.slo_breaches))
        if sig.shed_rate >= pol.shed_high:
            return "shed_rate"
        return "queue_depth"

    def _bump(self, name: str) -> None:
        m = getattr(self.pool, "metrics", None)
        if m is not None and hasattr(m, "inc"):
            m.inc(name)

    # ---- loop lifecycle ----
    def start(self) -> "Autoscaler":
        if self._thread is not None:
            raise RuntimeError("autoscaler already running")
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.policy.interval_s):
                try:
                    self.tick()
                except Exception:
                    import traceback
                    traceback.print_exc()  # a failed tick must not
                    # kill the loop — the next scrape may succeed

        self._thread = threading.Thread(target=_loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)

    @property
    def scale_ups(self) -> int:
        return sum(1 for d in self.decisions if d["action"] == "up")

    @property
    def scale_downs(self) -> int:
        return sum(1 for d in self.decisions if d["action"] == "down")
