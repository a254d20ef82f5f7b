"""Chaos correlation: pair fault-injection instants with recovery spans
(counterpart of ``hetu_tpu/telemetry/timeline.py``, copied whole).

Faults are injectable and REPLAYABLE (seeded
:class:`~hetu_tpu_torch.resilience.faults.FaultSchedule`); this module makes
the recoveries MEASURABLE.  Every injected fault leaves an instant event
``fault.<kind>`` in the trace (args: step, kind, arg, schedule); every
recovery mechanism leaves a span (``recovery.shard_repair``,
``recovery.retry``, ``recovery.nonfinite_skip``, ``elastic.reshard``,
``supervisor.checkpoint``, ``serve.migrate``, ``serve.failover``).  :func:`correlate` pairs them, and
:func:`recovery_histograms` folds the pairs into per-fault-kind
detection/recovery latency histograms — a chaos run's output becomes a
recovery SLO, not a pass/fail bit.

Latency definitions (per pair):

* ``detect_s``  — fault injection → recovery span START (how long the
  fault went unnoticed);
* ``recover_s`` — fault injection → recovery span END (total time to
  repaired).

Pairing is time-first: each fault claims the earliest-ending unclaimed
recovery carrying any of its :data:`RECOVERY_FOR` names whose END is
at-or-after the injection instant (a ``suspend_shard`` answered by a
quick ``recovery.retry`` must not steal an unrelated later
``recovery.shard_repair``).  Kinds in :data:`PREFERENCE_ORDERED` are the
exception — their name tuple is a strict preference, earlier names
exhausted before later ones are considered (a ``serve_preempt`` prefers
its ``serve.migrate`` drain even when an unrelated ``serve.failover``
happened to end first, because the migrate IS the recovery the
preemption directly invokes and the failover only its fallback).
Either way several faults may share ONE recovery event when no
unclaimed one exists (an elastic loss+join drained in the same step is
repaired by one reshard), and a recovery attempt that itself FAILED
(the tracer tags aborted spans ``args.error``) is never a candidate —
it repaired nothing.  Faults whose kind needs no recovery (``van_delay``
just sleeps) pair with nothing by design.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

FAULT_PREFIX = "fault."

# fault kind -> recovery event names that can close it.  By default any
# listed name is an equally valid recovery and the earliest-ending
# candidate wins; kinds in PREFERENCE_ORDERED treat the tuple as strict
# preference instead.
RECOVERY_FOR = {
    # a killed PS shard is answered by the guard's repair (training) or,
    # on the online-serving side, by the serving cache's degraded-stale
    # window (serve/recsys.py: serve stale from cache until pulls succeed
    # again) — whichever actually ran ends the outage, so time decides
    "kill_shard": ("recovery.shard_repair", "serve.recsys_degrade"),
    "suspend_shard": ("recovery.shard_repair", "recovery.retry",
                      "serve.recsys_degrade"),
    "van_error": ("recovery.retry",),
    "data_error": ("recovery.retry",),
    "nan_grad": ("recovery.nonfinite_skip",),
    "preempt": ("supervisor.checkpoint",),
    "worker_loss": ("elastic.reshard",),
    "worker_join": ("elastic.reshard",),
    "van_delay": (),  # a delay needs no recovery — unpaired by design
    # serving pool (serve/pool.py): a planned preemption is answered by
    # the live-migration drain (or, if the member was too broken to
    # export, the fold/re-prefill failover); an engine kill only ever by
    # the failover
    "serve_preempt": ("serve.migrate", "serve.failover"),
    "serve_engine_kill": ("serve.failover",),
    # cross-process pool (serve/crosshost.py): a SIGKILLed member
    # PROCESS is only ever answered by the lease-expiry failover; a
    # SIGSTOPped one is answered by the retroactive suspect window when
    # the partition heals (the member was never lost), falling back to
    # the failover only when the suspension outlasts the suspect grace
    "member_kill": ("serve.failover",),
    "member_suspend": ("serve.member_suspect", "serve.failover"),
    # multi-controller training (resilience/multicontroller.py): worker
    # PROCESS death → lease expiry → published shrink epoch; the span
    # ends when every survivor acked the new width
    "worker_proc_kill": ("elastic.reshard",),
    # network plane (ps/netem.py): a one-way partition that heals is
    # answered by the retroactive suspect window (the member was never
    # lost); one that outlasts the grace falls back to the failover —
    # structurally identical to member_suspend, which is the partition
    # LOOKALIKE this kind makes real
    "netem_partition": ("serve.member_suspect", "serve.failover"),
    # a gray link (loss/latency/bandwidth cliff) is answered by the
    # routing penalty window: the controller marks the link degraded on
    # measured RTT and closes the span when the RTT recovers
    "netem_degrade": ("serve.link_degraded",),
    # an injected slow link on a training worker is answered by the
    # straggler window (detection → policy applied or slowness gone);
    # under the evict policy the reshard is the fallback recovery
    "straggler": ("train.straggler", "elastic.reshard"),
    # MPMD pipeline (parallel/mpmd_elastic.py): a SIGKILLed stage
    # process is only ever answered by the stage-replacement epoch (the
    # span ends when every stage acked the exact resume); a slow stage
    # by the straggler window, falling back to a replacement only if
    # the slowness degenerated into a lease expiry
    "stage_kill": ("pipeline.stage_replace",),
    "stage_slow": ("train.straggler", "pipeline.stage_replace"),
    # control plane (ps/membership controller lease): a killed OR
    # suspended-past-takeover controller is answered by the fenced
    # takeover — a new incarnation claims the controller row, adopts
    # the fleet from blackboard + ledger, and republishes the frozen
    # epoch; the span ends when the hand-off (re-adoption, drain
    # aborts, re-routes / exact resume) is complete
    "controller_kill": ("ctrl.takeover",),
    "controller_suspend": ("ctrl.takeover",),
    # durable tier (ps/replica.py): a killed primary van is answered by
    # the backup's promotion (epoch-row CAS; the span runs from the
    # first failed-op detection to adoption).  A suspended van is
    # answered the same way — and when the suspension is shorter than
    # the promote grace, no promotion happens and the fault is
    # legitimately unpaired (the ops just retried through it).
    "van_kill": ("van.promote",),
    "van_suspend": ("van.promote",),
    # sequential campaign (second-fault chaos): killing the promoted
    # primary AFTER a re-silver is directly answered by the NEXT
    # promotion (the re-silvered backup takes over); the re-silver that
    # restores redundancy afterwards is the fallback closer when the
    # promote span is missing from a partial trace.  Preference-ordered:
    # the promotion IS the recovery the kill invokes, the resilver only
    # its consequence.
    "van_resilver_kill": ("van.promote", "van.resilver"),
    # a controller killed mid-van-failover is answered by the fenced
    # takeover, same as any controller death — the van pair's own
    # recovery runs concurrently and pairs with the VAN fault
    "controller_kill_mid_failover": ("ctrl.takeover",),
    # a member killed mid-resilver is answered by the pool's
    # lease-expiry failover, same as member_kill
    "member_kill_mid_resilver": ("serve.failover",),
}

# kinds whose RECOVERY_FOR tuple is a strict preference order: the first
# name is the recovery the fault DIRECTLY invokes, later names only
# fallbacks.  For every other multi-name kind any listed name can be the
# real recovery (a suspend_shard is repaired by whichever of
# shard_repair/retry actually ran), so time decides, not the tuple.
PREFERENCE_ORDERED = frozenset({"serve_preempt", "member_suspend",
                                "netem_partition", "straggler",
                                "stage_slow", "van_resilver_kill"})

# fault kind -> args a candidate recovery event must carry.  A preempt
# must claim the checkpoint the SIGTERM caused (reason="preempt"), not a
# cadence checkpoint that happened to land on the same step first.
RECOVERY_ATTRS = {
    "preempt": {"reason": "preempt"},
}


@dataclass
class FaultPair:
    """One injected fault and the recovery that answered it (or None)."""

    kind: str
    fault_ts_us: float
    step: int
    args: dict
    recovery_name: Optional[str] = None
    recovery_start_us: Optional[float] = None
    recovery_end_us: Optional[float] = None
    # pid of the process whose stream recorded the recovery — on a
    # MERGED fleet trace (telemetry.fleet.merge_streams) this is how a
    # test proves a controller-injected fault was answered by a span
    # recorded in a MEMBER process
    recovery_pid: Optional[int] = None

    @property
    def paired(self) -> bool:
        return self.recovery_name is not None

    @property
    def detect_s(self) -> Optional[float]:
        if not self.paired:
            return None
        return max(self.recovery_start_us - self.fault_ts_us, 0.0) / 1e6

    @property
    def recover_s(self) -> Optional[float]:
        if not self.paired:
            return None
        return max(self.recovery_end_us - self.fault_ts_us, 0.0) / 1e6


def _end_ts(ev: dict) -> float:
    return float(ev.get("ts", 0.0)) + float(ev.get("dur", 0.0))


def correlate(events) -> list:
    """``events``: Chrome-trace event dicts (``Tracer.events``,
    :func:`~hetu_tpu_torch.telemetry.trace.load_jsonl`, a loaded
    ``traceEvents`` list, or a clock-aligned MERGED fleet stream from
    :func:`hetu_tpu_torch.telemetry.fleet.merge_streams` — pairing is
    time-first, so a fault instant recorded in the controller's stream
    claims a recovery span recorded in a member's).  Returns one
    :class:`FaultPair` per ``fault.*`` instant, in injection order."""
    faults = []
    recoveries = []
    recovery_names = {n for names in RECOVERY_FOR.values() for n in names}
    for ev in events:
        name = ev.get("name", "")
        if name.startswith(FAULT_PREFIX):
            faults.append(ev)
        elif name in recovery_names:
            recoveries.append(ev)
    faults.sort(key=lambda e: (float(e.get("ts", 0.0)),
                               e.get("seq", 0)))
    recoveries.sort(key=lambda e: (_end_ts(e), e.get("seq", 0)))

    claimed: set = set()
    pairs = []
    for f in faults:
        args = dict(f.get("args") or {})
        kind = args.get("kind") or f["name"][len(FAULT_PREFIX):]
        ts = float(f.get("ts", 0.0))
        pair = FaultPair(kind=kind, fault_ts_us=ts,
                         step=int(args.get("step", -1)), args=args)
        want = RECOVERY_FOR.get(kind, ())
        need_attrs = RECOVERY_ATTRS.get(kind, {})
        best = None
        fallback = None  # already-claimed candidate (shared recovery)
        # recoveries are end-time sorted, so the first unclaimed hit in
        # a group is the earliest-ending one; preference-ordered kinds
        # scan singleton groups in tuple order, everyone else one group
        # spanning all names (earliest end across names wins)
        groups = [(n,) for n in want] \
            if kind in PREFERENCE_ORDERED else ([want] if want else [])
        for group in groups:
            for i, r in enumerate(recoveries):
                if r.get("name") not in group or _end_ts(r) < ts:
                    continue
                rargs = r.get("args") or {}
                if rargs.get("error"):
                    # a recovery attempt that itself FAILED (the tracer
                    # tags aborted spans args.error) repaired nothing —
                    # pairing with it would report e.g. a rolled-back
                    # migrate as the preemption's recovery and hide the
                    # real failover (or the fault going unrecovered)
                    continue
                if need_attrs:
                    if any(rargs.get(k) != v
                           for k, v in need_attrs.items()):
                        continue
                if i in claimed:
                    if fallback is None:
                        fallback = (i, r)
                    continue
                best = (i, r)
                break
            if best is not None:
                break
        if best is None and fallback is not None:
            # e.g. one reshard answering a same-step loss+join batch
            best = fallback
        if best is not None:
            i, r = best
            claimed.add(i)
            pair.recovery_name = r["name"]
            pair.recovery_start_us = float(r.get("ts", 0.0))
            pair.recovery_end_us = _end_ts(r)
            pair.recovery_pid = r.get("pid")
        pairs.append(pair)
    return pairs


def recovery_histograms(pairs, registry=None, *, buckets=None):
    """Fold pairs into per-kind detection/recovery latency histograms:
    ``recovery.<kind>.detect_s`` and ``recovery.<kind>.recover_s`` in
    ``registry`` (a fresh one when None).  Returns the registry."""
    from hetu_tpu_torch.telemetry.registry import (
        DEFAULT_LATENCY_BUCKETS, MetricsRegistry,
    )
    reg = registry if registry is not None else MetricsRegistry()
    buckets = buckets or DEFAULT_LATENCY_BUCKETS
    for p in pairs:
        if not p.paired:
            reg.counter(f"recovery.{p.kind}.unpaired").inc()
            continue
        reg.histogram(f"recovery.{p.kind}.detect_s",
                      buckets).observe(p.detect_s)
        reg.histogram(f"recovery.{p.kind}.recover_s",
                      buckets).observe(p.recover_s)
    return reg


def report(pairs) -> dict:
    """Per-fault-kind summary: counts, pairing rate, detect/recover
    percentiles.  Accepts
    either :func:`correlate` pairs or a raw event list (including a
    merged fleet stream), which it correlates first."""
    pairs = list(pairs)
    if pairs and isinstance(pairs[0], dict):
        pairs = correlate(pairs)
    reg = recovery_histograms(pairs)
    by_kind: dict = {}
    for p in pairs:
        d = by_kind.setdefault(p.kind, {"injected": 0, "paired": 0})
        d["injected"] += 1
        d["paired"] += int(p.paired)
    out = {}
    for kind, d in sorted(by_kind.items()):
        row = dict(d)
        for which in ("detect_s", "recover_s"):
            h = reg.metrics().get(f"recovery.{kind}.{which}")
            if h is not None and h.count:
                row[which] = {"p50": h.percentile(0.5),
                              "p90": h.percentile(0.9),
                              "p99": h.percentile(0.99),
                              "max": h.snapshot()["max"]}
        out[kind] = row
    return out
