"""Fleet trace stitching: N per-process span streams → ONE Perfetto trace
(counterpart of ``hetu_tpu/telemetry/fleet.py``, copied whole).

Every process in a run (controller, serving members, elastic workers,
MPMD stages — see :func:`hetu_tpu_torch.telemetry.trace.open_process_stream`)
writes its own crash-durable JSONL span stream on its own
``perf_counter`` epoch.  This module is the other half of that contract:

* **clock alignment** — each stream carries ``clock_sync`` metadata
  events ((track-relative ts, wall-clock ns) pairs, re-anchored
  periodically); :func:`merge_streams` rebases every stream onto the
  wall clock using the nearest preceding anchor, then shifts the whole
  fleet so the earliest event sits at ts 0 — streams from processes
  born seconds apart line up to wall-clock accuracy;
* **trace stitching** — :func:`stitch_flows` turns the request id
  (serving ``rid``) that the controller and members both stamp into
  their span args into Chrome flow events (``ph`` s/t/f, one flow id
  per rid), so Perfetto draws the causal chain submit → route → member
  queue/prefill/decode → resolve ACROSS process tracks;
* **latency decomposition** — :func:`latency_breakdown` reads the same
  stitched spans back as numbers: per-rid queue wait / prefill /
  decode / wire seconds (wire = controller→member hand-off plus
  completion hop, the only parts not measured inside one process);
* **fault pairing fleet-wide** — the merged event list feeds
  :func:`hetu_tpu_torch.telemetry.timeline.correlate` unchanged, so a fault
  injected in the controller process pairs with a recovery span
  recorded in a member process.

This is the post-hoc half.  The LIVE half is
:func:`hetu_tpu_torch.telemetry.health.tail_streams`, which follows the same
streams incrementally with the same anchor alignment (exposed here as
:func:`anchors` / :func:`offset_at` so the tail and the merge can never
disagree about where an event sits on the wall clock).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

STREAM_SUFFIX = ".trace.jsonl"

# span names that carry a request id and form the per-rid causal chain,
# in causal order (controller submit -> member lifecycle -> controller
# resolve); route/queue detail rides as args on these
_FLOW_CHAIN = ("serve.submit", "serve.request", "serve.resolve")
_FLOW_CAT = "fleet.rid"


def discover_streams(run_dir) -> list:
    """Every ``*.trace.jsonl`` under ``run_dir`` (sorted for stable
    track order)."""
    return sorted(Path(run_dir).glob(f"*{STREAM_SUFFIX}"))


def _load_source(src) -> list:
    """One source → raw event list.  Accepts a stream/export path, a
    live :class:`~hetu_tpu_torch.telemetry.trace.Tracer`, or an event list.

    A ``.jsonl`` path goes straight to the line loader — probing it as
    one JSON document first would read every stream twice, and a
    crash-truncated stream of exactly ONE complete line would parse as
    a dict and be misread as an (empty) Chrome export, silently
    dropping the very black box the flight recorder exists for."""
    from hetu_tpu_torch.telemetry.trace import Tracer, load_jsonl
    if isinstance(src, Tracer):
        return [dict(e) for e in src.events]
    if isinstance(src, (list, tuple)):
        return [dict(e) for e in src]
    import json
    p = Path(src)
    if p.name.endswith(".jsonl"):
        return load_jsonl(p)
    try:
        doc = json.loads(p.read_text())
    except (json.JSONDecodeError, UnicodeDecodeError):
        return load_jsonl(p)
    if isinstance(doc, dict):
        return doc.get("traceEvents", [])
    return doc if isinstance(doc, list) else []


def _anchors(events) -> list:
    """[(track_ts_us, wall_us)] sorted by track ts."""
    out = []
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "clock_sync":
            wall_ns = (ev.get("args") or {}).get("wall_ns")
            if wall_ns is not None:
                out.append((float(ev.get("ts", 0.0)),
                            float(wall_ns) / 1000.0))
    out.sort()
    return out


def _offset_at(anchors, ts: float) -> float:
    """wall_us - track_us at the nearest anchor at-or-before ``ts``
    (the first anchor for events predating it) — re-anchoring means a
    late event is corrected by a late anchor, bounding drift."""
    off = anchors[0][1] - anchors[0][0]
    for a_ts, a_wall in anchors:
        if a_ts > ts:
            break
        off = a_wall - a_ts
    return off


# the streaming tail (telemetry/health.py) aligns events with exactly
# this machinery — public names so external followers can too
def anchors(events) -> list:
    """Public alias of the anchor extractor: ``[(track_ts_us,
    wall_us)]`` pairs from a stream's ``clock_sync`` records."""
    return _anchors(events)


def offset_at(anchor_list, ts: float) -> float:
    """Public alias of the per-event alignment offset (see
    :func:`_offset_at`)."""
    return _offset_at(anchor_list, ts)


def merge_streams(sources) -> tuple:
    """Align N streams onto one clock; returns ``(events, processes)``.

    ``sources``: a run directory (every ``*.trace.jsonl`` inside), or an
    iterable of stream paths / live Tracers / event lists.  Events come
    back ts-rebased (wall-aligned, fleet-min at 0), sorted, with
    ``processes`` mapping pid → process name.  A stream with no
    ``clock_sync`` anchor (foreign trace) keeps its raw timeline.
    Colliding pids across streams (pid reuse between incarnations) are
    remapped so every stream keeps its own Perfetto track.
    """
    if isinstance(sources, (str, Path)) and Path(sources).is_dir():
        sources = discover_streams(sources)
    merged: list = []
    processes: dict = {}
    used_pids: set = set()
    for src in sources:
        events = _load_source(src)
        if not events:
            continue
        anchors = _anchors(events)
        # one pid per stream: remap on collision so two incarnations
        # that recycled a pid don't interleave on one track
        pids = {e.get("pid") for e in events if "pid" in e}
        remap = {}
        for pid in pids:
            new = pid
            while new in used_pids:
                new += 1_000_000
            used_pids.add(new)
            if new != pid:
                remap[pid] = new
        name = None
        for ev in events:
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                name = (ev.get("args") or {}).get("name")
                break
        for ev in events:
            ev = dict(ev)
            if remap:
                ev["pid"] = remap.get(ev.get("pid"), ev.get("pid"))
            if anchors and ev.get("name") != "process_name":
                ts = float(ev.get("ts", 0.0))
                ev["ts"] = ts + _offset_at(anchors, ts)
            merged.append(ev)
        for pid in pids:
            processes[remap.get(pid, pid)] = name or f"pid{pid}"
    # rebase the fleet so the earliest REAL event is ts 0 (keeps Perfetto
    # timestamps readable; metadata events keep ts 0 semantics anyway)
    real = [e for e in merged if e.get("ph") != "M"]
    if real:
        t0 = min(float(e.get("ts", 0.0)) for e in real)
        for ev in merged:
            if ev.get("name") != "process_name":
                ev["ts"] = float(ev.get("ts", 0.0)) - t0
    merged.sort(key=lambda e: (float(e.get("ts", 0.0)),
                               e.get("pid", 0), e.get("seq", 0)))
    return merged, processes


def _rid_chains(events) -> dict:
    """rid → its causal-chain spans, ordered: submit spans, then member
    request spans (ts order — a failover shows as several), then
    resolve spans."""
    by_rid: dict = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        name = ev.get("name")
        if name not in _FLOW_CHAIN:
            continue
        rid = (ev.get("args") or {}).get("rid")
        if rid is None:
            continue
        by_rid.setdefault(int(rid), {n: [] for n in _FLOW_CHAIN}
                          )[name].append(ev)
    chains = {}
    for rid, groups in by_rid.items():
        chain = []
        for name in _FLOW_CHAIN:
            chain.extend(sorted(groups[name],
                                key=lambda e: float(e.get("ts", 0.0))))
        if len(chain) >= 2:
            chains[rid] = chain
    return chains


def stitch_flows(events) -> list:
    """Chrome flow events (``ph`` s/t/f, id = rid) linking each rid's
    causal chain across process tracks.  Returns ONLY the new flow
    events; append them to the merged list for export."""
    flows = []
    for rid, chain in sorted(_rid_chains(events).items()):
        for i, ev in enumerate(chain):
            ph = "s" if i == 0 else ("f" if i == len(chain) - 1 else "t")
            f = {"ph": ph, "cat": _FLOW_CAT, "name": "rid", "id": rid,
                 # bound INSIDE the slice (ts is within [ts, ts+dur]),
                 # which is what lets Perfetto attach the arrow to it
                 "ts": float(ev.get("ts", 0.0)),
                 "pid": ev.get("pid", 0), "tid": ev.get("tid", 0)}
            if ph == "f":
                f["bp"] = "e"
            flows.append(f)
    return flows


def cross_process_flow_rids(events) -> set:
    """rids whose causal chain crosses a process boundary (≥1 flow hop
    with distinct pids) — the acceptance-criterion count."""
    out = set()
    for rid, chain in _rid_chains(events).items():
        if len({e.get("pid") for e in chain}) >= 2:
            out.add(rid)
    return out


def latency_breakdown(events) -> dict:
    """Per-rid latency decomposition (seconds)::

        {rid: {queue_s, prefill_s, decode_s, wire_s, total_s,
               status, tenant, hops, member_pids}}

    queue/prefill/decode come from the member-side ``serve.request``
    span args (measured inside the owning process); ``wire_s`` is what
    only the MERGED clock can see — submit→member hand-off plus the
    member-end→resolve completion hop.  ``hops`` counts member request
    spans (>1 = the rid survived a failover/migration)."""
    out = {}
    for rid, chain in sorted(_rid_chains(events).items()):
        submit = next((e for e in chain
                       if e["name"] == "serve.submit"), None)
        reqs = [e for e in chain if e["name"] == "serve.request"]
        resolve = next((e for e in reversed(chain)
                        if e["name"] == "serve.resolve"), None)
        if not reqs:
            continue
        last = reqs[-1]
        args = last.get("args") or {}
        row = {"queue_s": args.get("queue_s"),
               "prefill_s": args.get("prefill_s"),
               "decode_s": args.get("decode_s"),
               "status": args.get("status"),
               "tenant": args.get("tenant"),
               "hops": len(reqs),
               "member_pids": sorted({e.get("pid") for e in reqs})}
        wire = None
        if submit is not None:
            wire = max(float(reqs[0]["ts"]) - float(submit["ts"]),
                       0.0) / 1e6
            if resolve is not None:
                last_end = float(last["ts"]) + float(last.get("dur", 0.0))
                wire += max(float(resolve["ts"]) - last_end, 0.0) / 1e6
                end = float(resolve["ts"]) + float(resolve.get("dur", 0.0))
                row["total_s"] = max(end - float(submit["ts"]), 0.0) / 1e6
        row["wire_s"] = wire
        out[rid] = row
    return out


def chrome_trace_from(events, processes) -> dict:
    """Perfetto-loadable trace from an ALREADY-merged event list:
    stitched per-rid flows appended, one track per process.  Use when
    the merge already happened (a report built the events) — re-merging
    from disk would double the I/O for nothing."""
    evs = list(events) + stitch_flows(events)
    evs.sort(key=lambda e: (float(e.get("ts", 0.0)),
                            e.get("pid", 0), e.get("seq", 0)))
    return {"traceEvents": evs, "displayTimeUnit": "ms",
            "metadata": {"processes": {str(k): v
                                       for k, v in processes.items()}}}


def merged_chrome_trace(sources) -> dict:
    """One Perfetto-loadable trace over every source: aligned events +
    stitched per-rid flows, one track per process."""
    events, processes = merge_streams(sources)
    return chrome_trace_from(events, processes)


def write_merged(sources, path) -> str:
    import json
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(merged_chrome_trace(sources)))
    return str(p)


def stream_metric_dumps(source) -> list:
    """Every ``hetu_metrics`` black-box record in a stream (oldest
    first) — the killed member's last scraped registry lives here."""
    return [(e.get("args") or {}).get("metrics", {})
            for e in _load_source(source)
            if e.get("ph") == "M" and e.get("name") == "hetu_metrics"]


def merge_registry_dumps(dumps, *, registry=None):
    """Fold registry dumps (``MetricsRegistry.dump()`` dicts) into one
    fleet registry: counters sum, gauges last-write, histograms
    bucket-wise."""
    from hetu_tpu_torch.telemetry.registry import MetricsRegistry
    reg = registry if registry is not None else MetricsRegistry()
    for d in dumps:
        reg.merge(d)
    return reg
