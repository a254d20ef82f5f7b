"""The port's fleet telemetry (``hetu_tpu_torch.telemetry``: trace streams,
``registry`` merge, ``timeline``, ``fleet``, ``costs``, ``health``)
against hetu_tpu's, on the CPU.

The same event lists, registries and stream files go through both
packages and give the same results: fault pairs and reports, merged
streams (clock alignment, pid remaps), flows, latency breakdowns, cost
tables, registry dumps and merges, tails, windows, alert rules and the
doctor's verdicts.  Mirrored: the tests of ``tests/test_telemetry.py``
(tracer and timeline parts), ``tests/test_fleet_obs.py`` and
``tests/test_health.py`` that are not slow, less those that need
``tools/``, ``traffic/``, ``ps/replica``, ``ps/membership``,
``serve/crosshost`` or ``resilience/shardproc`` (not ported yet).

Floats: times derived from the same microsecond inputs are compared
exactly between the packages (the same Python arithmetic); against hand
values within 1e-9 s, or within 2e-4 s where a span's length comes from
the host clock.
"""

import json
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

import hetu_tpu.telemetry as ref_tel
from hetu_tpu.telemetry import costs as ref_costs
from hetu_tpu.telemetry import fleet as ref_fleet
from hetu_tpu.telemetry import health as ref_health
from hetu_tpu.telemetry import timeline as ref_timeline
from hetu_tpu.telemetry.registry import MetricsRegistry as RefRegistry
from hetu_tpu_torch import telemetry
from hetu_tpu_torch.telemetry import costs, fleet, health, timeline, trace
from hetu_tpu_torch.telemetry.health import (
    AlertRule, HealthMonitor, MetricWindows, StreamTail, diagnose,
    slo_burn_rules, tail_streams,
)
from hetu_tpu_torch.telemetry.registry import MetricsRegistry
from hetu_tpu_torch.telemetry.trace import Tracer, load_jsonl

REPO = Path(__file__).resolve().parent.parent
TRACE_PY = REPO / "hetu_tpu_torch" / "telemetry" / "trace.py"


@pytest.fixture(autouse=True)
def _tracing_off():
    """Every test starts and ends with both packages' tracing off: a test
    that enables it must not leak a live tracer into the next test on
    the same worker."""
    telemetry.disable()
    ref_tel.disable()
    yield
    telemetry.disable()
    ref_tel.disable()


def _append(path, records):
    with open(path, "a") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def _anchor(ts, wall_us):
    return {"ph": "M", "name": "clock_sync", "ts": float(ts),
            "args": {"wall_ns": int(wall_us * 1000)}}


def _ctr(v):
    return {"type": "counter", "value": v}


def _hist(buckets, counts):
    return {"type": "histogram", "buckets": list(buckets),
            "counts": list(counts), "sum": 0.0, "count": sum(counts),
            "min": 0.0, "max": 0.0}


def _pairs(pairs):
    """A FaultPair list as plain tuples (the packages' dataclasses are
    different classes)."""
    return [(p.kind, p.fault_ts_us, p.step, p.args, p.recovery_name,
             p.recovery_start_us, p.recovery_end_us, p.recovery_pid,
             p.detect_s, p.recover_s) for p in pairs]


# ---------------------------------------------------------------- tracer

def test_disabled_span_is_the_noop_singleton():
    assert not telemetry.enabled()
    s1 = telemetry.span("anything")
    assert s1 is trace.NULL_SPAN and telemetry.span("else") is s1
    with s1 as s:
        s.set("k", "v")  # swallowed, no error
    telemetry.instant("nothing")
    telemetry.complete("nothing", 0.0)
    assert telemetry.now_us() == 0.0
    assert telemetry.get_tracer() is None


def test_enable_disable_roundtrip():
    t = telemetry.enable()
    assert telemetry.enabled() and telemetry.get_tracer() is t
    with telemetry.span("a"):
        pass
    got = telemetry.disable()
    assert got is t and not telemetry.enabled()
    assert any(e["name"] == "a" for e in t.events)
    # the reference's metadata: a clock anchor, then the process name
    assert [e["name"] for e in t.events[:2]] == ["clock_sync",
                                                 "process_name"]


def _sample_tracer():
    t = telemetry.enable()
    with telemetry.span("outer") as sp:
        sp.set("k", 1)
        with telemetry.span("inner"):
            pass
        telemetry.instant("mark", {"x": 2})
    with telemetry.span("second"):
        pass
    telemetry.disable()
    return t


def test_chrome_trace_schema_and_track_monotonicity():
    doc = _sample_tracer().chrome_trace()
    assert "traceEvents" in doc and doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    assert {"outer", "inner", "mark", "second"} <= {e["name"] for e in evs}
    for e in evs:
        assert e["ph"] in ("X", "i", "M")
        assert isinstance(e["ts"], (int, float)) and e["ts"] >= 0
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
        if e["ph"] == "X":
            assert e["dur"] >= 0
        if e["ph"] == "i":
            assert e["s"] in ("t", "p", "g")
    by_track = {}
    for e in evs:
        by_track.setdefault((e["pid"], e["tid"]), []).append(e["ts"])
    for ts in by_track.values():
        assert ts == sorted(ts)
    outer = next(e for e in evs if e["name"] == "outer")
    inner = next(e for e in evs if e["name"] == "inner")
    assert outer["tid"] == inner["tid"] and outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6
    assert outer["args"] == {"k": 1}
    json.loads(json.dumps(doc))
    # seq: a lock-ordered count over every event
    seqs = [e["seq"] for e in _sample_tracer().events]
    assert seqs == list(range(len(seqs)))


def test_span_records_exception_attr():
    t = telemetry.enable()
    with pytest.raises(ValueError):
        with telemetry.span("boom"):
            raise ValueError("x")
    telemetry.disable()
    ev = next(e for e in t.events if e["name"] == "boom")
    assert ev["args"]["error"] == "ValueError"


def test_jsonl_stream_appends_and_reloads_in_both_packages(tmp_path):
    p = tmp_path / "sub" / "run.trace.jsonl"  # parent dir auto-created
    t = telemetry.enable(jsonl_path=p)
    with telemetry.span("a"):
        telemetry.instant("b")
    telemetry.disable()
    evs = load_jsonl(p)
    assert [e["name"] for e in evs] == [e["name"] for e in t.events]
    assert ref_tel.load_jsonl(p) == evs  # the reference reads it alike
    telemetry.enable(jsonl_path=p)  # append-only: a second run
    with telemetry.span("c"):
        pass
    telemetry.disable()
    assert len(load_jsonl(p)) > len(evs)
    with open(p, "a") as f:  # a torn final line is skipped, not fatal
        f.write('{"name": "torn...')
    assert [e["name"] for e in load_jsonl(p)][-1] == "c"
    with open(p, "a") as f:  # a torn line that still parses: no event
        f.write('\n12\n')
    assert load_jsonl(p) == ref_tel.load_jsonl(p)
    assert load_jsonl(p)[-1]["name"] == "c"


def test_write_chrome_loads_back(tmp_path):
    path = _sample_tracer().write_chrome(tmp_path / "t.json")
    doc = json.loads(Path(path).read_text())
    assert isinstance(doc["traceEvents"], list) and doc["traceEvents"]


def test_tracer_reanchors_on_interval_and_caps_memory():
    t = Tracer(anchor_interval_s=0.01)
    for _ in range(3):
        time.sleep(0.02)
        t.instant("tick")
    anchors = [e for e in t.events if e.get("name") == "clock_sync"]
    assert len(anchors) >= 3  # initial + periodic re-anchors
    walls = [e["args"]["wall_ns"] for e in anchors]
    assert walls == sorted(walls)
    capped = Tracer(max_events=20)
    for i in range(100):
        capped.instant("x", {"i": i})
    assert len(capped.events) <= 20
    assert capped.events[-1]["args"]["i"] == 99


def test_metric_dump_rides_the_stream_as_a_black_box(tmp_path):
    reg = MetricsRegistry()
    reg.counter("req").inc(3)
    reg.histogram("lat", (0.1, 1.0)).observe(0.5)
    t = Tracer(jsonl_path=tmp_path / "m.trace.jsonl", process_name="m")
    t.metric_dump(reg.dump())
    reg.counter("req").inc(2)
    t.metric_dump(reg.dump())
    t.close()
    for mod in (fleet, ref_fleet):
        dumps = mod.stream_metric_dumps(tmp_path / "m.trace.jsonl")
        assert [d["req"]["value"] for d in dumps] == [3, 5]
    fl = fleet.merge_registry_dumps(dumps)
    assert fl.counter("req").value == 8
    assert fl.dump() == ref_fleet.merge_registry_dumps(dumps).dump()


_CHILD_PRELUDE = f"""
import importlib.util, sys
spec = importlib.util.spec_from_file_location("t", {str(TRACE_PY)!r})
t = importlib.util.module_from_spec(spec)
spec.loader.exec_module(t)
"""


def test_sigkilled_child_stream_is_parseable_never_half_parsed(tmp_path):
    """SIGKILL a child in a tight span-write loop: every line but the
    last parses, and the loader drops the torn tail, never mangles it."""
    stream = tmp_path / "victim.trace.jsonl"
    child = _CHILD_PRELUDE + f"""
tr = t.Tracer(jsonl_path={str(stream)!r}, anchor_interval_s=0.005)
print("GO", flush=True)
i = 0
while True:
    tr.complete("spin", tr._now_us() - 5.0, {{"i": i, "pad": "x" * 64}})
    i += 1
"""
    p = subprocess.Popen([sys.executable, "-c", child],
                         stdout=subprocess.PIPE, text=True)
    try:
        assert p.stdout.readline().strip() == "GO"
        deadline = time.monotonic() + 30
        while stream.stat().st_size < 64 * 1024:  # mid-flight for sure
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        p.kill()
        p.wait()
    body = stream.read_text(errors="replace").split("\n")[:-1]
    parsed = 0
    for ln in body:
        if ln:
            json.loads(ln)  # must not raise: only the tail may tear
            parsed += 1
    assert parsed > 50
    spans = [e for e in load_jsonl(stream) if e.get("ph") == "X"]
    assert 50 < len(spans) <= parsed
    idx = [e["args"]["i"] for e in spans]
    assert idx == sorted(idx)


def test_sigterm_flushes_then_chains_to_default_death(tmp_path):
    child = _CHILD_PRELUDE + f"""
import time
tr = t.open_process_stream({str(tmp_path)!r}, "victim")
assert tr is not None and t.get_tracer() is tr
tr.complete("alive", tr._now_us() - 10.0, {{}})
print("GO", flush=True)
while True:
    time.sleep(0.05)
"""
    p = subprocess.Popen([sys.executable, "-c", child],
                         stdout=subprocess.PIPE, text=True)
    try:
        assert p.stdout.readline().strip() == "GO"
        p.send_signal(signal.SIGTERM)
        rc = p.wait(timeout=10)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert rc == -signal.SIGTERM  # the chained default still kills
    events = load_jsonl(tmp_path / "victim.trace.jsonl")
    assert any(e.get("name") == "alive" for e in events)
    assert {"ph": "M", "name": "process_name", "ts": 0.0,
            "args": {"name": "victim"}}.items() <= events[1].items()


def test_env_switch_disables_the_stream(tmp_path, monkeypatch):
    monkeypatch.setenv("HETU_OBS_STREAM", "0")
    assert trace.open_process_stream(tmp_path, "nope") is None
    assert not list(tmp_path.glob("*.trace.jsonl"))
    assert not telemetry.enabled()


# -------------------------------------------------------------- registry

def _both_registries(fill):
    a, b = MetricsRegistry(), RefRegistry()
    fill(a)
    fill(b)
    return a, b


def test_registry_merge_counters_sum_gauges_lww_histograms_bucketwise():
    def fill(cls):
        a, b = cls(), cls()
        a.counter("req").inc(3)
        b.counter("req").inc(4)
        a.gauge("depth").set(2.0)
        b.gauge("depth").set(7.0)
        for v in (0.05, 0.05, 0.2):
            a.histogram("lat", (0.1, 1.0)).observe(v)
        for v in (0.05, 0.9):
            b.histogram("lat", (0.1, 1.0)).observe(v)
        fl = cls()
        fl.merge(a)
        fl.merge(b.dump())  # dict form: what crossed the wire as JSON
        return fl

    fl = fill(MetricsRegistry)
    assert fl.counter("req").value == 7
    assert fl.gauge("depth").value == 7.0  # last write wins
    h = fl.metrics()["lat"]
    assert h.count == 5 and h._counts[0] == 3  # bucket-wise, not averaged
    assert abs(h.sum - 1.25) < 1e-9
    assert h.snapshot()["max"] == 0.9 and h.snapshot()["min"] == 0.05
    ref = fill(RefRegistry)
    assert fl.dump() == ref.dump()
    assert fl.snapshot() == ref.snapshot()
    assert fl.prometheus_text() == ref.prometheus_text()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert h.percentile(q) == ref.metrics()["lat"].percentile(q)
    with pytest.raises(ValueError):
        h.percentile(1.5)


def test_registry_merge_incompatible_buckets_raise():
    a, b = MetricsRegistry(), MetricsRegistry()
    a.histogram("lat", (0.1, 1.0)).observe(0.5)
    b.histogram("lat", (0.2, 2.0)).observe(0.5)
    with pytest.raises(ValueError, match="incompatible buckets"):
        a.merge(b)
    assert a.metrics()["lat"].count == 1  # not half-applied


def test_registry_merge_histogram_schema_mismatch_paths():
    a = MetricsRegistry()
    a.histogram("lat", (0.1, 1.0)).observe(0.5)
    good = a.dump()["lat"]
    b = MetricsRegistry()
    b.histogram("lat", (0.1, 1.0))
    with pytest.raises(ValueError, match="counts for"):
        b.merge({"lat": {**good, "counts": good["counts"][:-1]}})
    with pytest.raises(ValueError, match="unknown metric type"):
        MetricsRegistry().merge({"x": {"type": "summary", "value": 1}})
    c = MetricsRegistry()
    c.merge({"lat": good})
    c.merge({"lat": good})
    assert c.metrics()["lat"].count == 2


def test_registry_dump_crosses_packages_json_and_prefix(tmp_path):
    a = MetricsRegistry()
    a.counter("req", help="requests").inc(5)
    a.gauge("depth").set(3.0)
    a.histogram("lat", (0.1, 1.0)).observe(0.05)
    wired = json.loads(json.dumps(a.dump()))  # the scrape wire format
    back = MetricsRegistry.from_dump(wired)
    assert back.snapshot() == a.snapshot()
    # a port dump folds into a reference registry and back, unchanged
    ref = RefRegistry.from_dump(wired)
    assert ref.dump() == a.dump()
    assert MetricsRegistry.from_dump(ref.dump()).dump() == a.dump()
    ns = MetricsRegistry()
    ns.merge(wired, prefix="m0.")
    assert ns.counter("m0.req").value == 5
    assert "m0.lat" in ns.metrics()
    path = a.write_prometheus(tmp_path / "x" / "metrics.prom")
    assert Path(path).read_text() == ref.prometheus_text()
    a.counter("req").reset()
    assert a.counter("req").value == 0


def test_serve_metrics_per_tenant_accounting():
    from hetu_tpu.serve.metrics import ServeMetrics as RefServeMetrics
    from hetu_tpu_torch.serve.metrics import ServeMetrics

    def fill(m):
        m.note_tenant("gold", "requests", 2)
        m.note_tenant("gold", "shed")
        m.note_tenant(None, "requests")  # untagged: no-op
        m.observe_ttft(0.05, tenant="gold")
        m.observe_ttft(0.07)
        m.note_tenant("gold tier\nevil 1", "requests")
        return m.registry

    reg = fill(ServeMetrics())
    assert reg.counter("tenant.gold.requests").value == 2
    assert reg.counter("tenant.gold.shed").value == 1
    assert reg.counter("tenant.gold_tier_evil_1.requests").value == 1
    assert "\n\n" not in reg.prometheus_text()
    assert reg.metrics()["tenant.gold.ttft_s"].count == 1
    assert reg.metrics()["ttft_s"].count == 2
    fl = MetricsRegistry.from_dump(json.loads(json.dumps(reg.dump())))
    assert fl.counter("tenant.gold.requests").value == 2
    assert reg.dump() == fill(RefServeMetrics()).dump()


# -------------------------------------------------------------- timeline

TIMELINE_CASES = {
    "synthetic_rules": [
        {"ph": "i", "name": "fault.kill_shard", "ts": 100.0, "seq": 0,
         "args": {"kind": "kill_shard", "step": 1}},
        {"ph": "i", "name": "fault.van_delay", "ts": 110.0, "seq": 1,
         "args": {"kind": "van_delay", "step": 2}},
        {"ph": "X", "name": "recovery.shard_repair", "ts": 10.0,
         "dur": 20.0, "seq": 2, "args": {}},
        {"ph": "X", "name": "recovery.shard_repair", "ts": 400.0,
         "dur": 50.0, "seq": 3, "args": {}},
        {"ph": "i", "name": "fault.worker_loss", "ts": 500.0, "seq": 4,
         "args": {"kind": "worker_loss", "step": 5}},
        {"ph": "i", "name": "fault.worker_join", "ts": 500.5, "seq": 5,
         "args": {"kind": "worker_join", "step": 5}},
        {"ph": "X", "name": "elastic.reshard", "ts": 600.0, "dur": 80.0,
         "seq": 6, "args": {}}],
    "suspend_takes_its_retry": [
        {"ph": "i", "name": "fault.suspend_shard", "ts": 100.0, "seq": 0,
         "args": {"kind": "suspend_shard", "step": 1}},
        {"ph": "X", "name": "recovery.retry", "ts": 110.0, "dur": 10.0,
         "seq": 1, "args": {}},
        {"ph": "i", "name": "fault.kill_shard", "ts": 300.0, "seq": 2,
         "args": {"kind": "kill_shard", "step": 3}},
        {"ph": "X", "name": "recovery.shard_repair", "ts": 350.0,
         "dur": 50.0, "seq": 3, "args": {}}],
    "preempt_prefers_migrate": [
        {"ph": "i", "name": "fault.serve_preempt", "ts": 100.0, "seq": 0,
         "args": {"kind": "serve_preempt", "step": 1}},
        {"ph": "i", "name": "fault.serve_engine_kill", "ts": 105.0,
         "seq": 1, "args": {"kind": "serve_engine_kill", "step": 1}},
        {"ph": "X", "name": "serve.failover", "ts": 110.0, "dur": 10.0,
         "seq": 2, "args": {}},
        {"ph": "X", "name": "serve.migrate", "ts": 150.0, "dur": 30.0,
         "seq": 3, "args": {}}],
    "failed_recovery_unclaimed": [
        {"ph": "i", "name": "fault.serve_preempt", "ts": 100.0, "seq": 0,
         "args": {"kind": "serve_preempt", "step": 1}},
        {"ph": "X", "name": "serve.migrate", "ts": 110.0, "dur": 10.0,
         "seq": 1, "args": {"error": "RuntimeError"}},
        {"ph": "X", "name": "serve.failover", "ts": 200.0, "dur": 20.0,
         "seq": 2, "args": {}}],
    "preempt_checkpoint": [
        {"ph": "i", "name": "fault.preempt", "ts": 100.0, "seq": 0,
         "args": {"kind": "preempt", "step": 4}},
        {"ph": "X", "name": "supervisor.checkpoint", "ts": 150.0,
         "dur": 10.0, "seq": 1, "args": {"reason": "cadence", "step": 4}},
        {"ph": "X", "name": "supervisor.checkpoint", "ts": 200.0,
         "dur": 10.0, "seq": 2, "args": {"reason": "preempt", "step": 4}}],
    "van_faults": [
        {"ph": "i", "name": "fault.van_kill", "ts": 100.0, "seq": 0,
         "args": {"kind": "van_kill", "step": 2}},
        {"ph": "i", "name": "fault.van_suspend", "ts": 500.0, "seq": 1,
         "args": {"kind": "van_suspend", "step": 5}},
        {"ph": "X", "name": "van.promote", "ts": 180.0, "dur": 60.0,
         "seq": 2, "args": {"incarnation": 2, "won": True}},
        {"ph": "X", "name": "van.promote", "ts": 620.0, "dur": 40.0,
         "seq": 3, "args": {"incarnation": 3, "won": True}}],
    "campaign": [
        {"ph": "i", "name": "fault.van_resilver_kill", "ts": 100.0,
         "seq": 0, "args": {"kind": "van_resilver_kill", "step": 0}},
        {"ph": "X", "name": "van.resilver", "ts": 120.0, "dur": 30.0,
         "seq": 1, "args": {"ok": True}},
        {"ph": "X", "name": "van.promote", "ts": 160.0, "dur": 50.0,
         "seq": 2, "args": {"incarnation": 3, "won": True}},
        {"ph": "i", "name": "fault.controller_kill_mid_failover",
         "ts": 300.0, "seq": 3,
         "args": {"kind": "controller_kill_mid_failover", "step": 1}},
        {"ph": "X", "name": "ctrl.takeover", "ts": 340.0, "dur": 40.0,
         "seq": 4, "args": {"incarnation": 2}},
        {"ph": "i", "name": "fault.member_kill_mid_resilver",
         "ts": 600.0, "seq": 5,
         "args": {"kind": "member_kill_mid_resilver", "step": 2}},
        {"ph": "X", "name": "serve.failover", "ts": 650.0, "dur": 25.0,
         "seq": 6, "args": {}}],
}

# (kind, the recovery it must pair with, its start in us or None)
TIMELINE_WANT = {
    "synthetic_rules": [("kill_shard", "recovery.shard_repair", 400.0),
                        ("van_delay", None, None),
                        ("worker_loss", "elastic.reshard", 600.0),
                        ("worker_join", "elastic.reshard", 600.0)],
    "suspend_takes_its_retry": [
        ("suspend_shard", "recovery.retry", 110.0),
        ("kill_shard", "recovery.shard_repair", 350.0)],
    "preempt_prefers_migrate": [("serve_preempt", "serve.migrate", 150.0),
                                ("serve_engine_kill", "serve.failover",
                                 110.0)],
    "failed_recovery_unclaimed": [("serve_preempt", "serve.failover",
                                   200.0)],
    "preempt_checkpoint": [("preempt", "supervisor.checkpoint", 200.0)],
    "van_faults": [("van_kill", "van.promote", 180.0),
                   ("van_suspend", "van.promote", 620.0)],
    "campaign": [("van_resilver_kill", "van.promote", 160.0),
                 ("controller_kill_mid_failover", "ctrl.takeover", 340.0),
                 ("member_kill_mid_resilver", "serve.failover", 650.0)],
}


def test_timeline_tables_are_the_references():
    assert timeline.RECOVERY_FOR == ref_timeline.RECOVERY_FOR
    assert timeline.PREFERENCE_ORDERED == ref_timeline.PREFERENCE_ORDERED
    assert timeline.RECOVERY_ATTRS == ref_timeline.RECOVERY_ATTRS


@pytest.mark.parametrize("case", sorted(TIMELINE_CASES))
def test_timeline_pairs_and_reports_as_the_reference(case):
    evs = TIMELINE_CASES[case]
    pairs = timeline.correlate(evs)
    assert [(p.kind, p.recovery_name, p.recovery_start_us)
            for p in pairs] == TIMELINE_WANT[case]
    assert _pairs(pairs) == _pairs(ref_timeline.correlate(evs))
    rep = timeline.report(pairs)
    assert rep == ref_timeline.report(ref_timeline.correlate(evs))
    assert timeline.report(evs) == rep  # a raw event list correlates first
    reg = timeline.recovery_histograms(pairs)
    ref_reg = ref_timeline.recovery_histograms(ref_timeline.correlate(evs))
    assert reg.dump() == ref_reg.dump()
    if case == "synthetic_rules":
        ks = pairs[0]
        assert abs(ks.detect_s - 300e-6) < 1e-12
        assert abs(ks.recover_s - 350e-6) < 1e-12
        assert reg.metrics()["recovery.kill_shard.detect_s"].count == 1
        assert reg.metrics()["recovery.van_delay.unpaired"].value == 1


# ------------------------------------------------------------------ fleet

def test_streams_born_apart_align_to_the_wall_clock(tmp_path):
    """Two tracers born 200 ms apart: spans recorded at the same wall
    instant land at nearly the same merged ts, in both packages alike."""
    ta = Tracer(jsonl_path=tmp_path / "a.trace.jsonl",
                process_name="a", pid=1)
    time.sleep(0.2)
    tb = Tracer(jsonl_path=tmp_path / "b.trace.jsonl",
                process_name="b", pid=2)
    ta.complete("x", ta._now_us(), {"k": 1})
    tb.complete("x", tb._now_us(), {"k": 2})
    ta.close()
    tb.close()
    events, procs = fleet.merge_streams(tmp_path)
    assert procs == {1: "a", 2: "b"}
    spans = {e["args"]["k"]: e for e in events if e.get("ph") == "X"}
    raw = {k: [e for e in load_jsonl(tmp_path / f"{n}.trace.jsonl")
               if e.get("ph") == "X"][0]["ts"] for k, n in ((1, "a"),
                                                             (2, "b"))}
    assert abs(raw[1] - raw[2]) > 150_000  # raw axes really disagree
    assert abs(spans[1]["ts"] - spans[2]["ts"]) < 100_000  # merged agree
    assert (events, procs) == ref_fleet.merge_streams(tmp_path)


def test_merge_remaps_colliding_pids_as_the_reference(tmp_path):
    for name in ("a", "b", "c"):
        _append(tmp_path / f"{name}.trace.jsonl", [
            {"ph": "M", "name": "process_name", "pid": 7,
             "args": {"name": name}},
            dict(_anchor(0.0, 1_000_000.0 + len(name)), pid=7),
            {"ph": "i", "name": f"ev_{name}", "ts": 1.0, "pid": 7}])
    events, procs = fleet.merge_streams(tmp_path)
    assert set(procs) == {7, 1_000_007, 2_000_007}
    assert sorted(procs.values()) == ["a", "b", "c"]
    assert (events, procs) == ref_fleet.merge_streams(tmp_path)
    assert fleet.discover_streams(tmp_path) == \
        ref_fleet.discover_streams(tmp_path)


def _synthetic_chain(rid=7, ctrl_pid=1, member_pid=2):
    return [
        {"ph": "X", "name": "serve.submit", "ts": 1000.0, "dur": 500.0,
         "pid": ctrl_pid, "tid": 1, "args": {"rid": rid,
                                             "tenant": "gold"}},
        {"ph": "X", "name": "serve.request", "ts": 2500.0,
         "dur": 40_000.0, "pid": member_pid, "tid": 9,
         "args": {"rid": rid, "status": "ok", "tenant": "gold",
                  "queue_s": 0.004, "prefill_s": 0.006,
                  "decode_s": 0.03}},
        {"ph": "X", "name": "serve.resolve", "ts": 44_000.0, "dur": 50.0,
         "pid": ctrl_pid, "tid": 1, "args": {"rid": rid,
                                             "status": "ok"}},
    ]


def test_stitch_flows_links_the_chain_in_order():
    events = _synthetic_chain() + _synthetic_chain(rid=8, member_pid=1)
    flows = fleet.stitch_flows(events)
    assert [f["ph"] for f in flows[:3]] == ["s", "t", "f"]
    assert [f["pid"] for f in flows[:3]] == [1, 2, 1]  # ctrl→member→ctrl
    assert flows[2]["bp"] == "e"
    assert fleet.cross_process_flow_rids(events) == {7}
    assert flows == ref_fleet.stitch_flows(events)


def test_latency_breakdown_decomposes_queue_prefill_decode_wire():
    events = _synthetic_chain()
    # a failover: a second member request span for the rid
    events.insert(2, dict(events[1], ts=20_000.0, pid=3))
    rows = fleet.latency_breakdown(events)
    r = rows[7]
    assert r["queue_s"] == 0.004 and r["prefill_s"] == 0.006
    assert r["decode_s"] == 0.03 and r["tenant"] == "gold"
    assert r["hops"] == 2 and r["member_pids"] == [2, 3]
    assert abs(r["total_s"] - (44_050.0 - 1000.0) / 1e6) < 1e-9
    assert rows == ref_fleet.latency_breakdown(events)
    one = fleet.latency_breakdown(_synthetic_chain())[7]
    assert abs(one["wire_s"] - 0.003) < 1e-9  # 1.5 ms each way


def test_merged_chrome_trace_is_perfetto_shaped(tmp_path):
    p = tmp_path / "m.trace.jsonl"
    t = Tracer(jsonl_path=p, process_name="m", pid=5)
    with t.span("serve.step", {"rid": 1}, "serve"):
        pass
    t.close()
    doc = fleet.merged_chrome_trace([p])
    assert "traceEvents" in doc and doc["displayTimeUnit"] == "ms"
    for e in doc["traceEvents"]:
        assert "ph" in e
        if e["ph"] == "X":
            assert e["dur"] >= 0.0 and "pid" in e and "tid" in e
    json.loads(json.dumps(doc))
    assert doc == ref_fleet.merged_chrome_trace([p])
    out = fleet.write_merged([p], tmp_path / "out" / "merged.json")
    assert json.loads(Path(out).read_text()) == doc


def test_controller_fault_pairs_with_member_recorded_recovery(tmp_path):
    ctrl = Tracer(jsonl_path=tmp_path / "ctrl.trace.jsonl",
                  process_name="controller", pid=10)
    member = Tracer(jsonl_path=tmp_path / "member.trace.jsonl",
                    process_name="member", pid=20)
    ctrl.instant("fault.serve_preempt",
                 {"kind": "serve_preempt", "step": 1}, "fault")
    time.sleep(0.01)
    with member.span("serve.migrate", {"xfer": 3}, "serve"):
        time.sleep(0.01)
    ctrl.close()
    member.close()
    events, _ = fleet.merge_streams(tmp_path)
    pairs = timeline.correlate(events)
    assert len(pairs) == 1 and pairs[0].paired
    assert pairs[0].recovery_name == "serve.migrate"
    assert pairs[0].recovery_pid == 20  # recorded in the MEMBER process
    assert timeline.report(events)["serve_preempt"]["paired"] == 1
    ref_events, _ = ref_fleet.merge_streams(tmp_path)
    assert _pairs(pairs) == _pairs(ref_timeline.correlate(ref_events))


# ------------------------------------------------------------------ costs

def test_measured_op_costs_from_events_stream_and_registry(tmp_path):
    t = Tracer(jsonl_path=tmp_path / "ops.trace.jsonl")
    for d_us in (1000.0, 3000.0, 2000.0):
        t.complete("train.step", t._now_us() - d_us, {})
    t.complete("train.data_wait", t._now_us() - 500.0, {})
    t.close()
    for src in (t, tmp_path / "ops.trace.jsonl", list(t.events)):
        table = costs.measured_op_costs(src, prefix="train.")
        assert set(table) == {"train.step", "train.data_wait"}
        row = table["train.step"]
        assert row["count"] == 3
        assert abs(row["mean_s"] - 0.002) < 2e-4
        assert abs(row["p50_s"] - 0.002) < 2e-4
        assert row["max_s"] >= row["p50_s"] >= 0.0
    events = list(t.events)
    assert costs.measured_op_costs(events) == \
        ref_costs.measured_op_costs(events)
    reg = MetricsRegistry()
    for v in (0.001, 0.002, 0.003):
        reg.histogram("op.matmul.s", (0.0015, 0.0025, 0.01)).observe(v)
    table = costs.measured_op_costs(reg)
    assert table["op.matmul.s"]["count"] == 3
    assert abs(table["op.matmul.s"]["mean_s"] - 0.002) < 1e-9
    assert table == ref_costs.measured_op_costs(
        RefRegistry.from_dump(reg.dump()))
    assert costs.calibration_ratio(table, "op.matmul.s", 0.001) == 2.0
    with pytest.raises(KeyError):
        costs.calibration_ratio(table, "op.never_measured", 1.0)
    with pytest.raises(ValueError):
        costs.calibration_ratio(table, "op.matmul.s", 0.0)


# ----------------------------------------------------------------- health

def test_stream_tail_buffers_torn_final_line(tmp_path):
    p = tmp_path / "m.trace.jsonl"
    _append(p, [_anchor(0.0, 1_000_000.0)])
    line = json.dumps({"ph": "i", "name": "a", "ts": 10.0, "pid": 1})
    with open(p, "a") as f:
        f.write(line[:10])
    tail = StreamTail(p)
    assert tail.poll() == []  # torn: buffered, never mangled
    with open(p, "a") as f:
        f.write(line[10:] + "\n")
    out = tail.poll()
    assert [e["name"] for e in out] == ["a"]
    assert abs(out[0]["ts"] - 1_000_010.0) < 1e-6  # off = 1e6 - 0
    assert tail.poll() == []


def test_events_before_first_anchor_release_retroactively(tmp_path):
    p = tmp_path / "m.trace.jsonl"
    _append(p, [{"ph": "i", "name": "early", "ts": 5.0, "pid": 2}])
    tail = StreamTail(p)
    assert tail.poll() == []  # held
    _append(p, [_anchor(100.0, 7_000_000.0),
                {"ph": "i", "name": "late", "ts": 110.0, "pid": 2}])
    out = tail.poll()
    assert [e["name"] for e in out] == ["early", "late"]
    off = 7_000_000.0 - 100.0
    assert [e["ts"] for e in out] == [5.0 + off, 110.0 + off]


def test_reanchor_corrects_drift_and_tail_equals_merge(tmp_path):
    p = tmp_path / "m.trace.jsonl"
    _append(p, [_anchor(0.0, 1_000_000.0),
                {"ph": "i", "name": "mid", "ts": 10e6, "pid": 3},
                _anchor(40e6, 45_000_000.0),
                {"ph": "i", "name": "post", "ts": 41e6, "pid": 3}])
    out = {e["name"]: e["ts"] for e in StreamTail(p).poll()}
    assert out["mid"] == 10e6 + 1_000_000.0
    assert out["post"] == 41e6 + 5_000_000.0
    anchors = fleet.anchors(load_jsonl(p))
    assert anchors == ref_fleet.anchors(load_jsonl(p))
    assert fleet.offset_at(anchors, 10e6) == 1_000_000.0
    assert fleet.offset_at(anchors, 41e6) == 5_000_000.0
    ref_out = {e["name"]: e["ts"] for e in ref_health.StreamTail(p).poll()}
    assert out == ref_out


def test_fleet_tail_remaps_three_way_pid_collision(tmp_path):
    for name in ("a", "b", "c"):
        _append(tmp_path / f"{name}.trace.jsonl", [
            {"ph": "M", "name": "process_name", "pid": 7,
             "args": {"name": name}},
            _anchor(0.0, 1_000_000.0),
            {"ph": "i", "name": f"ev_{name}", "ts": 1.0, "pid": 7}])
    ft = tail_streams(tmp_path)
    evs = [e for e in ft.poll() if e.get("ph") == "i"]
    assert {e["pid"] for e in evs} == {7, 1_000_007, 2_000_007}
    assert sorted(ft.processes.values()) == ["a", "b", "c"]
    ref_ft = ref_health.tail_streams(tmp_path)
    ref_evs = [e for e in ref_ft.poll() if e.get("ph") == "i"]
    assert evs == ref_evs and ft.processes == ref_ft.processes


def test_fleet_tail_picks_up_streams_that_appear_later(tmp_path):
    _append(tmp_path / "a.trace.jsonl", [
        _anchor(0.0, 1e6), {"ph": "i", "name": "x", "ts": 1.0, "pid": 1}])
    ft = tail_streams(tmp_path)
    assert len(ft.poll()) == 1
    _append(tmp_path / "b.trace.jsonl", [
        _anchor(0.0, 2e6), {"ph": "i", "name": "y", "ts": 1.0, "pid": 2}])
    assert [e["name"] for e in ft.poll()] == ["y"]


def _windows(cls, samples):
    w = cls()
    for dump, t, src in samples:
        w.ingest(dump, t=t, source=src)
    return w


def test_metric_windows_since_last_and_windowed_deltas():
    samples = [({"req": _ctr(100)}, 0.0, "f"), ({"req": _ctr(130)}, 10.0,
                                                 "f")]
    for cls in (MetricWindows, ref_health.MetricWindows):
        w = _windows(cls, samples[:1])
        assert w.delta("req") == 100.0
        w = _windows(cls, samples)
        assert w.delta("req") == 30.0
        assert w.delta("req", 100.0) == 130.0
        assert abs(w.rate("req", 10.0) - 3.0) < 1e-12
        assert w.value("req") == 130.0
        w.ingest({"req": _ctr(5)}, t=20.0, source="f")  # a restart
        assert w.delta("req") == 0.0
        assert w.value("missing") is None


def test_metric_windows_hist_delta_frac_over_and_quantile():
    b = (0.1, 0.5)
    for cls in (MetricWindows, ref_health.MetricWindows):
        w = _windows(cls, [({"lat": _hist(b, [10, 0, 0])}, 0.0, None),
                           ({"lat": _hist(b, [10, 0, 6])}, 5.0, None)])
        assert w.hist_delta("lat") == ([0.1, 0.5], [0, 0, 6])
        assert w.frac_over("lat", 0.5) == 1.0
        assert abs(w.frac_over("lat", 0.5, window_s=100.0) - 6 / 16) < 1e-12
        w2 = _windows(cls, [({"lat": _hist(b, [4, 4, 0])}, 0.0, None)])
        assert w2.frac_over("lat", 0.25) == 0.5
        assert w2.quantile("lat", 0.99) == 0.5
        assert w.frac_over("nope", 0.5) is None


def test_metric_windows_ingest_events_per_pid_series():
    evs = [{"ph": "M", "name": "hetu_metrics", "ts": 1e6, "pid": 9,
            "args": {"metrics": {"req": _ctr(5)}}},
           {"ph": "M", "name": "hetu_metrics", "ts": 2e6, "pid": 11,
            "args": {"metrics": {"req": _ctr(7)}}},
           {"ph": "i", "name": "not_metrics", "ts": 3e6, "pid": 9}]
    w = MetricWindows()
    w.ingest_events(evs)
    assert sorted(w.sources()) == [9, 11]
    assert w.value("req") == 12.0
    assert w.value("req", source=9) == 5.0


def test_alert_rule_string_exprs_are_closed_and_never_raise():
    w = _windows(MetricWindows, [({"req": _ctr(1)}, 0.0, None),
                                 ({"req": _ctr(11)}, 5.0, None)])
    assert AlertRule("ok", "delta('req')", 0.0, window_s=10.0
                     ).evaluate(w) == 11.0
    assert AlertRule("bad", "this is not python").evaluate(w) is None
    assert AlertRule("esc", "__import__('os').getpid()").evaluate(w) is None
    assert AlertRule("call", lambda win: 1 / 0).evaluate(w) is None


def test_health_monitor_for_ticks_fire_resolve_and_instants(tmp_path):
    vals = {"v": 0}
    rule = AlertRule("link_degraded", "delta('ctrl.links_degraded')",
                     0.0, window_s=5.0, for_ticks=2,
                     fault_kinds=("netem_degrade",))
    reg = MetricsRegistry()
    mon = HealthMonitor(
        [rule], source=lambda: {"ctrl.links_degraded": _ctr(vals["v"])},
        registry=reg)
    telemetry.enable(jsonl_path=str(tmp_path / "mon.trace.jsonl"))
    try:
        assert mon.tick(now=0.0)["fired"] == []      # baseline
        vals["v"] = 1
        r = mon.tick(now=1.0)                        # breach 1: pending
        assert r["fired"] == [] and mon.active_alerts() == []
        vals["v"] = 2
        assert mon.tick(now=2.0)["fired"] == ["link_degraded"]
        act = mon.active_alerts()
        assert act[0]["rule"] == "link_degraded"
        assert act[0]["severity"] == "warn"
        assert reg.gauge("health.alerts_active").value == 1.0
        r = mon.tick(now=20.0)
        assert r["resolved"] == ["link_degraded"]
        assert mon.active_alerts() == []
        assert reg.counter("health.alerts_fired").value == 1
        assert reg.counter("health.alerts_resolved").value == 1
    finally:
        telemetry.disable()
    alerts = [e for e in load_jsonl(tmp_path / "mon.trace.jsonl")
              if e.get("name") == "health.alert"]
    assert [e["args"]["state"] for e in alerts] == ["firing", "resolved"]
    assert alerts[0]["args"]["rule"] == "link_degraded"


def test_health_monitor_tails_a_run_dir_and_diagnoses(tmp_path):
    """The monitor's tail feeds the windows and the doctor: a fault
    instant and a member's metric dumps on the streams fire the rule,
    and the diagnosis names the fault; the loop thread starts and
    stops."""
    _append(tmp_path / "member.trace.jsonl", [
        {"ph": "M", "name": "process_name", "pid": 9,
         "args": {"name": "member:0"}},
        _anchor(0.0, 1_000_000_000.0),
        {"ph": "M", "name": "hetu_metrics", "ts": 1e6, "pid": 9,
         "args": {"metrics": {"requests_shed": _ctr(0)}}},
        {"ph": "i", "name": "fault.netem_degrade", "ts": 2e6, "pid": 9,
         "args": {"kind": "netem_degrade", "member": 1}},
        {"ph": "M", "name": "hetu_metrics", "ts": 3e6, "pid": 9,
         "args": {"metrics": {"requests_shed": _ctr(40)}}}])
    rule = AlertRule("shed_spike", "rate('requests_shed')", 0.5,
                     window_s=10.0, fault_kinds=("netem_degrade",))
    mon = HealthMonitor([rule], tail=tmp_path, interval_s=0.05)
    r = mon.tick(now=1003.0)
    assert r["fired"] == ["shed_spike"]
    assert mon.last_diagnosis["top"]["kind"] == "netem_degrade"
    assert mon.last_diagnosis["top"]["member"] == 1
    mon.start()
    with pytest.raises(RuntimeError):
        mon.start()
    mon.stop()


def test_slo_burn_rules_fire_only_when_both_windows_burn():
    classes = {"gold": {"priority": 1, "weight": 4.0, "ttft_slo_s": 0.25},
               "free": {"priority": 0, "weight": 1.0, "ttft_slo_s": None}}
    rules = slo_burn_rules(classes, windows=(5.0, 20.0))
    assert [r.name for r in rules] == ["slo_burn.gold"]
    r = rules[0]
    assert r.labels == {"tenant": "gold"} and r.severity == "page"
    b = (0.25, 1.0)
    name = "tenant.gold.ttft_s"
    w = _windows(MetricWindows, [({name: _hist(b, [100, 0, 0])}, 0.0, None),
                                 ({name: _hist(b, [100, 40, 0])}, 18.0,
                                  None)])
    v = r.evaluate(w)
    assert v is not None and v > r.threshold
    ref_r = ref_health.slo_burn_rules(classes, windows=(5.0, 20.0))[0]
    ref_w = _windows(ref_health.MetricWindows,
                     [({name: _hist(b, [100, 0, 0])}, 0.0, None),
                      ({name: _hist(b, [100, 40, 0])}, 18.0, None)])
    assert v == ref_r.evaluate(ref_w)
    w2 = _windows(MetricWindows, [({name: _hist(b, [0, 0, 0])}, 0.0, None),
                                  ({name: _hist(b, [0, 40, 0])}, 1.0, None),
                                  ({name: _hist(b, [0, 40, 0])}, 18.0,
                                   None)])
    assert w2.frac_over(name, 0.25, 5.0) is None
    assert r.evaluate(w2) is None
    names = [x.name for x in health.default_fleet_rules(classes)]
    assert names == [x.name for x in ref_health.default_fleet_rules(
        classes)]


DIAGNOSE_EVENTS = [
    {"ph": "i", "name": "fault.netem_degrade", "ts": 90e6,
     "args": {"kind": "netem_degrade", "member": 2}},
    {"ph": "X", "name": "serve.link_degraded", "ts": 91e6,
     "dur": 4.2e6, "args": {"member": 2}},
    {"ph": "i", "name": "route.park", "ts": 92e6, "args": {"rid": 1}},
    {"ph": "i", "name": "route.park", "ts": 92.5e6, "args": {"rid": 2}},
    {"ph": "i", "name": "membership.event", "ts": 93e6,
     "args": {"kind": "suspect", "member": 2}},
]


def test_diagnose_ranks_injected_fault_with_recovery_pairing():
    alert = AlertRule("shed_spike", None,
                      fault_kinds=("netem_degrade", "member_kill"))
    d = diagnose(DIAGNOSE_EVENTS, alert=alert, now_us=100e6)
    assert d["top"]["kind"] == "netem_degrade"
    assert d["top"]["member"] == 2
    assert "serve.link_degraded closed 5.2s after injection" in \
        d["top"]["text"]
    assert d["top"]["text"].startswith("shed_spike ← netem_degrade "
                                       "on member 2")
    kinds = [v["kind"] for v in d["verdicts"]]
    assert len(kinds) == len(set(kinds))
    assert "routing_stall" in kinds
    assert diagnose([], alert=alert) is None
    ref_alert = ref_health.AlertRule(
        "shed_spike", None, fault_kinds=("netem_degrade", "member_kill"))
    assert d == ref_health.diagnose(DIAGNOSE_EVENTS, alert=ref_alert,
                                    now_us=100e6)


def test_diagnose_alert_affinity_disambiguates_sequential_faults():
    events = [
        {"ph": "i", "name": "fault.van_kill", "ts": 80e6,
         "args": {"kind": "van_kill", "van": 0}},
        {"ph": "i", "name": "fault.netem_degrade", "ts": 90e6,
         "args": {"kind": "netem_degrade", "member": 1}},
    ]
    link = AlertRule("link_degraded", None,
                     fault_kinds=("netem_degrade", "netem_partition"))
    van = AlertRule("van_failover", None, fault_kinds=("van_kill",))
    assert diagnose(events, alert=link,
                    now_us=95e6)["top"]["kind"] == "netem_degrade"
    assert diagnose(events, alert=van,
                    now_us=95e6)["top"]["kind"] == "van_kill"


def test_diagnose_ranks_serve_faults_from_a_pool_chaos_trace():
    """The pool's chaos run as the doctor sees it: each injected serve
    fault ranks first for an alert that names it, beside the organic
    serve.failover evidence."""
    events = [
        {"ph": "i", "name": "fault.serve_preempt", "ts": 10e6,
         "args": {"kind": "serve_preempt", "step": 2}},
        {"ph": "X", "name": "serve.migrate", "ts": 10.1e6, "dur": 0.2e6,
         "args": {"member": "m1"}},
        {"ph": "i", "name": "fault.serve_engine_kill", "ts": 11e6,
         "args": {"kind": "serve_engine_kill", "step": 4}},
        {"ph": "X", "name": "serve.failover", "ts": 11.3e6, "dur": 0.1e6,
         "args": {"member": "m2"}},
    ]
    for kind, rec in (("serve_preempt", "serve.migrate"),
                      ("serve_engine_kill", "serve.failover")):
        alert = AlertRule(f"serve_recovery.{kind}", None,
                          fault_kinds=(kind,))
        d = diagnose(events, alert=alert, now_us=12e6)
        assert d["top"]["kind"] == kind
        assert f"{rec} closed" in d["top"]["text"]
        ref_alert = ref_health.AlertRule(f"serve_recovery.{kind}", None,
                                         fault_kinds=(kind,))
        assert d == ref_health.diagnose(events, alert=ref_alert,
                                        now_us=12e6)
