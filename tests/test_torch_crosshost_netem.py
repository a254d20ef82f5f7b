"""The cross-process serving pool's network-fault plane
(``apply_net_fault``/``run_net_events``) and its live health plane
(``start_health_monitor``), with real CPU member processes of the
reference's ``TINY`` GPT, against hetu_tpu's scheduler.

A seeded one-way egress partition of a held member, fired through
``FaultInjector.pop_net_events`` and ``run_net_events``: the controller
stops hearing the member's beats, suspects it, and clears it when the
partition heals member-side; the monitor hosted on the controller fires
an alert on the suspicion; nothing fails over, and every stream matches
the oracle.  As in ``tests/test_torch_crosshost.py``, the members are held
at a decode round while the fault is live, and only the lease runs on wall
time, with margins of 3x or more.
"""

import pytest

from hetu_tpu_torch.resilience import FaultEvent, FaultInjector, FaultSchedule
from hetu_tpu_torch.serve.crosshost import CrossProcessServingPool
from hetu_tpu_torch.telemetry import timeline, trace
from hetu_tpu_torch.telemetry.health import AlertRule
from test_torch_crosshost import (  # noqa: F401  (oracle: a fixture)
    WAIT_S, _finish, _held_wave, _pool, _until, oracle,
)


def test_partition_through_run_net_events_is_alerted_and_cleared(
        tmp_path, oracle):  # noqa: F811
    """Egress partition of member 0 for 1.5 s against lease 0.4 s (3.75x)
    and grace 4.5 s (3x): suspected once, an alert while it is live,
    cleared at heal, no failover; a straggler event in the same schedule
    is left to the training supervisor that owns it."""
    part_s = 1.5
    tracer = trace.Tracer()
    trace.enable(tracer=tracer)
    try:
        pool = _pool(tmp_path, hb_ms=60, lease_s=0.4, suspect_grace_s=4.5)
        try:
            rule = AlertRule("member_suspect",
                             "delta('ctrl.members_suspected')", 0.0,
                             window_s=30.0, fault_kinds=("netem_partition",))
            mon = pool.start_health_monitor([rule], interval_s=0.1)
            assert pool.health_monitor is mon
            with pytest.raises(RuntimeError, match="already running"):
                pool.start_health_monitor()
            prompts = [[3, 1, 4], [1, 5, 9]]
            reqs = _held_wave(pool, prompts, 12)
            inj = FaultInjector(FaultSchedule([
                FaultEvent(1, "netem_partition", 0.0, part_s),
                FaultEvent(1, "straggler", 1.0, 5.0)]))
            inj.on_step(1)
            events = inj.pop_net_events()
            assert [e[0] for e in events] == ["netem_partition", "straggler"]
            pool.run_net_events(events)
            assert pool.metrics.count("netem_partitions_applied") == 1
            assert pool.metrics.count("stragglers_applied") == 0
            _until(lambda: any(a["rule"] == "member_suspect"
                               for a in mon.active_alerts()),
                   "the partition raised no alert while it was live")
            _until(lambda: pool.metrics.count("members_suspect_cleared")
                   >= 1, "the partitioned member was never cleared")
            assert pool.svc.state_of(0).state == "alive"
            for s in (0, 1):
                pool.release_member(s)
            for status, _ in _finish(reqs):
                assert status == "ok"
            assert [r.tokens for r in reqs] == \
                [oracle(p, 12) for p in prompts]
            assert pool.metrics.count("members_suspected") == 1
            assert pool.metrics.count("pool_failovers") == 0
            assert pool.metrics.count("members_rejoined") == 0
            assert all(p.poll() is None for p in pool.procs)
            fl = pool.fleet_metrics(scrape=False)
            assert fl.counter("ctrl.health.alerts_fired").value >= 1
        finally:
            pool.close()
        assert pool.health_monitor is None
    finally:
        trace.disable()
    pairs = timeline.correlate(tracer.events)
    parts = [p for p in pairs if p.kind == "netem_partition"]
    assert len(parts) == 1 and parts[0].paired, parts
    assert parts[0].recovery_name == "serve.member_suspect"
    names = [(e.get("name"), (e.get("args") or {}).get("rule"))
             for e in tracer.events]
    assert ("health.alert", "member_suspect") in names


@pytest.mark.parametrize("kind,direction,policy", [
    ("netem_partition", "egress", {"partition": True, "duration_s": 2.0}),
    ("netem_degrade", "both", {"latency_s": 0.05, "jitter_s": 0.05,
                               "drop_p": 0.05, "rate_mbps": 50.0,
                               "duration_s": 2.0}),
])
def test_apply_net_fault_sends_the_reference_policy(tmp_path, monkeypatch,
                                                    kind, direction,
                                                    policy):
    """The command each fault kind sends its member (spawns patched out:
    this pins the wire shape the member's ``netem`` dispatch reads); a
    member index wraps around the pool, and an unknown kind is refused."""
    monkeypatch.setattr(CrossProcessServingPool, "_spawn",
                        lambda self, slots: None)
    monkeypatch.setattr(CrossProcessServingPool, "_wait_joined",
                        lambda self, slots, timeout_s=None: None)
    pool = CrossProcessServingPool(2, workdir=tmp_path, start_poll=False)
    sent = []
    monkeypatch.setattr(pool, "_send", lambda slot, msg, **kw:
                        sent.append((slot, msg)))
    try:
        pool.apply_net_fault(kind, 3, 2.0)
        assert sent == [(1, {"cmd": "netem", "direction": direction,
                             "policy": policy})]
        assert pool.metrics.count(f"{kind}s_applied") == 1
        with pytest.raises(ValueError, match="unknown net fault"):
            pool.apply_net_fault("netem_cut", 0)
    finally:
        pool.close()
