"""The port's traffic plane (``hetu_tpu_torch.traffic``) against hetu_tpu on
the CPU.

Held to the reference across the packages, exactly:

* traces: ``dumps_trace(synthesize(spec))`` is byte-identical for the same
  spec (one tenant; two bursting tenants; a CTR tenant; a diurnal period
  shorter than the trace; no tenant; the ``traffic`` phase's spec of
  ``chip_smoke.py``);
* the autoscaler: the port's ``Autoscaler`` and the reference's, fed the
  same script of canned ``fleet_metrics`` dumps on one fake clock (queue
  depths, shed counters, a tenant's TTFT histogram or a monitor's burn
  alerts, actuator failures, a warm successor restored midway), return
  the same decision record and export the same state after every tick.

Mirrored one by one: the 16 tests of ``tests/test_traffic.py`` (the
scheduler's on the port's engines at the reference's tiny GPT, V 97, H 64,
2 layers, its weights drawn with numpy in the reference's layout and
carried across by ``interop.params_from_jax``; token streams held to the
reference's engine on those weights), the burn-alert trigger and the lazy
monitor adoption of ``tests/test_health.py``, and the fast lane of
``tests/test_soak.py`` (a warm successor holds where a cold one repeats
the scale action).  Last, the real-process warm takeover of
``tests/test_soak.py``: a controller process autoscales, is SIGKILLed at
its ``SCALED up`` line, and a takeover hands the journaled state to a
successor loop that holds; it runs under a time limit of its own.
"""

import json
import signal
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from hetu_tpu import traffic as jax_traffic
from hetu_tpu.serve import PagedServeEngine as JaxPagedServeEngine
from hetu_tpu.serve import ContinuousBatchingScheduler as JaxScheduler
from hetu_tpu.serve import Request as JaxRequest
from hetu_tpu.serve import ServeEngine as JaxServeEngine
from hetu_tpu_torch import traffic
from hetu_tpu_torch.serve import (
    ContinuousBatchingScheduler, PagedServeEngine, Request,
)
from hetu_tpu_torch.serve import migrate as mg
from hetu_tpu_torch.traffic import (
    AutoscalePolicy, Autoscaler, TenantSpec, TraceSpec, ctr_submitter,
    diurnal_multiplier, dumps_trace, load_trace, replay, save_trace,
    synthesize,
)
from test_torch_gpt_serve import _jax_model as _jax_gpt
from test_torch_gpt_serve import _torch_model as _torch_gpt

torch.set_num_threads(2)

pytestmark = pytest.mark.traffic


# ---------------------------------------------------------------------------
# across the packages: trace bytes
# ---------------------------------------------------------------------------

_TRACE_CASES = {
    "one_tenant": dict(
        seed=3, duration_s=15.0, base_qps=5.0, diurnal_peak_x=4.0,
        tenants=[dict(name="solo", slo="gold", deadline_lo_s=1.0,
                      deadline_hi_s=3.0, max_tokens=12)]),
    "two_tenants_bursting": dict(
        seed=7, duration_s=20.0, base_qps=6.0, diurnal_peak_x=10.0,
        tenants=[dict(name="gold", share=0.3, slo="gold",
                      deadline_lo_s=8.0, deadline_hi_s=12.0,
                      burst_x=2.0, burst_on_s=1.0, burst_off_s=3.0),
                 dict(name="bronze", share=0.7, slo="bronze",
                      deadline_lo_s=1.0, deadline_hi_s=2.5, burst_x=3.0,
                      burst_on_s=1.5, burst_off_s=2.0)]),
    "ctr_tenant": dict(
        seed=11, duration_s=12.0, base_qps=8.0, diurnal_peak_x=3.0,
        dense_dim=5, fields=6, key_space=40,
        tenants=[dict(name="gold", share=0.25, slo="gold"),
                 dict(name="ctr", share=0.5, kind="ctr", slo="bronze",
                      deadline_lo_s=5.0, deadline_hi_s=8.0)]),
    "short_diurnal_period": dict(
        seed=5, duration_s=30.0, base_qps=3.0, diurnal_peak_x=6.0,
        diurnal_period_s=7.5, zipf_s=1.4, n_prompts=16,
        tenants=[dict(name="a", share=0.6, burst_x=2.5, burst_on_s=0.5,
                      burst_off_s=1.5),
                 dict(name="b", share=0.4, kind="ctr")]),
    "no_tenant": dict(seed=0, duration_s=8.0, base_qps=4.0),
}


def _spec_in(pkg, kw):
    kw = dict(kw)
    tenants = [pkg.TenantSpec(**t) for t in kw.pop("tenants", [])]
    return pkg.TraceSpec(**kw, tenants=tenants)


@pytest.mark.parametrize("case", sorted(_TRACE_CASES))
def test_trace_bytes_equal_the_references(case):
    kw = _TRACE_CASES[case]
    got = dumps_trace(synthesize(_spec_in(traffic, kw)))
    want = jax_traffic.dumps_trace(
        jax_traffic.synthesize(_spec_in(jax_traffic, kw)))
    assert got == want
    assert len(json.loads(got)["events"]) > 0


def test_chip_smoke_traffic_spec_bytes_equal_the_references():
    """The ``traffic`` phase's own spec (GPT-2-small's vocabulary, 64
    prompts of up to 64 tokens) gives the reference's bytes."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    port_spec = cs.traffic_spec(0, 7.25)
    kw = {**{k: getattr(port_spec, k) for k in (
        "seed", "duration_s", "base_qps", "diurnal_peak_x",
        "diurnal_period_s", "vocab", "n_prompts", "max_prompt_len",
        "zipf_s")},
        "tenants": [dict(vars(t)) for t in port_spec.tenants]}
    want = jax_traffic.dumps_trace(
        jax_traffic.synthesize(_spec_in(jax_traffic, kw)))
    assert dumps_trace(synthesize(port_spec)) == want


# ---------------------------------------------------------------------------
# across the packages: the autoscaler's decisions on canned dumps
# ---------------------------------------------------------------------------

class FakePool:
    """The pool surface an Autoscaler touches (``fleet_metrics``,
    ``revive_member``, ``drain_member``, ``n_members``, and the journal
    hook), over canned ``fleet_metrics`` dumps; records every actuation
    and journal write, and fails the next up or down when asked."""

    def __init__(self, n_members=4, dump=None):
        self.n_members = n_members
        self.dump = dict(dump or {})
        self.revived, self.drained, self.journaled = [], [], []
        self.fail_next = None
        self.health_monitor = None

    def fleet_metrics(self, *, scrape=True):
        outer = self

        class _Reg:
            def dump(self):
                return json.loads(json.dumps(outer.dump))
        return _Reg()

    def revive_member(self, slot):
        if self.fail_next == "up":
            self.fail_next = None
            raise RuntimeError("spawn failed")
        self.revived.append(slot)

    def drain_member(self, slot, close=False):
        if self.fail_next == "down":
            self.fail_next = None
            raise RuntimeError("drain failed")
        self.drained.append((slot, close))

    def journal_autoscaler(self, state, *, sync=False):
        self.journaled.append((dict(state), bool(sync)))


class _Monitor:
    def __init__(self):
        self.alerts = []

    def active_alerts(self):
        return [dict(a) for a in self.alerts]


_BUCKETS = [0.1, 0.5, 1.0, 2.5, 5.0]


def _script(seed=0, ticks=90):
    """[(dt, dump, fail, burning)]: a load that ramps to a spike and back,
    as the fleet registry would report it tick by tick (queue depth
    gauges of four members, cumulative submit/shed counters, the gold
    tenant's cumulative TTFT histogram), two actuator failures, and a
    burn alert over the spike."""
    g = np.random.default_rng(seed)
    submitted = shed = 0
    counts = [0] * (len(_BUCKETS) + 1)
    out = []
    for i in range(ticks):
        x = np.sin(np.pi * min(i / 55.0, 1.0)) ** 2  # 0 -> 1 -> 0, flat
        depth = {f"m{s}.queue_depth": {"type": "gauge", "value": round(
            float(max(6.0 * x + g.normal(0.0, 0.4), 0.0)), 2)}
            for s in range(4)}
        sub = int(g.integers(10, 60))
        submitted += sub
        shed += int(g.binomial(sub, 0.15 * x))
        hot = int(g.binomial(sub // 3, x))
        counts[1] += sub // 3 - hot
        counts[4] += hot
        dump = {**depth,
                "requests_submitted": {"type": "counter",
                                       "value": submitted},
                "requests_shed": {"type": "counter", "value": shed},
                "tenant.gold.ttft_s": {
                    "type": "histogram", "buckets": list(_BUCKETS),
                    "counts": list(counts), "count": sum(counts),
                    "sum": float(sum(counts))}}
        dt = float(g.choice([0.3, 0.3, 0.3, 0.9, 2.5]))
        fail = {3: "up", 52: "down"}.get(i)
        out.append((dt, dump, fail, 0.45 < x))
    return out


def _scalers(trigger, now, pools, monitors, state=None):
    pol = dict(min_members=1, max_members=4, interval_s=0.3,
               queue_high=2.0, queue_low=0.5, shed_high=0.02,
               shed_low=0.005, up_ticks=2, down_ticks=4,
               up_cooldown_s=1.0, down_cooldown_s=2.0)
    out = []
    for pkg, pool, mon in zip((traffic, jax_traffic), pools, monitors):
        kw = dict(clock=lambda: now[0], ttft_slos={"gold": 1.0})
        if trigger == "burn":
            kw["monitor"] = mon
        if state is None:
            kw["active"] = {0}
        else:
            kw["state"] = dict(state)
        out.append(pkg.Autoscaler(pool, pkg.AutoscalePolicy(**pol), **kw))
    return out


@pytest.mark.parametrize("trigger", ["ttft_p99", "burn"])
def test_autoscaler_decisions_equal_the_references_tick_for_tick(trigger):
    now = [0.0]
    pools = [FakePool(), FakePool()]
    monitors = [_Monitor(), _Monitor()]
    port, ref = _scalers(trigger, now, pools, monitors)
    script = _script()
    acts = []
    for i, (dt, dump, fail, burning) in enumerate(script):
        if i == 45:
            # the loop dies mid-spike; warm successors adopt its journal
            state = port.export_state()
            assert state == ref.export_state()
            port, ref = _scalers(trigger, now, pools, monitors, state=state)
            assert port.export_state() == ref.export_state()
        now[0] += dt
        for pool, mon in zip(pools, monitors):
            pool.dump = dump
            if fail is not None:  # armed until the next such actuation
                pool.fail_next = fail
            mon.alerts = [{"rule": "slo_burn.gold", "severity": "page",
                           "value": 20.0 + i, "labels": {"tenant": "gold"}},
                          {"rule": "van_failover", "value": 1.0,
                           "labels": {}}] if burning else []
        got, want = port.tick(), ref.tick()
        assert got == want, i
        acts.append(got["action"])
        assert port.export_state() == ref.export_state(), i
        assert pools[0].revived == pools[1].revived
        assert pools[0].drained == pools[1].drained
        assert pools[0].journaled == pools[1].journaled
    # the script moves the loop every way it can move
    assert {"hold", "up", "down", "up_failed", "down_failed"} == set(acts)
    assert port.actions_total == ref.actions_total >= 3


# ---------------------------------------------------------------------------
# mirrors of tests/test_traffic.py — loadgen
# ---------------------------------------------------------------------------

def _spec(**kw):
    base = dict(
        seed=7, duration_s=20.0, base_qps=6.0,
        tenants=[
            TenantSpec(name="gold", share=0.25, slo="gold",
                       deadline_lo_s=3.0, deadline_hi_s=5.0),
            TenantSpec(name="bronze", share=0.75, slo="bronze",
                       burst_x=3.0, burst_on_s=2.0, burst_off_s=4.0),
            TenantSpec(name="ctr", share=0.5, kind="ctr"),
        ])
    base.update(kw)
    return TraceSpec(**base)


def test_trace_bytes_stable_and_roundtrip(tmp_path):
    """Same spec, same BYTES — twice in-process and through disk."""
    a, b = synthesize(_spec()), synthesize(_spec())
    assert dumps_trace(a) == dumps_trace(b)
    p = tmp_path / "trace.json"
    save_trace(a, p)
    assert dumps_trace(load_trace(p)) == dumps_trace(a)
    assert dumps_trace(synthesize(_spec(seed=8))) != dumps_trace(a)
    p2 = tmp_path / "bad.json"
    p2.write_text(dumps_trace({**a, "version": 999}))
    with pytest.raises(ValueError, match="version"):
        load_trace(p2)


def test_per_tenant_rates_and_diurnal_integral():
    flat = synthesize(_spec(diurnal_peak_x=1.0))
    by = {}
    for ev in flat["events"]:
        by.setdefault(ev["tenant"], []).append(ev)
    assert 15 <= len(by["gold"]) <= 50
    assert len(by["bronze"]) > len(by["gold"])
    spiky = synthesize(_spec(diurnal_peak_x=10.0))
    assert len(spiky["events"]) > 2.5 * len(flat["events"])
    mid = [e for e in spiky["events"] if 7.5 <= e["t"] < 12.5]
    edge = [e for e in spiky["events"] if e["t"] < 2.5 or e["t"] >= 17.5]
    assert len(mid) > 2 * len(edge)
    assert diurnal_multiplier(10.0, peak_x=10.0, period_s=20.0) == \
        pytest.approx(10.0)
    assert diurnal_multiplier(0.0, peak_x=10.0, period_s=20.0) == \
        pytest.approx(1.0)
    for ev in flat["events"]:
        if ev["tenant"] == "gold":
            assert 3.0 <= ev["deadline_s"] <= 5.0
            assert ev["slo"] == "gold"
    assert all("sparse" in e and "dense" in e for e in by["ctr"])
    assert all("prompt" in e for e in by["gold"])


def test_zipf_popularity_is_skewed():
    t = synthesize(_spec(duration_s=60.0, base_qps=8.0, zipf_s=1.1))
    prompts = [tuple(e["prompt"]) for e in t["events"]
               if e["kind"] == "llm"]
    assert len(prompts) > 200
    counts = sorted((prompts.count(p) for p in set(prompts)),
                    reverse=True)
    assert counts[0] >= 5 * counts[len(counts) // 2]
    keys = [k for e in t["events"] if e["kind"] == "ctr"
            for k in e["sparse"]]
    kc = sorted((keys.count(k) for k in set(keys)), reverse=True)
    assert kc[0] >= 3 * kc[len(kc) // 2]


def test_replay_is_open_loop_on_a_fake_clock():
    trace = synthesize(_spec(duration_s=5.0))
    now = [100.0]
    issued = []

    def clock():
        return now[0]

    def sleep(dt):
        assert dt > 0
        now[0] += dt

    calls = [0]

    def submit(ev):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("pool said no")
        issued.append((now[0] - 100.0, ev["t"]))
        return {"ok": ev["t"]}

    out = replay(trace, submit, clock=clock, sleep=sleep)
    assert len(out) == len(trace["events"])
    assert sum(1 for _, h in out if isinstance(h, Exception)) == 1
    for issue_t, arrival_t in issued:
        assert issue_t == pytest.approx(arrival_t, abs=1e-6)
    now[0], issued[:], calls[0] = 100.0, [], -10**9
    replay(trace, submit, speed=2.0, clock=clock, sleep=sleep)
    for issue_t, arrival_t in issued:
        assert issue_t == pytest.approx(arrival_t / 2.0, abs=1e-6)
    with pytest.raises(ValueError):
        replay(trace, submit, speed=0.0, clock=clock, sleep=sleep)


def test_ctr_submitter_scores_the_traces_ctr_events():
    """The trace's CTR events through ``ctr_submitter`` into a CPU
    ``RecsysPool`` (a Wide & Deep at the trace's widths over a PS table
    of its key space): every handle resolves ok with a probability, each
    within 1e-6 of the same request scored alone on the same weights."""
    from hetu_tpu_torch.models import WideDeep
    from hetu_tpu_torch.ps.client import PSTable
    from hetu_tpu_torch.serve.recsys import (
        RecsysEngine, RecsysPool, RecsysRequest, ServingEmbeddingCache,
    )
    from hetu_tpu_torch.telemetry.registry import MetricsRegistry

    spec = _spec(duration_s=3.0)
    trace = synthesize(spec)
    ctr = [e for e in trace["events"] if e["kind"] == "ctr"]
    assert ctr
    model = WideDeep(spec.fields, 8, spec.dense_dim, hidden=(16,),
                     generator=torch.Generator().manual_seed(0),
                     device="cpu")
    table = PSTable(spec.key_space, 8, init="normal", seed=1)

    def factory():
        return RecsysEngine(model, ServingEmbeddingCache(
            table, 32, registry=MetricsRegistry()), max_batch=16,
            min_bucket=4, device="cpu")

    pool = RecsysPool({"a": factory, "b": factory}, start_poll=False)
    try:
        out = replay({"events": ctr}, ctr_submitter(pool),
                     clock=lambda: 0.0, sleep=lambda dt: None)
        assert len(out) == len(ctr)
        alone = factory()
        for ev, (_, h) in zip(ctr, out):
            assert isinstance(h, RecsysRequest), h
            assert h.done.wait(60.0) and h.status == "ok", h.status
            assert 0.0 < h.score < 1.0
            want = alone.score(np.asarray([ev["dense"]], np.float32),
                               np.asarray([ev["sparse"]], np.int64))[0]
            assert abs(h.score - float(want)) <= 1e-6
            assert h.timeout_s == ev["deadline_s"]
        assert pool.metrics.count("pool_requests") == len(ctr)
    finally:
        pool.close()


# ---------------------------------------------------------------------------
# mirrors of tests/test_traffic.py — SLO classes on the port's scheduler
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gpt():
    """(JAX model, JAX variables, the port's model): the reference's tiny
    GPT, one numpy draw in the reference's layout in both packages."""
    jm, jv = _jax_gpt("xla")
    return jm, jv, _torch_gpt("xla")


def _pump(sch, max_steps=400):
    for _ in range(max_steps):
        if not sch.has_work():
            return
        sch.step()
    raise AssertionError("scheduler did not drain")


def _admission_order(reqs):
    assert all(r.first_token_at is not None for r in reqs)
    return [r.tenant for r in
            sorted(reqs, key=lambda r: r.first_token_at)]


def _paged(pkg, gpt, **kw):
    jm, jv, tm = gpt
    kw.setdefault("max_len", 64)
    kw.setdefault("page_size", 8)
    if pkg == "port":
        return PagedServeEngine(tm, device="cpu", **kw)
    return JaxPagedServeEngine(jm, jv, **kw)


def _run_classes(pkg, gpt, prompts, labels, slo_classes, num_slots=1):
    """Submit ``prompts`` tagged ``labels`` (tenant, slo) in order into
    one scheduler of ``pkg``; returns (admission order, token streams)."""
    sched_cls, req_cls = (ContinuousBatchingScheduler, Request) \
        if pkg == "port" else (JaxScheduler, JaxRequest)
    sch = sched_cls(_paged(pkg, gpt, num_slots=num_slots),
                    slo_classes=slo_classes)
    reqs = [req_cls(prompt=list(p), max_tokens=2, tenant=t, slo=s)
            for p, (t, s) in zip(prompts, labels)]
    for r in reqs:
        sch.submit(r)
    _pump(sch)
    assert all(r.status == "ok" for r in reqs)
    return _admission_order(reqs), [list(r.tokens) for r in reqs]


def _both(gpt, prompts, labels, slo_classes):
    got = _run_classes("port", gpt, prompts, labels, slo_classes)
    want = _run_classes("jax", gpt, prompts, labels, slo_classes)
    assert got == want  # the same admissions, the same tokens
    return got[0]


def test_priority_admission_strict_tiering(gpt):
    g = np.random.default_rng(31)
    prompts = [[int(t) for t in g.integers(1, 97, 5)] for _ in range(6)]
    labels = [(f"{s}{i}", s) for i, s in
              enumerate(["bronze"] * 3 + ["gold"] * 3)]
    order = _both(gpt, prompts, labels,
                  {"gold": {"priority": 2, "weight": 1.0},
                   "bronze": {"priority": 0, "weight": 1.0}})
    assert [t[:4] for t in order] == ["gold"] * 3 + ["bron"] * 3
    fifo = _both(gpt, prompts, labels, None)
    assert [t[:4] for t in fifo] == ["bron"] * 3 + ["gold"] * 3


def test_wfq_interleaves_flows_within_a_tier(gpt):
    g = np.random.default_rng(33)
    tenants = ("a", "a", "a", "a", "b", "b", "b", "b")
    prompts = [[int(t) for t in g.integers(1, 97, 5)] for _ in tenants]
    order = _both(gpt, prompts, [(t, "std") for t in tenants],
                  {"std": {"priority": 0, "weight": 1.0}})
    assert order == ["a", "b", "a", "b", "a", "b", "a", "b"]


def test_wfq_weights_split_admissions_proportionally(gpt):
    g = np.random.default_rng(34)
    slos = ("lo",) * 4 + ("hi",) * 4
    prompts = [[int(t) for t in g.integers(1, 97, 5)] for _ in slos]
    order = _both(gpt, prompts, [(s, s) for s in slos],
                  {"hi": {"priority": 0, "weight": 2.0},
                   "lo": {"priority": 0, "weight": 1.0}})
    first6 = order[:6]
    assert first6.count("hi") == 4 and first6.count("lo") == 2


def test_shed_projection_counts_only_same_or_higher_tier(gpt):
    engine = _paged("port", gpt, num_slots=1)
    sch = ContinuousBatchingScheduler(
        engine, shed=True,
        slo_classes={"gold": {"priority": 2, "weight": 1.0},
                     "bronze": {"priority": 0, "weight": 1.0}})
    sch._ewma_service_s = 1.0
    g = np.random.default_rng(35)

    def mk(slo):
        return Request(prompt=[int(t) for t in g.integers(1, 97, 5)],
                       max_tokens=2, tenant=slo, slo=slo, timeout_s=4.0)

    shed_bronze = 0
    for _ in range(10):
        if sch.submit(mk("bronze")).status == "shed":
            shed_bronze += 1
    assert shed_bronze >= 1
    gold = sch.submit(mk("gold"))
    assert gold.status != "shed" and gold.state == "queued"
    assert sch.submit(mk("bronze")).status == "shed"
    sch.drain()


# ---------------------------------------------------------------------------
# mirrors of tests/test_traffic.py — preemption and prefix re-dedup
# ---------------------------------------------------------------------------

def _oracle(gpt, prompts, n):
    """The reference's oracle: its slot engine, one request at a time, on
    the same weights."""
    jm, jv, _ = gpt
    out = []
    for p in prompts:
        e = JaxServeEngine(jm, jv, num_slots=1, max_len=64)
        slot = e.alloc_slot()
        toks = [e.prefill(slot, p)]
        for _ in range(n - 1):
            toks.append(e.decode()[slot])
        e.release(slot)
        out.append(toks)
    return out


@pytest.mark.migrate
@pytest.mark.paged
def test_adopted_overcommit_preempts_and_requeues_not_raises(gpt):
    g = np.random.default_rng(41)
    prompts = [[int(t) for t in g.integers(1, 97, 10)] for _ in range(3)]
    want = _oracle(gpt, prompts, 24)
    src = ContinuousBatchingScheduler(_paged("port", gpt, num_slots=3))
    reqs = [Request(prompt=list(p), max_tokens=24) for p in prompts]
    for r in reqs:
        src.submit(r)
    for _ in range(3):
        src.step()
    dst = ContinuousBatchingScheduler(_paged(
        "port", gpt, num_slots=3, num_pages=9, prefix_sharing=False))
    mg.migrate_inflight(src, dst)
    _pump(dst)
    assert [r.tokens for r in reqs] == want
    assert all(r.status == "ok" for r in reqs)
    assert dst.metrics.count("requests_preempted") >= 1


@pytest.mark.migrate
@pytest.mark.paged
def test_adopt_reindexes_prefix_for_future_sharing(gpt):
    g = np.random.default_rng(43)
    prefix = [int(t) for t in g.integers(1, 97, 16)]
    src = ContinuousBatchingScheduler(_paged("port", gpt, num_slots=2))
    moved = Request(prompt=prefix + [3, 5], max_tokens=12)
    src.submit(moved)
    for _ in range(3):
        src.step()
    dst = ContinuousBatchingScheduler(_paged("port", gpt, num_slots=2))
    mg.migrate_inflight(src, dst)
    assert dst.metrics.count("prefix_reindexed") >= 2
    follower = Request(prompt=prefix + [7, 9], max_tokens=6)
    dst.submit(follower)
    _pump(dst)
    assert moved.status == "ok" and follower.status == "ok"
    assert dst.engine.cache.prefix_hit_tokens >= 16
    assert moved.tokens == _oracle(gpt, [prefix + [3, 5]], 12)[0]
    assert follower.tokens == _oracle(gpt, [prefix + [7, 9]], 6)[0]


# ---------------------------------------------------------------------------
# mirrors of tests/test_traffic.py — the autoscaler on a fake pool
# ---------------------------------------------------------------------------

def _gauge(v):
    return {"type": "gauge", "value": float(v)}


def _counter(v):
    return {"type": "counter", "value": int(v)}


def _mk(policy=None, **kw):
    pool = FakePool()
    now = [0.0]
    pol = policy or AutoscalePolicy(
        min_members=1, max_members=3, queue_high=4.0, queue_low=0.5,
        shed_high=0.02, shed_low=0.001, up_ticks=2, down_ticks=3,
        up_cooldown_s=5.0, down_cooldown_s=10.0)
    sc = Autoscaler(pool, pol, clock=lambda: now[0], active={0}, **kw)
    return pool, sc, now


def test_autoscaler_up_needs_streak_then_cooldown():
    pool, sc, now = _mk()
    pool.dump = {"m0.queue_depth": _gauge(9.0)}
    assert sc.tick()["action"] == "hold"
    now[0] += 1
    assert sc.tick()["action"] == "up"
    assert pool.revived == [1] and sc.active == {0, 1}
    now[0] += 1
    sc.tick()
    now[0] += 1
    assert pool.revived == [1]
    now[0] += 10
    assert sc.tick()["action"] == "up"
    assert pool.revived == [1, 2] and sc.active == {0, 1, 2}
    for _ in range(10):
        now[0] += 10
        sc.tick()
    assert len(sc.active) == 3 and pool.revived == [1, 2]
    assert sc.scale_ups == 2


def test_autoscaler_down_is_slow_bounded_and_picks_idle_victim():
    pool, sc, now = _mk()
    sc.active = {0, 1, 2}
    pool.dump = {"m0.queue_depth": _gauge(0.5),
                 "m1.queue_depth": _gauge(0.0),
                 "m2.queue_depth": _gauge(0.1)}
    for _ in range(2):
        now[0] += 1
        assert sc.tick()["action"] == "hold"
    now[0] += 1
    rec = sc.tick()
    assert rec["action"] == "down" and rec["slot"] == 1
    assert pool.drained == [(1, True)] and sc.active == {0, 2}
    for _ in range(3):
        now[0] += 1
        sc.tick()
    assert len(pool.drained) == 1
    now[0] += 20
    for _ in range(4):
        now[0] += 1
        sc.tick()
    assert sc.active == {0}
    for _ in range(6):
        now[0] += 10
        sc.tick()
    assert len(sc.active) == 1 and sc.scale_downs == 2


def test_autoscaler_shed_rate_is_windowed_counter_deltas():
    pool, sc, now = _mk()
    pool.dump = {"requests_submitted": _counter(100),
                 "requests_shed": _counter(0),
                 "m0.queue_depth": _gauge(0.0)}
    sc.tick()
    pool.dump = {"requests_submitted": _counter(200),
                 "requests_shed": _counter(50),
                 "m0.queue_depth": _gauge(0.0)}
    now[0] += 1
    rec = sc.tick()
    assert rec["shed_rate"] == pytest.approx(0.5)
    now[0] += 10
    rec = sc.tick()
    assert rec["shed_rate"] == 0.0


def test_autoscaler_slo_breach_scales_up_with_named_reason():
    pool, sc, now = _mk(ttft_slos={"gold": 0.5})
    hist = {"type": "histogram", "buckets": [0.1, 1.0, 5.0],
            "counts": [0, 0, 20], "sum": 40.0, "count": 20}
    pool.dump = {"tenant.gold.ttft_s": dict(hist),
                 "m0.queue_depth": _gauge(0.0)}
    rec = sc.tick()
    assert rec["slo_breaches"].get("gold") == pytest.approx(5.0)
    now[0] += 1
    rec = sc.tick()
    assert rec["slo_breaches"] == {}
    pool.dump["tenant.gold.ttft_s"] = {**hist, "counts": [0, 0, 45],
                                       "count": 45}
    now[0] += 1
    rec = sc.tick()
    now[0] += 1
    pool.dump["tenant.gold.ttft_s"] = {**hist, "counts": [0, 0, 70],
                                       "count": 70}
    rec = sc.tick()
    assert rec["action"] == "up" and rec["reason"] == "slo_breach:gold"
    assert pool.revived == [1]


def test_autoscaler_actuator_failure_keeps_bookkeeping_honest():
    pool, sc, now = _mk()
    pool.dump = {"m0.queue_depth": _gauge(9.0)}
    pool.fail_next = "up"
    sc.tick()
    now[0] += 1
    rec = sc.tick()
    assert rec["action"] == "up_failed" and "spawn failed" in rec["error"]
    assert sc.active == {0}
    now[0] += 10
    assert sc.tick()["action"] == "up"


def test_autoscaler_bounds_validated_against_pool_geometry():
    pool = FakePool(n_members=2)
    with pytest.raises(ValueError, match="exceeds"):
        Autoscaler(pool, AutoscalePolicy(min_members=1, max_members=3))
    with pytest.raises(ValueError, match="min_members"):
        Autoscaler(pool, AutoscalePolicy(min_members=0, max_members=2))
    with pytest.raises(ValueError, match="max_members"):
        Autoscaler(pool, AutoscalePolicy(min_members=2, max_members=1))


def test_scale_actions_record_traffic_scale_spans():
    """Each action is a ``traffic.scale`` span (cat ``traffic``) with its
    reason, and bumps ``autoscale_up`` / ``autoscale_down`` on the pool's
    metrics."""
    from hetu_tpu_torch.serve.metrics import ServeMetrics
    from hetu_tpu_torch.telemetry import trace

    pool, sc, now = _mk()
    pool.metrics = ServeMetrics()
    tracer = trace.enable()
    try:
        pool.dump = {"m0.queue_depth": _gauge(9.0)}
        sc.tick()
        now[0] += 1
        sc.tick()
        pool.dump = {"m0.queue_depth": _gauge(0.0),
                     "m1.queue_depth": _gauge(0.0)}
        for _ in range(4):
            now[0] += 20
            sc.tick()
    finally:
        trace.disable()
    spans = [e for e in tracer.events
             if e.get("ph") == "X" and e["name"] == "traffic.scale"]
    assert [(e["args"]["action"], e["args"]["reason"], e["cat"])
            for e in spans] == [("up", "queue_depth", "traffic"),
                                ("down", "idle", "traffic")]
    assert pool.metrics.count("autoscale_up") == 1
    assert pool.metrics.count("autoscale_down") == 1


# ---------------------------------------------------------------------------
# mirrors of tests/test_health.py — the burn-alert trigger
# ---------------------------------------------------------------------------

def test_autoscaler_scales_up_on_burn_alert_with_named_reason():
    pool, mon, now = FakePool(n_members=2), _Monitor(), [0.0]
    sc = Autoscaler(
        pool, AutoscalePolicy(min_members=1, max_members=2, up_ticks=2,
                              up_cooldown_s=0.0, queue_high=1e9,
                              shed_high=1e9),
        active={0}, clock=lambda: now[0], monitor=mon)
    assert sc.tick()["action"] == "hold"
    mon.alerts = [{"rule": "slo_burn.gold", "severity": "page",
                   "value": 40.0, "threshold": 14.4, "since": 0.0,
                   "labels": {"tenant": "gold"},
                   "fault_kinds": ("netem_degrade",)},
                  {"rule": "van_failover", "severity": "page",
                   "value": 1.0, "threshold": 0.0, "since": 0.0,
                   "labels": {}, "fault_kinds": ("van_kill",)}]
    now[0] = 1.0
    assert sc.tick()["action"] == "hold"
    now[0] = 2.0
    rec = sc.tick()
    assert rec["action"] == "up"
    assert rec["reason"] == "slo_burn:gold"
    assert rec["slo_breaches"] == {"gold": 40.0}
    assert pool.revived == [1]
    mon.alerts = []
    now[0] = 3.0
    assert sc.tick()["action"] == "hold"


def test_autoscaler_adopts_pool_health_monitor_lazily():
    pool = FakePool(n_members=2)
    sc = Autoscaler(pool, AutoscalePolicy(min_members=1, max_members=2),
                    active={0}, clock=lambda: 0.0)
    assert sc.read_signals({}).burn_driven is False
    pool.health_monitor = _Monitor()
    sig = sc.read_signals({})
    assert sig.burn_driven is True and sig.slo_breaches == {}


# ---------------------------------------------------------------------------
# mirror of tests/test_soak.py's fast lane — warm vs cold successor
# ---------------------------------------------------------------------------

_OVERLOADED = {"m0.queue_depth": {"type": "gauge", "value": 9.0}}

_POL = AutoscalePolicy(min_members=1, max_members=3, queue_high=4.0,
                       queue_low=0.5, shed_high=0.5, shed_low=0.001,
                       up_ticks=2, down_ticks=3,
                       up_cooldown_s=600.0, down_cooldown_s=600.0)


def test_autoscaler_warm_takeover_holds_where_cold_duplicates():
    now = [0.0]
    pool1 = FakePool(3, _OVERLOADED)
    sc1 = Autoscaler(pool1, _POL, clock=lambda: now[0], active={0})
    assert sc1.tick()["action"] == "hold"
    now[0] += 1.0
    assert sc1.tick()["action"] == "up"
    assert pool1.revived == [1]
    assert pool1.journaled, "every tick must journal"
    state, sync = pool1.journaled[-1]
    assert sync  # an action tick journals synchronously
    assert state["actions"] == 1 and state["active"] == [0, 1]

    now[0] += 2.0
    pool2 = FakePool(3, _OVERLOADED)
    warm = Autoscaler(pool2, _POL, clock=lambda: now[0], state=state)
    assert warm.active == {0, 1}
    assert warm.actions_total == 1
    for _ in range(3):
        now[0] += 1.0
        assert warm.tick()["action"] == "hold"
    assert pool2.revived == [] and warm.actions_total == 1

    pool3 = FakePool(3, _OVERLOADED)
    cold = Autoscaler(pool3, _POL, clock=lambda: now[0], active={0, 1})
    cold.tick()
    now[0] += 1.0
    assert cold.tick()["action"] == "up"
    assert pool3.revived == [2]


# ---------------------------------------------------------------------------
# the real-process warm takeover (tests/test_soak.py's controller kill)
# ---------------------------------------------------------------------------

TAKEOVER_LIMIT_S = 150.0
TINY = {"vocab_size": 89, "hidden_size": 48, "num_layers": 2,
        "num_heads": 4, "ffn_size": 96, "max_position": 64,
        "num_slots": 4, "max_len": 48, "min_bucket": 8, "seed": 1,
        "device": "cpu"}
MEMBER_ENV = {"OMP_NUM_THREADS": "1"}
_SOAK_POLICY = {"min_members": 1, "max_members": 3, "queue_high": 0.0,
                "queue_low": -1.0, "shed_high": 2.0, "shed_low": -1.0,
                "up_ticks": 1, "down_ticks": 99,
                "up_cooldown_s": 600.0, "down_cooldown_s": 600.0}


@pytest.mark.crosshost
def test_controller_kill_after_autoscale_resumes_warm(tmp_path):
    """A controller process over a van process of its own parks slots 1
    and 2, ticks an always-overloaded autoscaler once (a journaled scale
    up: slot 1 revived) and is SIGKILLed once its log says ``SCALED up``;
    ``takeover`` replays the journaled state (one action, active [0, 1])
    and an ``Autoscaler`` over the taken-over pool adopts it and holds
    inside the journaled cooldown.  Every wait draws on one deadline."""
    from hetu_tpu_torch.resilience.shardproc import (
        free_port, spawn_module, spawn_shard_server,
    )
    from hetu_tpu_torch.serve.crosshost import CrossProcessServingPool

    limit = time.monotonic() + TAKEOVER_LIMIT_S

    def left():
        rest = limit - time.monotonic()
        assert rest > 0, f"over the test's {TAKEOVER_LIMIT_S} s limit"
        return rest

    van = spawn_shard_server(tmp_path, free_port(), "van")
    port = int(van.ready[0])
    cfg = {"workdir": str(tmp_path), "port": port, "n_members": 3,
           "model": TINY, "n_requests": 0, "hold_s": 600.0,
           "lease_s": 1.0, "suspect_grace_s": 1.0,
           "member_env": MEMBER_ENV,
           "autoscale": {"park": [1, 2], "active": [0],
                         "policy": _SOAK_POLICY, "ticks": 1}}
    path = Path(tmp_path) / "controller.json"
    path.write_text(json.dumps(cfg))
    ctrl = spawn_module(tmp_path, "controller",
                        "hetu_tpu_torch.serve.crosshost",
                        ["--controller", str(path)], extra_env=MEMBER_ENV,
                        timeout_s=left())
    pool = None
    try:
        while "SCALED up" not in ctrl.log_path.read_text():
            assert ctrl.poll() is None, ctrl.log_path.read_text()[-2000:]
            left()
            time.sleep(0.05)
        log = ctrl.log_path.read_text()
        assert "READY jax=0" in log and "SCALED up 1" in log
        ctrl.send_signal(signal.SIGKILL)
        ctrl.wait(left())
        pool = CrossProcessServingPool.takeover(
            workdir=tmp_path, port=port, lease_s=1.0, suspect_grace_s=1.0,
            spawn_timeout_s=left())
        st = pool.takeover_report["autoscaler_state"]
        assert st is not None, pool.takeover_report
        assert st["actions"] == 1 and st["active"] == [0, 1], st
        assert pool.autoscaler_state() == st
        sc = Autoscaler(pool, AutoscalePolicy(**_SOAK_POLICY))
        assert sc.active == {0, 1}
        assert sc.actions_total == 1
        rec = sc.tick()
        assert rec["action"] == "hold", rec
        assert sc.actions_total == 1
        # the successor's hold went into the ledger too: the pool's record
        # is the successor's state now
        assert pool.autoscaler_state()["active"] == [0, 1]
        left()
    finally:
        if pool is not None:
            pool.close()
        if ctrl.poll() is None:
            ctrl.kill()
            ctrl.wait()
        van.kill()
        van.wait()
