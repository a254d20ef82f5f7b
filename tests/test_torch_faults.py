"""The port's fault injection (``hetu_tpu_torch.resilience.faults``)
against hetu_tpu's, on the CPU.

The replay contract: ``FaultSchedule.generate`` draws from
``np.random.default_rng(seed)`` in the reference's order, so for the same
seed and keyword arguments the port's ``to_json`` is byte-identical to the
reference's, for every family of kinds that ``tests/test_resilience.py``
extends the draw with (the base kinds, the process, network, pipeline,
control-plane, durable-tier and campaign kinds), the frozen bytes and
``schedule_id`` included; the sequential campaign's draws too.

The injector: its van hook arms one-shot delays and errors on the port's
own van (``hetu_tpu_torch.ps.van``) and restores the previous hook; the
data fault raises once; the NaN fault poisons the first floating leaf of
a batch of torch tensors or numpy arrays (a copy; dict keys in sorted
order, as the reference's pytree walk visits them) and counts as the
reference does; serve, network and campaign events queue for their
chaos loops; process faults signal the live process of a slot.
"""

import subprocess
import sys
import time
from collections import namedtuple

import numpy as np
import pytest
import torch

from hetu_tpu.resilience import faults as jax_faults
from hetu_tpu_torch.ps import van
from hetu_tpu_torch.resilience import (
    KINDS, FaultEvent, FaultInjector, FaultSchedule,
    SequentialFaultCampaign, TransientDataError, TransientFault,
)
from hetu_tpu_torch.telemetry import trace

# each family of kinds as tests/test_resilience.py draws it: the keyword
# arguments of the schedule before the family existed, then the family's
_BASE = dict(steps=50, seed=7, van_errors=2, kill_shards=1, n_shards=2,
             serve_preempts=1, n_members=2)
_PROC = dict(member_kills=1, member_suspends=1, worker_proc_kills=1,
             n_workers=3)
_NET = dict(netem_partitions=1, netem_partition_s=0.8, netem_degrades=1,
            stragglers=1, straggler_s=1.5)
_STAGE = dict(stage_kills=1, stage_slows=1, stage_slow_s=2.5, n_stages=3)
_CTRL = dict(controller_kills=1, controller_suspends=1,
             controller_suspend_s=1.5, n_controllers=1)
_VAN = dict(van_kills=1, van_suspends=1, van_suspend_s=2.5, n_vans=2)
_CAMP = dict(van_resilver_kills=1, controller_mid_failover_kills=1,
             member_mid_resilver_kills=1)
FAMILIES = {
    "base": dict(steps=60, seed=7, van_errors=2, van_delays=1,
                 data_errors=2, nan_steps=1, kill_shards=1, n_shards=2),
    "frozen": dict(steps=50, seed=7, van_errors=2, van_delays=1,
                   data_errors=1, nan_steps=1, kill_shards=1,
                   suspend_shards=1, n_shards=2, preempt_at=40,
                   worker_losses=1, worker_joins=1, n_workers=3,
                   serve_preempts=1, serve_engine_kills=1, n_members=2),
    "process": {**_BASE, **_PROC},
    "network": {**_BASE, **_PROC, **_NET},
    "stage": {**_BASE, **_PROC, **_NET, **_STAGE},
    "controller": {**_BASE, **_PROC, **_NET, **_STAGE, **_CTRL},
    "van": {**_BASE, **_PROC, **_NET, **_STAGE, **_CTRL, **_VAN},
    "campaign": {**_BASE, **_PROC, **_NET, **_STAGE, **_CTRL, **_VAN,
                 **_CAMP},
    "pool_chaos": dict(steps=6, seed=3, serve_preempts=1,
                       serve_engine_kills=1, n_members=3),
    "elastic": dict(steps=4, seed=1, worker_losses=3, worker_joins=3,
                    n_workers=5),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("seed_shift", [0, 1, 13])
def test_schedule_bytes_equal_the_references(family, seed_shift):
    kw = dict(FAMILIES[family])
    kw["seed"] += seed_shift
    got = FaultSchedule.generate(**kw)
    want = jax_faults.FaultSchedule.generate(**kw)
    assert got.to_json() == want.to_json()
    assert got.schedule_id == want.schedule_id
    assert len(got) == len(want)
    back = FaultSchedule.from_json(want.to_json())
    assert back.to_json() == want.to_json()
    assert [tuple(e.__dict__.values()) for e in got.events] == \
        [tuple(e.__dict__.values()) for e in want.events]


def test_schedule_frozen_bytes_and_id():
    s = FaultSchedule.generate(**FAMILIES["frozen"])
    assert s.to_json() == (
        '[[1,"serve_preempt",0.0,0.0],[3,"suspend_shard",0.0,0.3],'
        '[14,"worker_loss",2.0,0.0],[29,"data_error",0.0,0.0],'
        '[31,"van_error",0.0,0.0],[39,"nan_grad",0.0,0.0],'
        '[40,"preempt",0.0,0.0],[41,"kill_shard",0.0,0.0],'
        '[41,"serve_engine_kill",0.0,0.0],[44,"van_delay",0.02,0.0],'
        '[46,"van_error",0.0,0.0],[46,"worker_join",2.0,0.0]]')
    assert s.schedule_id == "3ecb3f71"


def test_new_families_draw_after_every_earlier_kind():
    """Each family's extension leaves the earlier kinds' events as they
    were: the same events, plus the new ones."""
    order = ["process", "network", "stage", "controller", "van",
             "campaign"]
    prev = FaultSchedule.generate(**_BASE)
    for fam in order:
        grown = FaultSchedule.generate(**FAMILIES[fam])
        old = {e.kind for e in prev.events}
        assert [e for e in grown.events if e.kind in old] == prev.events
        prev = grown


def test_kinds_and_validation_match_the_reference():
    assert KINDS == jax_faults.KINDS
    s = FaultSchedule([FaultEvent(3, "nan_grad"), FaultEvent(3, "van_error"),
                       FaultEvent(5, "preempt")])
    assert {e.kind for e in s.at(3)} == {"nan_grad", "van_error"}
    assert s.at(4) == []
    with pytest.raises(ValueError):
        FaultSchedule([FaultEvent(1, "explode_datacenter")])


def test_sequential_campaign_draws_equal_the_references():
    a = SequentialFaultCampaign(seed=11, rounds=5, n_victims=2)
    ref = jax_faults.SequentialFaultCampaign(seed=11, rounds=5, n_victims=2)
    assert a.to_json() == ref.to_json()
    assert a.campaign_id == ref.campaign_id
    kind, victim = a.draw()
    assert (kind, victim) == a.draws[0]
    with pytest.raises(ValueError):
        a.draw()  # previous round still in flight
    a.complete(ok=True, recovery_s=0.5)
    with pytest.raises(ValueError):
        a.complete(ok=True)  # nothing in flight
    while not a.exhausted:
        a.draw()
        a.complete(ok=True, recovery_s=0.1)
    with pytest.raises(IndexError):
        a.draw()
    rep = a.report()
    assert rep["rounds_survived"] == rep["rounds_total"] == 5
    with pytest.raises(ValueError):
        SequentialFaultCampaign(seed=1, rounds=1, kinds=("nope",))


def test_injector_van_hook_arms_and_restores():
    """The hook rides the port's van: a delay, then an error, then
    nothing; uninstall puts the previous hook back."""
    seen = []
    prev = van.set_fault_hook(seen.append)
    sched = FaultSchedule([FaultEvent(0, "van_delay", 0.05),
                           FaultEvent(0, "van_error")])
    inj = FaultInjector(sched).install()
    try:
        inj.on_step(0)
        t0 = time.perf_counter()
        van._maybe_inject("blob_put")  # consumes the delay
        assert time.perf_counter() - t0 >= 0.04
        with pytest.raises(TransientFault):
            van._maybe_inject("blob_put")
        assert isinstance(TransientFault("x"), ConnectionError)
        van._maybe_inject("blob_get")  # nothing armed: the previous hook
        assert seen == ["blob_get"]
        assert inj.counters["van_delays_injected"] == 1
        assert inj.counters["van_errors_injected"] == 1
        assert inj.counters["faults_injected"] == 2
    finally:
        inj.uninstall()
        van.set_fault_hook(prev)
    van.set_fault_hook(None)
    try:
        van._maybe_inject("blob_put")  # no hook: a no-op
    finally:
        van.set_fault_hook(prev)


def test_data_fault_raises_once_then_the_retry_succeeds():
    inj = FaultInjector(FaultSchedule([FaultEvent(1, "data_error")]))
    calls = []
    fn = inj.wrap_batch_fn(lambda i: calls.append(i) or i)
    assert fn(0) == 0
    inj.on_step(1)
    with pytest.raises(TransientDataError):
        fn(1)
    assert fn(1) == 1  # the retry
    assert calls == [0, 1]
    assert inj.counters["data_errors_injected"] == 1


Pair = namedtuple("Pair", "ids x")

# batches of each shape the walk meets, numpy leaves only, so the
# reference's jax walk reads the same values
NP_BATCHES = {
    "dict": lambda: {"ids": np.arange(3), "x": np.ones((2, 2), np.float32)},
    "sorted_keys": lambda: {"z": np.ones(2, np.float32),
                            "a": np.zeros(3, np.float64)},
    "nested": lambda: ({"y": np.arange(4)},
                       [None, np.full((2,), 2.0, np.float32)]),
    "namedtuple": lambda: Pair(np.arange(2), np.ones((3,), np.float32)),
    "no_float": lambda: {"ids": np.arange(3), "mask": np.ones(2, bool)},
}


def _nan_mask(tree):
    if isinstance(tree, dict):
        return {k: _nan_mask(v) for k, v in sorted(tree.items())}
    if isinstance(tree, (list, tuple)):
        return [_nan_mask(v) for v in tree]
    if tree is None:
        return None
    a = np.asarray(tree.numpy() if isinstance(tree, torch.Tensor) else tree)
    return np.isnan(a).tolist() if np.issubdtype(a.dtype, np.floating) \
        else None


@pytest.mark.parametrize("name", sorted(NP_BATCHES))
def test_nan_fault_poisons_the_references_leaf(name):
    sched = [FaultEvent(2, "nan_grad")]
    got_inj = FaultInjector(FaultSchedule(sched))
    ref_inj = jax_faults.FaultInjector(jax_faults.FaultSchedule(sched))
    assert got_inj.corrupt_batch(1, NP_BATCHES[name]()) is not None
    got_inj.on_step(2)
    ref_inj.on_step(2)
    batch = NP_BATCHES[name]()
    got = got_inj.corrupt_batch(2, batch)
    want = ref_inj.corrupt_batch(2, NP_BATCHES[name]())
    assert _nan_mask(got) == _nan_mask(want)
    assert dict(got_inj.counters) == dict(ref_inj.counters)
    assert _nan_mask(batch) == _nan_mask(NP_BATCHES[name]())  # a copy
    if name == "namedtuple":
        assert isinstance(got, Pair)
    # one-shot: the next batch passes untouched
    again = NP_BATCHES[name]()
    assert got_inj.corrupt_batch(3, again) is again


def test_nan_fault_on_torch_tensors_keeps_type_and_copies():
    inj = FaultInjector(FaultSchedule([FaultEvent(1, "nan_grad")]))
    inj.on_step(1)
    x = torch.ones(2, 3).t()  # a non-contiguous view
    batch = {"ids": torch.arange(4), "x": x, "y": torch.zeros(2)}
    out = inj.corrupt_batch(1, batch)
    assert isinstance(out["x"], torch.Tensor)
    assert out["x"].shape == x.shape and out["x"].dtype == x.dtype
    assert torch.isnan(out["x"]).sum() == 1
    assert bool(torch.isnan(out["x"].reshape(-1)[0]))
    assert not torch.isnan(x).any()  # the caller's tensor is untouched
    assert out["ids"] is batch["ids"] and out["y"] is batch["y"]
    assert inj.counters["nan_injected"] == 1
    inj2 = FaultInjector(FaultSchedule([FaultEvent(1, "nan_grad")]))
    inj2.on_step(1)
    ints = (torch.arange(3), [torch.ones(2, dtype=torch.int32)])
    assert inj2.corrupt_batch(1, ints) is ints
    assert inj2.counters["nan_skipped_no_float_leaf"] == 1


def test_serve_net_and_campaign_events_queue_for_their_loops():
    sched = FaultSchedule([
        FaultEvent(1, "serve_preempt", 2.0),
        FaultEvent(1, "serve_engine_kill", 0.0),
        FaultEvent(2, "netem_partition", 1.0, 0.8),
        FaultEvent(2, "straggler", 0.0, 1.5),
        FaultEvent(3, "van_resilver_kill", 0.0),
        FaultEvent(3, "member_kill_mid_resilver", 1.0),
        FaultEvent(4, "worker_loss", 1.0),
        FaultEvent(4, "worker_join", 1.0)])
    tracer = trace.enable()
    try:
        inj = FaultInjector(sched)
        for step in range(1, 5):
            inj.on_step(step)
    finally:
        trace.disable()
    assert inj.pop_serve_events() == [("serve_engine_kill", 0),
                                      ("serve_preempt", 2)]
    assert inj.pop_serve_events() == []
    assert inj.pop_net_events(kinds=("straggler",)) == [
        ("straggler", 0, 1.5)]
    assert inj.pop_net_events() == [("netem_partition", 1, 0.8)]
    assert inj.pop_campaign_events() == [
        ("member_kill_mid_resilver", 1), ("van_resilver_kill", 0)]
    # events at one step come in the schedule's sorted order
    assert inj.pop_worker_events() == [("join", 1), ("loss", 1)]
    assert inj.counters["serve_preempts_injected"] == 1
    assert inj.counters["serve_engine_kills_injected"] == 1
    assert inj.counters["faults_injected"] == len(sched)
    instants = [e for e in tracer.events if e["ph"] == "i"]
    assert [e["name"] for e in instants] == [
        "fault." + e.kind for e in sched.events]
    assert all(e["args"]["schedule"] == sched.schedule_id for e in instants)


def _sleeper():
    return subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(60)"])


def test_process_faults_signal_the_live_slot():
    """member_kill picks the live process of the slot (modulo the live
    ones); preempt sends SIGTERM to the injector's pid; a fault with no
    process to hit is counted as skipped."""
    procs = [_sleeper(), _sleeper()]
    target = _sleeper()
    try:
        procs[0].kill()
        procs[0].wait()
        sched = FaultSchedule([FaultEvent(1, "member_kill", 0.0),
                               FaultEvent(2, "preempt"),
                               FaultEvent(3, "kill_shard", 5.0)])
        inj = FaultInjector(sched, member_procs=procs, pid=target.pid)
        inj.on_step(1)
        assert procs[1].poll() is not None  # the only live one was hit
        assert inj.counters["member_procs_killed"] == 1
        inj.on_step(2)
        assert target.wait(30) == -15  # SIGTERM
        inj.on_step(3)
        assert inj.counters["shard_faults_skipped_no_proc"] == 1
        inj2 = FaultInjector(FaultSchedule([FaultEvent(1, "member_kill")]),
                             member_procs=procs)
        inj2.on_step(1)
        assert inj2.counters["proc_faults_skipped_no_proc"] == 1
    finally:
        for p in procs + [target]:
            if p.poll() is None:
                p.kill()
            p.wait()
