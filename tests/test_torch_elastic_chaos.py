"""The port's elastic training plane under chaos, with real worker,
controller, van and standby processes on the CPU
(``hetu_tpu_torch.resilience.multicontroller``, ``resilience.standby``).

Port mirrors, each held to the assertions of the reference test it
mirrors (the reference's own versions stay ``slow``):

* ``tests/test_multicontroller.py:151``: a seeded worker-process SIGKILL →
  lease expiry → the survivors reshard at width 2 and go on; a
  replacement process is re-admitted (width 3); the merged consumed logs
  are a complete cover of the width-invariant schedule, and the kill
  pairs with ``elastic.reshard``;
* ``tests/test_netchaos.py:278,312,349``: an injected slow link on worker
  1 detected as a ``train.straggler``, tolerated (wait), resharded around
  (evict), and re-admitted by the probation loop once it heals;
* ``tests/test_ctrlchaos.py:653,737``: the controller process SIGKILLed
  mid-run and taken over with an exact resume, and killed between a
  PREPARE and its acks;
* ``tests/test_vanchaos.py:361``: an ``ordered_grads`` run over a
  replicated van pair ends with the backup's weights bitwise the
  primary's.

Added: a standby process with ``plane="elastic"`` that promotes itself
when the controller process is SIGKILLed, adopts the running fleet,
drives it to its last step and reports the takeover; the final weights
bitwise those of an un-killed same-seed run where no gradient was
re-pushed.

Every wait has a deadline of its own; every process is killed in
``finally``.  Only leases, parking, promotion and straggler detection
run on wall time, as they are defined on it.  The spawned processes run
one BLAS thread each, and the straggler fleet trains a [512, 512] table
(the reference tests': 8 x 4): at 8 x 4 a step's work is well under a
millisecond, so while the rest of a parallel test run holds the cores a
worker's scheduling stall alone makes it a 4x outlier of its peers before
the injected slow link (the reference's own test fails so under the same
load).  The assertions are the reference's.
"""

import json
import signal
import subprocess
import time
from pathlib import Path

import numpy as np
import pytest

from hetu_tpu_torch.ps import membership as mb
from hetu_tpu_torch.ps.van import RemotePSTable
from hetu_tpu_torch.resilience.faults import (
    FaultEvent, FaultInjector, FaultSchedule,
)
from hetu_tpu_torch.resilience.multicontroller import (
    MultiControllerElasticSupervisor, WorkerSpec, check_complete_cover,
    make_schedule, merge_consumed_logs, worker_metrics,
)
from hetu_tpu_torch.resilience.shardproc import (
    free_port, spawn_module, spawn_shard_server,
)
from hetu_tpu_torch.telemetry import timeline, trace

WAIT_S = 90.0
STRAGGLER_WIDTH = 512


@pytest.fixture(autouse=True)
def _one_blas_thread(monkeypatch):
    """One BLAS thread in each process the test spawns (they inherit the
    environment): idle pools of a thread a core in every worker contend
    with the van and the other workers."""
    for key in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS"):
        monkeypatch.setenv(key, "1")


def _until(sup, cond, what, timeout=WAIT_S):
    """Poll ``sup`` (None: nothing to poll) until ``cond()``; fail with
    the fleet's state after ``timeout``."""
    deadline = time.monotonic() + timeout
    while not cond():
        if sup is not None:
            sup.poll()
        assert time.monotonic() < deadline, (what, None if sup is None else [
            (m.slot, m.state, m.committed) for m in sup.svc.members])
        time.sleep(0.02)


def _reap(procs, workdir):
    """Kill ``procs`` and every process whose argv names ``workdir``
    (the workers of a killed controller have no other handle)."""
    for p in procs:
        if p is not None and p.poll() is None:
            try:
                p.send_signal(signal.SIGCONT)
            except OSError:
                pass
            p.kill()
            p.wait()
    subprocess.run(["pkill", "-9", "-f", str(workdir)],
                   capture_output=True, timeout=10)


def _log(proc):
    return Path(proc.log_path).read_text(errors="replace")


def _marker(proc, marker, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while marker not in _log(proc):
        assert proc.poll() is None or marker in _log(proc), \
            f"exited rc={proc.returncode} before {marker!r}: " \
            f"{_log(proc)[-2000:]}"
        assert time.monotonic() < deadline, \
            f"no {marker!r} within {timeout} s: {_log(proc)[-2000:]}"
        time.sleep(0.05)


def _count(proc, prefix):
    return sum(1 for ln in _log(proc).splitlines() if ln.startswith(prefix))


def _drive_kill(proc, injector, schedule, *, timeout=WAIT_S):
    """Feed the injector the controller's STEP markers until the seeded
    kill fires, then wait for the process to die."""
    kill_step = next(e.step for e in schedule.events)
    fired = 0
    deadline = time.monotonic() + timeout
    while proc.poll() is None:
        assert time.monotonic() < deadline, "seeded kill never fired"
        cur = _count(proc, "STEP")
        for t in range(fired + 1, cur + 1):
            injector.on_step(t)
        fired = max(fired, cur)
        if fired >= kill_step:
            break
        time.sleep(0.05)
    proc.wait(timeout=10)


def _spawn_van(workdir):
    port = free_port()
    return port, spawn_shard_server(workdir, port, tag="ctrlvan")


def _spawn_controller(workdir, cfg, tag="ctrl"):
    path = Path(workdir) / f"{tag}.json"
    path.write_text(json.dumps(cfg))
    return spawn_module(workdir, tag,
                        "hetu_tpu_torch.resilience.multicontroller",
                        ["--controller", str(path)], timeout_s=WAIT_S)


def _elastic_cfg(workdir, port, **kw):
    cfg = {"workdir": str(workdir), "port": port, "n_workers": 3,
           "steps": 80, "global_batch": 12, "data_seed": 5,
           "lease_s": 0.5, "suspect_grace_s": 0.4,
           "step_sleep_s": 0.04, "ctrl_lease_s": 0.8}
    cfg.update(kw)
    return cfg


# ---------------------------------------------------------------------------
# worker death, rejoin
# ---------------------------------------------------------------------------

def test_chaos_worker_proc_kill_reshard_and_rejoin_acceptance(tmp_path):
    """``tests/test_multicontroller.py:151``: a seeded worker-process
    SIGKILL → lease expiry → survivors reshard at width 2; a replacement
    is re-admitted (width 3); every step a complete cover; the fault
    pairs with ``elastic.reshard``."""
    schedule = FaultSchedule.generate(steps=40, seed=77,
                                      worker_proc_kills=1, n_workers=3)
    (ev,) = schedule.events
    assert ev.kind == "worker_proc_kill"
    assert schedule.to_json() == FaultSchedule.generate(
        steps=40, seed=77, worker_proc_kills=1, n_workers=3).to_json()
    tracer = trace.Tracer()
    trace.enable(tracer=tracer)
    try:
        sup = MultiControllerElasticSupervisor(
            3, workdir=tmp_path, steps=120, global_batch=24,
            lease_s=0.5, suspect_grace_s=0.3, step_sleep_s=0.02)
        sup.injector = FaultInjector(schedule, worker_procs=sup.procs)
        try:
            _until(sup, lambda: bool(sup.resizes), "shrink")
            shrink = sup.resizes[0]
            assert shrink.kind == "shrink" and shrink.width == 2
            assert sup.injector.counters["worker_procs_killed"] == 1
            dead = next(s for s in range(3)
                        if sup.procs[s].poll() is not None)
            _until(sup, lambda: min(
                sup.svc.state_of(s).committed for s in range(3)
                if s != dead) >= shrink.resume_step + 5,
                "post-shrink progress")
            sup.spawn_replacement(dead)
            _until(sup, lambda: len(sup.resizes) >= 2, "grow")
            grow = sup.resizes[-1]
            assert grow.kind == "grow" and grow.width == 3
            assert grow.resume_step >= shrink.resume_step
            rep = sup.run(deadline_s=WAIT_S)
            sup.verify_consumed(rep["consumed"])
            assert {r["width"] for r in rep["resizes"]} == {2, 3}
        finally:
            sup.close()
    finally:
        trace.disable()
    pairs = timeline.correlate(tracer.events)
    kills = [p for p in pairs if p.kind == "worker_proc_kill"]
    assert len(kills) == 1 and kills[0].paired
    assert kills[0].recovery_name == "elastic.reshard"
    assert kills[0].detect_s < 10.0


# ---------------------------------------------------------------------------
# stragglers
# ---------------------------------------------------------------------------

def _straggler_fleet(tmp_path, *, policy, duration_s, steps=40,
                     evict_after=2, **kw):
    schedule = FaultSchedule([FaultEvent(5, "straggler", 1.0,
                                         duration_s)])
    return MultiControllerElasticSupervisor(
        3, workdir=tmp_path, steps=steps, global_batch=24,
        features=STRAGGLER_WIDTH, out_dim=STRAGGLER_WIDTH, n_samples=240,
        lease_s=1.5, suspect_grace_s=1.0, step_sleep_s=0.01,
        straggler_policy=policy, straggler_factor=4.0,
        straggler_evict_after=evict_after, straggler_slow_ms=120,
        injector=FaultInjector(schedule), **kw)


def test_straggler_wait_policy_detects_and_tolerates(tmp_path):
    """``tests/test_netchaos.py:278``: worker 1's injected slow link is
    detected (``train.straggler``), tolerated and heals; nobody evicted,
    no reshard; a complete cover."""
    tracer = trace.Tracer()
    trace.enable(tracer=tracer)
    try:
        sup = _straggler_fleet(tmp_path, policy="wait", duration_s=1.5)
        try:
            rep = sup.run(deadline_s=WAIT_S)
            sup.verify_consumed(rep["consumed"])
            assert sup.straggle_records, "straggler never detected"
            rec = sup.straggle_records[0]
            assert rec["worker"] == 1 and rec["policy"] == "wait"
            assert rec["ratio"] >= 4.0
            assert not sup._evicted and not sup.resizes
        finally:
            sup.close()
    finally:
        trace.disable()
    pairs = timeline.correlate(tracer.events)
    stragglers = [p for p in pairs if p.kind == "straggler"]
    assert len(stragglers) == 1 and stragglers[0].paired
    assert stragglers[0].recovery_name == "train.straggler"
    assert stragglers[0].detect_s < 20.0


def test_straggler_evict_policy_reshards_around(tmp_path):
    """``tests/test_netchaos.py:312``: the slow link outlasts patience;
    the fleet reshards around worker 1 (alive, never lost); a complete
    cover at the new width."""
    tracer = trace.Tracer()
    trace.enable(tracer=tracer)
    try:
        sup = _straggler_fleet(tmp_path, policy="evict", duration_s=60.0,
                               evict_after=2)
        try:
            rep = sup.run(deadline_s=WAIT_S)
            sup.verify_consumed(rep["consumed"])
            assert 1 in sup._evicted
            rec = next(r for r in sup.straggle_records
                       if r["resolution"] == "evicted")
            assert rec["worker"] == 1
            shrinks = [r for r in rep["resizes"] if r["kind"] == "shrink"]
            assert shrinks and shrinks[0]["width"] == 2
            assert sup.procs[1].poll() is None
            assert sup.svc.state_of(1).state in ("alive", "suspect")
        finally:
            sup.close()
    finally:
        trace.disable()
    pairs = timeline.correlate(tracer.events)
    stragglers = [p for p in pairs if p.kind == "straggler"]
    assert len(stragglers) == 1 and stragglers[0].paired
    assert stragglers[0].recovery_name == "train.straggler"


def test_straggler_probation_auto_readmits_after_heal(tmp_path):
    """``tests/test_netchaos.py:349``: evicted, then re-admitted by the
    probation loop once the link heals; the run finishes at width 3 with
    the readmitted worker trained to the end."""
    sup = _straggler_fleet(tmp_path, policy="evict", duration_s=2.5,
                           evict_after=2, steps=220,
                           straggler_readmit_after=3)
    try:
        rep = sup.run(deadline_s=WAIT_S)
        sup.verify_consumed(rep["consumed"])
        assert any(r["resolution"] == "evicted"
                   for r in sup.straggle_records)
        shrinks = [r for r in rep["resizes"] if r["kind"] == "shrink"]
        assert shrinks and shrinks[0]["slot"] == 1
        assert 1 not in sup._evicted
        grows = [r for r in rep["resizes"] if r["kind"] == "grow"]
        assert grows and grows[-1]["width"] == 3
        assert grows[-1]["epoch"] > shrinks[0]["epoch"]
        assert sup.svc.state_of(1).committed >= sup.steps - 1
    finally:
        sup.close()


# ---------------------------------------------------------------------------
# controller death
# ---------------------------------------------------------------------------

def _clean(workdir, **kw):
    workdir.mkdir()
    sup = MultiControllerElasticSupervisor(3, workdir=workdir, **kw)
    try:
        rep = sup.run(deadline_s=WAIT_S)
        sup.verify_consumed(rep["consumed"])
        return rep
    finally:
        sup.close()


def test_chaos_controller_kill_elastic_byte_identical(tmp_path):
    """``tests/test_ctrlchaos.py:653``: the controller process SIGKILLed
    mid-run → the workers park; a takeover republishes the frozen
    membership with an exact resume; every step a complete cover, the
    weights within the reference test's tolerance of an un-killed run,
    a ``takeover`` resize, the kill paired with ``ctrl.takeover``."""
    clean = _clean(tmp_path / "clean", steps=80, global_batch=12,
                   data_seed=5, lease_s=0.5, suspect_grace_s=0.4,
                   step_sleep_s=0.04, ctrl_lease_s=0.8)
    schedule = FaultSchedule.generate(steps=80, seed=11,
                                      controller_kills=1)
    (ev,) = schedule.events
    assert ev.kind == "controller_kill"
    chaos_dir = tmp_path / "chaos"
    chaos_dir.mkdir()
    port, van_proc = _spawn_van(chaos_dir)
    new_sup = ctrl = None
    tracer = trace.Tracer()
    trace.enable(tracer=tracer)
    try:
        ctrl = _spawn_controller(chaos_dir, _elastic_cfg(chaos_dir, port),
                                 tag="elastic_ctrl")
        inj = FaultInjector(schedule, ctrl_procs=[ctrl])
        _drive_kill(ctrl, inj, schedule)
        assert inj.counters["controller_procs_killed"] == 1
        time.sleep(2.0)  # > ctrl_lease_s: every worker is parked
        new_sup = MultiControllerElasticSupervisor.takeover(
            workdir=chaos_dir, port=port, lease_s=0.5,
            suspect_grace_s=0.4)
        assert new_sup.takeover_report["incarnation"] >= 2
        chaos = new_sup.run(deadline_s=WAIT_S)
        new_sup.verify_consumed(chaos["consumed"])
        np.testing.assert_allclose(chaos["final_weights"],
                                   clean["final_weights"],
                                   rtol=0.05, atol=0.01)
        assert any(r["kind"] == "takeover" for r in chaos["resizes"])
    finally:
        if new_sup is not None:
            new_sup.close()
        _reap([ctrl, van_proc], chaos_dir)
        trace.disable()
    pairs = timeline.correlate(tracer.events)
    kills = [p for p in pairs if p.kind == "controller_kill"]
    assert len(kills) == 1 and kills[0].paired
    assert kills[0].recovery_name == "ctrl.takeover"


def test_chaos_controller_killed_between_prepare_and_ack(tmp_path):
    """``tests/test_ctrlchaos.py:737``: the controller publishes a
    PREPARE and dies before the acks; the takeover's fresh epoch
    supersedes the half-open one and resumes exactly."""
    port, van_proc = _spawn_van(tmp_path)
    new_sup = ctrl = None
    try:
        ctrl = _spawn_controller(
            tmp_path, _elastic_cfg(tmp_path, port, steps=30,
                                   step_sleep_s=0.02, prepare_hang_at=5),
            tag="prepare_ctrl")
        _marker(ctrl, "PREPARED")
        ctrl.kill()
        ctrl.wait()
        time.sleep(0.5)
        new_sup = MultiControllerElasticSupervisor.takeover(
            workdir=tmp_path, port=port, lease_s=0.5, suspect_grace_s=0.4)
        assert new_sup.takeover_report["epoch"] > 1
        chaos = new_sup.run(deadline_s=WAIT_S)
        new_sup.verify_consumed(chaos["consumed"])
    finally:
        if new_sup is not None:
            new_sup.close()
        _reap([ctrl, van_proc], tmp_path)


def test_standby_process_adopts_the_elastic_fleet(tmp_path):
    """A standby process with ``plane="elastic"`` watches the controller
    process; SIGKILL the controller: the standby promotes itself, adopts
    the parked fleet (incarnation 2, a ``takeover`` resize), drives it to
    its last step and checks the cover; the final weights on the van are
    bitwise an un-killed same-seed ``ordered_grads`` run's when no
    gradient was re-pushed (else within the tolerance of
    ``tests/test_ctrlchaos.py:717``); the controller, the standby and
    every worker loaded neither jax nor torch."""
    problem = dict(steps=40, global_batch=12, data_seed=5,
                   ordered_grads=True)
    clean = _clean(tmp_path / "clean", lease_s=0.5, suspect_grace_s=0.4,
                   **problem)
    work = tmp_path / "chaos"
    work.mkdir()
    port, van_proc = _spawn_van(work)
    ctrl = sb = None
    try:
        ctrl = _spawn_controller(work, _elastic_cfg(
            work, port, **problem, step_sleep_s=0.03))
        spec = WorkerSpec.from_json(
            sorted(work.glob("worker_*_*.json"))[0].read_text())
        path = work / "standby.json"
        path.write_text(json.dumps({
            "workdir": str(work), "port": port, "plane": "elastic",
            "membership_table": spec.membership_table,
            "n_slots": spec.n_slots, "lease_bound_s": 0.5,
            "poll_s": 0.05, "watch_timeout_s": WAIT_S,
            "resolve_timeout_s": WAIT_S,
            "takeover_kwargs": {"lease_s": 0.5, "suspect_grace_s": 0.4}}))
        sb = spawn_module(work, "standby",
                          "hetu_tpu_torch.resilience.standby", [str(path)],
                          timeout_s=WAIT_S)
        _marker(sb, "WATCHING")
        _until(None, lambda: _count(ctrl, "STEP") >= 8,
               "the controller saw too few steps")
        ctrl.kill()
        ctrl.wait(timeout=10)
        assert sb.wait(WAIT_S) == 0, _log(sb)[-2000:]
        lines = {ln.split(" ", 1)[0]: ln for ln in _log(sb).splitlines()
                 if ln}
        assert {"PROMOTED", "RESOLVED", "ALLDONE"} <= set(lines)
        assert "READY jax=0 torch=0" in _log(sb)
        got = json.loads(lines["RESOLVED"].split(" ", 1)[1])
        assert got["takeover"]["incarnation"] >= 2
        assert any(r["kind"] == "takeover" for r in got["resizes"])
        table = RemotePSTable("127.0.0.1", port, spec.features,
                              spec.out_dim, table_id=spec.weights_table,
                              create=False)
        try:
            weights = table.dense_pull()
        finally:
            table.close()
        # the cover again, from this process
        logs = [p for p in work.glob("worker_*_*.jsonl")
                if not p.name.endswith(".trace.jsonl")]
        check_complete_cover(merge_consumed_logs(logs),
                             make_schedule(spec), spec.steps)
        repushed = worker_metrics(work).counter(
            "ps.dp_repush_duplicates").value
        if repushed == 0:
            assert np.array_equal(weights, clean["final_weights"]), \
                np.abs(weights - clean["final_weights"]).max()
        else:
            np.testing.assert_allclose(weights, clean["final_weights"],
                                       rtol=0.05, atol=0.01)
        for log in work.glob("worker_*_*.log"):
            assert "jax=0 torch=0" in log.read_text(), log.read_text()
    finally:
        _reap([ctrl, sb, van_proc], work)


# ---------------------------------------------------------------------------
# the durable tier
# ---------------------------------------------------------------------------

def test_elastic_dual_write_keeps_backup_weights_bitwise(tmp_path):
    """``tests/test_vanchaos.py:361``: an ``ordered_grads`` run over a
    replicated van pair ends with the backup's weights table bitwise the
    primary's, and both the run's final weights."""
    ports = [free_port(), free_port()]
    vans = [spawn_shard_server(tmp_path, p, tag)
            for p, tag in zip(ports, ("prim", "back"))]
    van_spec = {"endpoints": [["127.0.0.1", p] for p in ports],
                "epoch_table": mb.fresh_table_id(),
                "promote_after_s": 0.3, "rcv_timeout_s": 1.5}
    sup = None
    try:
        sup = MultiControllerElasticSupervisor(
            2, workdir=tmp_path, steps=8, global_batch=8,
            own_van=False, port=ports[0], van_spec=van_spec,
            ordered_grads=True, lease_s=2.0, suspect_grace_s=2.0)
        rep = sup.run(deadline_s=WAIT_S)
        sup.verify_consumed(rep["consumed"])
        wt = sup.spec.weights_table
        rows, dim = sup.spec.features, sup.spec.out_dim
        got = []
        for p in ports:
            t = RemotePSTable("127.0.0.1", p, rows, dim, table_id=wt,
                              create=False)
            try:
                got.append(t.dense_pull())
            finally:
                t.close()
        assert np.array_equal(got[0], got[1])
        assert np.array_equal(got[0], rep["final_weights"])
    finally:
        if sup is not None:
            sup.close()
        _reap(vans, tmp_path)
