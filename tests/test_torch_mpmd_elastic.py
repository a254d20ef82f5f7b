"""The port's fault-tolerant MPMD pipeline (``hetu_tpu_torch.parallel.
mpmd_elastic``) against hetu_tpu's, with real stage, controller, van and
standby processes on the CPU.

Mirrored from ``tests/test_mpmd_elastic.py`` and
``tests/test_ctrlchaos.py:778`` (the reference's own versions are
``slow``):

* ``StageSpec`` round-trips; ``step_batch``, ``stage_init_weights`` and
  ``stage_table_rows`` are bitwise the reference's; the timeline pairs
  ``stage_kill`` with ``pipeline.stage_replace`` and ``stage_slow`` with
  ``train.straggler``;
* a clean 3-stage run ends with the reference ``MPMDPipelineSupervisor``'s
  same-seed parameters bit for bit, and GPipe (stash-bounded) with
  1F1B's;
* a seeded SIGKILL of the middle stage, landed at a committed step: one
  replacement, the final parameters byte-identical to the clean twin's,
  the kill paired with ``pipeline.stage_replace``;
* a SIGSTOPped stage suspected and cleared with zero replacements; a
  ``stage_slow`` link detected as a ``train.straggler`` window; both
  ending bitwise equal to the clean twin;
* the bf16 wire's edge bytes in the stage logs;
* the controller process SIGKILLed at a committed step and taken over,
  byte-identical to the clean twin.

Added: a standby process with ``plane="mpmd"`` that promotes itself when
the controller process is SIGKILLed, adopts the pipeline, drives it to
its last step and prints the digests of the final parameters, equal to
the clean twin's; every stage, controller and standby process loaded
neither jax nor torch.

Every wait has a deadline of its own; every process is killed in
``finally``.  Only leases, parking, promotion and straggler detection
run on wall time, as they are defined on it; each kill lands at a
committed step.
"""

import hashlib
import json
import signal
import subprocess
import threading
import time
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

from hetu_tpu.parallel import mpmd_elastic as ref
from hetu_tpu_torch.parallel import mpmd_elastic as me
from hetu_tpu_torch.parallel.mpmd_elastic import (
    MPMDPipelineSupervisor, StageSpec,
)
from hetu_tpu_torch.resilience.faults import (
    FaultEvent, FaultInjector, FaultSchedule,
)
from hetu_tpu_torch.resilience.shardproc import (
    free_port, spawn_module, spawn_shard_server,
)
from hetu_tpu_torch.telemetry import timeline, trace

WAIT_S = 90.0
# the chaos twins' problem: 3 stages, 1F1B over 4 microbatches of a
# bf16 wire, paced so a kill at step 5 leaves the stages more than the
# controller lease (0.8 s) of work
TWIN = dict(steps=40, n_microbatches=4, width=8, batch=8, schedule="1f1b",
            wire="bf16", data_seed=3, step_sleep_s=0.05)
KILL_SCHEDULE = dict(steps=10, seed=1)  # the middle stage / the
# controller at step 5 (the reference's acceptance draw)


@pytest.fixture(autouse=True)
def _one_blas_thread(monkeypatch):
    for key in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS"):
        monkeypatch.setenv(key, "1")


def _reap(procs, workdir):
    """Kill ``procs`` and every process whose argv names ``workdir``
    (the stages of a killed controller have no other handle)."""
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


def _count(proc, prefix):
    return sum(1 for ln in _log(proc).splitlines() if ln.startswith(prefix))


def _marker(proc, marker, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while marker not in _log(proc):
        assert proc.poll() is None or marker in _log(proc), \
            f"exited rc={proc.returncode} before {marker!r}: " \
            f"{_log(proc)[-2000:]}"
        assert time.monotonic() < deadline, \
            f"no {marker!r} within {timeout} s: {_log(proc)[-2000:]}"
        time.sleep(0.05)


def _run(workdir, *, deadline_s=WAIT_S, injector=None, before_run=None,
         **kw):
    """One in-process supervisor over ``workdir``: its report (final
    parameters included); every stage killed on the way out."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    base = dict(lease_s=0.5, suspect_grace_s=0.4)
    base.update(kw)
    sup = MPMDPipelineSupervisor(3, workdir=workdir, **base)
    try:
        if injector is not None:
            injector.stage_procs = sup.procs
            sup.injector = injector
        if before_run is not None:
            before_run(sup)
        return sup.run(deadline_s=deadline_s)
    finally:
        sup.close()
        _reap([], workdir)


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for s in a:
        np.testing.assert_array_equal(a[s], b[s])


def _ready_lines(workdir, glob):
    return [ln for p in Path(workdir).glob(glob)
            for ln in p.read_text(errors="replace").splitlines()
            if ln.startswith("READY")]


@pytest.fixture(scope="module")
def clean_twin(tmp_path_factory):
    """The un-killed run every chaos twin is held to."""
    return _run(tmp_path_factory.mktemp("clean_twin"), **TWIN)


# ---------------------------------------------------------------------------
# spec, data and layout against the reference
# ---------------------------------------------------------------------------

def _spec(mod, **kw):
    base = dict(port=1, stage=0, n_stages=3, steps=4, n_microbatches=4,
                width=8, batch=8, data_seed=5)
    base.update(kw)
    return mod.StageSpec(**base)


@pytest.mark.parametrize("kw", [
    dict(), dict(schedule="gpipe", stash_limit=3, wire="int8",
                 compute_sleep_s=0.001),
    dict(van={"endpoints": [["127.0.0.1", 1], ["127.0.0.1", 2]]},
         ctrl_lease_s=0.8, step_sleep_s=0.05)])
def test_stage_spec_roundtrips_as_the_reference(kw):
    spec = _spec(me, **kw)
    assert StageSpec.from_json(spec.to_json()) == spec
    assert asdict(spec) == asdict(_spec(ref, **kw))
    assert json.loads(spec.to_json()) == json.loads(
        _spec(ref, **kw).to_json())


@pytest.mark.parametrize("seed,width,batch", [(5, 8, 8), (0, 64, 64),
                                              (3, 16, 12)])
def test_step_batch_and_init_weights_are_the_references(seed, width,
                                                        batch):
    a = _spec(me, data_seed=seed, width=width, batch=batch)
    b = _spec(ref, data_seed=seed, width=width, batch=batch)
    for step in range(3):
        for x, y in zip(me.step_batch(a, step), ref.step_batch(b, step)):
            assert x.dtype == np.float32
            np.testing.assert_array_equal(x, y)
    for s in range(3):
        w = me.stage_init_weights(a, s)
        assert w.dtype == np.float32 and w.shape == (width, width)
        np.testing.assert_array_equal(w, ref.stage_init_weights(b, s))
    assert me.stage_table_rows(width) == ref.stage_table_rows(width) == \
        4 * width + 1


def test_stage_fault_timeline_pairing_and_report_coverage():
    """``stage_kill`` pairs only with ``pipeline.stage_replace``;
    ``stage_slow`` prefers its ``train.straggler`` window over an
    unrelated replacement; ``timeline.report`` covers both kinds."""
    evs = [
        {"ph": "i", "name": "fault.stage_kill", "ts": 100.0, "seq": 0,
         "args": {"kind": "stage_kill", "step": 3}},
        {"ph": "i", "name": "fault.stage_slow", "ts": 110.0, "seq": 1,
         "args": {"kind": "stage_slow", "step": 4}},
        {"ph": "X", "name": "pipeline.stage_replace", "ts": 150.0,
         "dur": 50.0, "seq": 2, "args": {"stage": 1}},
        {"ph": "X", "name": "train.straggler", "ts": 160.0,
         "dur": 300.0, "seq": 3, "args": {"stage": 2}},
    ]
    by = {p.kind: p for p in timeline.correlate(evs)}
    assert by["stage_kill"].paired
    assert by["stage_kill"].recovery_name == "pipeline.stage_replace"
    assert by["stage_slow"].paired
    assert by["stage_slow"].recovery_name == "train.straggler"
    rep = timeline.report(list(by.values()))
    for kind in ("stage_kill", "stage_slow"):
        assert rep[kind]["injected"] == 1 and rep[kind]["paired"] == 1
        assert "p50" in rep[kind]["recover_s"]


# ---------------------------------------------------------------------------
# clean runs
# ---------------------------------------------------------------------------

def _ref_run(workdir, **kw):
    sup = ref.MPMDPipelineSupervisor(3, workdir=workdir, lease_s=0.5,
                                     suspect_grace_s=0.4, **kw)
    try:
        return sup.run(deadline_s=WAIT_S)
    finally:
        sup.close()
        _reap([], workdir)


def test_clean_run_is_the_reference_supervisors_bitwise(tmp_path):
    """Same seed, same problem: the port's stages and the reference's end
    with the same parameters bit for bit; GPipe, stash-bounded to 3,
    equals 1F1B; the port's stages loaded neither jax nor torch."""
    problem = dict(steps=4, n_microbatches=4, width=8, batch=8,
                   data_seed=0)
    port_1f1b = _run(tmp_path / "port", **problem)
    assert not port_1f1b["replacements"]
    assert port_1f1b["epochs"] == 1
    (tmp_path / "ref").mkdir()
    want = _ref_run(tmp_path / "ref", **problem)
    _equal(port_1f1b["final_params"], want["final_params"])
    gpipe = _run(tmp_path / "gpipe", schedule="gpipe", stash_limit=3,
                 **problem)
    _equal(gpipe["final_params"], port_1f1b["final_params"])
    for workdir in (tmp_path / "port", tmp_path / "gpipe"):
        lines = _ready_lines(workdir, "stage_*_*.log")
        assert len(lines) == 3
        assert all(ln.split()[2:] == ["jax=0", "torch=0"] for ln in lines)
    # the stash the schedule allowed: 1F1B at most S - s, GPipe 3
    for rep_, bound in ((port_1f1b, lambda s: 3 - s), (gpipe, lambda s: 3)):
        for p in rep_["log_paths"]:
            recs = [json.loads(ln) for ln in Path(p).read_text()
                    .splitlines() if ln.strip()]
            assert recs and all(r["peak_stash"] == bound(r["stage"])
                                for r in recs)


def test_bf16_wire_counts_edge_bytes(clean_twin):
    """bf16 edges move half the logical bytes; every stage logs them."""
    seen = 0
    for p in clean_twin["log_paths"]:
        lines = [ln for ln in Path(p).read_text().splitlines()
                 if ln.strip()]
        wb = json.loads(lines[-1])["wire_bytes"]
        if wb["logical"]:
            seen += 1
            assert wb["wire"] * 2 == wb["logical"]
    assert seen == 3  # every stage has at least one bf16 edge


# ---------------------------------------------------------------------------
# stage faults
# ---------------------------------------------------------------------------

def test_chaos_stage_kill_replacement_byte_identical(tmp_path, clean_twin):
    """The seeded SIGKILL of the middle stage at step 5 → lease expiry →
    one replacement process (weights pulled from the PS) → the final
    parameters byte-identical to the clean twin's; the kill pairs with
    ``pipeline.stage_replace``."""
    schedule = FaultSchedule.generate(stage_kills=1, n_stages=3,
                                      **KILL_SCHEDULE)
    (ev,) = schedule.events
    assert (ev.kind, ev.step, ev.arg) == ("stage_kill", 5, 1.0)
    inj = FaultInjector(schedule)
    tracer = trace.Tracer()
    trace.enable(tracer=tracer)
    try:
        chaos = _run(tmp_path, injector=inj, **TWIN)
    finally:
        trace.disable()
    assert inj.counters["stage_procs_killed"] == 1
    assert len(chaos["replacements"]) == 1
    assert chaos["replacements"][0]["stages"] == [1]
    assert chaos["replacements"][0]["resume_step"] >= 1
    _equal(chaos["final_params"], clean_twin["final_params"])
    pairs = [p for p in timeline.correlate(tracer.events)
             if p.kind == "stage_kill"]
    assert len(pairs) == 1 and pairs[0].paired
    assert pairs[0].recovery_name == "pipeline.stage_replace"
    assert pairs[0].detect_s < 10.0
    assert timeline.report(pairs)["stage_kill"]["paired"] == 1


def test_chaos_stage_sigstop_suspected_then_cleared(tmp_path, clean_twin):
    """A SIGSTOPped middle stage (stopped once the fleet committed step
    2, resumed 1 s later) is suspected and cleared: zero replacements,
    one epoch, the clean twin's parameters."""

    def pause(sup):
        deadline = time.monotonic() + WAIT_S
        while max(sup.svc.state_of(s).committed for s in range(3)) < 2:
            sup.poll()
            assert time.monotonic() < deadline, "the fleet never moved"
            time.sleep(0.02)
        victim = sup.procs[1]
        victim.send_signal(signal.SIGSTOP)
        t = threading.Timer(1.0,
                            lambda: victim.send_signal(signal.SIGCONT))
        t.daemon = True
        t.start()

    rep = _run(tmp_path, before_run=pause,
               **{**TWIN, "lease_s": 0.4, "suspect_grace_s": 2.5})
    assert rep["counters"].get("suspect", 0) >= 1
    assert rep["counters"].get("clear", 0) >= 1
    assert rep["counters"].get("lost", 0) == 0
    assert not rep["replacements"]
    assert rep["epochs"] == 1
    _equal(rep["final_params"], clean_twin["final_params"])


def test_chaos_stage_slow_rides_straggler_detection(tmp_path, clean_twin):
    """A ``stage_slow`` netem link on stage 1 from step 3 for 2 s: the
    straggler plane opens a ``train.straggler`` window for stage 1 (wait
    policy, ratio >= 4), no membership change, the clean twin's
    parameters; the fault pairs with the window."""
    inj = FaultInjector(FaultSchedule([FaultEvent(3, "stage_slow", 1.0,
                                                  2.0)]))
    tracer = trace.Tracer()
    trace.enable(tracer=tracer)
    try:
        rep = _run(tmp_path, injector=inj, lease_s=1.5,
                   suspect_grace_s=1.0, straggler_slow_ms=120, **TWIN)
    finally:
        trace.disable()
    assert inj.counters["stage_slows_injected"] == 1
    rec = next(r for r in rep["straggle_records"] if r["stage"] == 1)
    assert rec["policy"] == "wait" and rec["ratio"] >= 4.0
    assert not rep["replacements"]
    _equal(rep["final_params"], clean_twin["final_params"])
    slows = [p for p in timeline.correlate(tracer.events)
             if p.kind == "stage_slow"]
    assert len(slows) == 1 and slows[0].paired
    assert slows[0].recovery_name == "train.straggler"


# ---------------------------------------------------------------------------
# controller faults
# ---------------------------------------------------------------------------

def _spawn_controller(workdir, port, tag="ctrl", **kw):
    cfg = {"workdir": str(workdir), "port": port, "n_stages": 3,
           "lease_s": 0.5, "suspect_grace_s": 0.4, "ctrl_lease_s": 0.8,
           "deadline_s": WAIT_S, **TWIN, **kw}
    path = Path(workdir) / f"{tag}.json"
    path.write_text(json.dumps(cfg))
    return spawn_module(workdir, tag, "hetu_tpu_torch.parallel.mpmd_elastic",
                        ["--controller", str(path)], timeout_s=WAIT_S)


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


def test_chaos_controller_kill_takeover_byte_identical(tmp_path,
                                                       clean_twin):
    """``tests/test_ctrlchaos.py:778``: the controller process SIGKILLed
    at its fifth progress step → the stages park; a takeover re-freezes
    with an exact resume; the final parameters byte-identical to the
    clean twin's; the kill pairs with ``ctrl.takeover``."""
    schedule = FaultSchedule.generate(controller_kills=1, **KILL_SCHEDULE)
    (ev,) = schedule.events
    assert (ev.kind, ev.step) == ("controller_kill", 5)
    port = free_port()
    van_proc = spawn_shard_server(tmp_path, port, tag="ctrlvan")
    ctrl = new_sup = None
    tracer = trace.Tracer()
    trace.enable(tracer=tracer)
    try:
        ctrl = _spawn_controller(tmp_path, port)
        inj = FaultInjector(schedule, ctrl_procs=[ctrl])
        _drive_kill(ctrl, inj, schedule)
        assert inj.counters["controller_procs_killed"] == 1
        time.sleep(2.0)  # > ctrl_lease_s: every stage is parked
        new_sup = MPMDPipelineSupervisor.takeover(
            workdir=tmp_path, port=port, lease_s=0.5, suspect_grace_s=0.4)
        assert new_sup.takeover_report["incarnation"] >= 2
        # the takeover adopted the parked pipeline mid-run
        assert new_sup.takeover_report["resume_step"] < TWIN["steps"]
        chaos = new_sup.run(deadline_s=WAIT_S)
        _equal(chaos["final_params"], clean_twin["final_params"])
    finally:
        if new_sup is not None:
            new_sup.close()
        _reap([ctrl, van_proc], tmp_path)
        trace.disable()
    kills = [p for p in timeline.correlate(tracer.events)
             if p.kind == "controller_kill"]
    assert len(kills) == 1 and kills[0].paired
    assert kills[0].recovery_name == "ctrl.takeover"


def test_standby_process_adopts_the_mpmd_pipeline(tmp_path, clean_twin):
    """A standby process with ``plane="mpmd"`` watches the controller
    process; SIGKILL the controller at a committed step: the standby
    promotes itself, adopts the parked pipeline, drives it to its last
    step and prints ``RESOLVED`` with the digests of the final
    parameters — the clean twin's — then ``ALLDONE``; the controller,
    the standby and every stage loaded neither jax nor torch, and the
    adopted stages left on their own."""
    port = free_port()
    van_proc = spawn_shard_server(tmp_path, port, tag="ctrlvan")
    ctrl = sb = None
    try:
        ctrl = _spawn_controller(tmp_path, port)
        spec = StageSpec.from_json(
            sorted(tmp_path.glob("stage_*_*.json"))[0].read_text())
        path = tmp_path / "standby.json"
        path.write_text(json.dumps({
            "workdir": str(tmp_path), "port": port, "plane": "mpmd",
            "membership_table": spec.membership_table,
            "n_slots": spec.n_stages, "lease_bound_s": 0.5,
            "poll_s": 0.05, "watch_timeout_s": WAIT_S,
            "resolve_timeout_s": WAIT_S,
            "takeover_kwargs": {"lease_s": 0.5, "suspect_grace_s": 0.4}}))
        sb = spawn_module(tmp_path, "standby",
                          "hetu_tpu_torch.resilience.standby", [str(path)],
                          timeout_s=WAIT_S)
        _marker(sb, "WATCHING")
        deadline = time.monotonic() + WAIT_S
        while _count(ctrl, "STEP") < 6:
            assert ctrl.poll() is None and time.monotonic() < deadline, \
                _log(ctrl)[-2000:]
            time.sleep(0.05)
        ctrl.kill()
        ctrl.wait(timeout=10)
        assert sb.wait(WAIT_S) == 0, _log(sb)[-2000:]
        lines = {ln.split(" ", 1)[0]: ln for ln in _log(sb).splitlines()
                 if ln}
        order = [ln.split(" ", 1)[0] for ln in _log(sb).splitlines()
                 if ln.split(" ", 1)[0] in ("PROMOTED", "RESOLVED",
                                            "ALLDONE")]
        assert order == ["PROMOTED", "RESOLVED", "ALLDONE"], order
        assert "READY jax=0 torch=0" in _log(sb)
        assert "READY jax=0 torch=0" in _log(ctrl)
        got = json.loads(lines["RESOLVED"].split(" ", 1)[1])
        assert got["takeover"]["incarnation"] >= 2
        assert got["takeover"]["resume_step"] < TWIN["steps"]
        want = {str(s): hashlib.blake2b(
            np.ascontiguousarray(w).tobytes(), digest_size=16).hexdigest()
            for s, w in clean_twin["final_params"].items()}
        assert got["digests"] == want
        lines = _ready_lines(tmp_path, "stage_*_*.log")
        assert len(lines) >= 3
        assert all(ln.split()[2:] == ["jax=0", "torch=0"] for ln in lines)
        # the adopted stages finished and exited on their own
        assert not subprocess.run(
            ["pgrep", "-f", f"{tmp_path}/stage_"],
            capture_output=True).stdout.strip()
    finally:
        _reap([ctrl, sb, van_proc], tmp_path)
