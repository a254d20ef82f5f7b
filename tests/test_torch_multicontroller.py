"""The port's multi-controller elastic training plane
(``hetu_tpu_torch.resilience.multicontroller``, ``resilience.memberproc``)
against hetu_tpu's, on the CPU.

Against the reference, for the same arguments: ``WorkerSpec``'s JSON byte
for byte; the seeded dataset, the width-invariant schedule's slices and
their CRCs bitwise (seeds x widths 1-3); every accept and reject case of
``tests/test_multicontroller.py``'s complete-cover checker, fed to both
packages, with the same verdict and message; the global-batch
divisibility check; ``drive_controller_harness`` over fake ``poll`` /
``progress`` / ``done`` printing the same markers with the same return
codes (READY, STEP, DEADLINE -> 2, ALLDONE, FENCED -> 3); a
``ControlPlaneMember`` that voids its step (``EpochChanged``) when the
control row moves during a barrier and parks while the controller is
silent; and a clean 2-worker, 8-step, ``ordered_grads`` run in each
package over its own van: the consumed records (step, epoch, width, rank,
CRC) equal and the final weights bitwise equal (the same numpy math, the
same van sources, rank order).

Port mirrors of ``tests/test_multicontroller.py:218`` (two clean
``ordered_grads`` runs bitwise) and ``tests/test_ctrlchaos.py:325`` (the
``deaf_ack_s`` plumb).  The departures are pinned: a worker's READY line
says ``jax=0 torch=0``; ``controller_main`` reads ``features``,
``out_dim``, ``n_samples``, ``lr`` and ``ordered_grads`` (a config without
them builds the reference's supervisor); the re-push counter reaches
``fleet_metrics()`` through the workers' trace streams.

Every wait has a deadline of its own; every fleet is closed in ``finally``.
"""

import threading
import time

import numpy as np
import pytest

from hetu_tpu.ps import membership as jmb
from hetu_tpu.resilience import memberproc as jmp
from hetu_tpu.resilience import multicontroller as jmc
from hetu_tpu_torch.ps import membership as mb
from hetu_tpu_torch.resilience import memberproc as mp
from hetu_tpu_torch.resilience import multicontroller as mc
from hetu_tpu_torch.telemetry import fleet, trace

WAIT_S = 60.0


def _spec(module, **kw):
    base = dict(port=1, slot=0, n_slots=3, steps=4, global_batch=12,
                features=4, out_dim=2, n_samples=48, data_seed=5)
    base.update(kw)
    return module.WorkerSpec(**base)


# ---------------------------------------------------------------------------
# the data half: spec, dataset, schedule, CRCs, complete cover
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"step_sleep_s": 0.01, "ctrl_lease_s": 0.8},
    {"ordered_grads": True, "staging_table": 77, "log_path": "w.jsonl",
     "van": {"endpoints": [["127.0.0.1", 1], ["127.0.0.1", 2]],
             "epoch_table": 9}}],
    ids=["defaults", "paced", "ordered_replicated"])
def test_worker_spec_json_is_the_references(kw):
    port, ref = _spec(mc, **kw), _spec(jmc, **kw)
    assert port.to_json() == ref.to_json()
    assert mc.WorkerSpec.from_json(ref.to_json()) == port
    assert port.membership_table == mb.TRAIN_MEMBERSHIP_TABLE == \
        jmb.TRAIN_MEMBERSHIP_TABLE


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_dataset_slices_and_crcs_equal_the_references(seed):
    port = _spec(mc, data_seed=seed)
    ref = _spec(jmc, data_seed=seed)
    for a, b in zip(mc.make_dataset(port), jmc.make_dataset(ref)):
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a, b)
    sp, sr = mc.make_schedule(port), jmc.make_schedule(ref)
    for step in range(6):  # past one epoch of 4 batches: a reshuffle
        assert mc.slice_crc(sp.global_batch(step)) == \
            jmc.slice_crc(sr.global_batch(step))
        for w in (1, 2, 3):
            for r in range(w):
                got, want = sp.local_slice(step, r, w), \
                    sr.local_slice(step, r, w)
                assert all(np.array_equal(x, y) for x, y in zip(got, want))
                assert mc.slice_crc(got) == jmc.slice_crc(want)


def _cover(module, schedule, step, width, *, epoch, ranks=None):
    return [(epoch, width, r,
             module.slice_crc(schedule.local_slice(step, r, width)))
            for r in (range(width) if ranks is None else ranks)]


def _case(name, module):
    """``tests/test_multicontroller.py:59-117``'s consumed maps, built
    with ``module``: (consumed, steps)."""
    s = module.make_schedule(_spec(module))

    def c(step, width, **kw):
        return _cover(module, s, step, width, **kw)
    if name == "clean":
        return {st: c(st, 3, epoch=1) for st in range(4)}, 4
    if name == "resize_and_residue":
        return {0: c(0, 3, epoch=1), 1: c(1, 3, epoch=1),
                2: c(2, 3, epoch=1, ranks=[1]) + c(2, 2, epoch=2),
                3: c(3, 2, epoch=2)}, 4
    if name == "missing_step":
        return {st: c(st, 3, epoch=1) for st in (0, 1, 3)}, 4
    if name == "partial_latest_epoch":
        return {0: c(0, 3, epoch=1, ranks=[0, 2])}, 1
    if name == "wrong_bytes":
        consumed = {0: c(0, 3, epoch=1)}
        e, w, r, _ = consumed[0][1]
        consumed[0][1] = (e, w, r, 12345)
        return consumed, 1
    if name == "mixed_widths":
        return {0: c(0, 3, epoch=1) + c(0, 2, epoch=1)}, 1
    if name == "duplicate":
        return {0: c(0, 3, epoch=1, ranks=[1, 1]) + c(0, 2, epoch=2)}, 1
    raise KeyError(name)


@pytest.mark.parametrize("name,match", [
    ("clean", None), ("resize_and_residue", None),
    ("missing_step", "step 2 was never"),
    ("partial_latest_epoch", "do not cover"), ("wrong_bytes", "CRC"),
    ("mixed_widths", "several widths"), ("duplicate", "duplicate")])
def test_complete_cover_verdicts_equal_the_references(name, match):
    verdicts = []
    for module in (mc, jmc):
        consumed, steps = _case(name, module)
        sched = module.make_schedule(_spec(module))
        try:
            module.check_complete_cover(consumed, sched, steps)
            verdicts.append(None)
        except AssertionError as e:
            verdicts.append(str(e))
    assert verdicts[0] == verdicts[1]
    if match is None:
        assert verdicts[0] is None
    else:
        assert verdicts[0] is not None and match in verdicts[0]
    # the port's checker reads the reference's records the same way
    consumed, steps = _case(name, jmc)
    try:
        mc.check_complete_cover(consumed, mc.make_schedule(_spec(mc)),
                                steps)
        got = None
    except AssertionError as e:
        got = str(e)
    assert got == verdicts[1]


def test_merged_logs_equal_the_references(tmp_path):
    recs = [{"step": 1, "epoch": 2, "width": 2, "rank": 1, "crc": 7},
            {"step": 0, "epoch": 1, "width": 3, "rank": 0, "crc": 9}]
    import json
    p = tmp_path / "w.jsonl"
    p.write_text("".join(json.dumps(r) + "\n" for r in recs) + "\n")
    paths = [p, tmp_path / "missing.jsonl"]
    assert mc.merge_consumed_logs(paths) == jmc.merge_consumed_logs(paths)
    assert mc.merge_consumed_logs(paths) == {1: [(2, 2, 1, 7)],
                                             0: [(1, 3, 0, 9)]}


@pytest.mark.parametrize("n,gb", [(3, 16), (2, 9), (4, 6)])
def test_supervisor_validates_global_batch_divisibility(tmp_path, n, gb):
    errors = []
    for module in (mc, jmc):
        with pytest.raises(ValueError, match="divide") as e:
            module.MultiControllerElasticSupervisor(
                n, workdir=tmp_path, steps=2, global_batch=gb)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# ---------------------------------------------------------------------------
# the member protocol
# ---------------------------------------------------------------------------

def _harness(module, mbmod, capsys, *, done_at=None, fence_at=None,
             deadline_s=5.0, fence_after_done=True):
    """Run ``module.drive_controller_harness`` over fakes: progress
    climbs -1, 0, 1, ... one a poll; ``done()`` turns true at
    ``done_at``; ``poll()`` raises the package's ``ControllerFenced`` at
    call ``fence_at`` (or, after ALLDONE, on the next call)."""
    state = {"polls": 0, "p": -1, "done": False}

    def poll():
        state["polls"] += 1
        if fence_at is not None and state["polls"] >= fence_at:
            raise mbmod.ControllerFenced("fenced")
        if state["done"] and fence_after_done:
            raise mbmod.ControllerFenced("fenced")

    def progress():
        state["p"] = min(state["p"] + 1, 3) if state["polls"] > 1 else -1
        return state["p"]

    def done():
        state["done"] = done_at is not None and state["p"] >= done_at
        return state["done"]

    rc = module.drive_controller_harness(poll, progress, done,
                                         deadline_s=deadline_s)
    return rc, capsys.readouterr().out.split("\n")


@pytest.mark.parametrize("kw,rc_want,last", [
    (dict(done_at=3), 3, "FENCED"),           # ALLDONE, then fenced
    (dict(done_at=None, deadline_s=1.0), 2, "DEADLINE"),
    (dict(fence_at=3), 3, "FENCED")],          # fenced mid-run
    ids=["alldone", "deadline", "fenced"])
def test_controller_harness_markers_equal_the_references(capsys, kw,
                                                          rc_want, last):
    rc, lines = _harness(mp, mb, capsys, **kw)
    rc_ref, lines_ref = _harness(jmp, jmb, capsys, **kw)
    assert rc == rc_ref == rc_want
    assert lines == lines_ref
    assert lines[0] == "READY" and [x for x in lines if x][-1] == last
    if rc_want != 2:
        assert "DEADLINE" not in lines
    if "done_at" in kw and kw["done_at"] is not None:
        assert "ALLDONE" in lines and "STEP 3" in lines


class _FakeMember:
    """The blackboard surface a member reads: a control row the test
    moves, the controller's silence, and its incarnation."""

    def __init__(self):
        self.row = (1, 2, 3, 0, 0, -1, 0)
        self.silent = False
        self.ctrl_inc = 1
        self.reads = 0

    def read_control(self):
        self.reads += 1
        return self.row

    def controller_silent(self, bound_s):
        return self.silent


class _Spec:
    hb_ms = 50
    port = 1
    barrier_base = 0
    barrier_wait_s = 0.01
    ctrl_lease_s = 0.5


def _member(module):
    """A ``ControlPlaneMember`` of ``module`` at epoch 1 with no van:
    the attributes ``_init_control_plane`` sets, minus the netem hook."""
    class Member(module.ControlPlaneMember):
        pass
    m = Member()
    m.spec, m.member = _Spec(), _FakeMember()
    m.committed, m.epoch, m.acked = 3, 1, 1
    m._replica, m._van_voided, m._bars = None, None, None
    m._stop = threading.Event()
    return m


class _StuckBarrier:
    """A barrier that times out until ``release`` is set; ``on_wait``
    runs at each wait (the test moves the control row there)."""

    def __init__(self, on_wait):
        self.on_wait, self.waits = on_wait, 0

    def wait(self, timeout_s):
        self.waits += 1
        self.on_wait(self.waits)
        raise TimeoutError


@pytest.mark.parametrize("move", ["new_epoch", "prepare"])
def test_member_voids_its_step_when_the_control_row_moves(move):
    """A barrier that times out re-reads the control row: unchanged, the
    member waits again; a new epoch or a PREPARE freeze raises
    ``EpochChanged`` (the in-flight step is void) — in both packages."""
    for module in (mp, jmp):
        m = _member(module)

        def on_wait(n, m=m):
            if n == 3:
                m.member.row = ((2, 2, 3, 5, 0, -1, 0) if move ==
                                "new_epoch" else (1, 2, 3, 0, 1, -1, 0))
        bar = _StuckBarrier(on_wait)
        with pytest.raises(module.EpochChanged):
            m._await_barrier(bar)
        assert bar.waits == 3  # two timeouts re-waited, the third moved
        m.member.row = (1, 2, 3, 0, 0, -1, 0)
        m._check_epoch()  # the same epoch, no freeze: no raise


def test_member_parks_while_the_controller_is_silent():
    """``_park_if_headless``: disabled while the controller beats; parks
    while it is silent; the same incarnation's beat resumes at once; a
    NEW incarnation holds the member until its republish (a new epoch)
    lands — in both packages."""
    for module in (mp, jmp):
        m = _member(module)
        assert m._park_if_headless() is False
        # silent, then the same incarnation beats again
        m.member.silent = True
        t = threading.Timer(0.2, lambda m=m: setattr(m.member, "silent",
                                                     False))
        t.start()
        t0 = time.monotonic()
        assert m._park_if_headless() is True
        assert 0.15 < time.monotonic() - t0 < WAIT_S
        assert m.parks == 1
        t.join(WAIT_S)
        # silent, then a takeover: a new incarnation beats, and the member
        # holds until the control row moves to a new epoch
        m.member.silent = True

        def takeover(m=m):
            m.member.ctrl_inc = 2
            m.member.silent = False
        t1 = threading.Timer(0.1, takeover)
        t2 = threading.Timer(0.4, lambda m=m: setattr(
            m.member, "row", (2, 2, 3, 5, 1, -1, 0)))
        t1.start()
        t2.start()
        t0 = time.monotonic()
        assert m._park_if_headless() is True
        assert 0.35 < time.monotonic() - t0 < WAIT_S
        assert m.parks == 2
        t1.join(WAIT_S)
        t2.join(WAIT_S)
        # disabled when ctrl_lease_s is 0
        m.spec = type("S", (_Spec,), {"ctrl_lease_s": 0.0})()
        m.member.silent = True
        assert m._park_if_headless() is False


# ---------------------------------------------------------------------------
# clean runs, worker processes over the van
# ---------------------------------------------------------------------------

def _clean_run(module, workdir, **kw):
    workdir.mkdir()
    sup = module.MultiControllerElasticSupervisor(
        2, workdir=workdir, steps=8, global_batch=8, lease_s=2.0,
        suspect_grace_s=2.0, ordered_grads=True, **kw)
    try:
        rep = sup.run(deadline_s=WAIT_S)
        sup.verify_consumed(rep["consumed"])
        return rep, sup
    finally:
        sup.close()


def _records(consumed):
    return {step: sorted(recs) for step, recs in consumed.items()}


def test_clean_ordered_run_equals_the_references(tmp_path):
    """A clean 2-worker, 8-step, ``ordered_grads`` run in each package
    over its own van: every consumed record equal, the final weights
    bitwise equal; the port's workers said ``jax=0 torch=0``."""
    got, sup = _clean_run(mc, tmp_path / "port")
    want, _ = _clean_run(jmc, tmp_path / "ref")
    assert _records(got["consumed"]) == _records(want["consumed"])
    assert sorted(got["consumed"]) == list(range(8))
    assert got["final_weights"].dtype == np.float32
    assert np.array_equal(got["final_weights"], want["final_weights"]), \
        np.abs(got["final_weights"] - want["final_weights"]).max()
    assert got["epochs"] == want["epochs"] == 1
    assert got["resizes"] == want["resizes"] == []
    for slot in (0, 1):
        (log,) = (tmp_path / "port").glob(f"worker_{slot}_*.log")
        assert f"READY {slot} jax=0 torch=0" in log.read_text()
    # the clean run counted no re-push; both workers dumped on close
    dumps = [fleet.stream_metric_dumps(p) for p in
             sorted((tmp_path / "port").glob("worker_s*.trace.jsonl"))]
    assert len(dumps) == 2 and all(dumps)
    assert sup.fleet_metrics().counter("ps.dp_repush_duplicates").value \
        == 0


def test_ordered_grads_clean_runs_bitwise_identical(tmp_path):
    """Port mirror of ``tests/test_multicontroller.py:218``: two clean
    same-seed ``ordered_grads`` runs end bitwise equal."""
    w1 = _clean_run(mc, tmp_path / "a")[0]["final_weights"]
    w2 = _clean_run(mc, tmp_path / "b")[0]["final_weights"]
    assert np.array_equal(w1, w2), (
        f"ordered-grads runs diverged: max |d| = {np.abs(w1 - w2).max()}")


def test_deaf_ack_plumbs_through_elastic_supervisor(tmp_path,
                                                    monkeypatch):
    """Port mirror of ``tests/test_ctrlchaos.py:325`` (spawns patched
    out: this pins the constructor plumb, not member behaviour)."""
    S = mc.MultiControllerElasticSupervisor
    monkeypatch.setattr(S, "_spawn", lambda self, slot: None)
    monkeypatch.setattr(S, "_wait_joined",
                        lambda self, slots, timeout_s=None: None)
    monkeypatch.setattr(S, "_publish", lambda self, **kw: None)
    sup = S(2, workdir=tmp_path, steps=2, global_batch=4, deaf_ack_s=2.5)
    try:
        assert sup.svc.deaf_ack_s == 2.5
        # the parking bound rides the worker spec
        assert sup.spec.ctrl_lease_s == 0.0
    finally:
        sup.close()


def _controller_kwargs(module, monkeypatch, tmp_path, cfg):
    """The keyword arguments ``module.controller_main`` builds its
    supervisor with (the supervisor and the harness faked)."""
    import json
    got = {}

    class Sup:
        poll = None

        def __init__(self, n, **kw):
            got.update(kw, n_workers=n)
    monkeypatch.setattr(module, "MultiControllerElasticSupervisor", Sup)
    monkeypatch.setattr(module, "drive_controller_harness",
                        lambda *a, **k: 0)
    monkeypatch.setattr(module.trace, "open_process_stream",
                        lambda *a, **k: None)
    path = tmp_path / "ctrl.json"
    path.write_text(json.dumps(cfg))
    assert module.controller_main(str(path)) == 0
    return got


def test_controller_config_keys_beyond_the_references(tmp_path,
                                                      monkeypatch):
    """A config without the added keys builds the reference's supervisor
    (the added keys at the supervisor's defaults); with them, the problem
    they name."""
    import inspect
    defaults = inspect.signature(
        mc.MultiControllerElasticSupervisor.__init__).parameters
    cfg = {"workdir": str(tmp_path), "port": 7, "n_workers": 3,
           "steps": 5, "global_batch": 12, "lease_s": 0.5}
    port = _controller_kwargs(mc, monkeypatch, tmp_path, cfg)
    ref = _controller_kwargs(jmc, monkeypatch, tmp_path, cfg)
    added = {"features", "out_dim", "n_samples", "lr", "ordered_grads"}
    assert set(port) - set(ref) == added
    assert {k: port[k] for k in ref} == ref
    assert {k: port[k] for k in added} == {k: defaults[k].default
                                           for k in added}
    wide = _controller_kwargs(mc, monkeypatch, tmp_path, {
        **cfg, "features": 64, "out_dim": 32, "n_samples": 768,
        "lr": 0.01, "ordered_grads": True})
    assert (wide["features"], wide["out_dim"], wide["n_samples"],
            wide["lr"], wide["ordered_grads"]) == (64, 32, 768, 0.01, True)


def test_repush_counter_reaches_fleet_metrics(tmp_path):
    """A worker that counts a re-pushed gradient writes its registry into
    its trace stream at once (a SIGKILL before its close would lose the
    count otherwise); ``fleet_metrics()`` sums the last dump of every
    worker stream in the workdir."""
    from hetu_tpu_torch.telemetry import default_registry

    class Worker:
        _count_repush = mc.WorkerProcess._count_repush

    counter = default_registry.counter("ps.dp_repush_duplicates")
    before = counter.value
    for slot, n in ((0, 2), (1, 1)):
        tracer = trace.Tracer(
            jsonl_path=tmp_path / f"worker_s{slot}_p{100 + slot}.trace.jsonl")
        trace.enable(tracer=tracer)
        try:
            for _ in range(n):
                Worker()._count_repush()
        finally:
            trace.disable()
            tracer.close()
    assert counter.value == before + 3

    # each stream's LAST dump counts: this process's registry after two
    # and after three re-pushes
    got = mc.worker_metrics(tmp_path).counter(
        "ps.dp_repush_duplicates").value
    assert got == (before + 2) + (before + 3)
