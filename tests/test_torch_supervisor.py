"""The port's training supervisor (``hetu_tpu_torch.resilience.supervisor``)
against hetu_tpu's, on the CPU.

Mirrored from the reference's fast lane (``tests/test_resilience.py``):
keep-K pruning; restore past a corrupt newest file, by CRC and by a
matching CRC over garbage; none when empty; the guarded step; training
with counted faults; the abort after three nonfinite steps; a
non-transient error raised at once; retries given up after their budget;
in-process preemption with step-exact resume; the preempt flag cleared
between runs; the signal handler restored; counters through
``MetricLogger``.  From the chaos tests: a real SIGTERM to a training
subprocess and a step-exact resume (``test_resilience_chaos.py``), and
``PSShardGuard``'s durable slots over two real van shard processes
(``test_elastic_chaos.py``); from ``test_telemetry.py``, the supervisor's
phase spans.

Parity, on the reference's toy problem (``Linear(4, 16)`` -> ReLU ->
``Linear(16, 2)``, Adam 0.01, 30 steps, one ``nan_grad`` and two
``data_error`` faults), the same weights on both sides: equal counters
(the checkpoint latency aside), equal ``supervisor.retry`` instant
arguments, per-step losses within rtol 1e-5 (atol 1e-6), final
parameters within rtol 1e-4 (atol 1e-5).  Checkpoints cross the packages
both ways, for a ``TrainState`` and for a plain dict, and the ``.crc``
sidecars are the same bytes.

The port's departures, each pinned here: ``CheckpointManager(config=)``;
``NonFiniteAbort.state`` is the caller's live state; no ``train.compile``
span (the port's Executor runs eagerly); a cadence snapshot skips a shard
that awaits repair.
"""

import os
import signal
import subprocess
import sys
import time
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hetu_tpu as ht
from hetu_tpu import layers as jlayers
from hetu_tpu import optim as joptim
from hetu_tpu import resilience as jres
from hetu_tpu.telemetry import trace as jtrace
from hetu_tpu.train import checkpoint as jckpt
from hetu_tpu.train.executor import Executor as JExecutor
from hetu_tpu_torch import interop, layers, ops, optim
from hetu_tpu_torch import rng as hrng
from hetu_tpu_torch.resilience import (
    CheckpointManager, FaultEvent, FaultInjector, FaultSchedule,
    NonFiniteAbort, PSShardGuard, Supervisor, TransientDataError,
    TransientFault, default_is_transient,
)
from hetu_tpu_torch.resilience.shardproc import free_port, spawn_shard_server
from hetu_tpu_torch.telemetry import trace
from hetu_tpu_torch.train import Executor
from hetu_tpu_torch.train import checkpoint
from hetu_tpu_torch.utils.logger import MetricLogger

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5

# ---------------------------------------------------------------------------
# the reference's toy training problem, in both packages
# ---------------------------------------------------------------------------

_G = np.random.default_rng(0)
_X = _G.standard_normal((256, 4)).astype(np.float32)
_Y = (_X.sum(1) > 0).astype(np.int32)


def _batch_fn(i):
    lo = (int(i) * 32) % 224
    return {"x": _X[lo:lo + 32], "y": _Y[lo:lo + 32]}


def _jax_model():
    return jlayers.Sequential(jlayers.Linear(4, 16), jlayers.Relu(),
                              jlayers.Linear(16, 2))


def _jax_executor(seed=0):
    model = _jax_model()

    def loss_fn(params, model_state, batch, rng, train):
        out, new_state = model.apply(
            {"params": params, "state": model_state}, batch["x"],
            train=train, rng=rng)
        loss = jnp.mean(ht.ops.softmax_cross_entropy_sparse(out, batch["y"]))
        return loss, ({}, new_state)

    ex = JExecutor(loss_fn, joptim.AdamOptimizer(0.01), seed=seed)
    state = ex.init_state(model.init(jax.random.PRNGKey(seed)))
    return ex, state


def _torch_executor(seed=0):
    """The port's toy executor, its weights the reference's at ``seed``
    (``model.init(PRNGKey(seed))``) carried across through ``interop``."""
    g = torch.Generator().manual_seed(seed)
    model = layers.Sequential(layers.Linear(4, 16, generator=g),
                              layers.Relu(),
                              layers.Linear(16, 2, generator=g))
    params = _jax_model().init(jax.random.PRNGKey(seed))["params"]
    model.load_state_dict(interop.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), model))

    def loss_fn(params, model_state, batch, gen, train):
        out = model(batch["x"])
        loss = ops.softmax_cross_entropy_sparse(out, batch["y"]).mean()
        return loss, ({}, model_state)

    ex = Executor(loss_fn, optim.AdamOptimizer(0.01), seed=seed)
    return ex, ex.init_state(model), model


def _params(state):
    return {k: v.detach().clone() for k, v in state.params.items()}


# ---------------------------------------------------------------------------
# checkpoint manager
# ---------------------------------------------------------------------------

def _np_state(seed):
    g = np.random.default_rng(seed)
    return {"w": g.standard_normal((4, 2)).astype(np.float32)}


def test_manager_keep_k_prunes(tmp_path):
    m = CheckpointManager(tmp_path, keep=3)
    for s in (2, 4, 6, 8):
        m.save(_np_state(s), s)
    assert m.steps() == [4, 6, 8]
    files = sorted(p.name for p in tmp_path.iterdir())
    assert "ckpt-00000002.npz" not in files
    assert "ckpt-00000008.crc" in files
    ref = jres.CheckpointManager(tmp_path / "ref", keep=3)
    for s in (2, 4, 6, 8):
        ref.save(_np_state(s), s)
    assert files == sorted(p.name for p in ref.dir.iterdir())


def test_manager_restore_skips_corrupt_newest(tmp_path):
    m = CheckpointManager(tmp_path, keep=5)
    for s in (1, 2, 3):
        m.save(_np_state(s), s)
    # corrupt newest: garbage npz, stale crc sidecar -> crc mismatch
    (tmp_path / "ckpt-00000003.npz").write_bytes(os.urandom(64))
    state, step = m.restore(_np_state(0))
    assert step == 2
    np.testing.assert_array_equal(state["w"], _np_state(2)["w"])
    assert m.skipped == [str(tmp_path / "ckpt-00000003.npz")]

    # corrupt with a matching crc: the load itself must call it corrupt
    garbage = os.urandom(64)
    (tmp_path / "ckpt-00000002.npz").write_bytes(garbage)
    (tmp_path / "ckpt-00000002.crc").write_text(
        f"{zlib.crc32(garbage):08x} {len(garbage)}\n")
    state, step = m.restore(_np_state(0))
    assert step == 1
    assert m.last_restored == str(tmp_path / "ckpt-00000001.npz")


def test_manager_restore_none_when_empty(tmp_path):
    assert CheckpointManager(tmp_path).restore(_np_state(0)) is None


def test_manager_refuses_a_train_state_without_its_config(tmp_path):
    """The port's ``config=`` departure: a ``TrainState`` is converted to
    the reference's layout through its model's config, so without one the
    save refuses rather than writing what no load can read."""
    ex, state, model = _torch_executor()
    with pytest.raises(TypeError, match="config"):
        CheckpointManager(tmp_path).save(state, 1)
    assert CheckpointManager(tmp_path).steps() == []
    CheckpointManager(tmp_path, config=model).save(state, 1)
    assert CheckpointManager(tmp_path).steps() == [1]


def test_manager_restores_tensors_in_their_template_kind(tmp_path):
    """A plain dict of tensors comes back as tensors of the template's
    dtype (a bf16 leaf through its exact f32 copy), nested keys and
    all."""
    g = torch.Generator().manual_seed(3)
    state = {"b": {"z": torch.randn(3, generator=g).to(torch.bfloat16),
                   "a": torch.arange(4, dtype=torch.int32)},
             "w": torch.randn(2, 5, generator=g)}
    m = CheckpointManager(tmp_path)
    m.save(state, 7)
    template = {"b": {"z": torch.zeros(3, dtype=torch.bfloat16),
                      "a": torch.zeros(4, dtype=torch.int32)},
                "w": torch.zeros(2, 5)}
    got, step = m.restore(template)
    assert step == 7
    for path in (("b", "z"), ("b", "a"), ("w",)):
        a, b = got, state
        for k in path:
            a, b = a[k], b[k]
        assert isinstance(a, torch.Tensor) and a.dtype == b.dtype
        assert torch.equal(a, b), path


# ---------------------------------------------------------------------------
# checkpoints across the packages, and the .crc sidecar's bytes
# ---------------------------------------------------------------------------

def _trained_pair(steps=3):
    jex, js = _jax_executor(seed=2)
    tex, ts, model = _torch_executor(seed=2)
    for i in range(steps):
        js, _ = jex.run("train", js, _batch_fn(i))
        ts, _ = tex.run("train", ts, _batch_fn(i))
    return (jex, js), (tex, ts, model)


def test_reference_manager_checkpoint_restores_in_the_port(tmp_path):
    (_, js), _ = _trained_pair()
    jres.CheckpointManager(tmp_path, keep=2).save(js, 3)
    tex, fresh, model = _torch_executor(seed=9)
    m = CheckpointManager(tmp_path, keep=2, config=model)
    got, step = m.restore(fresh)
    assert step == 3 and got is fresh and got.step == 3
    want = jckpt.state_dict(js)
    have = checkpoint.state_dict(got, model)
    assert list(have) == list(want)
    for k, w in want.items():
        assert np.array_equal(have[k], np.asarray(w)), k
    # the sidecar the reference wrote is the one the port would write
    path = tmp_path / "ckpt-00000003.npz"
    crc, n = CheckpointManager._crc_file(path)
    assert path.with_suffix(".crc").read_bytes() == \
        f"{crc:08x} {n}\n".encode()


def test_port_manager_checkpoint_restores_in_the_reference(tmp_path):
    (_, js), (tex, ts, model) = _trained_pair()
    CheckpointManager(tmp_path, keep=2, config=model).save(ts, 3)
    got, step = jres.CheckpointManager(tmp_path, keep=2).restore(js)
    assert step == 3
    want = checkpoint.state_dict(ts, model)
    have = jckpt.state_dict(got)
    assert list(have) == list(want)
    for k, w in want.items():
        assert np.array_equal(np.asarray(have[k]), w), k
    path = tmp_path / "ckpt-00000003.npz"
    crc, n = jres.CheckpointManager._crc_file(path)
    assert path.with_suffix(".crc").read_bytes() == \
        f"{crc:08x} {n}\n".encode()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_plain_dict_checkpoints_cross_the_packages(tmp_path, writer):
    state = {"a": {"k": np.arange(6, dtype=np.int32).reshape(2, 3)},
             "w": _np_state(4)["w"]}
    make = jres.CheckpointManager if writer == "reference" \
        else CheckpointManager
    read = CheckpointManager if writer == "reference" \
        else jres.CheckpointManager
    make(tmp_path).save(state, 5)
    template = {"a": {"k": np.zeros((2, 3), np.int32)},
                "w": np.zeros((4, 2), np.float32)}
    got, step = read(tmp_path).restore(template)
    assert step == 5
    np.testing.assert_array_equal(np.asarray(got["a"]["k"]), state["a"]["k"])
    np.testing.assert_array_equal(np.asarray(got["w"]), state["w"])
    path = tmp_path / "ckpt-00000005.npz"
    assert checkpoint.read_header(path) == jckpt.read_header(path)
    crc, n = read._crc_file(path)
    assert path.with_suffix(".crc").read_text() == f"{crc:08x} {n}\n"


# ---------------------------------------------------------------------------
# guarded train step
# ---------------------------------------------------------------------------

def test_guarded_step_skips_nonfinite_update():
    ex, state, _ = _torch_executor()
    p0 = _params(state)

    bad = {"x": np.full((32, 4), np.nan, np.float32), "y": _Y[:32]}
    state, metrics = ex.run("train_guarded", state, bad)
    assert int(metrics["nonfinite"]) == 1
    assert state.step == 1  # the step advances past the poisoned batch
    for k, v in state.params.items():
        assert torch.equal(v, p0[k]), k

    state, metrics = ex.run("train_guarded", state, _batch_fn(0))
    assert int(metrics["nonfinite"]) == 0
    assert np.isfinite(float(metrics["loss"]))
    assert max(float((v.detach() - p0[k]).abs().max())
               for k, v in state.params.items()) > 0


# ---------------------------------------------------------------------------
# supervisor
# ---------------------------------------------------------------------------

def test_supervisor_trains_and_counts_faults(tmp_path):
    ex, state, model = _torch_executor()
    sched = FaultSchedule([FaultEvent(3, "nan_grad"),
                           FaultEvent(5, "data_error"),
                           FaultEvent(7, "data_error")])
    sup = Supervisor(ex, ckpt_dir=tmp_path, ckpt_every=10, config=model,
                     injector=FaultInjector(sched), backoff_base_s=0.001)
    losses = []

    def post_step(i, st, metrics, batch):
        losses.append(float(metrics["loss"]))

    rep = sup.run(state, _batch_fn, 30, post_step=post_step)
    assert rep.step == 30 and not rep.preempted
    assert rep.counters["nonfinite_steps_skipped"] == 1
    assert rep.counters["retries_data"] == 2
    assert rep.counters["checkpoints"] >= 2
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])
    assert len(losses) == 29  # post_step is skipped on the poisoned step


def test_supervisor_aborts_after_consecutive_nonfinite(tmp_path):
    """The abort hands back the last finite state, checkpointed: in the
    port that is the caller's own state object, its tensors the pre-step
    values the guarded steps put back."""
    ex, state, model = _torch_executor()
    p0 = _params(state)
    bad = {"x": np.full((32, 4), np.nan, np.float32), "y": _Y[:32]}
    sup = Supervisor(ex, nonfinite_limit=3, ckpt_dir=tmp_path, config=model)
    with pytest.raises(NonFiniteAbort) as ei:
        sup.run(state, lambda i: bad, 10)
    assert sup.counters["nonfinite_steps_skipped"] == 3
    assert ei.value.state is not None and ei.value.step == 2
    assert ei.value.state.params is state.params  # the live tensors
    for k, v in ei.value.state.params.items():
        assert torch.equal(v, p0[k]), k
    assert sup.manager.steps() == [2]
    restored = sup.manager.restore(ei.value.state)
    assert restored is not None and restored[1] == 2


def test_supervisor_nontransient_error_raises_immediately():
    ex, state, _ = _torch_executor()
    sup = Supervisor(ex, retries=5)
    calls = []

    def bad_batch(i):
        calls.append(i)
        raise ValueError("a real bug, not a transient")

    with pytest.raises(ValueError):
        sup.run(state, bad_batch, 10)
    assert len(calls) == 1
    assert sup.counters.get("retries", 0) == 0


def test_supervisor_retry_gives_up_after_budget():
    ex, state, _ = _torch_executor()
    sup = Supervisor(ex, retries=3, backoff_base_s=0.001)
    calls = []

    def always_flaky(i):
        calls.append(i)
        raise TransientDataError("flaky forever")

    with pytest.raises(TransientDataError):
        sup.run(state, always_flaky, 10)
    assert len(calls) == 4  # initial + 3 retries
    assert sup.counters["retries"] == 3


@pytest.mark.parametrize("exc, want", [
    (TransientFault("injected"), True),
    (TransientDataError("flaky"), True),
    (ConnectionError("reset"), True),
    (TimeoutError("slow"), True),
    (RuntimeError("hetu_ps group_sparse_pull failed with rc=-1"), True),
    (RuntimeError("CUDA out of memory"), False),
    (ValueError("shape"), False),
])
def test_default_is_transient(exc, want):
    assert default_is_transient(exc) is want


def test_preemption_checkpoint_and_step_exact_resume(tmp_path):
    """SIGTERM (the injector's simulated preemption) checkpoints at the
    end of the step in flight; a fresh supervisor resumes and finishes
    with exactly the state of an uninterrupted run: parameters, slots,
    rng words, step and (seed, seqnum), bit for bit."""
    total = 12
    ex_a, st_a, model = _torch_executor(seed=5)
    rep_a = Supervisor(ex_a).run(st_a, _batch_fn, total)
    rng_a = hrng.get_seed_status()
    want = checkpoint.state_dict(rep_a.state, model)

    ex_b, st_b, _ = _torch_executor(seed=5)
    sched = FaultSchedule([FaultEvent(6, "preempt")])
    sup_b = Supervisor(ex_b, ckpt_dir=tmp_path, ckpt_every=100,
                       injector=FaultInjector(sched), config=model)
    rep_b = sup_b.run(st_b, _batch_fn, total)
    assert rep_b.preempted
    assert rep_b.step == 7  # the signal lands in step 6; the step finishes
    assert rep_b.counters["preempt_signals"] == 1

    ex_c, st_c, model_c = _torch_executor(seed=999)  # restore must win
    rep_c = Supervisor(ex_c, ckpt_dir=tmp_path, config=model_c).run(
        st_c, _batch_fn, total)
    assert rep_c.counters["resumed_from_step"] == 7
    assert rep_c.step == total
    assert hrng.get_seed_status() == rng_a
    got = checkpoint.state_dict(rep_c.state, model_c)
    assert list(got) == list(want)
    for k, w in want.items():
        assert np.array_equal(got[k], w), k


def test_preempt_flag_clears_between_runs_on_same_supervisor(tmp_path):
    ex, state, model = _torch_executor()
    sched = FaultSchedule([FaultEvent(3, "preempt")])
    sup = Supervisor(ex, ckpt_dir=tmp_path, injector=FaultInjector(sched),
                     config=model)
    rep = sup.run(state, _batch_fn, 10)
    assert rep.preempted and rep.step == 4
    rep2 = sup.run(rep.state, _batch_fn, 10, resume=False)
    assert not rep2.preempted
    assert rep2.step == 10


def test_supervisor_signal_handler_restored():
    ex, state, _ = _torch_executor()
    before = signal.getsignal(signal.SIGTERM)
    Supervisor(ex).run(state, _batch_fn, 2)
    assert signal.getsignal(signal.SIGTERM) is before


def test_supervisor_off_the_main_thread_leaves_the_handler_alone():
    import threading
    ex, state, _ = _torch_executor()
    before = signal.getsignal(signal.SIGTERM)
    out = {}
    th = threading.Thread(target=lambda: out.update(
        rep=Supervisor(ex).run(state, _batch_fn, 2)))
    th.start()
    th.join(60)
    assert out["rep"].step == 2
    assert signal.getsignal(signal.SIGTERM) is before


def test_counters_flow_through_metric_logger(tmp_path):
    log_path = tmp_path / "train.log"
    logger = MetricLogger(str(log_path))
    ex, state, _ = _torch_executor()
    sched = FaultSchedule([FaultEvent(1, "nan_grad")])
    sup = Supervisor(ex, injector=FaultInjector(sched), logger=logger)
    sup.run(state, _batch_fn, 5)
    logger.close()
    assert logger.counters_snapshot()["nonfinite_steps_skipped"] == 1
    assert "nonfinite_steps_skipped" in log_path.read_text()


# ---------------------------------------------------------------------------
# parity with the reference on the toy problem
# ---------------------------------------------------------------------------

def _supervised(pkg, tmp_path):
    """30 supervised steps of the toy problem in ``pkg`` ("jax" or
    "torch") under one nan_grad and two data_error faults, checkpointing
    every 10: (report, per-step losses, supervisor.retry instant args,
    final parameters in the reference's tree)."""
    sched_kw = dict(steps=30, seed=0, nan_steps=1, data_errors=2)
    losses = []

    def post_step(i, st, metrics, batch):
        losses.append((i, float(metrics["loss"])))

    if pkg == "jax":
        ex, state = _jax_executor(seed=1)
        tr = jtrace.enable()
        try:
            sup = jres.Supervisor(
                ex, ckpt_dir=tmp_path / pkg, ckpt_every=10,
                injector=jres.FaultInjector(
                    jres.FaultSchedule.generate(**sched_kw)),
                backoff_base_s=0.001, seed=4)
            rep = sup.run(state, _batch_fn, 30, post_step=post_step)
        finally:
            jtrace.disable()
        params = jax.tree_util.tree_map(np.asarray, rep.state.params)
    else:
        ex, state, model = _torch_executor(seed=1)
        tr = trace.enable()
        try:
            sup = Supervisor(
                ex, ckpt_dir=tmp_path / pkg, ckpt_every=10,
                injector=FaultInjector(FaultSchedule.generate(**sched_kw)),
                backoff_base_s=0.001, seed=4, config=model)
            rep = sup.run(state, _batch_fn, 30, post_step=post_step)
        finally:
            trace.disable()
        params = interop.params_to_jax(rep.state.params, model)
    retries = [e["args"] for e in tr.events
               if e["name"] == "supervisor.retry"]
    return rep, losses, retries, params


def test_supervised_toy_run_matches_the_reference(tmp_path):
    ref, ref_losses, ref_retries, ref_params = _supervised("jax", tmp_path)
    got, losses, retries, params = _supervised("torch", tmp_path)
    skip = {"checkpoint_latency_s_last"}
    assert {k: v for k, v in got.counters.items() if k not in skip} == \
        {k: v for k, v in ref.counters.items() if k not in skip}
    assert got.counters["nonfinite_steps_skipped"] == 1
    assert got.counters["retries_data"] == 2
    assert retries == ref_retries and len(retries) == 2
    assert [i for i, _ in losses] == [i for i, _ in ref_losses]
    np.testing.assert_allclose([x for _, x in losses],
                               [x for _, x in ref_losses],
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    for (path, r), (_, a) in zip(
            jax.tree_util.tree_flatten_with_path(ref_params)[0],
            jax.tree_util.tree_flatten_with_path(params)[0]):
        np.testing.assert_allclose(a, r, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=jax.tree_util.keystr(path))
    assert got.step == ref.step == 30
    assert CheckpointManager(tmp_path / "torch").steps() == \
        jres.CheckpointManager(tmp_path / "jax").steps() == [10, 20, 30]


def test_supervisor_phase_spans():
    """The reference's span counts (``test_telemetry.py``), but for
    ``train.compile``: the port's Executor runs eagerly and compiles
    nothing."""
    ex, state, _ = _torch_executor()
    tr = trace.enable()
    try:
        Supervisor(ex, injector=FaultInjector(FaultSchedule([])),
                   backoff_base_s=0.001).run(state, _batch_fn, 4)
    finally:
        trace.disable()
    names = [e["name"] for e in tr.events]
    assert "train.compile" not in names
    assert names.count("train.data_wait") == 4
    assert names.count("train.host_to_device") == 4
    assert names.count("train.step.train_guarded") == 4


def test_checkpoint_and_recovery_spans(tmp_path):
    ex, state, model = _torch_executor()
    sched = FaultSchedule([FaultEvent(1, "data_error"),
                           FaultEvent(2, "nan_grad")])
    tr = trace.enable()
    try:
        Supervisor(ex, ckpt_dir=tmp_path, ckpt_every=2, config=model,
                   injector=FaultInjector(sched),
                   backoff_base_s=0.001).run(state, _batch_fn, 4)
    finally:
        trace.disable()
    names = [e["name"] for e in tr.events]
    # cadence at 2, final at 4
    assert names.count("supervisor.checkpoint") == 2
    assert names.count("supervisor.checkpoint_write") == 2
    assert names.count("recovery.retry") == 1
    assert names.count("recovery.nonfinite_skip") == 1
    from hetu_tpu_torch.telemetry import timeline
    pairs = timeline.correlate(tr.events)
    assert {p.kind for p in pairs} == {"data_error", "nan_grad"}
    assert all(p.paired for p in pairs)


# ---------------------------------------------------------------------------
# a real SIGTERM to a training subprocess
# ---------------------------------------------------------------------------

TRAIN_SRC = '''
import hashlib, sys
sys.path.insert(0, {repo!r})
import numpy as np, torch
torch.set_num_threads(1)
from hetu_tpu_torch import layers, ops, optim, rng as hrng
from hetu_tpu_torch.resilience import Supervisor
from hetu_tpu_torch.train import Executor, checkpoint

ckpt_dir, hold_at = sys.argv[1], int(sys.argv[2])
g = np.random.default_rng(0)
X = g.standard_normal((128, 4)).astype(np.float32)
Y = (X.sum(1) > 0).astype(np.int32)
gen = torch.Generator().manual_seed(5)
model = layers.Sequential(layers.Linear(4, 16, generator=gen), layers.Relu(),
                          layers.Linear(16, 2, generator=gen))

def loss_fn(params, model_state, batch, gen, train):
    loss = ops.softmax_cross_entropy_sparse(model(batch["x"]),
                                            batch["y"]).mean()
    return loss, ({{}}, model_state)

def batch_fn(i):
    lo = (int(i) * 32) % 96
    return {{"x": X[lo:lo + 32], "y": Y[lo:lo + 32]}}

def post_step(i, state, metrics, batch):
    print("step", i, flush=True)
    if i == hold_at:
        sys.stdin.readline()  # held here until the parent has signalled

ex = Executor(loss_fn, optim.AdamOptimizer(0.01), seed=5)
state = ex.init_state(model)
sup = Supervisor(ex, ckpt_dir=ckpt_dir, ckpt_every=100, config=model)
rep = sup.run(state, batch_fn, 12, post_step=post_step)
assert "jax" not in sys.modules
assert not any(m == "hetu_tpu" or m.startswith("hetu_tpu.")
               for m in sys.modules)
if rep.preempted:
    print("PREEMPTED", rep.step, flush=True)
else:
    leaves = checkpoint.state_dict(rep.state, model).values()
    h = hashlib.md5(b"".join(np.asarray(l).tobytes() for l in leaves))
    print("DONE", rep.step, h.hexdigest(), *hrng.get_seed_status(),
          flush=True)
'''


def _run_train(tmp_path, ckpt_dir, *, sigterm_after_step=-1):
    script = tmp_path / "train.py"
    script.write_text(TRAIN_SRC.format(repo=str(REPO)))
    proc = subprocess.Popen(
        [sys.executable, str(script), str(ckpt_dir),
         str(sigterm_after_step)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line.strip())
            if line.startswith(f"step {sigterm_after_step}"):
                proc.send_signal(signal.SIGTERM)
                proc.stdin.write("go\n")
                proc.stdin.flush()
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return rc, lines


def test_sigterm_preemption_resume_is_step_exact(tmp_path):
    """A real SIGTERM to a training subprocess, held at step 4 until the
    signal is sent, checkpoints and exits cleanly; rerunning resumes and
    finishes with the exact state (step, md5 of every leaf, (seed,
    seqnum)) of an uninterrupted run."""
    rc, lines = _run_train(tmp_path, tmp_path / "ref_ckpt")
    assert rc == 0, lines
    ref_done = [ln for ln in lines if ln.startswith("DONE")][0]

    pre_dir = tmp_path / "pre_ckpt"
    rc, lines = _run_train(tmp_path, pre_dir, sigterm_after_step=4)
    assert rc == 0, lines
    assert "PREEMPTED 5" in lines, lines

    rc, lines = _run_train(tmp_path, pre_dir)  # resumes
    assert rc == 0, lines
    assert [ln for ln in lines if ln.startswith("step")][0] == "step 5"
    assert [ln for ln in lines if ln.startswith("DONE")][0] == ref_done


# ---------------------------------------------------------------------------
# PSShardGuard over real van shard processes
# ---------------------------------------------------------------------------

ROWS, DIM = 16, 4


@pytest.fixture
def two_servers(tmp_path):
    ports = [free_port(), free_port()]
    procs = [spawn_shard_server(tmp_path, p, f"s{i}")
             for i, p in enumerate(ports)]
    yield ports, procs
    for p in procs:
        p.kill()
        p.wait()


def _adam_table(ports, table_id):
    from hetu_tpu_torch.ps import van
    return van.PartitionedPSTable(
        [("127.0.0.1", p) for p in ports], rows=ROWS, dim=DIM,
        init="zeros", optimizer="adam", lr=0.01, table_id=table_id,
        heartbeat_ms=100)


def _kill_and_wait_dead(t, procs, i, deadline):
    procs[i].kill()
    procs[i].wait()
    while t.alive[i]:
        assert time.monotonic() < deadline, "the heartbeat never saw it"
        time.sleep(0.05)


def test_killed_shard_resumes_with_bitwise_identical_slots(two_servers,
                                                           tmp_path):
    """Same pushes into a guarded table and a control table; SIGKILL the
    guarded table's shard 1 after the snapshot; after repair, weights and
    Adam m, v and step on the resurrected shard equal the control's
    bitwise, and one more push lands on the control's trajectory."""
    ports, procs = two_servers
    t = _adam_table(ports, table_id=951)
    control = _adam_table(ports, table_id=952)

    idx = np.arange(ROWS, dtype=np.int64)
    g = np.random.default_rng(3).standard_normal((ROWS, DIM)) \
        .astype(np.float32)
    for k in range(5):
        t.sparse_push(idx, g * (k + 1))
        control.sparse_push(idx, g * (k + 1))

    guard = PSShardGuard(t, snapshot_path=tmp_path / "snap.npz")
    assert guard.slots
    guard.snapshot()

    shard1 = np.arange(8, 16, dtype=np.int64)
    want_w = control.sparse_pull(shard1)
    want_s1, want_s2, want_step = control.slots_get(shard1)
    assert (want_step == 5).all()
    assert np.abs(want_s1).sum() > 0 and np.abs(want_s2).sum() > 0
    control.sparse_push(shard1, g[8:])
    want_w6 = control.sparse_pull(shard1)
    want6 = control.slots_get(shard1)

    deadline = time.monotonic() + 30
    _kill_and_wait_dead(t, procs, 1, deadline)
    procs[1] = spawn_shard_server(tmp_path, ports[1], "r1")
    while guard.repairs == 0:
        assert time.monotonic() < deadline, "shard never repaired"
        guard.poll()
        time.sleep(0.05)

    np.testing.assert_array_equal(t.sparse_pull(shard1), want_w)
    got_s1, got_s2, got_step = t.slots_get(shard1)
    np.testing.assert_array_equal(got_s1, want_s1)
    np.testing.assert_array_equal(got_s2, want_s2)
    np.testing.assert_array_equal(got_step, want_step)

    t.sparse_push(shard1, g[8:])
    np.testing.assert_array_equal(t.sparse_pull(shard1), want_w6)
    for got, want in zip(t.slots_get(shard1), want6):
        np.testing.assert_array_equal(got, want)
    t.close()
    control.close()


def test_slot_snapshot_persists_and_reloads(two_servers, tmp_path):
    """A guard rebuilt from its persisted snapshot file still repairs
    slots; the file holds the reference's keys, and the reference's guard
    reads the same arrays from it."""
    ports, procs = two_servers
    t = _adam_table(ports, table_id=953)
    idx = np.arange(ROWS, dtype=np.int64)
    g = np.random.default_rng(5).standard_normal((ROWS, DIM)) \
        .astype(np.float32)
    t.sparse_push(idx, g)
    guard = PSShardGuard(t, snapshot_path=tmp_path / "snap.npz")
    assert guard.snapshot() == 2
    s1, s2, st = t.slots_get(idx)

    with np.load(tmp_path / "snap.npz") as z:
        assert sorted(z.files) == ["have", "have_slots", "s1", "s2", "step",
                                   "values"]
    guard2 = PSShardGuard(t, snapshot_path=tmp_path / "snap.npz")
    ref = jres.PSShardGuard(t, snapshot_path=tmp_path / "snap.npz")
    for gd in (guard2, ref):
        assert gd._have_slots == {0, 1} and gd._have == {0, 1}
        np.testing.assert_array_equal(gd._snap, t.sparse_pull(idx))
        np.testing.assert_array_equal(gd._snap_s1, s1)
        np.testing.assert_array_equal(gd._snap_s2, s2)
        np.testing.assert_array_equal(gd._snap_step, st)
    t.close()


def test_snapshot_skips_a_shard_awaiting_repair(two_servers, tmp_path):
    """A shard seen dead, then re-created blank by a training op before
    the next poll (and pushed to), is not snapshotted by a cadence
    snapshot in between: the repair replays the rows it had before the
    kill.  The reference's guard snapshots the blank re-create there and
    replays that."""
    ports, procs = two_servers
    t = _adam_table(ports, table_id=954)
    idx = np.arange(ROWS, dtype=np.int64)
    shard1 = np.arange(8, 16, dtype=np.int64)
    learned = np.arange(ROWS * DIM, dtype=np.float32).reshape(ROWS, DIM)
    t.sparse_set(idx, learned)
    guards = {"port": PSShardGuard(t), "reference": jres.PSShardGuard(t)}
    for gd in guards.values():
        gd.snapshot()

    _kill_and_wait_dead(t, procs, 1, time.monotonic() + 30)
    for gd in guards.values():
        gd.poll()  # sees shard 1 dead: pending
    procs[1] = spawn_shard_server(tmp_path, ports[1], "r1")
    t.sparse_push(idx, np.ones((ROWS, DIM), np.float32))  # re-creates blank
    assert t.recovered == 1
    blank = t.sparse_pull(shard1)
    assert not np.array_equal(blank, learned[8:])
    got = {}
    for name, gd in guards.items():
        assert gd.snapshot() == (1 if name == "port" else 2)
        assert gd.poll() == 1
        got[name] = t.sparse_pull(shard1)
        t.sparse_set(shard1, blank)  # the next guard starts from the same
    np.testing.assert_array_equal(got["port"], learned[8:])
    np.testing.assert_array_equal(got["reference"], blank)
    t.close()


def test_supervisor_repairs_a_killed_shard_from_its_snapshot(two_servers,
                                                             tmp_path):
    """``test_resilience_chaos.py``'s supervised repair: shard 1 holds
    rows that training never touches; it is SIGKILLed at step 6 and
    respawned on its port; the guard replays its snapshot, and training on
    shard 0's rows keeps descending."""
    import threading

    ports, procs = two_servers
    from hetu_tpu_torch.ps import van
    t = van.PartitionedPSTable([("127.0.0.1", p) for p in ports], rows=ROWS,
                               dim=DIM, init="zeros", optimizer="sgd",
                               lr=0.3, seed=0, table_id=901,
                               heartbeat_ms=100)
    learned = np.arange(8 * DIM, dtype=np.float32).reshape(8, DIM) + 1.0
    shard1_rows = np.arange(8, 16, dtype=np.int64)
    t.sparse_set(shard1_rows, learned)

    g = np.random.default_rng(0)
    X = torch.tensor(g.standard_normal((16, 4)).astype(np.float32))
    Yd = X @ torch.tensor(g.standard_normal((4, 2)).astype(np.float32))
    targets = torch.tensor(g.standard_normal((8, DIM)).astype(np.float32))
    model = layers.Linear(4, 2, generator=torch.Generator().manual_seed(0))
    idx0 = np.arange(8, dtype=np.int64)

    def loss_fn(params, model_state, batch, gen, train):
        diff = batch["rows"] - batch["targets"]
        loss = ((model(batch["x"]) - batch["y"]) ** 2).mean() \
            + (diff * diff).sum()
        return loss, ({"ge": 2.0 * diff.detach(),
                       "row_mse": (diff * diff).mean().detach()},
                      model_state)

    def batch_fn(i):
        time.sleep(0.1)  # the heartbeat sees the death between steps
        return {"x": X, "y": Yd, "rows": t.sparse_pull(idx0),
                "targets": targets}

    row_mses = []

    def post_step(i, s, m, b):
        t.sparse_push(idx0, m["ge"].numpy())
        row_mses.append(float(m["row_mse"]))

    ex = Executor(loss_fn, optim.SGDOptimizer(0.1), seed=0)
    guard = PSShardGuard(t, snapshot_path=tmp_path / "snap.npz")
    guard.snapshot()
    injector = FaultInjector(
        FaultSchedule([FaultEvent(6, "kill_shard", 1.0)]), shard_procs=procs)
    sup = Supervisor(ex, injector=injector, guards=[guard], retries=25,
                     backoff_base_s=0.05, backoff_max_s=0.5)

    stop, respawned = threading.Event(), []

    def respawner():
        while not stop.is_set():
            for i, p in enumerate(procs):
                if p.poll() is not None and not stop.is_set():
                    time.sleep(0.2)
                    procs[i] = spawn_shard_server(tmp_path, ports[i],
                                                  f"r{i}")
                    respawned.append(i)
            time.sleep(0.1)

    watcher = threading.Thread(target=respawner, daemon=True)
    watcher.start()
    try:
        rep = sup.run(ex.init_state(model), batch_fn, 30,
                      post_step=post_step)
    finally:
        stop.set()
        watcher.join(10)
    assert rep.step == 30
    assert rep.counters["shards_killed"] == 1 and respawned == [1]
    assert t.recovered == 1 and rep.counters["shard_repairs"] == 1
    np.testing.assert_array_equal(t.sparse_pull(shard1_rows), learned)
    assert row_mses[-1] < row_mses[0] * 1e-3, (row_mses[0], row_mses[-1])
    t.close()
