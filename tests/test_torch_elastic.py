"""The port's elastic supervisor (``hetu_tpu_torch/resilience/elastic.py``)
against hetu_tpu on the CPU.

A ``gloo`` world of 4 rank processes starts once for the module
(``tests/torch_dppipe_bodies.py``), one data-parallel worker a rank
(``MeshConfig(dp=4)``), and runs the reference's ``tests/test_elastic.py``
cases on the same numpy model, data and fault schedule:

* the 4 → 3 → 4 run (a seeded ``worker_loss`` and a later
  ``worker_join``): the resizes ``[("shrink", 3), ("grow", 4)]`` at the
  reference's steps, its counters, and the final parameters against the
  reference ``ElasticSupervisor``'s at rtol 2e-4 / atol 1e-5, and against
  the port's fault-free dp = 4 run; the rng words bitwise those of the
  fault-free run; after the grow every rank's parameters, slots, step and
  rng bitwise equal (the rejoined rank's stale state was replaced);
* every worker lost raises ``ElasticReshardError`` on every rank;
* ``fixed_per_worker`` sets a gradient scale of 4/3 after one loss, the
  lost rank runs no step, and ``rank_of`` gives the survivors' slots;
* ``min_width`` refuses a mesh narrower than it;
* each resize's spans, and the final state in the model's own tensors on
  the final mesh;
* a checkpoint taken at width 3 records ``dp_width``, ``alive`` and
  ``nominal_dp`` and restores into a width-4 run;
* a PS shard guard's evidence that only one rank's guards see promotes
  the hosting worker's loss at the reference's step, on every rank;
* ``config`` is the mesh's ``MeshConfig`` and the checkpoints' model
  configuration is ``model_config`` (the port's ``Supervisor`` already
  takes ``config=`` for the latter);
* ``MembershipMonitor``'s decisions equal the reference's on the same
  event sequences (in this process).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hetu_tpu as ht
import torch_dppipe_bodies as bodies
from hetu_tpu import layers as jlayers
from hetu_tpu import optim as joptim
from hetu_tpu.data.dataloader import ElasticBatchSchedule
from hetu_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from hetu_tpu.resilience import ElasticSupervisor as JaxElasticSupervisor
from hetu_tpu.resilience import FaultInjector as JaxFaultInjector
from hetu_tpu.resilience import FaultSchedule as JaxFaultSchedule
from hetu_tpu.resilience import MembershipMonitor as JaxMonitor
from hetu_tpu.train.executor import Executor as JaxExecutor
from hetu_tpu_torch.parallel import ranks
from hetu_tpu_torch.resilience.elastic import (
    ElasticReshardError, MembershipMonitor,
)

STEPS = 14
FAULTS = dict(steps=STEPS, seed=11, worker_losses=1, worker_joins=1,
              n_workers=4)


def data():
    g = np.random.default_rng(0)
    X = g.standard_normal((240, 6)).astype(np.float32)
    Y = (X @ g.standard_normal((6, 3))).astype(np.float32)
    return X, Y


def _jax_model():
    return jlayers.Sequential(jlayers.Linear(6, 16), jlayers.Relu(),
                              jlayers.Linear(16, 3))


def _jax_problem(seed=1):
    model = _jax_model()

    def loss_fn(params, model_state, batch, rng, train):
        pred, ns = model.apply({"params": params, "state": model_state},
                               batch["x"], train=train, rng=rng)
        return jnp.mean((pred - batch["y"]) ** 2), ({}, ns)

    ex = JaxExecutor(loss_fn, joptim.AdamOptimizer(0.03), seed=seed)
    state = ex.init_state(model.init(jax.random.PRNGKey(seed)))
    return ex, state


@pytest.fixture(scope="module")
def reference():
    """The reference's 4 -> 3 -> 4 run, and its initial tree."""
    X, Y = data()
    sched = ElasticBatchSchedule((X, Y), 24, seed=3)

    def batch_fn(i):
        x, y = sched.global_batch(i)
        return {"x": x, "y": y}
    ex, st = _jax_problem()
    init = jax.tree_util.tree_map(np.asarray, st.params)
    faults = JaxFaultSchedule.generate(**FAULTS)
    sup = JaxElasticSupervisor(ex, config=JaxMeshConfig(dp=4),
                               schedule=sched,
                               injector=JaxFaultInjector(faults))
    rep = sup.run(st, batch_fn, STEPS)
    return dict(init=init, schedule_json=faults.to_json(),
                resizes=[(e.kind, e.worker, e.width, e.step, e.alive)
                         for e in sup.resizes],
                params=jax.tree_util.tree_map(np.asarray, rep.state.params),
                counters=dict(rep.counters))


@pytest.fixture(scope="module")
def world(reference, tmp_path_factory):
    X, Y = data()
    spec = dict(X=X, Y=Y, init=reference["init"], steps=STEPS,
                faults=FAULTS, guard_rank=2,
                ckpt_dir=str(tmp_path_factory.mktemp("elastic_ckpt")))
    return ranks.run(bodies.run_cases, 4, threads=1, timeout_s=300,
                     args=({"el": ("elastic", spec)},))


def test_ranks_load_no_jax(world):
    assert not any(r["_jax_loaded"] for r in world)


def test_elastic_4_3_4_matches_the_reference(world, reference):
    want = reference["resizes"]
    assert [(k, w) for k, _, w, _, _ in want] == [("shrink", 3), ("grow", 4)]
    ref_flat = {
        f"{i}.{leaf}": v for i, sub in reference["params"].items()
        for leaf, v in sub.items()}
    for rank, r in enumerate(world):
        e = r["el"]
        assert e["schedule_json"] == reference["schedule_json"]
        got = e["434"]
        assert got["resizes"] == want, rank
        assert got["step"] == STEPS
        for k in ("worker_losses_injected", "worker_joins_injected",
                  "elastic_width"):
            assert got["counters"][k] == reference["counters"][k], k
        assert got["counters"]["resizes_shrink"] == 1
        assert got["counters"]["resizes_grow"] == 1
        assert all(d > 0 for d in got["downtime"])
        params = got["state"]["params"]
        assert set(params) == set(ref_flat)
        for name, p in params.items():
            # the port's Linear weight is [out, in], the reference's
            # [in, out]
            ref = ref_flat[name].T if name.endswith("weight") else \
                ref_flat[name]
            np.testing.assert_allclose(p, ref, rtol=2e-4, atol=1e-5,
                                       err_msg=f"rank {rank} {name}")
            np.testing.assert_allclose(p, e["fault_free"]["params"][name],
                                       rtol=2e-4, atol=1e-5)
        # the rng words rode the resharding exactly
        np.testing.assert_array_equal(got["state"]["rng"],
                                      e["fault_free"]["rng"])


def test_reshard_spans_and_placement(world):
    """Each resize runs the reference's spans (reshard, snapshot, remesh)
    on every rank, and the port's broadcast at the grow; every rank in
    the new mesh re-places the state (the lost one only at the grow; the
    run's start places it too).  The final state is the model's own
    parameters, every tensor on the width-4 mesh: none keeps the width-3
    mesh's groups."""
    lost = world[0]["el"]["434"]["resizes"][0][1]
    for rank, r in enumerate(world):
        got = r["el"]["434"]
        sp = got["spans"]
        assert sp["elastic.reshard"] == sp["elastic.snapshot"] == \
            sp["elastic.remesh"] == 2
        assert sp["elastic.broadcast"] == 1
        assert sp["elastic.replace"] == (2 if rank == lost else 3)
        assert got["meshes"] == [(0, 1, 2, 3)]
        assert got["own"]
        assert got["downtime_last"] > 0


def test_after_the_grow_every_rank_holds_the_same_state(world):
    """The lost worker's rank came back with a stale state; the grow's
    broadcast replaced it: every rank's final state is bitwise the
    others'."""
    lost = world[0]["el"]["434"]["resizes"][0][1]
    states = [r["el"]["434"]["state"] for r in world]
    base = states[lost - 1 if lost else 1]
    for s in states:
        assert s["step"] == base["step"] == STEPS
        assert s["opt_step"] == base["opt_step"]
        np.testing.assert_array_equal(s["rng"], base["rng"])
        for n in base["params"]:
            assert s["params"][n].tobytes() == base["params"][n].tobytes()
        for k in base["slots"]:
            for n in base["slots"][k]:
                assert s["slots"][k][n].tobytes() == \
                    base["slots"][k][n].tobytes()


def test_all_workers_lost_raises_on_every_rank(world):
    for r in world:
        assert r["el"]["all_lost"] is not None
        assert "workers alive" in r["el"]["all_lost"]


def test_fixed_per_worker_mode_rescales_grads(world):
    for rank, r in enumerate(world):
        got = r["el"]["per_worker"]
        assert got["step"] == 3
        assert got["scale"] == pytest.approx(4 / 3)
        assert got["trained"] == (rank != 0)  # worker 0 was lost
        assert got["rank_of"] == [0, 1, 2]
        assert "not alive" in got["lost_rank_of"]


def test_min_width_refuses_a_narrower_mesh(world):
    for r in world:
        assert "min_width=4" in r["el"]["min_width"]


def test_checkpoint_records_width_and_restores_at_another(world):
    for r in world:
        c = r["el"]["ckpt"]
        assert c["width1"] == 3
        assert c["extra"] == {"dp_width": 3, "alive": [0, 1, 3],
                              "nominal_dp": 4}
        assert c["resumed"] == c["newest"]
        assert c["step"] == 10 and c["width2"] == 4 and c["mesh_dp"] == 4


def test_guard_evidence_one_rank_sees_resizes_every_rank(world):
    """Only rank 2's guards hold shard 1 pending; the agreed evidence
    promotes worker 3's loss at step 2 (strikes at steps 0 and 1) on
    every rank, as the reference's single controller does."""
    for r in world:
        g = r["el"]["guard"]
        assert g["step"] == 6
        assert g["resizes"] == [("shrink", 3, 3, 2)]
        assert g["width"] == 3


def test_mesh_config_and_model_config_are_two_keywords(world):
    for r in world:
        got = r["el"]["434"]
        assert got["config_is_mesh"] and got["manager_config_is_model"]


MONITOR_CASES = {
    "threshold": [("fail", 2), ("fail", 2), ("ok", 2), ("fail", 2),
                  ("fail", 2), ("pop",), ("fail", 2), ("pop",), ("fail", 2),
                  ("pop",), ("join", 2), ("pop",), ("join", 2), ("pop",)],
    "events": [("loss", 1), ("loss", 3), ("loss", 1), ("pop",), ("join", 3),
               ("join", 1), ("pop",), ("fail", 0), ("fail", 0), ("fail", 0),
               ("fail", 0), ("pop",), ("join", 0), ("pop",)],
}


@pytest.mark.parametrize("case", sorted(MONITOR_CASES))
def test_membership_monitor_decides_as_the_reference(case):
    mons = (MembershipMonitor(4, fail_threshold=3),
            JaxMonitor(4, fail_threshold=3))
    for op in MONITOR_CASES[case]:
        outs = []
        for m in mons:
            if op[0] == "fail":
                m.report_failure(op[1])
            elif op[0] == "ok":
                m.report_ok(op[1])
            elif op[0] == "pop":
                outs.append(m.pop_decisions())
            else:
                m.inject(op[0], op[1])
        if outs:
            assert outs[0] == outs[1], (case, op)
        assert mons[0].alive == mons[1].alive
    for m, err in ((mons[0], ElasticReshardError), (mons[1], Exception)):
        with pytest.raises(err):
            m.inject("join", 9)
        with pytest.raises(ValueError):
            m.inject("move", 0)
