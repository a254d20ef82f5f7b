"""The port's ShardSpec algebra (``hetu_tpu_torch.parallel.spec``)
against hetu_tpu's.

The pattern checks are pure: every pair of specs of a 2-D array over the
axes ``dp`` and ``tp`` (with and without partial axes) gets the same
answer from both packages, and ``predict_collective`` the same
prediction.  The reference audits XLA's SPMD partitioner for the
collective a transition inserts; here DTensor's ``redistribute`` from
``src`` to ``dst`` in a ``gloo`` world of 4 (dp 2 x tp 2) issues exactly
the collective ``predict_collective`` names, counted under
``CommDebugMode``, and keeps the values.
"""

import itertools

import pytest

import torch_parallel_bodies as bodies
from hetu_tpu.parallel import spec as ref_spec
from hetu_tpu_torch.parallel import ranks
from hetu_tpu_torch.parallel import spec as port_spec

ENTRIES = (None, "dp", "tp")
DIMS = [d for d in itertools.product(ENTRIES, repeat=2)
        if not (d[0] is not None and d[0] == d[1])]
PARTIALS = ((), ("dp",), ("tp",))
SPECS = [(d, p) for d in DIMS for p in PARTIALS if not set(p) & set(d)]


def _pair(mod, d, p):
    return mod.ShardSpec(dims=d, partial=p)


@pytest.mark.parametrize("src", SPECS, ids=str)
def test_pattern_checks_match_the_reference(src):
    for dst in SPECS:
        a, b = _pair(port_spec, *src), _pair(port_spec, *dst)
        ra, rb = _pair(ref_spec, *src), _pair(ref_spec, *dst)
        for check in ("check_allreduce", "check_reducescatter",
                      "check_allgather", "check_alltoall"):
            assert getattr(a, check)(b) == getattr(ra, check)(rb), \
                (check, src, dst)
        assert port_spec.predict_collective(a, b) == \
            ref_spec.predict_collective(ra, rb), (src, dst)


def test_constructors_and_conversions():
    s = port_spec.ShardSpec.split(3, 1, "tp")
    assert s == port_spec.ShardSpec(dims=(None, "tp", None))
    assert tuple(s.pspec()) == tuple(ref_spec.ShardSpec.split(
        3, 1, "tp").pspec())
    assert port_spec.ShardSpec.replicated(2).dims == (None, None)
    assert port_spec.NodeStatus is port_spec.ShardSpec
    with pytest.raises(ValueError, match="reduce it first"):
        port_spec.ShardSpec(dims=(None,), partial=("dp",)).named(None)


# (src, dst) -> the c10d collective DTensor must issue for the predicted
# kind; on a CPU gloo group DTensor runs an all-to-all as an all-gather
# and a local chunk (its documented fallback: gloo has no CPU alltoall
# for it), so that kind accepts either
KIND_OPS = {"all-reduce": {"all_reduce"},
            "reduce-scatter": {"reduce_scatter_tensor"},
            "all-gather": {"all_gather_into_tensor"},
            "all-to-all": {"all_to_all_single", "all_gather_into_tensor"}}
TRANSITIONS = {
    "allreduce_dp": (((None, None), ("dp",)), ((None, None), ())),
    "allreduce_tp": (((None, "dp"), ("tp",)), ((None, "dp"), ())),
    "reducescatter": (((None, None), ("tp",)), (("tp", None), ())),
    "allgather": ((("dp", None), ()), ((None, None), ())),
    "allgather_tp": ((("dp", "tp"), ()), (("dp", None), ())),
    "alltoall": ((("tp", None), ()), ((None, "tp"), ())),
}


@pytest.fixture(scope="module")
def counts():
    res = ranks.run(bodies.run_cases, 4, threads=1, timeout_s=300, args=(
        {"c": ("spec_counts", dict(mesh={"dp": 2, "tp": 2},
                                   cases=TRANSITIONS)),
         "m": ("mesh_helpers", {})},))
    return res


@pytest.mark.parametrize("tid", list(TRANSITIONS))
def test_redistribute_issues_the_predicted_collective(tid, counts):
    src, dst = TRANSITIONS[tid]
    kind = port_spec.predict_collective(port_spec.ShardSpec(*src),
                                        port_spec.ShardSpec(*dst))[0]
    for r in counts:
        issued, kept = r["c"][tid]
        assert kept, tid
        assert sum(issued.values()) == 1, issued
        assert set(issued) <= KIND_OPS[kind], (kind, issued)


def test_local_and_elastic_mesh_and_constrain(counts):
    """``local_mesh`` puts every rank on dp; ``elastic_mesh`` keeps the
    survivors' own ranks (worker 1 of dp 2 x tp 2: ranks 2 and 3) and
    gives the others no mesh; ``constrain`` cuts a whole value to this
    rank's piece and redistributes a DTensor."""
    import numpy as np
    full = np.arange(32.0).reshape(8, 4)
    for rank, r in enumerate(counts):
        m = r["m"]
        assert m["local"] == {"pp": 1, "dp": 4, "sp": 1, "ep": 1, "tp": 1}
        if rank < 2:
            assert m["elastic"] is None
        else:
            assert m["elastic"] == {"pp": 1, "dp": 1, "sp": 1, "ep": 1,
                                    "tp": 2}
            assert m["elastic_ranks"] == [2, 3]
        assert m["a"][0] == "(Shard(dim=0),)"
        np.testing.assert_array_equal(m["a"][1], full[2 * rank:2 * rank + 2])
        assert m["b"][0] == "(Replicate(),)"
        np.testing.assert_array_equal(m["b"][1], full)
