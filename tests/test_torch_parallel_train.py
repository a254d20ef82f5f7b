"""The port's data- and tensor-parallel training against hetu_tpu on the
CPU.

Each world of ``gloo`` rank processes (``hetu_tpu_torch.parallel.ranks``)
starts once per module and runs every case of this file in it
(``tests/torch_parallel_bodies.py``); the tests compare its results with
the JAX package run in this process on the same numpy parameters (the
reference's layout, through ``interop``) and the same batches:

* dp = 2 and 4 against the single-device JAX executor, SGD, every step's
  loss at rtol 1e-4 and the parameters at rtol 1e-4 / atol 1e-5
  (``tests/test_executor.py::test_dp_mesh_matches_single_device``), also
  on a batch whose dp shards hold unequal counts of valid labels (the loss
  is the global batch's, not a mean of per-shard means);
* MegatronLM at tp = 2 and at dp = 2 x tp = 2, Adam, the loss at rtol
  2e-4 (``tests/test_strategies.py``), the ffn weight still tp-split after
  the in-place updates; ResNet-18 under ModelParallel4CNN at dp 2 x tp 2;
* the fused head + CE on a vocabulary split over tp (the table never
  gathered, its gradient split) against the reference's fused CE;
* a ZeRO-1 strategy (slots split over dp) against the same strategy on
  the reference's dp = 2 mesh: the slots are sharded, the losses and the
  parameters are the reference's;
* dropout under dp draws the global mask (each rank keeps its shard):
  the losses equal the port's single-process run;
* the quantized grad sync (``TestExecutorGradSync``): ``"exact"``,
  ``"int8"``, ``"bf16"`` and the per-parameter callable each against the
  reference's Executor on its own dp = 2 mesh (every step's loss and the
  final ``w``/``b`` at rtol 1e-5); beside that the reference's own checks
  (int8 within its bound of the exact loss, the callable's wire bytes)
  and the ``ValueError`` refusals;
* checkpoints of a tp = 2 state cross between the packages both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_bodies as bodies
from hetu_tpu import rng as jax_rng
from hetu_tpu.models.gpt import GPTConfig as JaxGPTConfig
from hetu_tpu.models.gpt import GPTModel as JaxGPTModel
from hetu_tpu.optim import AdamOptimizer as JaxAdam
from hetu_tpu.optim import SGDOptimizer as JaxSGD
from hetu_tpu.train import Executor as JaxExecutor
from hetu_tpu.train import checkpoint as jax_checkpoint
from hetu_tpu_torch import interop
from hetu_tpu_torch import rng as torch_rng
from hetu_tpu_torch.models import GPTConfig
from hetu_tpu_torch.parallel import ranks

V, H, L, NH, FFN, P, B, S = 64, 32, 2, 4, 64, 32, 8, 16
STEPS = 3
CFG = dict(vocab_size=V, hidden_size=H, num_layers=L, num_heads=NH,
           ffn_size=FFN, max_position=P, dropout_rate=0.0,
           ce_row_chunk=32)


@pytest.fixture(autouse=True)
def _keep_global_rng_status():
    saved = jax_rng.get_seed_status(), torch_rng.get_seed_status()
    yield
    jax_rng.set_seed_status(*saved[0])
    torch_rng.set_seed_status(*saved[1])


def jax_params():
    model = JaxGPTModel(JaxGPTConfig(**CFG))
    return jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(0))["params"])


def port_params():
    return {k: v.numpy() for k, v in interop.params_from_jax(
        jax_params(), GPTConfig(**CFG)).items()}


def batches(masked=False, n=STEPS):
    g = np.random.default_rng(1)
    out = []
    for _ in range(n):
        ids = g.integers(0, V, (B, S)).astype(np.int64)
        if masked:
            ids[0, 3:] = -1   # dp shard 0 holds far fewer valid labels
            ids[1, 9:] = -1
        out.append(ids)
    return out


def jax_train(opt, bs, mesh=None, strategy=None):
    model = JaxGPTModel(JaxGPTConfig(**CFG))
    ex = JaxExecutor(model.lm_loss_fn(), opt, mesh=mesh,
                     dist_strategy=strategy, seed=0)
    st = ex.init_state({"params": jax.tree_util.tree_map(
        jnp.asarray, jax_params()), "state": {}})
    losses = []
    for ids in bs:
        st, m = ex.run("train", st, (jnp.asarray(ids.astype(np.int32)),))
        losses.append(float(m["loss"]))
    return losses, st


def _gpt(mesh, opt, bs, **kw):
    return ("train_gpt", dict(mesh=mesh, opt=opt, batches=bs,
                              params=port_params(), cfg=CFG, **kw))


CASES2 = {
    "dp2": _gpt({"dp": 2}, ("sgd", 0.1), batches()),
    "dp2_masked": _gpt({"dp": 2}, ("sgd", 0.1), batches(masked=True)),
    "tp2": _gpt({"tp": 2}, ("adam", 1e-2), batches(),
                strategy="MegatronLM"),
    "zero1": _gpt({"dp": 2}, ("adam", 1e-2, 1e-3), batches(),
                  strategy="zero1"),
    "dropout_dp2": ("train_gpt", dict(
        mesh={"dp": 2}, opt=("sgd", 0.1), batches=batches(masked=True),
        params=port_params(), cfg=dict(CFG, dropout_rate=0.1))),
    "dropout_single": ("train_gpt", dict(
        opt=("sgd", 0.1), batches=batches(masked=True),
        params=port_params(), cfg=dict(CFG, dropout_rate=0.1))),
}


def _resnet_case():
    from hetu_tpu.models.resnet import ResNet18 as JaxResNet18
    from hetu_tpu_torch.models import ResNet18
    variables = jax.tree_util.tree_map(np.asarray, JaxResNet18(
        num_classes=10).init(jax.random.PRNGKey(0)))
    port = ResNet18(num_classes=10, device="cpu")
    params = {k: v.numpy() for k, v in interop.params_from_jax(
        variables, port).items()}
    state = {k: v.numpy() for k, v in interop.state_from_jax(
        variables, port).items()}
    x = np.random.default_rng(0).standard_normal((8, 3, 32, 32)).astype(
        np.float32)
    y = np.random.default_rng(1).integers(0, 10, 8).astype(np.int64)
    return variables, ("train_resnet", dict(
        mesh={"dp": 2, "tp": 2}, opt=("sgd", 0.1), strategy=
        "ModelParallel4CNN", params=params, state=state,
        batches=[(x, y)] * 2))


SYNC_STEPS = {"exact": 50, "int8": 50, "bf16": 50, "per_param": 5}


def linear_problem():
    """``TestExecutorGradSync``'s regression problem."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(16, 1)).astype(np.float32)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    return {"x": x, "y": x @ w + 0.01 * rng.normal(size=(64, 1)).astype(
        np.float32)}


def vocab_ce_inputs():
    g = np.random.default_rng(3)
    labels = g.integers(0, V, (2, 11)).astype(np.int64)
    labels[0, 4:] = -1
    return dict(h=g.standard_normal((2, 11, H)).astype(np.float32),
                w=(0.5 * g.standard_normal((V, H))).astype(np.float32),
                labels=labels)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    # a tp = 2 state saved by the port (after training), and the
    # reference's checkpoint loaded into a tp = 2 state
    _, jst = jax_train(JaxAdam(1e-2, eps=1e-3), batches(n=1))
    jax_checkpoint.save(d / "ref.ckpt", jst)
    cases = dict(CASES2)
    cases["save_tp2"] = _gpt({"tp": 2}, ("adam", 1e-2, 1e-3), batches(n=1),
                             strategy="MegatronLM", save=str(d / "port.ckpt"))
    cases["load_tp2"] = _gpt({"tp": 2}, ("adam", 1e-2, 1e-3), [],
                             strategy="MegatronLM", load=str(d / "ref.ckpt"))
    cases["vocab_ce"] = ("vocab_ce", dict(mesh={"tp": 2}, row_chunk=8,
                                          **vocab_ce_inputs()))
    lin = linear_problem()
    for gs, steps in SYNC_STEPS.items():
        cases[f"sync_{gs}"] = ("grad_sync", dict(
            mesh={"dp": 2}, grad_sync=gs, batch=lin, steps=steps))
    res = ranks.run(bodies.run_cases, 2, args=(cases,), threads=1,
                    timeout_s=300)
    return res, d, jst


@pytest.fixture(scope="module")
def world4():
    variables, resnet = _resnet_case()
    cases = {
        "dp4": _gpt({"dp": 4}, ("sgd", 0.1), batches()),
        "dp2tp2": _gpt({"dp": 2, "tp": 2}, ("adam", 1e-2), batches(),
                       strategy="MegatronLM"),
        "resnet": resnet,
    }
    res = ranks.run(bodies.run_cases, 4, args=(cases,), threads=1,
                    timeout_s=300)
    return res, variables


def _ref_params(st):
    return {k: v.numpy() for k, v in interop.params_from_jax(
        jax.tree_util.tree_map(np.asarray, st.params),
        GPTConfig(**CFG)).items()}


def test_rank_processes_load_no_jax(world2, world4):
    for res in (world2[0], world4[0]):
        assert not any(r["_jax_loaded"] for r in res)


@pytest.mark.parametrize("case,world", [("dp2", 2), ("dp2_masked", 2),
                                        ("dp4", 4)])
def test_dp_mesh_matches_single_device(case, world, world2, world4):
    """SGD over dp: every step's loss and the final parameters equal the
    single-device JAX run (rtol 1e-4, atol 1e-5), also with unequal
    counts of valid labels in the shards."""
    res = (world2 if world == 2 else world4)[0]
    want, st = jax_train(JaxSGD(0.1), batches(masked="masked" in case))
    ref = _ref_params(st)
    for r in res:
        got = r[case]
        np.testing.assert_allclose(got["losses"], want, rtol=1e-4)
        for n, p in got["params"].items():
            np.testing.assert_allclose(p, ref[n], rtol=1e-4, atol=1e-5,
                                       err_msg=n)
        assert all("Replicate" in s for s in got["placements"].values())


@pytest.mark.parametrize("case,world", [("tp2", 2), ("dp2tp2", 4)])
def test_megatron_tp_matches_single_device(case, world, world2, world4):
    res = (world2 if world == 2 else world4)[0]
    want, _ = jax_train(JaxAdam(1e-2), batches())
    for r in res:
        got = r[case]
        np.testing.assert_allclose(got["losses"], want, rtol=2e-4)
        # params still tp-sharded after the in-place updates
        pl = got["placements"]["blocks.0.ffn_in.weight"]
        assert "Shard(dim=0)" in pl, pl
        assert "Shard(dim=1)" in got["placements"]["blocks.1.attn.out.weight"]
        assert "Shard(dim=0)" in got["placements"]["tok_emb"]


def test_vocab_parallel_ce_keeps_the_table_split(world2):
    """The fused head + CE on a table split over tp by vocabulary rows:
    each rank holds half the rows, the table's gradient stays split, and
    the loss and both gradients equal the reference's
    ``lm_head_cross_entropy`` on the whole tensors (rtol 1e-5)."""
    from hetu_tpu.ops.losses import lm_head_cross_entropy as ref_ce
    x = vocab_ce_inputs()
    loss, (gh, gw) = jax.value_and_grad(
        lambda h, w: ref_ce(h, w, jnp.asarray(x["labels"]), row_chunk=8),
        argnums=(0, 1))(jnp.asarray(x["h"]), jnp.asarray(x["w"]))
    for r in world2[0]:
        got = r["vocab_ce"]
        assert got["w_local_rows"] == V // 2
        assert got["w_grad"] == "(Shard(dim=0),)", got["w_grad"]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        np.testing.assert_allclose(got["gh"], np.asarray(gh), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["gw"], np.asarray(gw), rtol=1e-5,
                                   atol=1e-6)


def test_resnet18_model_parallel_cnn_matches_single_device(world4):
    from hetu_tpu.models.resnet import ResNet18 as JaxResNet18
    res, variables = world4
    model = JaxResNet18(num_classes=10)
    ex = JaxExecutor(model.loss_fn(), JaxSGD(0.1), seed=0)
    st = ex.init_state(jax.tree_util.tree_map(jnp.asarray, variables))
    x = np.random.default_rng(0).standard_normal((8, 3, 32, 32)).astype(
        np.float32)
    y = np.random.default_rng(1).integers(0, 10, 8).astype(np.int32)
    want = []
    for _ in range(2):
        st, m = ex.run("train", st, (jnp.asarray(x), jnp.asarray(y)))
        want.append(float(m["loss"]))
    for r in res:
        np.testing.assert_allclose(r["resnet"]["losses"], want, rtol=2e-4)
        assert "Shard(dim=0)" in r["resnet"]["placements"]["fc.weight"]


def test_zero1_slots_shard_over_dp_and_match_the_reference(world2):
    from jax.sharding import PartitionSpec as JP

    import hetu_tpu as ht
    from hetu_tpu.parallel.strategies import DataParallel as JaxDP

    class JaxZero1(JaxDP):
        def slot_spec(self, path, leaf):
            return JP("dp")

    want, st = jax_train(JaxAdam(1e-2, eps=1e-3), batches(),
                         mesh=ht.make_mesh(dp=2), strategy=JaxZero1())
    ref = _ref_params(st)
    for r in world2[0]:
        got = r["zero1"]
        assert "Shard(dim=0)" in got["slot_placements"]["m"]["tok_emb"]
        assert "Replicate" in got["placements"]["tok_emb"]
        np.testing.assert_allclose(got["losses"], want, rtol=2e-4)
        for n, p in got["params"].items():
            np.testing.assert_allclose(p, ref[n], rtol=1e-4, atol=2e-4,
                                       err_msg=n)


def test_dropout_under_dp_draws_the_global_mask(world2):
    """Each rank keeps its shard of the mask drawn over the global shape:
    dp = 2 trains as the single process does."""
    single = world2[0][0]["dropout_single"]
    for r in world2[0]:
        np.testing.assert_allclose(r["dropout_dp2"]["losses"],
                                   single["losses"], rtol=1e-5)


def _per_param_wire(path):
    return "int8" if "w" in path else "f32"


@pytest.fixture
def jax_shard_map_check_vma(monkeypatch):
    """The reference's quantized step calls ``shard_map(...,
    check_rep=False)``, which jax 0.9 takes as ``check_vma``: rename the
    keyword for the duration of a test (the function is unchanged)."""
    from hetu_tpu.parallel import collectives as coll
    orig = coll.shard_map

    def shard_map(f=None, **kw):
        if "check_rep" in kw:
            kw["check_vma"] = kw.pop("check_rep")
        return orig(f, **kw) if f is not None else (
            lambda g: orig(g, **kw))
    monkeypatch.setattr(coll, "shard_map", shard_map)


@pytest.mark.parametrize("gs", list(SYNC_STEPS))
def test_quant_grad_sync_matches_the_reference(gs, world2,
                                               jax_shard_map_check_vma):
    """The port's grad sync over dp = 2 (per-shard loss, the quantized
    pmean of every gradient, the pmean of the loss) against the
    reference's Executor with the same ``grad_sync`` on its dp = 2 mesh,
    the same batch and zero initial weights: every step's loss and the
    final ``w`` and ``b`` at rtol 1e-5."""
    from jax.sharding import Mesh

    from hetu_tpu.optim.optimizer import SGDOptimizer as RefSGD

    def loss_fn(params, state, b, rng_, train):
        loss = jnp.mean((b["x"] @ params["w"] + params["b"] - b["y"]) ** 2)
        return loss, ({"mse": loss}, state)

    ex = JaxExecutor(loss_fn, RefSGD(0.1),
                     mesh=Mesh(np.array(jax.devices()[:2]), ("dp",)),
                     dp_axis="dp",
                     grad_sync=_per_param_wire if gs == "per_param" else gs)
    st = ex.init_state({"params": {"w": jnp.zeros((16, 1)),
                                   "b": jnp.zeros((1,))}})
    batch = {k: jnp.asarray(v) for k, v in linear_problem().items()}
    want = []
    for _ in range(SYNC_STEPS[gs]):
        st, m = ex.run("train", st, batch)
        want.append(float(m["loss"]))
    for r in world2[0]:
        got = r[f"sync_{gs}"]
        np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
        for n in ("w", "b"):
            np.testing.assert_allclose(got["params"][n],
                                       np.asarray(st.params[n]), rtol=1e-5,
                                       atol=1e-7, err_msg=n)


def test_int8_grad_sync_loss_parity(world2):
    r = world2[0][0]
    exact, quant = r["sync_exact"]["loss"], r["sync_int8"]["loss"]
    assert quant <= max(2 * exact, exact + 1e-4)


def test_per_param_callable_and_counters(world2):
    r = world2[0][0]["sync_per_param"]
    assert np.isfinite(r["loss"])
    # 5 steps x (w: 16 int8 + 1 scale, b: 1 f32 elt)
    assert r["wire"] == 5 * ((16 + 4) + 4)


def test_quant_sync_and_strategy_refusals():
    from hetu_tpu_torch.optim import SGDOptimizer
    from hetu_tpu_torch.parallel.strategies import MegatronLM
    from hetu_tpu_torch.train import Executor
    fn = bodies.linear_loss_fn(bodies._Linear())
    with pytest.raises(ValueError, match="mesh"):
        Executor(fn, SGDOptimizer(0.1), grad_sync="int8")
    with pytest.raises(ValueError, match="grad_sync"):
        Executor(fn, SGDOptimizer(0.1), mesh=object(), grad_sync="fp4")
    with pytest.raises(ValueError, match="replicated"):
        Executor(fn, SGDOptimizer(0.1), mesh=object(), grad_sync="int8",
                 dist_strategy=MegatronLM())
    with pytest.raises(ValueError, match="mesh"):
        Executor(fn, SGDOptimizer(0.1), dist_strategy=MegatronLM())


def test_batch_not_divisible_by_dp_raises():
    from hetu_tpu_torch.train.executor import _shard_batch

    class _Mesh:
        mesh_dim_names = ("dp",)
        shape = (4,)
    with pytest.raises(ValueError, match="pad or drop the remainder"):
        _shard_batch((torch.zeros(6, 3),), _Mesh(), "dp", local=True)


def test_tp2_checkpoint_crosses_to_the_reference(world2):
    """A tp = 2 state saved whole by the port loads into the reference."""
    res, d, _ = world2
    model = JaxGPTModel(JaxGPTConfig(**CFG))
    ex = JaxExecutor(model.lm_loss_fn(), JaxAdam(1e-2, eps=1e-3), seed=0)
    tmpl = ex.init_state(model.init(jax.random.PRNGKey(1)))
    st = jax_checkpoint.load(d / "port.ckpt", tmpl)
    ref = _ref_params(st)
    for n, p in res[0]["save_tp2"]["params"].items():
        np.testing.assert_array_equal(ref[n], p, err_msg=n)


def test_reference_checkpoint_loads_into_a_tp2_state(world2):
    res, _, jst = world2
    ref = _ref_params(jst)
    for r in res:
        got = r["load_tp2"]
        for n, p in got["params"].items():
            np.testing.assert_array_equal(p, ref[n], err_msg=n)
        assert "Shard(dim=0)" in got["placements"]["blocks.0.attn.qkv.weight"]
