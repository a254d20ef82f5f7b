"""The port's MPMD pipeline pieces (``hetu_tpu_torch.parallel.mpmd``)
against hetu_tpu's on the CPU.

* The schedules, the stash count and the wire codecs against the
  reference's functions over a grid (``tests/test_mpmd_elastic.py:53-160``
  merged into parametrised cases): the same op lists, the same errors,
  the same payload bytes; the decode round-trips, bf16 propagates
  non-finite values, wrong sizes are refused.
* ``VanMailbox``: a blob round-trip, and the blob transport's van frames
  against the sparse transport's (``tests/test_van_blob.py:130``).
* ``MPMDStageRunner`` with tanh stages in separate processes on the CPU:
  stage dps [2, 1] (two steps bitwise equal), [1, 2, 1]; every gradient
  against ``jax.grad`` of the same net at the reference test's rtol 2e-4
  / atol 1e-6 (``tests/test_mpmd.py:145,272``).
* The slice as a whole: the runner at [2, 1] over two blocks of a narrow
  GPT whose weights are the JAX package's (``interop.params_from_jax``);
  the loss and every block gradient against ``jax.grad`` of the JAX
  package's same blocks and loss.
* The heterogeneous stage (``tests/test_mpmd.py:388``): stage 0 is its own
  tensor-parallel program, a two-rank gloo world with a column-split
  weight (only rank 0 talks to the mailboxes; the group broadcasts the
  input and all-gathers the output), stage 1 is unsharded.  The reference
  runs that stage as one process over two devices.

Every process has its own time limit, and every one is killed in
``finally``.
"""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hetu_tpu.parallel import mpmd as ref
from hetu_tpu_torch.parallel import mpmd
from hetu_tpu_torch.ps import van

REPO = Path(__file__).resolve().parent.parent
PROC_S = 120.0  # a stage process's own time limit
RTOL, ATOL = 2e-4, 1e-6  # tests/test_mpmd.py's, for the tanh nets


@pytest.fixture(scope="module")
def port():
    p = van.serve(0)
    yield p
    van.stop()


# ---------------------------------------------------------------------------
# schedules and codecs against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n_src,n_dst", [(4, 2, 1), (6, 2, 3), (7, 3, 2),
                                           (1, 1, 1), (8, 4, 4)])
def test_round_robin_assignments_match_the_reference(m, n_src, n_dst):
    assert mpmd.round_robin_assignments(m, n_src, n_dst) == \
        ref.round_robin_assignments(m, n_src, n_dst)


SCHEDULE_GRID = [(kind, S, s, M, stash)
                 for kind in ("gpipe", "1f1b")
                 for S, M in ((2, 2), (3, 4), (3, 8), (4, 16), (4, 3))
                 for s in range(S)
                 for stash in ((0, 3) if kind == "gpipe" else (0,))]


@pytest.mark.parametrize("kind,S,s,M,stash", SCHEDULE_GRID)
def test_schedule_ops_and_peak_stash_match_the_reference(kind, S, s, M,
                                                         stash):
    got = mpmd.schedule_ops(kind, stage=s, n_stages=S, n_microbatches=M,
                            stash_limit=stash)
    want = ref.schedule_ops(kind, stage=s, n_stages=S, n_microbatches=M,
                            stash_limit=stash)
    assert got == want
    assert mpmd.peak_stash(got) == ref.peak_stash(want)
    # every microbatch F once then B once, backwards ascending
    assert [m for op, m in got if op == "B"] == list(range(M))
    assert sorted(m for op, m in got if op == "F") == list(range(M))
    if kind == "1f1b":
        assert mpmd.peak_stash(got) == min(M, S - s)


@pytest.mark.parametrize("kw,match", [
    (dict(kind="pipedream2bw", stage=0), "unknown schedule"),
    (dict(kind="gpipe", stage=3), "outside"),
    (dict(kind="1f1b", stage=-1), "outside")])
def test_schedule_ops_refuses_like_the_reference(kw, match):
    kind = kw.pop("kind")
    for mod in (mpmd, ref):
        with pytest.raises(ValueError, match=match):
            mod.schedule_ops(kind, n_stages=2, n_microbatches=2, **kw)


def _payload(n, kind, seed=3):
    a = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    if kind == "nonfinite":
        a[::7] = np.nan
        a[1::11] = np.inf
        a[2::13] = -np.inf
        # NaNs whose bf16 rounding carry overflows the mantissa
        a[3] = np.frombuffer(np.uint32(0x7FFFFFFF).tobytes(), np.float32)[0]
        a[4] = np.frombuffer(np.uint32(0xFFFFFFFF).tobytes(), np.float32)[0]
    elif kind == "zeros":
        a[:] = 0.0
    elif kind == "scaled":
        a *= np.float32(1e-3) * np.arange(n, dtype=np.float32)
    return a


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("n,kind", [(257, "normal"), (300, "scaled"),
                                    (64, "zeros"), (1, "normal"),
                                    (130, "nonfinite")])
def test_encode_wire_gives_the_references_bytes(wire, n, kind):
    a = _payload(n, kind)
    got, logical = mpmd.encode_wire(a, wire)
    want, ref_logical = ref.encode_wire(a, wire)
    assert logical == ref_logical == n * 4
    assert got == want
    back = mpmd.decode_wire(got, n, wire)
    np.testing.assert_array_equal(back, ref.decode_wire(want, n, wire))
    assert back.dtype == np.float32 and back.shape == (n,)
    back[0] = 1.0  # a writable copy
    if kind == "normal":
        tol = {"f32": 0.0, "bf16": 0.01, "int8": 0.05}[wire]
        np.testing.assert_allclose(mpmd.decode_wire(got, n, wire), a,
                                   atol=tol * np.abs(a).max())


def test_bf16_wire_propagates_nonfinite_values():
    a = np.array([1.0, np.nan, -np.nan, np.inf, -np.inf, 0.0], np.float32)
    a[1] = np.frombuffer(np.uint32(0x7FFFFFFF).tobytes(), np.float32)[0]
    a[2] = np.frombuffer(np.uint32(0xFFFFFFFF).tobytes(), np.float32)[0]
    b = mpmd.decode_wire(mpmd.encode_wire(a, "bf16")[0], a.size, "bf16")
    assert np.isnan(b[1]) and np.isnan(b[2])
    assert b[3] == np.inf and b[4] == -np.inf
    assert b[0] == 1.0 and b[5] == 0.0


@pytest.mark.parametrize("wire,n,wrong", [("f32", 8, 9), ("bf16", 8, 9),
                                          ("int8", 100, 300)])
def test_decode_wire_refuses_wrong_sizes(wire, n, wrong):
    p, _ = mpmd.encode_wire(np.ones(n, np.float32), wire)
    with pytest.raises(ValueError, match="expected"):
        mpmd.decode_wire(p, wrong, wire)
    with pytest.raises(ValueError, match="unknown wire"):
        mpmd.encode_wire(np.ones(8, np.float32), "fp8")


def test_wire_sizes():
    n = 300
    a = np.ones(n, np.float32)
    assert len(mpmd.encode_wire(a, "f32")[0]) == n * 4
    assert len(mpmd.encode_wire(a, "bf16")[0]) == n * 2
    nblk = -(-n // mpmd.Q8_BLOCK)
    assert len(mpmd.encode_wire(a, "int8")[0]) == \
        nblk * mpmd.Q8_BLOCK + nblk * 4


# ---------------------------------------------------------------------------
# the mailbox
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_mailbox_blob_roundtrip_counts_bytes(port, wire):
    from hetu_tpu_torch.telemetry import default_registry
    path = f"mpmd.test_{wire}"
    tx = mpmd.VanMailbox("127.0.0.1", port, 9300 + len(wire), 64,
                         wire=wire, metric_path=path)
    rx = mpmd.VanMailbox("127.0.0.1", port, 9300 + len(wire), 64,
                         wire=wire)
    try:
        msgs = [np.arange(64, dtype=np.float32) * (i + 1) for i in range(3)]
        got = []

        def reader():
            for i in range(3):
                got.append(rx.get((8, 8), i + 1, timeout_s=30.0))
        t = threading.Thread(target=reader, daemon=True)
        t.start()
        for i, m in enumerate(msgs):
            tx.put(m, i + 1, timeout_s=30.0)
        t.join(30.0)
        assert not t.is_alive()
        for m, g in zip(msgs, got):
            assert g.shape == (8, 8)
            np.testing.assert_array_equal(
                g.ravel(), mpmd.decode_wire(mpmd.encode_wire(m, wire)[0],
                                            64, wire))
        per = 4 if wire == "f32" else 2
        assert tx.bytes_logical == rx.bytes_logical == 3 * 64 * 4
        assert tx.bytes_wire == rx.bytes_wire == 3 * 64 * per
        assert default_registry.counter(f"{path}.bytes_wire").value == \
            3 * 64 * per
        with pytest.raises(ValueError, match="capacity"):
            tx.put(np.zeros(65, np.float32), 4)
    finally:
        tx.close()
        rx.close()


def test_mailbox_blob_vs_sparse_frame_count(port):
    """``tests/test_van_blob.py:130``: 8 messages of 4096 f32 while the
    writer computes 300 ms between messages and the reader already
    waits; the blob mailbox costs put + get + ack a message, the sparse
    one polls."""
    N, SIZE, COMPUTE_S = 8, 4096, 0.3
    msgs = [np.full(SIZE, i + 1, np.float32) for i in range(N)]

    def run(impl, channel):
        tx = mpmd.VanMailbox("127.0.0.1", port, channel, SIZE, impl=impl)
        rx = mpmd.VanMailbox("127.0.0.1", port, channel, SIZE, impl=impl)
        f0 = van.stats_frames("127.0.0.1", port)

        def writer():
            for i, m in enumerate(msgs):
                time.sleep(COMPUTE_S)  # the stage's compute
                tx.put(m, i + 1)

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        for i, m in enumerate(msgs):
            got = rx.get((SIZE,), i + 1, poll_s=0.001)
            np.testing.assert_array_equal(got, m)
        t.join(30.0)
        assert not t.is_alive()
        frames = van.stats_frames("127.0.0.1", port) - f0
        tx.close()
        rx.close()
        return frames

    blob_frames = run("blob", 9200)
    sparse_frames = run("sparse", 9201)
    assert blob_frames <= 4 * N + 4, blob_frames
    assert sparse_frames >= 15 * blob_frames, (sparse_frames, blob_frames)


# ---------------------------------------------------------------------------
# the stage runner: tanh stages in separate processes
# ---------------------------------------------------------------------------

RUNNER_SRC = """
import sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from hetu_tpu_torch.parallel.mpmd import MPMDStageRunner

torch.set_num_threads(1)
stage, replica = {stage}, {replica}
D, B, M = {D}, {B}, {M}
DPS = {dps}
mb = B // M

def stage_fn(w, x):
    return torch.tanh(x @ w)

w = torch.tensor(np.random.default_rng(100 + stage).standard_normal(
    (D, D)) * 0.4, dtype=torch.float32)
runner = MPMDStageRunner(
    stage_fn, stage=stage, replica=replica, stage_dps=DPS,
    n_microbatches=M, in_shape=(mb, D), out_shape=(mb, D),
    host="127.0.0.1", port={port}, base_channel={base}, grad_size=D * D,
    device="cpu")
data = loss_fn = None
if stage == 0:
    x = np.random.default_rng(0).standard_normal((B, D)).astype(np.float32)
    data = [x[i * mb:(i + 1) * mb] for i in range(M)]
if stage == len(DPS) - 1:
    y = torch.tensor(np.random.default_rng(7).standard_normal((B, D)) * 0.1,
                     dtype=torch.float32)
    ys = [y[i * mb:(i + 1) * mb] for i in range(M)]
    # run_step calls loss_fn once a microbatch it owns, ascending
    order = []
    def loss_fn(out):
        return torch.mean((out - ys[order.pop(0)]) ** 2)
steps = []
for _ in range({steps}):
    if stage == len(DPS) - 1:
        order[:] = runner._my_microbatches()
    steps.append(runner.run_step(w, loss_fn=loss_fn, data=data))
# a second step, on identical inputs, reuses the cleared accumulator and
# the acked mailboxes: bitwise the first
for later in steps[1:]:
    assert steps[0][0] == later[0], (steps[0][0], later[0])
    assert torch.equal(steps[0][1], later[1])
assert steps[0][1].dtype == torch.float32 and steps[0][1].shape == (D, D)
np.save({out!r}, steps[0][1].numpy())
print("DONE", steps[0][0], flush=True)
runner.close()
"""


def _run_procs(tmp_path, jobs, *, timeout=PROC_S):
    """One process a (name, source); each must exit 0 and print DONE
    within ``timeout``; every process is killed on the way out."""
    procs = []
    try:
        for name, src in jobs:
            p = tmp_path / f"{name}.py"
            p.write_text(src)
            procs.append(subprocess.Popen(
                [sys.executable, str(p)], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
                env={**os.environ, "OMP_NUM_THREADS": "1"}))
        outs = []
        deadline = time.monotonic() + timeout
        for p in procs:
            stdout, stderr = p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
            assert p.returncode == 0, stderr[-3000:]
            assert "DONE" in stdout, stdout
            outs.append(stdout)
        return outs
    finally:
        for p in procs:
            p.kill()
            p.wait()


def _tanh_oracle(D, B, n_stages):
    """jax.grad of the same tanh net over the full batch (the mean of
    the microbatch means: equal microbatches)."""
    x = jnp.asarray(np.random.default_rng(0).standard_normal((B, D)),
                    jnp.float32)
    ws = [jnp.asarray(np.random.default_rng(100 + s).standard_normal(
        (D, D)) * 0.4, jnp.float32) for s in range(n_stages)]
    y = jnp.asarray(np.random.default_rng(7).standard_normal((B, D)) * 0.1,
                    jnp.float32)

    def full(*ws_):
        h = x
        for w in ws_:
            h = jnp.tanh(h @ w)
        return jnp.mean((h - y) ** 2)

    return float(full(*ws)), jax.grad(full, argnums=tuple(
        range(n_stages)))(*ws)


@pytest.mark.parametrize("dps", [[2, 1], [1, 2, 1]],
                         ids=["dps2-1", "dps1-2-1"])
def test_stage_runner_tanh_stages_match_jax_grad(tmp_path, port, dps):
    D, B, M = 8, 8, 4
    base = 5_000_000 + 100_000 * len(dps)
    outs, jobs = {}, []
    for stage, dp in enumerate(dps):
        for rep in range(dp):
            out = str(tmp_path / f"g_{stage}_{rep}.npy")
            outs[(stage, rep)] = out
            jobs.append((f"runner_{stage}_{rep}", RUNNER_SRC.format(
                repo=str(REPO), stage=stage, replica=rep, D=D, B=B, M=M,
                dps=dps, port=port, out=out, base=base, steps=2)))
    stdouts = _run_procs(tmp_path, jobs)
    loss, want = _tanh_oracle(D, B, len(dps))
    for s, dp in enumerate(dps):
        for rep in range(dp):
            np.testing.assert_allclose(np.load(outs[(s, rep)]),
                                       np.asarray(want[s]), rtol=RTOL,
                                       atol=ATOL)
        # every replica of a stage holds the same reduced gradient
        for rep in range(1, dp):
            np.testing.assert_array_equal(np.load(outs[(s, 0)]),
                                          np.load(outs[(s, rep)]))
    # the last stage's summed loss is M times the mean
    last = float(stdouts[-1].split()[-1])
    np.testing.assert_allclose(last / M, loss, rtol=RTOL)


# ---------------------------------------------------------------------------
# the slice as a whole: GPT blocks as stages
# ---------------------------------------------------------------------------

GPT = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=2,
           ffn_size=256, max_position=32, dropout_rate=0.0)
GPT_B, GPT_S, GPT_M = 4, 32, 4
# f32 on the CPU, the same math in another library: the loss to 1e-5
# relative, each gradient to 1e-4 of its own max|G| (measured on the CPU:
# the loss 5.2e-8 apart, the gradients at most 9.1e-7 of max|G|)
TOL_GPT_LOSS, TOL_GPT_GRAD = 1e-5, 1e-4

GPT_STAGE_SRC = """
import sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from torch.func import functional_call
from hetu_tpu_torch import ops
from hetu_tpu_torch.models import GPTConfig, GPTModel
from hetu_tpu_torch.parallel.mpmd import MPMDStageRunner

torch.set_num_threads(1)
stage, replica, DPS = {stage}, {replica}, {dps}
B, S, M, H = {B}, {S}, {M}, {H}
mb = B // M
cfg = GPTConfig(**{cfg!r}, attention_impl="xla")
model = GPTModel(cfg, device="cpu")
sd = dict(np.load({weights!r}))
model.load_state_dict({{k: torch.from_numpy(v) for k, v in sd.items()}})
ids = torch.tensor(np.load({ids!r}))
block = model.blocks[stage]
params = {{n: p.detach() for n, p in block.named_parameters()}}

def stage_fn(p, x):
    return functional_call(block, p, (x,))

runner = MPMDStageRunner(
    stage_fn, stage=stage, replica=replica, stage_dps=DPS,
    n_microbatches=M, in_shape=(mb, S, H), out_shape=(mb, S, H),
    host="127.0.0.1", port={port}, base_channel=6_000_000,
    grad_size=sum(p.numel() for p in params.values()), device="cpu")
data = loss_fn = None
if stage == 0:
    with torch.no_grad():
        h = model._embed(ids, model.pos_emb[None, :S])
    data = [h[i * mb:(i + 1) * mb] for i in range(M)]
else:
    order = runner._my_microbatches()
    tok = model.tok_emb.detach()
    def loss_fn(o):
        m = order.pop(0)
        return ops.lm_head_cross_entropy(model.ln_f(o)[:, :-1], tok,
                                         ids[m * mb:(m + 1) * mb, 1:])
loss, grads = runner.run_step(params, loss_fn=loss_fn, data=data)
np.savez({out!r}, loss=np.float64(loss),
         **{{n: g.numpy() for n, g in grads.items()}})
print("DONE", flush=True)
runner.close()
"""


def _jax_gpt(seed=11):
    from hetu_tpu.models.gpt import GPTConfig as JaxGPTConfig
    from hetu_tpu.models.gpt import GPTModel as JaxGPTModel
    model = JaxGPTModel(JaxGPTConfig(**GPT))
    variables = model.init(jax.random.PRNGKey(seed))
    return model, variables["params"]


def test_gpt_blocks_as_stages_match_jax_grad(tmp_path, port):
    from hetu_tpu import ops as jops
    from hetu_tpu_torch import interop
    from hetu_tpu_torch.models import GPTConfig

    jmodel, jparams = _jax_gpt()
    cfg = GPTConfig(**GPT)
    sd = interop.params_from_jax(jparams, cfg)
    weights = str(tmp_path / "weights.npz")
    np.savez(weights, **{k: v.numpy() for k, v in sd.items()})
    ids = np.random.default_rng(5).integers(0, GPT["vocab_size"],
                                            (GPT_B, GPT_S))
    ids_path = str(tmp_path / "ids.npy")
    np.save(ids_path, ids)
    dps = [2, 1]
    outs, jobs = {}, []
    for stage, dp in enumerate(dps):
        for rep in range(dp):
            out = str(tmp_path / f"gpt_{stage}_{rep}.npz")
            outs[(stage, rep)] = out
            jobs.append((f"gpt_{stage}_{rep}", GPT_STAGE_SRC.format(
                repo=str(REPO), stage=stage, replica=rep, dps=dps, B=GPT_B,
                S=GPT_S, M=GPT_M, H=GPT["hidden_size"], cfg=GPT,
                weights=weights, ids=ids_path, port=port, out=out)))
    _run_procs(tmp_path, jobs)

    # the JAX package's same blocks and loss, over the whole batch (the
    # mean of M equal microbatches' means)
    jids = jnp.asarray(ids)
    h0 = (jops.embedding_lookup(jparams["tok_emb"], jids)
          + jparams["pos_emb"][None, :GPT_S])

    def loss(blocks):
        h = h0
        for i in range(GPT["num_layers"]):
            p_l = jax.tree_util.tree_map(lambda a: a[i], blocks)
            h, _ = jmodel.block.apply({"params": p_l, "state": {}}, h)
        h = jops.layer_norm(h, jparams["ln_f_scale"], jparams["ln_f_bias"])
        return jops.lm_head_cross_entropy(h[:, :-1], jparams["tok_emb"],
                                          jids[:, 1:])

    want_loss, gblocks = jax.jit(jax.value_and_grad(loss))(
        jparams["blocks"])
    want = interop.params_from_jax({**jparams, "blocks": gblocks}, cfg)
    got_loss = float(np.load(outs[(1, 0)])["loss"]) / GPT_M
    assert abs(got_loss - float(want_loss)) <= \
        TOL_GPT_LOSS * abs(float(want_loss))
    block_names = {k.split(".", 2)[2] for k in want
                   if k.startswith("blocks.0.")}
    for (stage, rep), path in outs.items():
        got = np.load(path)
        names = [n for n in got.files if n != "loss"]
        assert set(names) == block_names  # every parameter of the block
        for n in names:
            w = want[f"blocks.{stage}.{n}"].numpy()
            gap = np.abs(got[n] - w).max() / np.abs(w).max()
            assert gap <= TOL_GPT_GRAD, (stage, rep, n, gap)
    for n in np.load(outs[(0, 0)]).files:
        np.testing.assert_array_equal(np.load(outs[(0, 0)])[n],
                                      np.load(outs[(0, 1)])[n])


# ---------------------------------------------------------------------------
# the heterogeneous stage: a tensor-parallel rank world as stage 0
# ---------------------------------------------------------------------------

TP_STAGE_SRC = """
import sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import torch.distributed as dist

D, B, M = {D}, {B}, {M}
mb = B // M


class TPColumn(torch.autograd.Function):
    # y = tanh(x @ w) with w split by columns over the group: rank 0's x
    # is broadcast, each rank computes its columns, the group all-gathers
    # them; the backward broadcasts rank 0's cotangent, each rank forms
    # its dw columns, and dx is summed over the group

    @staticmethod
    def forward(ctx, x, w_local):
        xb = x.detach().clone()
        dist.broadcast(xb, src=0)
        y_local = torch.tanh(xb @ w_local)
        parts = [torch.empty_like(y_local)
                 for _ in range(dist.get_world_size())]
        dist.all_gather(parts, y_local.contiguous())
        ctx.save_for_backward(xb, w_local, y_local)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, gy):
        xb, w_local, y_local = ctx.saved_tensors
        gb = gy.contiguous().clone()
        dist.broadcast(gb, src=0)
        c = w_local.shape[1]
        r = dist.get_rank()
        gz = gb[:, r * c:(r + 1) * c] * (1.0 - y_local * y_local)
        gx = gz @ w_local.t()
        dist.all_reduce(gx)
        return gx, xb.t() @ gz


def tp_stage(rank, world, port):
    from hetu_tpu_torch.parallel.mpmd import MPMDStageRunner
    torch.set_num_threads(1)
    w = torch.tensor(np.random.default_rng(100).standard_normal((D, D))
                     * 0.4, dtype=torch.float32)
    c = D // world
    w_local = w[:, rank * c:(rank + 1) * c].contiguous()
    if rank == 0:
        runner = MPMDStageRunner(
            lambda p, x: TPColumn.apply(x, p), stage=0, replica=0,
            stage_dps=[1, 1], n_microbatches=M, in_shape=(mb, D),
            out_shape=(mb, D), host="127.0.0.1", port=port,
            base_channel=7_000_000, grad_size=D * c, device="cpu")
        x = np.random.default_rng(0).standard_normal((B, D)).astype(
            np.float32)
        _, g = runner.run_step(w_local, data=[x[i * mb:(i + 1) * mb]
                                              for i in range(M)])
        runner.close()
    else:
        # the same collectives, in the runner's order (all M forwards,
        # then all M backwards): rank 0's values arrive by broadcast
        leaf = w_local.clone().requires_grad_(True)
        ys = [TPColumn.apply(torch.zeros(mb, D), leaf) for _ in range(M)]
        g = None
        for y in ys:
            (gw,) = torch.autograd.grad(y, [leaf],
                                        grad_outputs=torch.zeros_like(y))
            g = gw if g is None else g + gw
        g = g / torch.full_like(g, float(M))
    parts = [torch.empty_like(g) for _ in range(world)]
    dist.all_gather(parts, g.contiguous())
    return torch.cat(parts, dim=1).numpy()


if __name__ == "__main__":
    from hetu_tpu_torch.parallel import ranks
    res = ranks.run(tp_stage, 2, backend="gloo", args=({port},),
                    timeout_s=90.0, threads=1)
    np.testing.assert_array_equal(res[0], res[1])
    np.save({out!r}, res[0])
    print("DONE", flush=True)
"""

def test_heterogeneous_tp_rank_world_stage(tmp_path, port):
    """``tests/test_mpmd.py:388``: stage 0 a two-rank tensor-parallel
    program (column-split weight over gloo), stage 1 unsharded; both
    gradients against ``jax.grad`` of the same net."""
    D, B, M = 8, 8, 4
    out0, out1 = str(tmp_path / "tp0.npy"), str(tmp_path / "tp1.npy")
    _run_procs(tmp_path, [
        ("tp_stage0", TP_STAGE_SRC.format(repo=str(REPO), D=D, B=B, M=M,
                                          port=port, out=out0)),
        ("tp_stage1", RUNNER_SRC.format(
            repo=str(REPO), stage=1, replica=0, D=D, B=B, M=M, dps=[1, 1],
            port=port, out=out1, base=7_000_000, steps=1))])
    _, want = _tanh_oracle(D, B, 2)
    np.testing.assert_allclose(np.load(out0), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.load(out1), np.asarray(want[1]),
                               rtol=RTOL, atol=ATOL)
