"""hetu_tpu_torch stands alone: it imports neither ``jax`` nor ``hetu_tpu``.

Subprocesses import the package and, on the CPU, run the serving slice
(one prefill and one decode), GQA Llama through the paged engine and the
scheduler (prefix sharing included), a migration between a slot and a
paged engine (an int8 payload, then ``migrate_inflight``), the front
end over the van (``InferenceServer`` answering an ``InferenceClient``,
then ``migrate_inflight`` over two blob channels), the GPT and MoE
training slices (two
AdamW steps of the Executor and a checkpoint round trip each), GQA Llama
serving and a BERT pretraining step, the four other MoE gates and the
remote PS tiers (a partitioned table, the remote HET cache, ``PSEmbedding``
over them), the CNN family, and an LSTM classifier, a GCN on a sampled
batch and the op zoo, the compression zoo, and the serving pool with the
fleet plane (a fault schedule, a merged stream, the timeline and the
doctor), and the cross-process pool, whose member processes say
whether they loaded jax, as van servers and standby controllers do, and
the traffic plane with an autoscaling controller over such a pool, the
elastic training plane, whose controller and worker processes load
neither jax nor torch, and the data- and tensor-parallel plane and the
sharded plane (ShardedGPT, ring and Ulysses attention, GPipe, the
expert-parallel MoE layer), and the partial-reduce step, the distributed
GCN, the elastic supervisor, the 1F1B pipeline and HetPipe, whose rank
processes say whether they loaded jax, and the MPMD pipeline plane, whose
stage processes load neither jax nor torch;
``jax`` and ``hetu_tpu`` must stay out of
``sys.modules``.  An AST scan of every module of the package,
and of ``chip_smoke.py``, finds no import of either.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "hetu_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_FORBIDDEN = ("jax", "jaxlib", "hetu_tpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in _FORBIDDEN


def _run(code: str) -> str:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_import_is_lazy_and_jax_free():
    out = _run(
        "import sys, hetu_tpu_torch\n"
        "assert 'torch' not in sys.modules, 'import pulled in torch'\n"
        "hetu_tpu_torch.serve\n"
        "mods = sorted(m for m in sys.modules\n"
        "              if m.split('.')[0] in ('jax', 'jaxlib', 'hetu_tpu'))\n"
        "print('LEAKED', mods)\n")
    assert "LEAKED []" in out


def test_serving_slice_runs_without_jax():
    out = _run(
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from hetu_tpu_torch.models import GPTConfig, GPTModel\n"
        "from hetu_tpu_torch.serve import ServeEngine\n"
        "cfg = GPTConfig(vocab_size=97, hidden_size=32, num_layers=2,\n"
        "                num_heads=4, ffn_size=64, max_position=32,\n"
        "                attention_impl='flash')\n"
        "e = ServeEngine(GPTModel(cfg, device='cpu'), num_slots=2,\n"
        "                max_len=32, min_bucket=8, device='cpu')\n"
        "s = e.alloc_slot()\n"
        "toks = [e.prefill(s, [1, 2, 3]), e.decode()[s]]\n"
        "assert all(0 <= t < 97 for t in toks), toks\n"
        "mods = sorted(m for m in sys.modules\n"
        "              if m.split('.')[0] in ('jax', 'jaxlib', 'hetu_tpu'))\n"
        "print('LEAKED', mods)\n")
    assert "LEAKED []" in out


def test_paged_serving_runs_without_jax():
    out = _run(
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from hetu_tpu_torch.models import LlamaConfig, LlamaModel\n"
        "from hetu_tpu_torch.serve import (\n"
        "    ContinuousBatchingScheduler, PagedServeEngine, Request)\n"
        "cfg = LlamaConfig(vocab_size=97, hidden_size=32, num_layers=2,\n"
        "                  num_heads=4, num_kv_heads=2, ffn_size=48,\n"
        "                  max_position=64)\n"
        "e = PagedServeEngine(LlamaModel(cfg, device='cpu'), num_slots=2,\n"
        "                     max_len=64, page_size=8, device='cpu')\n"
        "reqs = [Request(prompt=[1, 2, 3] * 7, max_tokens=3)\n"
        "        for _ in range(3)]\n"
        "ContinuousBatchingScheduler(e).run(reqs)\n"
        "assert [r.status for r in reqs] == ['ok'] * 3\n"
        "assert e.cache.prefix_hit_tokens > 0\n"
        "mods = sorted(m for m in sys.modules\n"
        "              if m.split('.')[0] in ('jax', 'jaxlib', 'hetu_tpu'))\n"
        "print('LEAKED', mods)\n")
    assert "LEAKED []" in out


def test_migration_runs_without_jax():
    """A bf16 Llama's burst drained from a slot engine to a paged one
    through an int8 payload, then moved back by migrate_inflight."""
    out = _run(
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from hetu_tpu_torch.models import LlamaConfig, LlamaModel\n"
        "from hetu_tpu_torch.serve import (\n"
        "    ContinuousBatchingScheduler, PagedServeEngine, Request,\n"
        "    ServeEngine, migrate)\n"
        "cfg = LlamaConfig(vocab_size=97, hidden_size=32, num_layers=2,\n"
        "                  num_heads=4, num_kv_heads=2, ffn_size=48,\n"
        "                  max_position=64, dtype=torch.bfloat16)\n"
        "m = LlamaModel(cfg, device='cpu')\n"
        "a = ContinuousBatchingScheduler(ServeEngine(\n"
        "    m, num_slots=2, max_len=64, device='cpu'))\n"
        "b = ContinuousBatchingScheduler(PagedServeEngine(\n"
        "    m, num_slots=2, max_len=64, page_size=8, device='cpu'))\n"
        "reqs = [Request(prompt=[1, 2, 3, 4, 5], max_tokens=6)\n"
        "        for _ in range(3)]\n"
        "for r in reqs:\n"
        "    a.submit(r)\n"
        "a.step()\n"
        "payload, pairs = migrate.export_payload(a, codec='int8')\n"
        "got, _ = migrate.adopt_payload(b, payload)\n"
        "migrate.release_exported(a, pairs)\n"
        "b.step()\n"
        "migrate.migrate_inflight(b, a)\n"
        "a.run([])\n"
        "assert [r.status for r in got] == ['ok'] * 3\n"
        "assert b.engine.metrics.count('slots_adopted') == 2\n"
        "mods = sorted(m for m in sys.modules\n"
        "              if m.split('.')[0] in ('jax', 'jaxlib', 'hetu_tpu'))\n"
        "print('LEAKED', mods)\n")
    assert "LEAKED []" in out


def test_server_and_wire_run_without_jax():
    """A GPT behind InferenceServer answers an InferenceClient over the
    port's van; then a burst moves between two schedulers over two blob
    channels with the int8 codec."""
    out = _run(
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from hetu_tpu_torch.models import GPTConfig, GPTModel\n"
        "from hetu_tpu_torch.ps import van\n"
        "from hetu_tpu_torch.serve import (\n"
        "    ContinuousBatchingScheduler, InferenceClient, InferenceServer,\n"
        "    Request, ServeEngine, migrate)\n"
        "cfg = GPTConfig(vocab_size=97, hidden_size=32, num_layers=2,\n"
        "                num_heads=4, ffn_size=64, max_position=64)\n"
        "m = GPTModel(cfg, device='cpu')\n"
        "eng = lambda: ServeEngine(m, num_slots=2, max_len=48,\n"
        "                          min_bucket=8, device='cpu')\n"
        "srv = InferenceServer(ContinuousBatchingScheduler(eng()),\n"
        "                      max_clients=1, poll_s=0.05)\n"
        "c = InferenceClient('127.0.0.1', srv.port, 0)\n"
        "r = c.generate([1, 2, 3], max_tokens=4, timeout_s=30.0)\n"
        "assert r['status'] == 'ok' and len(r['tokens']) == 4, r\n"
        "tx = van.BlobChannel('127.0.0.1', srv.port, 99)\n"
        "rx = van.BlobChannel('127.0.0.1', srv.port, 99)\n"
        "a, b = (ContinuousBatchingScheduler(eng()) for _ in range(2))\n"
        "reqs = [Request(prompt=[5, 6, 7], max_tokens=6) for _ in range(2)]\n"
        "for q in reqs:\n"
        "    a.submit(q)\n"
        "a.step()\n"
        "migrate.migrate_inflight(a, b, wire=(tx, rx), codec='int8',\n"
        "                         chunk_bytes=1024, timeout_s=30.0)\n"
        "b.run([])\n"
        "assert [q.status for q in reqs] == ['ok'] * 2\n"
        "assert b.engine.metrics.count('slots_adopted') == 2\n"
        "for ch in (c, tx, rx):\n"
        "    ch.close()\n"
        "srv.close()\n"
        "mods = sorted(m for m in sys.modules\n"
        "              if m.split('.')[0] in ('jax', 'jaxlib', 'hetu_tpu'))\n"
        "print('LEAKED', mods)\n")
    assert "LEAKED []" in out


def test_training_slice_runs_without_jax(tmp_path):
    out = _run(
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from hetu_tpu_torch.models import GPTConfig, GPTModel\n"
        "from hetu_tpu_torch.optim import AdamWOptimizer\n"
        "from hetu_tpu_torch.train import Executor, checkpoint\n"
        "cfg = GPTConfig(vocab_size=97, hidden_size=32, num_layers=2,\n"
        "                num_heads=4, ffn_size=64, max_position=32,\n"
        "                dropout_rate=0.1, attention_impl='flash',\n"
        "                remat=True, ce_row_chunk=16)\n"
        "m = GPTModel(cfg, device='cpu')\n"
        "ex = Executor(m.lm_loss_fn(), AdamWOptimizer(1e-2), seed=0)\n"
        "st = ex.init_state(m)\n"
        "ids = torch.randint(0, 97, (2, 16))\n"
        "losses = []\n"
        "for _ in range(2):\n"
        "    st, met = ex.run('train', st, (ids,))\n"
        "    losses.append(float(met['loss']))\n"
        f"checkpoint.save({str(tmp_path / 'c.npz')!r}, st, cfg)\n"
        f"st = checkpoint.load({str(tmp_path / 'c.npz')!r}, st, cfg)\n"
        "assert st.step == 2 and all(l == l for l in losses), losses\n"
        "mods = sorted(m for m in sys.modules\n"
        "              if m.split('.')[0] in ('jax', 'jaxlib', 'hetu_tpu'))\n"
        "print('LEAKED', mods)\n")
    assert "LEAKED []" in out


def test_moe_training_slice_runs_without_jax(tmp_path):
    out = _run(
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from hetu_tpu_torch.models import MoEConfig, MoETransformer\n"
        "from hetu_tpu_torch.optim import AdamWOptimizer\n"
        "from hetu_tpu_torch.train import Executor, checkpoint\n"
        "cfg = MoEConfig(vocab_size=97, hidden_size=32, num_layers=2,\n"
        "                num_heads=4, ffn_size=64, num_experts=4,\n"
        "                max_position=32, dtype=torch.bfloat16)\n"
        "m = MoETransformer(cfg, device='cpu')\n"
        "ex = Executor(m.lm_loss_fn(), AdamWOptimizer(1e-2), seed=0)\n"
        "st = ex.init_state(m)\n"
        "ids = torch.randint(0, 97, (2, 16))\n"
        "losses = []\n"
        "for _ in range(2):\n"
        "    st, met = ex.run('train', st, (ids,))\n"
        "    losses.append(float(met['loss']))\n"
        f"checkpoint.save({str(tmp_path / 'c.npz')!r}, st, cfg)\n"
        f"st = checkpoint.load({str(tmp_path / 'c.npz')!r}, st, cfg)\n"
        "assert st.step == 2 and all(l == l for l in losses), losses\n"
        "assert set(met) == {'loss', 'lm_loss', 'aux_loss'}, met\n"
        "mods = sorted(m for m in sys.modules\n"
        "              if m.split('.')[0] in ('jax', 'jaxlib', 'hetu_tpu'))\n"
        "print('LEAKED', mods)\n")
    assert "LEAKED []" in out


def test_llama_serving_and_bert_training_run_without_jax():
    out = _run(
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from hetu_tpu_torch.models import BertConfig, BertModel\n"
        "from hetu_tpu_torch.models import LlamaConfig, LlamaModel\n"
        "from hetu_tpu_torch.optim import AdamWOptimizer\n"
        "from hetu_tpu_torch.serve import ServeEngine\n"
        "from hetu_tpu_torch.train import Executor\n"
        "cfg = LlamaConfig(vocab_size=97, hidden_size=32, num_layers=2,\n"
        "                  num_heads=4, num_kv_heads=2, ffn_size=48,\n"
        "                  max_position=32, attention_impl='flash')\n"
        "e = ServeEngine(LlamaModel(cfg, device='cpu'), num_slots=2,\n"
        "                max_len=32, min_bucket=8, device='cpu')\n"
        "s = e.alloc_slot()\n"
        "toks = [e.prefill(s, [1, 2, 3]), e.decode()[s]]\n"
        "assert all(0 <= t < 97 for t in toks), toks\n"
        "bc = BertConfig(vocab_size=97, hidden_size=32, num_layers=2,\n"
        "                num_heads=4, ffn_size=48, max_position=16,\n"
        "                attention_impl='flash')\n"
        "m = BertModel(bc, device='cpu')\n"
        "ex = Executor(m.pretrain_loss_fn(), AdamWOptimizer(1e-2), seed=0)\n"
        "st = ex.init_state(m)\n"
        "ids = torch.randint(0, 97, (2, 16))\n"
        "b = (ids, torch.zeros_like(ids), None, ids, torch.tensor([0, 1]))\n"
        "st, met = ex.run('train', st, b)\n"
        "assert set(met) == {'loss', 'mlm_loss', 'nsp_loss'}, met\n"
        "mods = sorted(m for m in sys.modules\n"
        "              if m.split('.')[0] in ('jax', 'jaxlib', 'hetu_tpu'))\n"
        "print('LEAKED', mods)\n")
    assert "LEAKED []" in out


def test_moe_gates_and_remote_ps_tiers_run_without_jax():
    """``layers.moe`` with each of the four other gates (a forward and a
    backward through ``MoELayer``), then ``ps.van`` and ``ps.embedding``:
    a van server in this process, a table partitioned over it behind the
    remote HET cache, and ``PSEmbedding(endpoints=...)``'s pull, push and
    layered prefetch."""
    out = _run(
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "import numpy as np\n"
        "from hetu_tpu_torch.layers import moe\n"
        "from hetu_tpu_torch.ps import embedding, van\n"
        "g = torch.Generator().manual_seed(0)\n"
        "for gate in (moe.HashGate(4), moe.KTop1Gate(8, 4, 2, generator=g),\n"
        "             moe.BalanceAssignmentGate(8, 4, generator=g),\n"
        "             moe.SAMGate(8, 4, generator=g)):\n"
        "    layer = moe.MoELayer(gate, moe.Expert(4, 8, 16, generator=g))\n"
        "    x = torch.randn(32, 8, generator=g, requires_grad=True)\n"
        "    gi = torch.arange(32) if isinstance(gate, moe.HashGate) \\\n"
        "        else None\n"
        "    y, aux = layer(x, gate_input=gi)\n"
        "    (y.sum() + aux).backward()\n"
        "    assert x.grad is not None\n"
        "port = van.serve(0)\n"
        "t = van.PartitionedPSTable([('127.0.0.1', port)], 50, 4)\n"
        "c = van.RemoteCacheTable(t, 8)\n"
        "assert c.embedding_lookup([1, 2]).shape == (2, 4)\n"
        "c.close(); t.close()\n"
        "e = embedding.PSEmbedding(50, 4, endpoints=[('127.0.0.1', port)],\n"
        "                          cache_capacity=16)\n"
        "e.push([3, 4], e.pull([3, 4]))\n"
        "e.prefetch_layered([(1, [5]), (0, [6])])\n"
        "assert e.pull_layered(0).shape == (1, 4)\n"
        "e.pull_layered(1); e.close(); van.stop()\n"
        "mods = sorted(m for m in sys.modules\n"
        "              if m.split('.')[0] in ('jax', 'jaxlib', 'hetu_tpu'))\n"
        "print('LEAKED', mods)\n")
    assert "LEAKED []" in out


def test_cnn_training_slice_runs_without_jax(tmp_path):
    """A tiny ResNet ([1, 1, 1, 1] blocks) trains two Executor steps with
    its BatchNorm state, through the Dataloader, and round-trips a
    checkpoint, in a process where ``jax`` and ``hetu_tpu`` cannot be
    imported at all."""
    out = _run(
        "import sys\n"
        "sys.modules.update(jax=None, jaxlib=None, hetu_tpu=None)\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(2)\n"
        "from hetu_tpu_torch import layers\n"
        "from hetu_tpu_torch.data import Dataloader, datasets\n"
        "from hetu_tpu_torch.models import BasicBlock, ResNet\n"
        "from hetu_tpu_torch.optim import MomentumOptimizer\n"
        "from hetu_tpu_torch.train import Executor, checkpoint\n"
        "x, y, _, _ = datasets.cifar10(synthetic_n=16)\n"
        "m = ResNet(BasicBlock, [1, 1, 1, 1], device='cpu')\n"
        "ex = Executor(m.loss_fn(), MomentumOptimizer(0.1, 0.9), seed=0)\n"
        "st = ex.init_state(m)\n"
        "for b in Dataloader((x, y), 8, shuffle=True):\n"
        "    st, met = ex.run('train', st, b)\n"
        "assert st.step == 2 and float(met['loss']) == float(met['loss'])\n"
        "assert st.model_state['bn1.mean'] is m.bn1.mean\n"
        "assert float(m.bn1.var.min()) != 1.0\n"
        f"ex.save({str(tmp_path / 'c.npz')!r}, st, m)\n"
        "want = checkpoint.state_dict(st, m)\n"
        "m.bn1.mean.zero_()\n"
        f"st = ex.load({str(tmp_path / 'c.npz')!r}, st, m)\n"
        "got = checkpoint.state_dict(st, m)\n"
        "assert all(np.array_equal(got[k], w) for k, w in want.items())\n"
        "ex.run('validate', st, (x[:4], y[:4]))\n"
        "mods = sorted(m for m in sys.modules if sys.modules[m] is not None\n"
        "              and m.split('.')[0] in ('jax', 'jaxlib', 'hetu_tpu'))\n"
        "print('LEAKED', mods)\n")
    assert "LEAKED []" in out


def test_rnn_gcn_and_op_zoo_run_without_jax():
    """An LSTM classifier's Executor step, a GCN step on a batch sampled
    from in-process PS tables, and ops of the four families, in a process
    where ``jax`` and ``hetu_tpu`` cannot be imported at all."""
    out = _run(
        "import sys\n"
        "sys.modules.update(jax=None, jaxlib=None, hetu_tpu=None)\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(2)\n"
        "from hetu_tpu_torch import ops\n"
        "from hetu_tpu_torch.data.graph_sampler import (\n"
        "    DistGraph, NeighborSampler)\n"
        "from hetu_tpu_torch.models import GCN, RNNClassifier\n"
        "from hetu_tpu_torch.optim import AdamOptimizer\n"
        "from hetu_tpu_torch.ps import PSTable\n"
        "from hetu_tpu_torch.train import Executor\n"
        "g = np.random.default_rng(0)\n"
        "m = RNNClassifier('lstm', 8, device='cpu')\n"
        "ex = Executor(m.loss_fn(), AdamOptimizer(1e-3), seed=0)\n"
        "st, met = ex.run('train', ex.init_state(m),\n"
        "                 (g.random((4, 784), np.float32),\n"
        "                  g.integers(0, 10, 4)))\n"
        "src, dst = g.integers(0, 30, 120), g.integers(0, 30, 120)\n"
        "graph = DistGraph.publish(\n"
        "    src, dst, g.standard_normal((30, 6)), g.integers(0, 3, 30),\n"
        "    max_degree=4, table_factory=lambda r, d, t: PSTable(\n"
        "        r, d, init='zeros'))\n"
        "b = NeighborSampler(graph).sample([0, 1], (3, 2)).pad_to(31, 40)\n"
        "es, ed, ew = ops.gcn_norm(torch.tensor(b.edge_src),\n"
        "                          torch.tensor(b.edge_dst), 31)\n"
        "gcn = GCN(6, 8, 3, device='cpu')\n"
        "ex = Executor(gcn.loss_fn(es, ed, ew), AdamOptimizer(0.01))\n"
        "st, met2 = ex.run('train', ex.init_state(gcn),\n"
        "                  (b.features, b.labels, b.seed_mask))\n"
        "x = torch.tensor(g.standard_normal((3, 4)), dtype=torch.float32)\n"
        "v, i = ops.topk(ops.add(x, 1.0), 2)\n"
        "u, inv = ops.unique(ops.argsort(x), 5)\n"
        "y = ops.interpolate(x[None, None], size=(6, 2))\n"
        "assert y.shape == (1, 1, 6, 2) and ops.matmul(x, x.t()).shape \\\n"
        "    == (3, 3)\n"
        "assert np.isfinite(float(met['loss']) + float(met2['loss']))\n"
        "mods = sorted(m for m in sys.modules if sys.modules[m] is not None\n"
        "              and m.split('.')[0] in ('jax', 'jaxlib', 'hetu_tpu'))\n"
        "print('LEAKED', mods)\n")
    assert "LEAKED []" in out


def test_compression_zoo_runs_without_jax():
    """Each method of the compression zoo looks up a batch, a DPQ table
    trains one Adam step under the example's head, the OptEmbed flow and
    the scheduler's int8 switch run, and the quantize ops, in a process
    where ``jax`` and ``hetu_tpu`` cannot be imported at all."""
    out = _run(
        "import sys\n"
        "sys.modules.update(jax=None, jaxlib=None, hetu_tpu=None)\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(2)\n"
        "import hetu_tpu_torch as htt\n"
        "from hetu_tpu_torch import embedding_compress as ec, ops, optim\n"
        "from hetu_tpu_torch.embedding_compress.scheduler import (\n"
        "    Stage, switch_to_quantized)\n"
        "from hetu_tpu_torch.models.ctr_common import mlp_tower\n"
        "g = torch.Generator().manual_seed(0)\n"
        "ids = torch.tensor([[1, 5, 99], [0, 7, -1]])\n"
        "names = [n for n in dir(ec) if n.endswith('Embedding')\n"
        "         and n not in ('SparseEmbedding', 'QuantizedEmbedding')]\n"
        "args = {'HashEmbedding': (0.1,), 'ROBEEmbedding': (0.1,),\n"
        "        'DedupEmbedding': (0.2,)}\n"
        "for n in names:\n"
        "    rows = getattr(ec, n)(100, 8, *args.get(n, ()), generator=g)(ids)\n"
        "    assert rows.shape == (2, 3, 8), n\n"
        "emb = ec.DPQEmbedding(100, 8, codes=16, generator=g)\n"
        "head = mlp_tower(24, (4,), out_dim=1, generator=g)\n"
        "params = {**{'embed.' + k: p for k, p in emb.named_parameters()},\n"
        "          **{'head.' + k: p for k, p in head.named_parameters()}}\n"
        "opt = optim.AdamOptimizer(1e-2)\n"
        "loss = head(emb(ids).reshape(2, -1)).square().mean()\n"
        "opt.update(dict(zip(params, torch.autograd.grad(\n"
        "    loss, list(params.values())))), opt.init_state(params), params)\n"
        "oe = ec.OptEmbedEmbedding(100, 8, generator=g)\n"
        "flow = ec.OptEmbedFlow(oe, lambda p, b: oe(b).square().sum())\n"
        "flow.train_supernet({'embed.' + k: p for k, p in\n"
        "                     oe.named_parameters()}, [ids])\n"
        "assert flow.finalize([1, 2, 3]).field_dims.tolist() == [1, 2, 3]\n"
        "q = ec.CompressionScheduler([Stage('a', 1), Stage(\n"
        "    'b', 2, switch_to_quantized(None))]).maybe_transition(\n"
        "    1, ec.PrunedEmbedding(100, 8, generator=g))\n"
        "assert q.q.dtype == torch.int8 and q(ids).shape == (2, 3, 8)\n"
        "x = torch.randn(4, 8, generator=g)\n"
        "qx, s = ops.quantize(x)\n"
        "assert ops.dequantize(qx, s).shape == ops.prune_low_magnitude(\n"
        "    x, 0.5).shape\n"
        "mods = sorted(m for m in sys.modules\n"
        "              if m.split('.')[0] in ('jax', 'jaxlib', 'hetu_tpu')\n"
        "              and sys.modules[m] is not None)\n"
        "print('LEAKED', mods)\n")
    assert "LEAKED []" in out


def test_serving_pool_and_fleet_plane_run_without_jax(tmp_path):
    """A two-member ServingPool serves a request, drains a member in
    process and fails another over; a seeded FaultSchedule, the
    timeline, a process stream merged by the fleet plane and the health
    doctor run beside it."""
    out = _run(
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from hetu_tpu_torch.models import GPTConfig, GPTModel\n"
        "from hetu_tpu_torch.serve import ServeEngine, ServingPool\n"
        "from hetu_tpu_torch.resilience import FaultSchedule\n"
        "from hetu_tpu_torch.telemetry import (\n"
        "    fleet, health, timeline, trace)\n"
        "cfg = GPTConfig(vocab_size=97, hidden_size=32, num_layers=2,\n"
        "                num_heads=4, ffn_size=64, max_position=32)\n"
        "m = GPTModel(cfg, device='cpu')\n"
        "f = lambda: ServeEngine(m, num_slots=2, max_len=32,\n"
        "                        min_bucket=8, device='cpu')\n"
        f"tr = trace.open_process_stream({str(tmp_path)!r}, 'pool')\n"
        "pool = ServingPool({'a': f, 'b': f, 'c': f}, start_poll=False)\n"
        "try:\n"
        "    assert pool.generate([1, 2, 3], max_tokens=4)['status'] == 'ok'\n"
        "    trace.instant('fault.serve_preempt', {'kind': 'serve_preempt'})\n"
        "    pool.drain_member('a', wire=False)\n"
        "    trace.instant('fault.serve_engine_kill',\n"
        "                  {'kind': 'serve_engine_kill'})\n"
        "    pool.failover('b')\n"
        "    assert pool.generate([4, 5], max_tokens=3)['status'] == 'ok'\n"
        "finally:\n"
        "    pool.close()\n"
        "    trace.disable()\n"
        f"ev, procs = fleet.merge_streams({str(tmp_path)!r})\n"
        "pairs = timeline.correlate(ev)\n"
        "assert [p.paired for p in pairs] == [True, True], pairs\n"
        "d = health.diagnose(ev, alert=health.AlertRule(\n"
        "    'x', fault_kinds=('serve_engine_kill',)))\n"
        "assert d['top']['kind'] == 'serve_engine_kill', d\n"
        "s = FaultSchedule.generate(steps=6, seed=0, serve_preempts=1,\n"
        "                           serve_engine_kills=1, n_members=3)\n"
        "assert len(s) == 2\n"
        "mods = sorted(m for m in sys.modules\n"
        "              if m.split('.')[0] in ('jax', 'jaxlib', 'hetu_tpu'))\n"
        "print('LEAKED', mods)\n")
    assert "LEAKED []" in out
    names = {p.relative_to(PKG).as_posix() for p in SOURCES
             if PKG in p.parents}
    assert {"serve/pool.py", "resilience/__init__.py",
            "resilience/faults.py", "telemetry/registry.py",
            "telemetry/trace.py", "telemetry/timeline.py",
            "telemetry/fleet.py", "telemetry/costs.py",
            "telemetry/health.py"} <= names


def test_cross_process_pool_and_its_members_run_without_jax(tmp_path):
    """A CrossProcessServingPool of two member processes on the CPU
    serves a request with a netem emulator installed: neither the
    controller nor a member process loads jax (each member says so on its
    READY line and in its metrics)."""
    out = _run(
        "import sys\n"
        "from hetu_tpu_torch.ps import netem\n"
        "from hetu_tpu_torch.serve.crosshost import CrossProcessServingPool\n"
        "model = {'vocab_size': 89, 'hidden_size': 32, 'num_layers': 2,\n"
        "         'num_heads': 4, 'ffn_size': 64, 'max_position': 32,\n"
        "         'max_len': 32, 'device': 'cpu'}\n"
        f"pool = CrossProcessServingPool(2, workdir={str(tmp_path)!r},\n"
        "    model=model, member_env={'OMP_NUM_THREADS': '1'})\n"
        "em = netem.NetEm(seed=0).install()\n"
        "try:\n"
        "    assert pool.generate([1, 2, 3], max_tokens=4)['status'] == 'ok'\n"
        "    d = pool.fleet_metrics().dump()\n"
        "    print('MEMBER_JAX', [int(d[f'm{s}.member.jax_loaded']['value'])\n"
        "                         for s in (0, 1)])\n"
        "finally:\n"
        "    em.uninstall()\n"
        "    pool.close()\n"
        "mods = sorted(m for m in sys.modules\n"
        "              if m.split('.')[0] in ('jax', 'jaxlib', 'hetu_tpu'))\n"
        "print('LEAKED', mods)\n")
    assert "LEAKED []" in out
    assert "MEMBER_JAX [0, 0]" in out
    logs = sorted(tmp_path.glob("member_*.log"))
    assert len(logs) == 2
    for log in logs:
        assert "READY" in log.read_text() and "jax=0" in log.read_text()
    names = {p.relative_to(PKG).as_posix() for p in SOURCES
             if PKG in p.parents}
    assert {"launcher.py", "resilience/shardproc.py", "ps/netem.py",
            "ps/membership.py", "serve/crosshost.py"} <= names


def test_van_and_standby_processes_run_without_jax(tmp_path):
    """A van server process loads neither jax nor torch (its READY line
    says so), and a standby controller process attached to a blackboard
    on it over a replicated pair says ``jax=0`` on its READY line and
    stands down when its watch budget lapses."""
    import json

    from hetu_tpu_torch.ps import membership as mb
    from hetu_tpu_torch.resilience.shardproc import (
        free_port, spawn_module, spawn_shard_server,
    )
    ports = [free_port(), free_port()]
    vans = [spawn_shard_server(tmp_path, p, f"v{i}")
            for i, p in enumerate(ports)]
    try:
        for v, p in zip(vans, ports):
            assert v.ready == [str(p), "jax=0", "torch=0"]
        spec = {"endpoints": [["127.0.0.1", p] for p in ports],
                "epoch_table": mb.fresh_table_id()}
        tid = mb.fresh_table_id()
        bb = mb.create_blackboard("127.0.0.1", ports[0], table_id=tid,
                                  n_slots=1, replica=spec)
        cfg = tmp_path / "standby.json"
        cfg.write_text(json.dumps({
            "workdir": str(tmp_path), "port": ports[0], "n_slots": 1,
            "membership_table": tid, "van": spec, "lease_bound_s": 60.0,
            "watch_timeout_s": 0.5}))
        sb = spawn_module(tmp_path, "standby",
                          "hetu_tpu_torch.resilience.standby", [str(cfg)],
                          timeout_s=120.0)
        assert sb.wait(120.0) == 2  # no decision: TIMEOUT
        log = sb.log_path.read_text()
        assert "READY jax=0" in log and "TIMEOUT" in log
        bb.close()
    finally:
        for v in vans:
            v.kill()
            v.wait()
    names = {p.relative_to(PKG).as_posix() for p in SOURCES
             if PKG in p.parents}
    assert {"ps/replica.py", "resilience/standby.py"} <= names


def test_traffic_plane_and_autoscaled_controller_run_without_jax(tmp_path):
    """A controller scales a CrossProcessServingPool of CPU members with
    the traffic plane: a slot parked, an autoscaler tick that revives it,
    a seeded open-loop trace replayed through ``llm_submitter``; neither
    the controller nor a member process loads jax."""
    out = _run(
        "import sys\n"
        "from hetu_tpu_torch.serve.crosshost import CrossProcessServingPool\n"
        "from hetu_tpu_torch.traffic import (AutoscalePolicy, Autoscaler,\n"
        "    TenantSpec, TraceSpec, llm_submitter, replay, synthesize)\n"
        "model = {'vocab_size': 89, 'hidden_size': 32, 'num_layers': 2,\n"
        "         'num_heads': 4, 'ffn_size': 64, 'max_position': 32,\n"
        "         'max_len': 32, 'device': 'cpu'}\n"
        f"pool = CrossProcessServingPool(2, workdir={str(tmp_path)!r},\n"
        "    model=model, member_env={'OMP_NUM_THREADS': '1'}, shed=True,\n"
        "    slo_classes={'gold': {'priority': 2, 'weight': 4.0}},\n"
        "    scrape_s=0.25)\n"
        "try:\n"
        "    pool.drain_member(1, close=True)\n"
        "    sc = Autoscaler(pool, AutoscalePolicy(min_members=1,\n"
        "        max_members=2, queue_high=0.0, up_ticks=1), active={0})\n"
        "    assert sc.tick()['action'] == 'up' and sc.active == {0, 1}\n"
        "    trace = synthesize(TraceSpec(seed=1, duration_s=1.0,\n"
        "        base_qps=6.0, vocab=89, max_prompt_len=6,\n"
        "        tenants=[TenantSpec('gold', slo='gold', max_tokens=3,\n"
        "                            deadline_lo_s=60, deadline_hi_s=90)]))\n"
        "    out = replay(trace, llm_submitter(pool))\n"
        "    assert out and all(h.done.wait(60) for _, h in out)\n"
        "    print('STATUS', sorted({h.status for _, h in out}))\n"
        "    print('JOURNALED', pool.autoscaler_state()['actions'])\n"
        "finally:\n"
        "    pool.close()\n"
        "mods = sorted(m for m in sys.modules\n"
        "              if m.split('.')[0] in ('jax', 'jaxlib', 'hetu_tpu'))\n"
        "print('LEAKED', mods)\n")
    assert "LEAKED []" in out
    assert "STATUS ['ok']" in out and "JOURNALED 1" in out
    logs = sorted(tmp_path.glob("member_*.log"))
    assert len(logs) == 3  # two members, then the revived one
    for log in logs:
        assert "READY" in log.read_text() and "jax=0" in log.read_text()
    names = {p.relative_to(PKG).as_posix() for p in SOURCES
             if PKG in p.parents}
    assert {"traffic/__init__.py", "traffic/loadgen.py",
            "traffic/autoscale.py"} <= names


def test_ctr_serving_runs_without_jax():
    """A two-member RecsysPool on the CPU over a PS table scores a
    request, a trace's CTR events through ``ctr_submitter`` and one over
    the wire; ``hetu_tpu_torch.serve.recsys`` loads neither jax nor
    hetu_tpu."""
    out = _run(
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from hetu_tpu_torch.models import WideDeep\n"
        "from hetu_tpu_torch.ps.client import PSTable\n"
        "from hetu_tpu_torch.serve import (RecsysClient, RecsysEngine,\n"
        "    RecsysPool, ServingEmbeddingCache)\n"
        "from hetu_tpu_torch.telemetry.registry import MetricsRegistry\n"
        "from hetu_tpu_torch.traffic import (TenantSpec, TraceSpec,\n"
        "    ctr_submitter, replay, synthesize)\n"
        "m = WideDeep(4, 8, 8, hidden=(16,), device='cpu')\n"
        "t = PSTable(64, 8, seed=1)\n"
        "f = lambda: RecsysEngine(m, ServingEmbeddingCache(\n"
        "    t, 16, registry=MetricsRegistry()), max_batch=8,\n"
        "    min_bucket=2, device='cpu')\n"
        "pool = RecsysPool({'a': f, 'b': f}, start_poll=False)\n"
        "front = pool.frontend(max_clients=1)\n"
        "cl = RecsysClient('127.0.0.1', pool.port, 0)\n"
        "try:\n"
        "    assert pool.score([0.0] * 8, [1, 2, 3, 4])['status'] == 'ok'\n"
        "    assert cl.score([0.0] * 8, [1, 2, 3, 4])['status'] == 'ok'\n"
        "    tr = synthesize(TraceSpec(seed=2, duration_s=1.0, base_qps=8.0,\n"
        "        tenants=[TenantSpec('c', kind='ctr', deadline_lo_s=60,\n"
        "                            deadline_hi_s=90)]))\n"
        "    out = replay(tr, ctr_submitter(pool))\n"
        "    assert out and all(h.done.wait(60) for _, h in out)\n"
        "    print('STATUS', sorted({h.status for _, h in out}))\n"
        "finally:\n"
        "    cl.close()\n"
        "    front.close()\n"
        "    pool.close()\n"
        "mods = sorted(m for m in sys.modules\n"
        "              if m.split('.')[0] in ('jax', 'jaxlib', 'hetu_tpu'))\n"
        "print('LEAKED', mods)\n")
    assert "LEAKED []" in out and "STATUS ['ok']" in out
    names = {p.relative_to(PKG).as_posix() for p in SOURCES
             if PKG in p.parents}
    assert {"serve/recsys.py", "serve/pool.py",
            "traffic/loadgen.py"} <= names


def test_training_supervisor_straggler_and_logger_run_without_jax(
        tmp_path):
    """The supervisor, straggler detection and the metric logger import
    without torch (the checkpoint module loads on first use), then a
    supervised run preempted by the injector resumes from its checkpoint,
    a detector sweep records an episode, and the logger holds the
    counters; jax and hetu_tpu stay out."""
    out = _run(
        "import sys\n"
        "import hetu_tpu_torch.resilience.supervisor\n"
        "import hetu_tpu_torch.resilience.straggler\n"
        "import hetu_tpu_torch.utils.logger\n"
        "print('TORCH', 'torch' in sys.modules)\n"
        "import torch\n"
        "from hetu_tpu_torch import layers, ops, optim\n"
        "from hetu_tpu_torch.resilience import (FaultEvent, FaultInjector,\n"
        "    FaultSchedule, Supervisor)\n"
        "from hetu_tpu_torch.resilience.straggler import StragglerDetector\n"
        "from hetu_tpu_torch.train import Executor\n"
        "from hetu_tpu_torch.utils import MetricLogger\n"
        "g = torch.Generator().manual_seed(0)\n"
        "model = layers.Sequential(layers.Linear(4, 8, generator=g),\n"
        "                          layers.Relu(),\n"
        "                          layers.Linear(8, 2, generator=g))\n"
        "x = torch.randn(16, 4, generator=g)\n"
        "y = (x.sum(1) > 0).int()\n"
        "def loss_fn(params, model_state, batch, gen, train):\n"
        "    loss = ops.softmax_cross_entropy_sparse(model(batch[0]),\n"
        "                                            batch[1]).mean()\n"
        "    return loss, ({}, model_state)\n"
        "logger = MetricLogger()\n"
        "ex = Executor(loss_fn, optim.AdamOptimizer(0.01), seed=0)\n"
        "inj = FaultInjector(FaultSchedule([FaultEvent(2, 'preempt')]))\n"
        f"sup = Supervisor(ex, ckpt_dir={str(tmp_path)!r}, injector=inj,\n"
        "                 config=model, logger=logger)\n"
        "rep = sup.run(ex.init_state(model), lambda i: (x, y), 5)\n"
        "assert rep.preempted and rep.step == 3\n"
        f"rep = Supervisor(ex, ckpt_dir={str(tmp_path)!r}, config=model)\\\n"
        "    .run(ex.init_state(model), lambda i: (x, y), 5)\n"
        "print('RESUMED', rep.counters['resumed_from_step'], rep.step)\n"
        "det = StragglerDetector(factor=2.0)\n"
        "det.observe({0: 10.0, 1: 10.0, 2: 50.0})\n"
        "det.close_all()\n"
        "print('EPISODES', len(det.records))\n"
        "print('LOGGED', logger.counters_snapshot()['checkpoints'])\n"
        "mods = sorted(m for m in sys.modules\n"
        "              if m.split('.')[0] in ('jax', 'jaxlib', 'hetu_tpu'))\n"
        "print('LEAKED', mods)\n")
    assert "TORCH False" in out and "LEAKED []" in out
    assert "RESUMED 3 5" in out and "EPISODES 1" in out
    assert "LOGGED 1" in out
    names = {p.relative_to(PKG).as_posix() for p in SOURCES
             if PKG in p.parents}
    assert {"resilience/supervisor.py", "resilience/straggler.py",
            "utils/logger.py"} <= names


def _maps_load(pid: int) -> dict:
    """Whether process ``pid`` has mapped torch's or jaxlib's shared
    libraries (an import of either maps them)."""
    maps = Path(f"/proc/{int(pid)}/maps").read_text()
    return {"torch": int("libtorch" in maps or "/torch/lib/" in maps),
            "jax": int("jaxlib" in maps)}


def test_elastic_plane_processes_run_without_jax_or_torch(tmp_path):
    """The elastic training plane imports neither jax nor torch: an
    in-process supervisor runs a 2-worker fleet to its end with both out
    of ``sys.modules``; a spawned ``--controller`` process over a van
    process maps neither library while its fleet trains, and every
    worker it spawned says ``jax=0 torch=0`` on its READY line."""
    import json
    import time

    out = _run(
        "import sys\n"
        "import hetu_tpu_torch.resilience.multicontroller as mc\n"
        "print('AT_IMPORT', 'jax' in sys.modules, 'torch' in sys.modules)\n"
        "sup = mc.MultiControllerElasticSupervisor(\n"
        f"    2, workdir={str(tmp_path)!r},\n"
        "    steps=4, global_batch=4, lease_s=2.0, suspect_grace_s=2.0,\n"
        "    ordered_grads=True)\n"
        "try:\n"
        "    sup.verify_consumed(sup.run(deadline_s=60.0)['consumed'])\n"
        "finally:\n"
        "    sup.close()\n"
        "mods = sorted(m for m in sys.modules\n"
        "              if m.split('.')[0] in ('jax', 'jaxlib', 'hetu_tpu',\n"
        "                                     'torch'))\n"
        "print('LEAKED', mods)\n")
    assert "AT_IMPORT False False" in out and "LEAKED []" in out
    for log in tmp_path.glob("worker_*_*.log"):
        assert "jax=0 torch=0" in log.read_text()

    from hetu_tpu_torch.resilience.shardproc import (
        free_port, spawn_module, spawn_shard_server,
    )
    work = tmp_path / "spawned"
    work.mkdir()
    port = free_port()
    procs = [spawn_shard_server(work, port, "v")]
    try:
        cfg = work / "ctrl.json"
        cfg.write_text(json.dumps({
            "workdir": str(work), "port": port, "n_workers": 2,
            "steps": 6, "global_batch": 4, "lease_s": 2.0,
            "suspect_grace_s": 2.0, "deadline_s": 60.0}))
        ctrl = spawn_module(work, "ctrl",
                            "hetu_tpu_torch.resilience.multicontroller",
                            ["--controller", str(cfg)], timeout_s=120.0)
        procs.append(ctrl)
        deadline = time.monotonic() + 60.0
        while "ALLDONE" not in ctrl.log_path.read_text():
            assert ctrl.poll() is None and time.monotonic() < deadline, \
                ctrl.log_path.read_text()[-2000:]
            time.sleep(0.05)
        assert _maps_load(ctrl.pid) == {"torch": 0, "jax": 0}
        logs = sorted(work.glob("worker_*_*.log"))
        assert len(logs) == 2
        for slot, log in enumerate(logs):
            assert f"READY {slot} jax=0 torch=0" in log.read_text()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        subprocess.run(["pkill", "-9", "-f", str(work)],
                       capture_output=True, timeout=10)
    names = {p.relative_to(PKG).as_posix() for p in SOURCES
             if PKG in p.parents}
    assert {"resilience/memberproc.py",
            "resilience/multicontroller.py"} <= names


def test_parallel_plane_and_its_rank_processes_run_without_jax():
    """Two gloo rank processes train the GPT under MegatronLM (tp = 2)
    and dp = 2 with int8 grad sync; neither they nor their parent load
    jax or hetu_tpu."""
    out = _run(
        "import sys\n"
        "sys.path.insert(0, 'tests')\n"
        "import numpy as np, torch\n"
        "import torch_parallel_bodies as b\n"
        "from hetu_tpu_torch import parallel\n"
        "from hetu_tpu_torch.parallel import collectives, ranks, spec\n"
        "from hetu_tpu_torch.parallel.strategies import MegatronLM\n"
        "from hetu_tpu_torch.models import GPTConfig, GPTModel\n"
        "cfg = dict(vocab_size=32, hidden_size=16, num_layers=1,\n"
        "           num_heads=2, ffn_size=32, max_position=8,\n"
        "           dropout_rate=0.0)\n"
        "m = GPTModel(GPTConfig(**cfg), device='cpu')\n"
        "p = {k: v.detach().numpy() for k, v in m.state_dict().items()}\n"
        "ids = [np.random.default_rng(0).integers(0, 32, (4, 8))]\n"
        "case = lambda **kw: ('train_gpt', dict(opt=('sgd', 0.1),\n"
        "    batches=ids, params=p, cfg=cfg, **kw))\n"
        "res = ranks.run(b.run_cases, 2, threads=1, args=({\n"
        "    'tp': case(mesh={'tp': 2}, strategy='MegatronLM'),\n"
        "    'int8': case(mesh={'dp': 2}, grad_sync='int8')},))\n"
        "print('RANKS_JAX', [r['_jax_loaded'] for r in res])\n"
        "print('LOSS', all(np.isfinite(r['tp']['losses']).all() for r in res))\n"
        "mods = sorted(m for m in sys.modules\n"
        "              if m.split('.')[0] in ('jax', 'jaxlib', 'hetu_tpu'))\n"
        "print('LEAKED', mods)\n")
    assert "LEAKED []" in out and "RANKS_JAX [False, False]" in out
    assert "LOSS True" in out
    names = {p.relative_to(PKG).as_posix() for p in SOURCES
             if PKG in p.parents}
    assert {"parallel/__init__.py", "parallel/mesh.py", "parallel/ranks.py",
            "parallel/collectives.py", "parallel/spec.py",
            "parallel/strategies/__init__.py", "parallel/strategies/base.py",
            "parallel/strategies/simple.py"} <= names


def test_sharded_plane_and_its_rank_processes_run_without_jax():
    """Two gloo rank processes run ShardedGPT at pp = 2 (one Adam step),
    the ring and Ulysses at sp = 2, GPipe at pp = 2 and the
    expert-parallel MoELayer at ep = 2, from weights of the port's own
    init; neither they nor their parent load jax or hetu_tpu."""
    out = _run(
        "import sys\n"
        "sys.path.insert(0, 'tests')\n"
        "import numpy as np, torch\n"
        "import torch_sharded_bodies as b\n"
        "from hetu_tpu_torch import interop\n"
        "from hetu_tpu_torch.models import ShardedGPT, ShardedGPTConfig\n"
        "from hetu_tpu_torch.parallel import (GPipe, ranks, ring_attention,\n"
        "                                     ulysses_attention)\n"
        "cfg = dict(vocab_size=32, hidden_size=16, num_layers=2,\n"
        "           num_heads=2, ffn_size=16, num_experts=2, top_k=1,\n"
        "           capacity_factor=2.0, max_position=8)\n"
        "m = ShardedGPT(ShardedGPTConfig(**cfg))\n"
        "full = m.init(torch.Generator().manual_seed(0))\n"
        "tree = interop._nested({k: v.numpy() for k, v in full.items()})\n"
        "ids = np.random.default_rng(0).integers(0, 32, (4, 8))\n"
        "g = np.random.default_rng(1)\n"
        "x = {k: g.standard_normal((1, 2, 8, 4)).astype(np.float32)\n"
        "     for k in 'qkvw'}\n"
        "lay = {'w': g.standard_normal((2, 4, 4)).astype(np.float32),\n"
        "       'b': np.zeros((2, 4), np.float32)}\n"
        "pipe = dict(layers=lay, h=np.ones((4, 4), np.float32),\n"
        "            w=np.ones((4, 4), np.float32), M=2, remat=True)\n"
        "e = g.standard_normal\n"
        "moe = dict(D=4, F=8, E=2, cf=2.0, x=e((2, 4)).astype(np.float32),\n"
        "           w=e((2, 4)).astype(np.float32), params={\n"
        "    'gate': {'gate_w': e((4, 2)).astype(np.float32)},\n"
        "    'experts': {'w1': e((2, 4, 8)).astype(np.float32),\n"
        "                'b1': np.zeros((2, 8), np.float32),\n"
        "                'w2': e((2, 8, 4)).astype(np.float32),\n"
        "                'b2': np.zeros((2, 4), np.float32)}})\n"
        "res = ranks.run(b.run_cases, 2, threads=1, args=({\n"
        "    'gpt': ('sharded_gpt', dict(cfg=cfg, params=tree,\n"
        "        mesh={'pp': 2}, ids=ids, labels=ids, lr=1e-3, steps=1)),\n"
        "    'seq': ('seq_attention', x),\n"
        "    'pipe': ('gpipe', {'cases': {'c': pipe}}),\n"
        "    'moe': ('moe_ep', moe)},))\n"
        "print('RANKS_JAX', [r['_jax_loaded'] for r in res])\n"
        "print('LOSS', all(np.isfinite(r['gpt']['losses']).all()\n"
        "                  for r in res))\n"
        "mods = sorted(m for m in sys.modules\n"
        "              if m.split('.')[0] in ('jax', 'jaxlib', 'hetu_tpu'))\n"
        "print('LEAKED', mods)\n")
    assert "LEAKED []" in out and "RANKS_JAX [False, False]" in out
    assert "LOSS True" in out
    names = {p.relative_to(PKG).as_posix() for p in SOURCES
             if PKG in p.parents}
    assert {"parallel/ring_attention.py", "parallel/ulysses.py",
            "parallel/pipeline.py", "models/gpt_sharded.py"} <= names


def test_dppipe_plane_and_its_rank_processes_run_without_jax():
    """Two gloo rank processes run the partial-reduce step, the
    distributed GCN, the elastic supervisor (a loss and a rejoin, a
    width-1 mesh between them), the 1F1B pipeline and HetPipe over a van
    table, from numpy inputs; neither they nor their parent load jax or
    hetu_tpu."""
    out = _run(
        "import sys, tempfile\n"
        "sys.path.insert(0, 'tests')\n"
        "import numpy as np\n"
        "import torch_dppipe_bodies as b\n"
        "from hetu_tpu_torch import parallel, resilience\n"
        "from hetu_tpu_torch.ops import distgcn\n"
        "from hetu_tpu_torch.parallel import ranks\n"
        "from hetu_tpu_torch.ps import van\n"
        "assert parallel.PipeDream1F1B and parallel.HetPipeWorker\n"
        "assert parallel.preduce_step_fn and parallel.make_weight_table\n"
        "assert resilience.ElasticSupervisor and resilience.ResizeEvent\n"
        "g = np.random.default_rng(0)\n"
        "f = lambda *s: g.standard_normal(s).astype(np.float32)\n"
        "x = f(8, 4)\n"
        "pre = dict(x=x, y=x.sum(-1), mask=np.asarray([1., 0.]),\n"
        "           const_batch=np.repeat(np.arange(2.,\n"
        "                                 dtype=np.float32), 4))\n"
        "gcn = dict(src=g.integers(0, 8, 20), dst=g.integers(0, 8, 20),\n"
        "           w=f(20), h=f(8, 2), cot=f(8, 2))\n"
        "X = f(48, 6)\n"
        "el = dict(X=X, Y=X[:, :3].copy(), steps=6, guard_rank=1,\n"
        "          init={'0': {'weight': f(6, 16), 'bias': f(16)},\n"
        "                '1': {}, '2': {'weight': f(16, 3), 'bias': f(3)}},\n"
        "          faults=dict(steps=6, seed=11, worker_losses=1,\n"
        "                      worker_joins=1, n_workers=2),\n"
        "          ckpt_dir=tempfile.mkdtemp())\n"
        "lay = {'w': f(2, 4, 4) * 0.3, 'b': f(2, 4) * 0.1}\n"
        "pipe = {'c': dict(kind='loss', layers=lay, M=4, h=f(8, 4),\n"
        "                  y=f(8, 4))}\n"
        "port = van.serve(0)\n"
        "het = {'c': dict(layers=lay, M=2, h=f(4, 4), y=f(4, 4), lr=0.05,\n"
        "                 sync_every=1, waves=2, table_id=0x5E7_1001)}\n"
        "res = ranks.run(b.run_cases, 2, threads=1, args=({\n"
        "    'pre': ('preduce', pre), 'gcn': ('distgcn', gcn),\n"
        "    'el': ('elastic', el), 'pipe': ('pipedream', {'cases': pipe}),\n"
        "    'het': ('hetpipe', {'port': port, 'cases': het})},))\n"
        "van.stop()\n"
        "print('RANKS_JAX', [r['_jax_loaded'] for r in res])\n"
        "print('RESIZES', [[k for k, *_ in r['el']['434']['resizes']]\n"
        "                  for r in res])\n"
        "print('FINITE', all(np.isfinite(r['pipe']['c']['loss'])\n"
        "                    and np.isfinite(r['het']['c']['losses']).all()\n"
        "                    for r in res))\n"
        "mods = sorted(m for m in sys.modules\n"
        "              if m.split('.')[0] in ('jax', 'jaxlib', 'hetu_tpu'))\n"
        "print('LEAKED', mods)\n")
    assert "LEAKED []" in out and "RANKS_JAX [False, False]" in out
    assert "RESIZES [['shrink', 'grow'], ['shrink', 'grow']]" in out
    assert "FINITE True" in out
    names = {p.relative_to(PKG).as_posix() for p in SOURCES
             if PKG in p.parents}
    assert {"parallel/preduce.py", "parallel/pipedream.py",
            "parallel/hetpipe.py", "ops/distgcn.py",
            "resilience/elastic.py"} <= names


def test_mpmd_plane_and_its_stage_processes_run_without_jax(tmp_path):
    """The MPMD pipeline plane: importing ``parallel.mpmd`` and
    ``parallel.mpmd_elastic`` loads neither jax nor torch; an in-process
    ``MPMDPipelineSupervisor`` runs three stage processes to their end
    with both still out of ``sys.modules``, and every stage says ``jax=0
    torch=0`` on its READY line; then two ``MPMDStageRunner`` stages (two
    threads over an in-process van, on the CPU) run a step with torch,
    and jax and hetu_tpu stay out."""
    out = _run(
        "import sys, threading\n"
        "import numpy as np\n"
        "import hetu_tpu_torch.parallel.mpmd as mpmd\n"
        "import hetu_tpu_torch.parallel.mpmd_elastic as me\n"
        "print('AT_IMPORT', 'jax' in sys.modules, 'torch' in sys.modules)\n"
        "sup = me.MPMDPipelineSupervisor(\n"
        f"    3, workdir={str(tmp_path)!r}, steps=3, lease_s=2.0,\n"
        "    suspect_grace_s=2.0)\n"
        "try:\n"
        "    rep = sup.run(deadline_s=60.0)\n"
        "finally:\n"
        "    sup.close()\n"
        "print('STAGES_DONE', sorted(rep['final_params']),\n"
        "      'torch' in sys.modules, 'jax' in sys.modules)\n"
        "import torch\n"
        "from hetu_tpu_torch.ps import van\n"
        "port = van.serve(0)\n"
        "out = {}\n"
        "def stage(s):\n"
        "    r = mpmd.MPMDStageRunner(\n"
        "        lambda w, x: torch.tanh(x @ w), stage=s, replica=0,\n"
        "        stage_dps=[1, 1], n_microbatches=2, in_shape=(2, 4),\n"
        "        out_shape=(2, 4), host='127.0.0.1', port=port,\n"
        "        grad_size=16, device='cpu')\n"
        "    x = np.ones((4, 4), np.float32)\n"
        "    out[s] = r.run_step(torch.eye(4) * 0.5,\n"
        "        data=[x[:2], x[2:]] if s == 0 else None,\n"
        "        loss_fn=(lambda y: y.square().mean()) if s else None)\n"
        "    r.close()\n"
        "ts = [threading.Thread(target=stage, args=(s,)) for s in (0, 1)]\n"
        "[t.start() for t in ts]; [t.join(60) for t in ts]\n"
        "van.stop()\n"
        "print('RUNNER', all(bool(torch.isfinite(out[s][1]).all())\n"
        "                    for s in (0, 1)))\n"
        "mods = sorted(m for m in sys.modules\n"
        "              if m.split('.')[0] in ('jax', 'jaxlib', 'hetu_tpu'))\n"
        "print('LEAKED', mods)\n")
    assert "AT_IMPORT False False" in out, out
    assert "STAGES_DONE [0, 1, 2] False False" in out, out
    assert "RUNNER True" in out and "LEAKED []" in out, out
    logs = sorted(tmp_path.glob("stage_*_*.log"))
    assert len(logs) == 3
    for stage, log in enumerate(logs):
        assert f"READY {stage} jax=0 torch=0" in log.read_text()
    names = {p.relative_to(PKG).as_posix() for p in SOURCES
             if PKG in p.parents}
    assert {"parallel/mpmd.py", "parallel/mpmd_elastic.py"} <= names


def test_maps_probe_sees_torch_in_a_process_that_imports_it():
    """The library probe the elastic test relies on: this test process
    has imported torch (the package's tests do), and the probe says so."""
    import torch  # noqa: F401
    assert _maps_load(os.getpid())["torch"] == 1


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str) and _forbidden(node.args[0].value):
            bad.append(node.args[0].value)
    assert not bad, f"{path.name} imports {bad}"


def test_scan_sees_the_whole_package():
    names = {p.relative_to(PKG).as_posix() for p in SOURCES if PKG in p.parents}
    assert {"__init__.py", "ops/cuda_kernels/flash_attention.py",
            "serve/engine.py", "models/gpt.py", "interop.py",
            "train/executor.py", "train/checkpoint.py",
            "optim/optimizer.py", "lr/__init__.py", "rng.py",
            "ops/cuda_kernels/embedding.py", "ops/moe_ops.py",
            "layers/moe.py", "models/moe_transformer.py",
            "models/llama.py", "models/bert.py", "ops/rope.py",
            "ps/van.py", "serve/server.py", "serve/migrate.py",
            "ops/reduce.py", "ps/embedding.py", "ps/client.py",
            "ops/conv.py", "models/resnet.py", "models/cnn_zoo.py",
            "models/mlp.py", "data/datasets.py", "data/dataloader.py",
            "layers/rnn.py", "ops/graph_ops.py", "models/gcn.py",
            "models/rnn_classifier.py", "data/graph_sampler.py",
            "ops/elementwise.py", "ops/shape.py",
            "resilience/memberproc.py",
            "resilience/multicontroller.py"} <= names
