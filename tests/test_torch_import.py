"""hetu_tpu_torch stands alone: it imports neither ``jax`` nor ``hetu_tpu``.

Subprocesses import the package and, on the CPU, run the serving slice
(one prefill and one decode), GQA Llama through the paged engine and the
scheduler (prefix sharing included), a migration between a slot and a
paged engine (an int8 payload, then ``migrate_inflight``), the GPT and
MoE training slices (two
AdamW steps of the Executor and a checkpoint round trip each), GQA Llama
serving and a BERT pretraining step; ``jax`` and ``hetu_tpu`` must
stay out of ``sys.modules``.  An AST scan of every module of the package,
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
            "models/llama.py", "models/bert.py", "ops/rope.py"} <= names
