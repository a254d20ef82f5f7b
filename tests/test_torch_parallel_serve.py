"""The port's tensor-parallel serving engines against hetu_tpu's on the
CPU (``tests/test_serve.py:122-140``, ``tests/test_paged_kv.py:100-108``).

The same parameters (the reference's ``init``, through ``interop``) serve
one greedy request in the reference's single-device engine and in the
port's engines on a tp mesh of ``gloo`` ranks: the tokens are equal.  At
tp = 2 over Llama's 2 kv heads (and GPT's 4) the KV cache and the page
pool hold each rank's own kv heads; at tp = 4 over 2 kv heads the cache is
replicated and the weight splits degrade per dimension
(``Strategy._fit``).
"""

import jax
import numpy as np
import pytest

import torch_parallel_bodies as bodies
from hetu_tpu.models.gpt import GPTConfig as JGPTConfig
from hetu_tpu.models.gpt import GPTModel as JGPT
from hetu_tpu.models.llama import LlamaConfig as JLlamaConfig
from hetu_tpu.models.llama import LlamaModel as JLlama
from hetu_tpu.serve import ServeEngine as JServeEngine
from hetu_tpu_torch import interop
from hetu_tpu_torch.models import GPTConfig, LlamaConfig
from hetu_tpu_torch.parallel import ranks

LLAMA = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, ffn_size=96, max_position=64)
GPT = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
           ffn_size=128, max_position=64, dropout_rate=0.0)
PROMPT = [3, 14, 15, 9, 2, 6]
N = 8


def _jax(model):
    if model == "llama":
        m = JLlama(JLlamaConfig(**LLAMA))
        return m, m.init(jax.random.PRNGKey(1)), LlamaConfig(**LLAMA)
    m = JGPT(JGPTConfig(**GPT))
    return m, m.init(jax.random.PRNGKey(0)), GPTConfig(**GPT)


def _want(model, prompt=PROMPT, n=N):
    m, variables, _ = _jax(model)
    eng = JServeEngine(m, variables, num_slots=2, max_len=32, min_bucket=8)
    slot = eng.alloc_slot()
    toks = [eng.prefill(slot, prompt)]
    while len(toks) < n:
        toks.append(eng.decode()[slot])
    return toks


def _case(model, tp, paged, prompt=PROMPT, n=N):
    _, variables, cfg = _jax(model)
    params = {k: v.numpy() for k, v in interop.params_from_jax(
        jax.tree_util.tree_map(np.asarray, variables), cfg).items()}
    engine = dict(paged=paged, num_slots=2, max_len=32)
    engine.update(dict(page_size=8) if paged else dict(min_bucket=8))
    return ("serve", dict(mesh={"tp": tp}, model=model,
                          cfg=LLAMA if model == "llama" else GPT,
                          params=params, engine=engine, prompt=prompt, n=n))


CASES = {
    2: {"llama_slot": _case("llama", 2, False),
        "llama_paged": _case("llama", 2, True),
        "gpt_slot": _case("gpt", 2, False),
        "gpt_paged": _case("gpt", 2, True)},
    4: {"llama_tp4_slot": _case("llama", 4, False, [7, 3, 1], 6),
        "llama_tp4_paged": _case("llama", 4, True, [7, 3, 1], 6)},
}


@pytest.fixture(scope="module")
def worlds():
    return {w: ranks.run(bodies.run_cases, w, args=(c,), threads=1,
                         timeout_s=300)
            for w, c in CASES.items()}


@pytest.mark.parametrize("world,cid", [(w, c) for w, cs in CASES.items()
                                       for c in cs])
def test_tp_engine_matches_the_reference_engine(world, cid, worlds):
    model = cid.split("_")[0]
    spec = CASES[world][cid][1]
    want = _want(model, spec["prompt"], spec["n"])
    nkv = (LLAMA["num_kv_heads"] if model == "llama"
           else GPT["num_heads"])
    for r in worlds[world]:
        assert r[cid]["tokens"] == want, cid
        # kv heads split over tp when they divide it, whole otherwise
        assert r[cid]["cache_heads"] == (nkv // world if nkv % world == 0
                                         else nkv)
    assert not any(r["_jax_loaded"] for r in worlds[world])
