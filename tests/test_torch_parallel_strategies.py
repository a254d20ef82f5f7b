"""The port's strategies against hetu_tpu's, parameter by parameter.

For every parameter of GPT, Llama, BERT and ResNet-18, each strategy's
spec in the port (over the port's names and layouts) is the reference's
spec of the same parameter mapped through ``interop.reference_paths``: the
leading layer entry of a stacked block parameter dropped and a ``Linear``
weight's entries reversed (``[in, out]`` -> ``[out, in]``).  The JSON
files cross between the packages both ways, and ``make_mesh`` refuses a
mesh it cannot build truthfully.
"""

import jax
import numpy as np
import pytest
import torch

from hetu_tpu.models.bert import BertConfig as JBertConfig
from hetu_tpu.models.bert import BertModel as JBert
from hetu_tpu.models.gpt import GPTConfig as JGPTConfig
from hetu_tpu.models.gpt import GPTModel as JGPT
from hetu_tpu.models.llama import LlamaConfig as JLlamaConfig
from hetu_tpu.models.llama import LlamaModel as JLlama
from hetu_tpu.models.resnet import ResNet18 as JResNet18
from hetu_tpu.parallel import strategies as ref_strategies
from hetu_tpu_torch import interop
from hetu_tpu_torch.models import (
    BertConfig, BertModel, GPTConfig, GPTModel, LlamaConfig, LlamaModel,
    ResNet18,
)
from hetu_tpu_torch.parallel import strategies as port_strategies

SMALL = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
             ffn_size=64, max_position=32)
STRATEGIES = ("DataParallel", "MegatronLM", "ModelParallel4CNN",
              "ModelParallel4LM", "OneWeirdTrick4CNN")


def _models():
    llama = dict(SMALL, num_kv_heads=2)
    bert = dict(SMALL, dropout_rate=0.0)
    resnet = ResNet18(num_classes=10, device="cpu")
    return {
        "gpt": (JGPT(JGPTConfig(**SMALL)), GPTConfig(**SMALL),
                GPTModel(GPTConfig(**SMALL), device="cpu")),
        "llama": (JLlama(JLlamaConfig(**llama)), LlamaConfig(**llama),
                  LlamaModel(LlamaConfig(**llama), device="cpu")),
        "bert": (JBert(JBertConfig(**bert)), BertConfig(**bert),
                 BertModel(BertConfig(**bert), device="cpu")),
        "resnet18": (JResNet18(num_classes=10), resnet, resnet),
    }


MODELS = _models()


def _ref_leaves(jmodel):
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))["params"]
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    return {jax.tree_util.keystr(p): leaf for p, leaf in flat}


def _mapped(spec, ndim, flips, stacked):
    dims = list(spec) + [None] * (ndim + stacked - len(spec))
    dims = dims[1:] if stacked else dims
    dims = dims[::-1] if flips else dims
    while dims and dims[-1] is None:
        dims.pop()
    return tuple(dims)


def _norm(spec):
    dims = list(spec)
    while dims and dims[-1] is None:
        dims.pop()
    return tuple(dims)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("model", list(MODELS))
def test_every_parameter_takes_the_reference_spec(model, strategy):
    jmodel, config, port = MODELS[model]
    leaves = _ref_leaves(jmodel)
    params = dict(port.named_parameters())
    refs = interop.reference_paths(config, list(params))
    ref_s = getattr(ref_strategies, strategy)()
    port_s = getattr(port_strategies, strategy)()
    split = 0
    for name, p in params.items():
        key, flips, stacked = refs[name]
        want = _mapped(ref_s.param_spec(key, leaves[key]), p.ndim, flips,
                       stacked)
        got = _norm(port_s.param_spec(name, p))
        assert got == want, (name, key, got, want)
        split += any(d is not None for d in got)
    if strategy == "MegatronLM" and model != "resnet18":
        assert split > 0


def test_reference_reads_the_port_strategy_file(tmp_path):
    _, config, port = MODELS["gpt"]
    path = tmp_path / "port.json"
    params = dict(port.named_parameters())
    port_strategies.MegatronLM().save_json(params, path, config)
    loaded = ref_strategies.Strategy.load_json(path)
    ref = ref_strategies.MegatronLM()
    for key, leaf in _ref_leaves(MODELS["gpt"][0]).items():
        assert tuple(loaded.param_spec(key, leaf)) == \
            tuple(ref.param_spec(key, leaf)), key


def test_port_reads_the_reference_strategy_file(tmp_path):
    jmodel, config, port = MODELS["llama"]
    path = tmp_path / "ref.json"
    ref_strategies.MegatronLM().save_json(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))["params"], path)
    loaded = port_strategies.Strategy.load_json(path, config)
    want = port_strategies.MegatronLM()
    for name, p in port.named_parameters():
        assert _norm(loaded.param_spec(name, p)) == \
            _norm(want.param_spec(name, p)), name


def test_make_mesh_refuses_what_it_cannot_build(monkeypatch):
    from hetu_tpu_torch.parallel import MeshConfig, make_mesh
    assert MeshConfig(dp=2, tp=4).num_devices == 8
    with pytest.raises(ValueError, match="no process group"):
        make_mesh(tp=2, device="cpu")
    with pytest.raises(ValueError, match="nccl needs"):
        make_mesh(dp=1, device="cpu", backend="nccl")
    # two nccl ranks on one GPU: refused, naming the explicit choice
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="backend='gloo'"):
        make_mesh(tp=2)
