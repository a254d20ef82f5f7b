"""Parameter interop with the JAX reference (``hetu_tpu``).

:func:`params_from_jax` turns a ``hetu_tpu`` parameter tree — nested dicts
of arrays, as ``model.init(key)["params"]`` gives after ``np.asarray`` on
each leaf — into a ``state_dict`` for the port's model of the same config
(``GPTModel`` for a ``GPTConfig``, ``LlamaModel`` for a ``LlamaConfig``,
``BertModel`` for a ``BertConfig``, ``MoETransformer`` for an
``MoEConfig``); :func:`params_to_jax` is its inverse.  They handle:

* the layout of matmul weights: the reference stores ``[in, out]``, the
  port ``nn.Linear``'s ``[out, in]`` (Llama's fused QKV, output and SwiGLU
  weights, BERT's pooler, MLM dense and NSP weights alike; the MoE gate's
  ``gate_w [D, E]`` and the stacked experts keep the reference's layout);
* the blocks of GPT, Llama and BERT, stacked ``[L, ...]`` by ``vmap`` in
  the reference, one ``blocks.<i>.`` prefix per layer here; the MoE
  model's ``layer<l>`` subtrees, ``layers.<l>.`` here;
* the LM heads: GPT's and BERT's MLM head are tied to ``tok_emb`` in both
  packages, so no head key exists; Llama's untied ``lm_head [V, H]`` has
  its own key in both;
* the CTR models (``WideDeep``, ``WideDeepDevice``, ``DeepFM``,
  ``DeepCrossing``, ``DCN``), a bare ``MoELayer`` (with any of the five
  gates: ``{"gate": {...}, "experts": {w1, b1, w2, b2}}``, a hash gate's
  subtree empty), the CNN family, the RNN cells, ``RNN`` and
  ``RNNClassifier`` (``{"rnn": {w, b}, "head": {weight, bias}}``, as
  ``examples/rnn_mnist.py`` builds it) and ``GCN`` (``{w1, w2}``), which
  have no config: the port's model itself takes the config's place.
  Their ``state_dict`` names are the reference's tree paths joined by dots
  (``deep.0.weight`` is ``["deep"]["0"]["weight"]``), but for an ``RNN``,
  whose parameters the reference holds at its own level and the port in
  its ``cell`` (``rnn.cell.w`` is ``["rnn"]["w"]``); a ``Linear``'s weight
  is transposed, every other leaf (the embedding table, the residual
  units' ``w1``/``w2``, the cross net's ``w``, the cells' fused ``w``,
  GCN's ``w1``/``w2``) is copied as it is.  Parameterless children (the
  towers' ``Relu``s) are empty dicts in the reference's tree.

:func:`opt_state_from_jax` and :func:`opt_state_to_jax` do the same for an
optimizer state ``{"step", "slots": {"m": params-like, "v": ...}}``, whose
slots mirror the parameters.

:func:`state_from_jax` and :func:`state_to_jax` do it for the model state
(``variables["state"]``): a tree model's :func:`state_buffers` (the batch
norms' ``mean`` and ``var``) by the same dotted paths, every module a
subtree, empty where it holds no state, as in the reference.

:func:`variables_from_jax` and :func:`variables_to_jax` carry the
variables of a module whose reference tree is flat, as every method of
the embedding-compression zoo's is: ``{"params": {name: array}, "state":
{name: array}}`` against the module's parameters and its ``state_names``
buffers, under the same names and in the reference's layouts (DPQ's
``logits [N, m, C]``, the TT cores ``[r, i, j, r']``, the ELL
``values``/``cols``); the state keeps its dtype (int8 ``q``, int32
``remap`` and ``cols``).

:func:`sharded_params_from_jax` turns the reference ``ShardedGPT``'s tree
into one rank's shards of the port's ``ShardedGPT`` (a flat dict by tree
path, ``blocks.qkv_w``, the ``[L, ...]`` stacks kept);
:func:`sharded_params_to_jax` assembles every rank's shards back into the
tree.  :func:`stage_params_from_jax` takes one pipeline stage of the
reference's stacked ``[n_stages, L / n_stages, ...]`` tree (its
``GPipe``/``PipeDream1F1B.stack_params``) for the rank that runs it, and
:func:`stage_params_to_jax` stacks the stages back.

No ``jax`` import: leaves are read with ``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from hetu_tpu_torch.layers.base import Sequential, state_buffers
from hetu_tpu_torch.layers.linear import Linear
from hetu_tpu_torch.layers.moe import MoELayer
from hetu_tpu_torch.layers.rnn import RNN, RNNCellBase
from hetu_tpu_torch.models.bert import BertConfig
from hetu_tpu_torch.models.ctr_zoo import DCN, DeepCrossing, DeepFM
from hetu_tpu_torch.models.gcn import GCN
from hetu_tpu_torch.models.llama import LlamaConfig
from hetu_tpu_torch.models.moe_transformer import MoEConfig
from hetu_tpu_torch.models.resnet import BasicBlock, ResNet
from hetu_tpu_torch.models.rnn_classifier import RNNClassifier
from hetu_tpu_torch.models.wdl import WideDeep, WideDeepDevice

# (reference path under "blocks", port name under "blocks.<i>.", is a
# matmul weight whose layout flips)
_BLOCK_PARAMS = (
    (("attn", "qkv_weight"), "attn.qkv.weight", True),
    (("attn", "qkv_bias"), "attn.qkv.bias", False),
    (("attn", "out_weight"), "attn.out.weight", True),
    (("attn", "out_bias"), "attn.out.bias", False),
    (("ln1", "scale"), "ln1.scale", False),
    (("ln1", "bias"), "ln1.bias", False),
    (("ffn_in", "weight"), "ffn_in.weight", True),
    (("ffn_in", "bias"), "ffn_in.bias", False),
    (("ffn_out", "weight"), "ffn_out.weight", True),
    (("ffn_out", "bias"), "ffn_out.bias", False),
    (("ln2", "scale"), "ln2.scale", False),
    (("ln2", "bias"), "ln2.bias", False),
)
# (reference key, port name, flips) of the parameters outside the blocks
_TOP_PARAMS = (("tok_emb", "tok_emb", False), ("pos_emb", "pos_emb", False),
               ("ln_f_scale", "ln_f.scale", False),
               ("ln_f_bias", "ln_f.bias", False))
_LLAMA_BLOCK_PARAMS = (
    (("attn", "qkv_weight"), "attn.qkv_weight", True),
    (("attn", "out_weight"), "attn.out_weight", True),
    (("rms1_scale",), "rms1_scale", False),
    (("rms2_scale",), "rms2_scale", False),
    (("ffn_gate",), "ffn_gate", True),
    (("ffn_up",), "ffn_up", True),
    (("ffn_down",), "ffn_down", True),
)
_LLAMA_TOP_PARAMS = (("tok_emb", "tok_emb", False),
                     ("lm_head", "lm_head", False),
                     ("rms_f_scale", "rms_f_scale", False))
_BERT_TOP_PARAMS = (
    *_TOP_PARAMS[:2], ("seg_emb", "seg_emb", False),
    ("emb_ln_scale", "emb_ln.scale", False),
    ("emb_ln_bias", "emb_ln.bias", False),
    ("pooler_w", "pooler.weight", True), ("pooler_b", "pooler.bias", False),
    ("mlm_dense_w", "mlm_dense.weight", True),
    ("mlm_dense_b", "mlm_dense.bias", False),
    ("mlm_ln_scale", "mlm_ln.scale", False),
    ("mlm_ln_bias", "mlm_ln.bias", False),
    ("mlm_bias", "mlm_bias", False),
    ("nsp_w", "nsp.weight", True), ("nsp_b", "nsp.bias", False),
)
# the MoE model: (reference path under "layer<l>", port name under
# "layers.<l>.", flips)
_MOE_LAYER_PARAMS = (
    *(((mod, name), dst, flip) for (mod, name), dst, flip in _BLOCK_PARAMS
      if mod in ("attn", "ln1", "ln2")),
    (("moe", "gate", "gate_w"), "moe.gate.gate_w", False),
    *((("moe", "experts", n), f"moe.experts.{n}", False)
      for n in ("w1", "b1", "w2", "b2")),
)
_MOE_TOP_PARAMS = _TOP_PARAMS[:2]


def _layout(config):
    """(top-level, per-block) parameter tables of the stacked-block model
    of ``config``: GPT, Llama or BERT."""
    if isinstance(config, LlamaConfig):
        return _LLAMA_TOP_PARAMS, _LLAMA_BLOCK_PARAMS
    if isinstance(config, BertConfig):
        return _BERT_TOP_PARAMS, _BLOCK_PARAMS
    return _TOP_PARAMS, _BLOCK_PARAMS


def _tensor(w, flip):
    w = np.asarray(w, np.float32)
    return torch.tensor(w.T if flip else w)


def _moe_from_jax(p, config) -> dict:
    out = {dst: _tensor(p[src], flip) for src, dst, flip in _MOE_TOP_PARAMS}
    for layer in range(config.num_layers):
        for path, dst, flip in _MOE_LAYER_PARAMS:
            w = p[f"layer{layer}"]
            for key in path:
                w = w[key]
            out[f"layers.{layer}.{dst}"] = _tensor(w, flip)
    return out


def _moe_to_jax(arr, config) -> dict:
    p = {src: arr(dst) for src, dst, _ in _MOE_TOP_PARAMS}
    for layer in range(config.num_layers):
        for path, dst, flip in _MOE_LAYER_PARAMS:
            w = arr(f"layers.{layer}.{dst}")
            node = p.setdefault(f"layer{layer}", {})
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = w.T if flip else w
    return p


# models without a config whose parameter and state names are the
# reference's tree paths
_TREE_MODELS = (WideDeep, WideDeepDevice, DeepFM, DeepCrossing, DCN,
                MoELayer, ResNet, BasicBlock, Sequential, RNNCellBase, RNN,
                RNNClassifier, GCN)


def _tree_flips(model, name: str) -> bool:
    """Whether parameter ``name`` of a tree model is a ``Linear``'s weight
    (stored transposed in the reference)."""
    owner, _, leaf = name.rpartition(".")
    return leaf == "weight" and isinstance(model.get_submodule(owner), Linear)


def _param_names(model) -> list:
    return [name for name, _ in model.named_parameters()]


def _tree_path(model, name: str) -> list:
    """The reference's tree path of the port's dotted ``name``: an
    ``RNN``'s ``cell`` is no level of the reference's tree."""
    path, node = [], model
    for key in name.split(".") if name else ():
        skip = isinstance(node, RNN) and key == "cell"
        node = getattr(node, key)
        if not skip:
            path.append(key)
    return path


def _at(tree, path):
    """The node of a nested dict at ``path``, a list of keys."""
    for key in path:
        tree = tree[key]
    return tree


def _tree_from_jax(p, model, names) -> dict:
    return {name: _tensor(_at(p, _tree_path(model, name)),
                          _tree_flips(model, name))
            for name in names}


def _tree_to_jax(arr, model, names) -> dict:
    """The reference's tree of ``model``: a subtree for every module, the
    leaves ``names`` filled from ``arr``."""
    p: dict = {}
    for name, _ in model.named_modules():
        node = p
        for key in _tree_path(model, name):
            node = node.setdefault(key, {})
    for name in names:
        *path, leaf = _tree_path(model, name)
        w = arr(name)
        _at(p, path)[leaf] = w.T if _tree_flips(model, name) else w
    return p


def _keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys."""
    return "".join(f"[{k!r}]" for k in path)


def reference_paths(config, names) -> dict:
    """Port parameter name -> ``(keystr, flips, stacked)``: the
    reference's tree path of that parameter as ``jax.tree_util.keystr``
    prints it (``"['blocks']['attn']['qkv_weight']"``), whether its layout
    is the transpose of the port's, and whether the reference stacks it
    over the layers (a leading ``[L]`` dimension the port's per-layer
    tensor lacks).  ``config`` as for :func:`params_from_jax`."""
    if isinstance(config, _TREE_MODELS):
        return {n: (_keystr(_tree_path(config, n)), _tree_flips(config, n),
                    False) for n in names}
    out = {}
    if isinstance(config, MoEConfig):
        top, layered = _MOE_TOP_PARAMS, _MOE_LAYER_PARAMS
        for src, dst, flip in top:
            out[dst] = (_keystr((src,)), flip, False)
        for layer in range(config.num_layers):
            for path, dst, flip in layered:
                out[f"layers.{layer}.{dst}"] = (
                    _keystr((f"layer{layer}",) + path), flip, False)
    else:
        top, block = _layout(config)
        for src, dst, flip in top:
            out[dst] = (_keystr((src,)), flip, False)
        for layer in range(config.num_layers):
            for path, dst, flip in block:
                out[f"blocks.{layer}.{dst}"] = (
                    _keystr(("blocks",) + path), flip, True)
    missing = [n for n in names if n not in out]
    if missing:
        raise KeyError(f"no reference path for {missing[:3]}")
    return {n: out[n] for n in names}


def params_from_jax(tree, config) -> dict:
    """``hetu_tpu`` params (or ``{"params": ...}`` variables) → the
    parameters of a float32 CPU ``state_dict`` for the port's model of
    ``config`` (for a tree model: the port's model itself; a model with
    state takes its buffers from :func:`state_from_jax`)."""
    p = tree["params"] if "params" in tree else tree
    if isinstance(config, _TREE_MODELS):
        return _tree_from_jax(p, config, _param_names(config))
    if isinstance(config, MoEConfig):
        return _moe_from_jax(p, config)
    top, block = _layout(config)
    out = {dst: _tensor(p[src], flip) for src, dst, flip in top}
    for path, dst, flip in block:
        stacked = p["blocks"]
        for key in path:
            stacked = stacked[key]
        stacked = np.asarray(stacked, np.float32)
        if stacked.shape[0] != config.num_layers:
            raise ValueError(
                f"blocks/{'/'.join(path)} stacks {stacked.shape[0]} layers, "
                f"config has {config.num_layers}")
        for i in range(config.num_layers):
            out[f"blocks.{i}.{dst}"] = _tensor(stacked[i], flip)
    return out


def params_to_jax(state_dict, config) -> dict:
    """The parameters of a ``state_dict`` of the port's model of
    ``config`` (for a tree model: the model itself) → the ``hetu_tpu``
    parameter tree as float32 numpy arrays (blocks stacked ``[L,
    ...]``)."""
    def arr(name):
        return state_dict[name].detach().float().cpu().numpy()

    if isinstance(config, _TREE_MODELS):
        return _tree_to_jax(arr, config, _param_names(config))
    if isinstance(config, MoEConfig):
        return _moe_to_jax(arr, config)
    top, block = _layout(config)
    p = {src: arr(dst).T if flip else arr(dst) for src, dst, flip in top}
    blocks: dict = {}
    for path, dst, flip in block:
        layers = [arr(f"blocks.{i}.{dst}") for i in range(config.num_layers)]
        node = blocks
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack([w.T if flip else w for w in layers])
    p["blocks"] = blocks
    return p


def state_from_jax(tree, config) -> dict:
    """``hetu_tpu`` model state (or ``{"state": ...}`` variables) → float32
    CPU tensors by the names of :func:`state_buffers`.  Only the tree
    models hold state; for the others the (empty) state is copied."""
    s = tree["state"] if "state" in tree else tree
    if isinstance(config, _TREE_MODELS):
        return _tree_from_jax(s, config, state_buffers(config))
    return {k: _tensor(v, False) for k, v in s.items()}


def state_to_jax(model_state, config) -> dict:
    """The port's model state (name -> tensor) → the ``hetu_tpu`` state
    tree as float32 numpy arrays: a tree model's nested dicts, every
    module a subtree (empty without state)."""
    def arr(name):
        return model_state[name].detach().float().cpu().numpy()

    if isinstance(config, _TREE_MODELS):
        return _tree_to_jax(arr, config, model_state)
    return {k: arr(k) for k in model_state}


def opt_state_from_jax(tree, config) -> dict:
    """A ``hetu_tpu`` optimizer state → the port's ``{"step": int,
    "slots": {name: state_dict}}`` (float32 CPU tensors); ``{}`` stays
    ``{}``."""
    if not tree:
        return {}
    return {"step": int(np.asarray(tree["step"])),
            "slots": {name: params_from_jax(slot, config)
                      for name, slot in tree["slots"].items()}}


def opt_state_to_jax(opt_state, config) -> dict:
    """The port's optimizer state → the ``hetu_tpu`` tree (int32 step,
    float32 numpy slots stacked like the parameters); ``{}`` stays
    ``{}``."""
    if not opt_state:
        return {}
    return {"step": np.asarray(opt_state["step"], np.int32),
            "slots": {name: params_to_jax(slot, config)
                      for name, slot in opt_state["slots"].items()}}


def variables_from_jax(variables, module) -> dict:
    """A flat ``hetu_tpu`` variables dict (``{"params": ..., "state":
    ...}``, numpy leaves) → a CPU ``state_dict`` for ``module``: the
    parameters as float32, the state buffers in their own dtype."""
    out = {k: _tensor(v, False) for k, v in variables["params"].items()}
    out.update({k: torch.tensor(np.asarray(v))
                for k, v in variables.get("state", {}).items()})
    return out


def variables_to_jax(module) -> dict:
    """``module``'s parameters and ``state_names`` buffers → the flat
    ``hetu_tpu`` variables dict of numpy arrays (copies: a later in-place
    update of the module leaves them as they are)."""
    return {"params": {n: p.detach().float().cpu().numpy().copy()
                       for n, p in module.named_parameters()},
            "state": {n: getattr(module, n).detach().cpu().numpy().copy()
                      for n in getattr(module, "state_names", ())}}


def _flat_tree(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _nested(flat: dict) -> dict:
    out: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def sharded_params_from_jax(tree, model, device=None) -> dict:
    """The reference ``ShardedGPT.init`` tree (numpy leaves, blocks
    stacked ``[L, ...]``) → this rank's shards for ``model`` (a port
    ``ShardedGPT``) under its ``param_specs``, as :meth:`ShardedGPT.place`
    gives them; no layout flips."""
    return model.place({k: torch.tensor(np.asarray(v, dtype=np.float32))
                        for k, v in _flat_tree(tree).items()}, device)


def sharded_params_to_jax(pieces, specs: dict, sizes: dict) -> dict:
    """Every rank's shards assembled into the reference's tree (numpy).
    ``pieces``: ``[(coords, {name: array})]``, one entry a rank
    (``ShardedGPT.coords`` and that rank's shards, or any tensors laid out
    like them, such as gradients); ``specs``: ``ShardedGPT.param_specs()``;
    ``sizes``: ``ShardedGPT.sizes``."""
    flat = {}
    for name, spec in specs.items():
        split = {d: a for d, a in enumerate(spec) if a is not None}
        first = np.asarray(pieces[0][1][name])
        whole = np.zeros(tuple(n * sizes[split[d]] if d in split else n
                               for d, n in enumerate(first.shape)),
                         first.dtype)
        for coords, shards in pieces:
            part = np.asarray(shards[name])
            at = tuple(slice(coords[split[d]] * n, (coords[split[d]] + 1) * n)
                       if d in split else slice(None)
                       for d, n in enumerate(part.shape))
            whole[at] = part
        flat[name] = whole
    return _nested(flat)


def stage_params_from_jax(tree, stage: int, device=None) -> dict:
    """Stage ``stage`` of the reference's stacked pipeline tree (numpy
    leaves ``[n_stages, L / n_stages, ...]``, nested dicts kept) as float32
    tensors ``[1, L / n_stages, ...]`` on ``device``: the tree
    ``PipeDream1F1B.local_stage`` gives on that stage's rank."""
    if isinstance(tree, dict):
        return {k: stage_params_from_jax(v, stage, device)
                for k, v in tree.items()}
    a = np.asarray(tree, dtype=np.float32)
    return torch.tensor(a[stage:stage + 1], device=device)


def stage_params_to_jax(stages) -> dict:
    """Every stage's tree, in stage order (tensors or arrays, each leaf
    ``[1, L / n_stages, ...]``), stacked into the reference's ``[n_stages,
    L / n_stages, ...]`` tree of numpy arrays."""
    first = stages[0]
    if isinstance(first, dict):
        return {k: stage_params_to_jax([s[k] for s in stages])
                for k in first}
    return np.concatenate([
        s.detach().float().cpu().numpy() if isinstance(s, torch.Tensor)
        else np.asarray(s, np.float32) for s in stages])
