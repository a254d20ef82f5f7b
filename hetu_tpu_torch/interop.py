"""Parameter interop with the JAX reference (``hetu_tpu``).

:func:`params_from_jax` turns a ``hetu_tpu`` parameter tree — nested dicts
of arrays, as ``model.init(key)["params"]`` gives after ``np.asarray`` on
each leaf — into a ``state_dict`` for the port's model of the same config
(:class:`~hetu_tpu_torch.models.GPTModel` for a ``GPTConfig``,
:class:`~hetu_tpu_torch.models.MoETransformer` for an ``MoEConfig``);
:func:`params_to_jax` is its inverse.  They handle:

* the layout of ``Linear`` and MHA weights: the reference stores
  ``[in, out]``, the port ``nn.Linear``'s ``[out, in]`` (the MoE gate's
  ``gate_w [D, E]`` and the stacked experts keep the reference's layout);
* GPT's blocks, stacked ``[L, ...]`` by ``vmap`` in the reference, one
  ``blocks.<i>.`` prefix per layer here; the MoE model's ``layer<l>``
  subtrees, ``layers.<l>.`` here;
* the LM head, tied to ``tok_emb`` in both, so no head key exists.

:func:`opt_state_from_jax` and :func:`opt_state_to_jax` do the same for an
optimizer state ``{"step", "slots": {"m": params-like, "v": ...}}``, whose
slots mirror the parameters.

No ``jax`` import: leaves are read with ``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from hetu_tpu_torch.models.moe_transformer import MoEConfig

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
_TOP_PARAMS = (("tok_emb", "tok_emb"), ("pos_emb", "pos_emb"),
               ("ln_f_scale", "ln_f.scale"), ("ln_f_bias", "ln_f.bias"))
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


def _moe_from_jax(p, config) -> dict:
    out = {dst: torch.tensor(np.asarray(p[src], np.float32))
           for src, dst in _MOE_TOP_PARAMS}
    for layer in range(config.num_layers):
        for path, dst, flip in _MOE_LAYER_PARAMS:
            w = p[f"layer{layer}"]
            for key in path:
                w = w[key]
            w = np.asarray(w, np.float32)
            out[f"layers.{layer}.{dst}"] = torch.tensor(w.T if flip else w)
    return out


def _moe_to_jax(arr, config) -> dict:
    p = {src: arr(dst) for src, dst in _MOE_TOP_PARAMS}
    for layer in range(config.num_layers):
        for path, dst, flip in _MOE_LAYER_PARAMS:
            w = arr(f"layers.{layer}.{dst}")
            node = p.setdefault(f"layer{layer}", {})
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = w.T if flip else w
    return p


def params_from_jax(tree, config) -> dict:
    """``hetu_tpu`` params (or ``{"params": ...}`` variables) → a float32
    CPU ``state_dict`` for the port's model of ``config``."""
    p = tree["params"] if "params" in tree else tree
    if isinstance(config, MoEConfig):
        return _moe_from_jax(p, config)
    out = {}
    for src, dst in _TOP_PARAMS:
        out[dst] = torch.tensor(np.asarray(p[src], np.float32))
    blocks = p["blocks"]
    for (mod, name), dst, flip in _BLOCK_PARAMS:
        stacked = np.asarray(blocks[mod][name], np.float32)
        if stacked.shape[0] != config.num_layers:
            raise ValueError(
                f"blocks/{mod}/{name} stacks {stacked.shape[0]} layers, "
                f"config has {config.num_layers}")
        for i in range(config.num_layers):
            w = stacked[i].T if flip else stacked[i]
            out[f"blocks.{i}.{dst}"] = torch.tensor(w)
    return out


def params_to_jax(state_dict, config) -> dict:
    """A ``state_dict`` of the port's model of ``config`` → the ``hetu_tpu``
    parameter tree as float32 numpy arrays (GPT blocks stacked
    ``[L, ...]``)."""
    def arr(name):
        return state_dict[name].detach().float().cpu().numpy()

    if isinstance(config, MoEConfig):
        return _moe_to_jax(arr, config)
    p = {src: arr(dst) for src, dst in _TOP_PARAMS}
    blocks: dict = {}
    for (mod, name), dst, flip in _BLOCK_PARAMS:
        layers = [arr(f"blocks.{i}.{dst}") for i in range(config.num_layers)]
        blocks.setdefault(mod, {})[name] = np.stack(
            [w.T if flip else w for w in layers])
    p["blocks"] = blocks
    return p


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
