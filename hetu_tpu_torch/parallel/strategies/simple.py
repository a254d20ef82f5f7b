"""Manual strategies (counterpart of
``hetu_tpu/parallel/strategies/simple.py``): DataParallel, the CNN and LM
model-parallel presets and MegatronLM, over the port's parameter names
and layouts (a ``Linear`` weight ``[out, in]``: the reference's column
split of its ``[in, out]`` weight is dim 0 here, its row split dim 1).
``tests/test_torch_parallel_strategies.py`` holds every parameter of GPT,
Llama, BERT and ResNet-18 to the reference's spec mapped through
:func:`~hetu_tpu_torch.interop.reference_paths`.
"""

from __future__ import annotations

from hetu_tpu_torch.parallel.mesh import AXIS_TP
from hetu_tpu_torch.parallel.spec import P
from hetu_tpu_torch.parallel.strategies.base import Strategy


class DataParallel(Strategy):
    """All parameters replicated, the batch over dp."""

    def param_spec(self, path, leaf):
        return P()


class ModelParallel4CNN(Strategy):
    """CNN model parallelism: the fully connected layers column-split over
    tp (a ``Linear`` weight ``[out, in]`` on dim 0, its bias on dim 0),
    convolutions replicated."""

    FC_MARKERS = ("fc", "linear", "dense")
    # BERT's heads, whose reference names (mlm_dense_w, pooler_w, nsp_w
    # and their _b) say neither "weight" nor "bias": the rule leaves them
    # replicated there
    SHORT_NAMED = ("mlm_dense.", "pooler.", "nsp.")

    def param_spec(self, path, leaf):
        if path.startswith(self.SHORT_NAMED):
            return P()
        low = path.lower()
        if any(m in low for m in self.FC_MARKERS) and "weight" in low \
                and leaf.ndim == 2:
            return P(AXIS_TP, None)   # column split of [out, in]
        if any(m in low for m in self.FC_MARKERS) and "bias" in low:
            return P(AXIS_TP)
        return P()


class OneWeirdTrick4CNN(ModelParallel4CNN):
    """Krizhevsky's one weird trick: data parallel conv trunk, model
    parallel FC head — ModelParallel4CNN's specs, paired with a dp axis
    in the mesh."""


class ModelParallel4LM(ModelParallel4CNN):
    """The LM flavour of the CNN preset (upstream: ModelParallel4CNN with
    a flag); MegatronLM is the LM strategy to use."""


class MegatronLM(Strategy):
    """Megatron tensor parallelism for GPT, Llama and BERT.

    Column-parallel (output dim, dim 0 of ``[out, in]``): the fused QKV
    weight and bias, ``ffn_in`` and the SwiGLU gate/up pair.  Row-parallel
    (input dim, dim 1): the attention output, ``ffn_out`` and SwiGLU down;
    their biases replicated.  Vocab-parallel (dim 0): ``tok_emb`` and
    BERT's ``mlm_bias``."""

    COL = ("attn.qkv.weight", "attn.qkv.bias", "attn.qkv_weight",
           "ffn_in.weight", "ffn_in.bias", "ffn_gate", "ffn_up")
    ROW = ("attn.out.weight", "attn.out_weight", "ffn_out.weight",
           "ffn_down")
    VOCAB = ("tok_emb", "mlm_bias")

    def param_spec(self, path, leaf):
        if any(path.endswith(k) for k in self.VOCAB):
            return P(AXIS_TP, *(None,) * (leaf.ndim - 1))
        if any(path.endswith(k) for k in self.COL):
            return P(AXIS_TP, *(None,) * (leaf.ndim - 1))
        if any(path.endswith(k) for k in self.ROW) and leaf.ndim >= 2:
            return P(None, AXIS_TP)
        return P()
