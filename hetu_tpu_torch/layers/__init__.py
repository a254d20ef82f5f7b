"""Layers as ``nn.Module``s (counterpart of ``hetu_tpu/layers``)."""

from hetu_tpu_torch.layers.attention import MultiHeadAttention
from hetu_tpu_torch.layers.base import Module, Sequential
from hetu_tpu_torch.layers.linear import Embedding, Linear
from hetu_tpu_torch.layers.misc import Relu
from hetu_tpu_torch.layers.moe import (
    BalanceAssignmentGate, Expert, HashGate, KTop1Gate, MoELayer, SAMGate,
    TopKGate,
)
from hetu_tpu_torch.layers.norm import LayerNorm
from hetu_tpu_torch.layers.transformer import TransformerBlock

__all__ = ["Module", "Sequential", "Linear", "Embedding", "Relu",
           "LayerNorm", "MultiHeadAttention", "TransformerBlock", "TopKGate",
           "HashGate", "KTop1Gate", "BalanceAssignmentGate", "SAMGate",
           "Expert", "MoELayer"]
