"""Layers as ``nn.Module``s (counterpart of ``hetu_tpu/layers``)."""

from hetu_tpu_torch.layers.attention import MultiHeadAttention
from hetu_tpu_torch.layers.base import Module
from hetu_tpu_torch.layers.linear import Linear
from hetu_tpu_torch.layers.norm import LayerNorm
from hetu_tpu_torch.layers.transformer import TransformerBlock

__all__ = ["Module", "Linear", "LayerNorm", "MultiHeadAttention",
           "TransformerBlock"]
