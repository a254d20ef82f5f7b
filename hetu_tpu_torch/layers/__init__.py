"""Layers as ``nn.Module``s (counterpart of ``hetu_tpu/layers``)."""

from hetu_tpu_torch.layers.attention import MultiHeadAttention
from hetu_tpu_torch.layers.base import (
    Lambda, Module, Sequential, child_generator, state_buffers,
)
from hetu_tpu_torch.layers.linear import Conv2d, Embedding, Linear
from hetu_tpu_torch.layers.misc import (
    AvgPool2d, DropOut, Flatten, Gelu, MaxPool2d, Relu, Sigmoid, Tanh,
)
from hetu_tpu_torch.layers.moe import (
    BalanceAssignmentGate, Expert, HashGate, KTop1Gate, MoELayer, SAMGate,
    TopKGate,
)
from hetu_tpu_torch.layers.norm import BatchNorm, InstanceNorm2d, LayerNorm
from hetu_tpu_torch.layers.rnn import (
    RNN, GRUCell, LSTMCell, RNNCell, RNNCellBase,
)
from hetu_tpu_torch.layers.transformer import TransformerBlock

__all__ = ["Module", "Sequential", "Lambda", "child_generator",
           "state_buffers", "Linear", "Conv2d", "Embedding", "Relu", "Gelu",
           "Tanh", "Sigmoid", "DropOut", "Flatten", "MaxPool2d",
           "AvgPool2d", "LayerNorm", "BatchNorm", "InstanceNorm2d",
           "MultiHeadAttention", "TransformerBlock", "TopKGate",
           "HashGate", "KTop1Gate", "BalanceAssignmentGate", "SAMGate",
           "Expert", "MoELayer", "RNNCellBase", "RNNCell", "LSTMCell",
           "GRUCell", "RNN"]
