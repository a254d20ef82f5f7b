"""Models (counterpart of ``hetu_tpu/models``): the GPT decoder LM, the fully
sharded GPT-MoE training step (``ShardedGPT``), the MoE transformer LM, the Llama decoder LM, the BERT encoder, the CTR models
(Wide & Deep, DeepFM, Deep Crossing, DCN and its cross net), the CNN
family (ResNet, VGG, LeNet, MLP), GCN and the recurrent classifier."""

from hetu_tpu_torch.models.bert import (
    BertConfig, BertModel, bert_base, bert_large,
)
from hetu_tpu_torch.models.cnn_zoo import VGG, LeNet
from hetu_tpu_torch.models.ctr_zoo import DCN, CrossNet, DeepCrossing, DeepFM
from hetu_tpu_torch.models.gcn import GCN
from hetu_tpu_torch.models.gpt import GPTConfig, GPTModel, gpt2_small
from hetu_tpu_torch.models.gpt_sharded import ShardedGPT, ShardedGPTConfig
from hetu_tpu_torch.models.llama import LlamaConfig, LlamaModel, llama2_7b
from hetu_tpu_torch.models.mlp import MLP
from hetu_tpu_torch.models.moe_transformer import MoEConfig, MoETransformer
from hetu_tpu_torch.models.resnet import (
    BasicBlock, ResNet, ResNet18, ResNet34, classifier_loss_fn,
)
from hetu_tpu_torch.models.rnn_classifier import RNNClassifier
from hetu_tpu_torch.models.wdl import WideDeep, WideDeepDevice

__all__ = ["GPTConfig", "GPTModel", "gpt2_small", "ShardedGPT",
           "ShardedGPTConfig", "GCN", "RNNClassifier",
           "MoEConfig", "MoETransformer",
           "LlamaConfig", "LlamaModel", "llama2_7b", "BertConfig",
           "BertModel", "bert_base", "bert_large", "WideDeep",
           "WideDeepDevice", "DeepFM", "DeepCrossing", "DCN", "CrossNet",
           "BasicBlock", "ResNet", "ResNet18", "ResNet34",
           "classifier_loss_fn", "VGG", "LeNet", "MLP"]
