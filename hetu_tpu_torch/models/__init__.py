"""Models (counterpart of ``hetu_tpu/models``): the GPT decoder LM, the MoE
transformer LM, the Llama decoder LM, the BERT encoder and the CTR models
(Wide & Deep, DeepFM, Deep Crossing, DCN)."""

from hetu_tpu_torch.models.bert import (
    BertConfig, BertModel, bert_base, bert_large,
)
from hetu_tpu_torch.models.ctr_zoo import DCN, DeepCrossing, DeepFM
from hetu_tpu_torch.models.gpt import GPTConfig, GPTModel
from hetu_tpu_torch.models.llama import LlamaConfig, LlamaModel, llama2_7b
from hetu_tpu_torch.models.moe_transformer import MoEConfig, MoETransformer
from hetu_tpu_torch.models.wdl import WideDeep, WideDeepDevice

__all__ = ["GPTConfig", "GPTModel", "MoEConfig", "MoETransformer",
           "LlamaConfig", "LlamaModel", "llama2_7b", "BertConfig",
           "BertModel", "bert_base", "bert_large", "WideDeep",
           "WideDeepDevice", "DeepFM", "DeepCrossing", "DCN"]
