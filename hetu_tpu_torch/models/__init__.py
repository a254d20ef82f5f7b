"""Models (counterpart of ``hetu_tpu/models``): the GPT decoder LM and the
MoE transformer LM."""

from hetu_tpu_torch.models.gpt import GPTConfig, GPTModel
from hetu_tpu_torch.models.moe_transformer import MoEConfig, MoETransformer

__all__ = ["GPTConfig", "GPTModel", "MoEConfig", "MoETransformer"]
