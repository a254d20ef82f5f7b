"""Models (counterpart of ``hetu_tpu/models``): the GPT decoder LM."""

from hetu_tpu_torch.models.gpt import GPTConfig, GPTModel

__all__ = ["GPTConfig", "GPTModel"]
