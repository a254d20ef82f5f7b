"""Multi-stage compression training schedulers (counterpart of
``hetu_tpu/embedding_compress/scheduler.py``).

Training proceeds in stages (e.g. dense warmup -> prune schedule -> frozen
sparse finetune; or full-precision train -> quantized serving switch).
The carry the hooks map is the embedding module: a hook changes its state
buffers in place, or returns another module.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional


@dataclass
class Stage:
    name: str
    until_step: int                 # stage active while step < until_step
    on_enter: Optional[Callable] = None  # fn(carry) -> carry


class CompressionScheduler:
    """Drives stage transitions by step count (multistage.py analog).

    Example (DeepLight pruning):
        sched = CompressionScheduler([
            Stage("warmup", 1000),
            Stage("prune", 5000, on_enter=prune_rate_setter(0.9)),
            Stage("finetune", 10000),
        ])
        module = sched.maybe_transition(step, module)
    """

    def __init__(self, stages: List[Stage]):
        if not stages or any(a.until_step >= b.until_step
                             for a, b in zip(stages, stages[1:])):
            raise ValueError("stages must be given, their until_step "
                             "increasing")
        self.stages = stages
        self._current = 0

    @property
    def current(self) -> Stage:
        return self.stages[self._current]

    def stage_at(self, step: int) -> int:
        for i, s in enumerate(self.stages):
            if step < s.until_step:
                return i
        return len(self.stages) - 1

    def maybe_transition(self, step: int, carry):
        """Advance stages; run the on_enter hook of each newly entered
        stage on the carry."""
        target = self.stage_at(step)
        while self._current < target:
            self._current += 1
            hook = self.stages[self._current].on_enter
            if hook is not None:
                carry = hook(carry)
        return carry


def prune_rate_setter(rate: float):
    """on_enter hook: set a PrunedEmbedding's ``rate`` buffer in place."""
    def hook(module):
        module.rate.fill_(rate)
        return module

    return hook


def switch_to_quantized(embedding_module, bits: int = 8):
    """on_enter hook: the carried dense module's table ``w`` in int8
    serving form, a :class:`QuantizedEmbedding` (switchinference.py
    analog).  ``embedding_module`` is the reference's argument, unused
    there too: the hook reads the carry."""
    from hetu_tpu_torch.embedding_compress.layers import QuantizedEmbedding

    def hook(module):
        w = module.w.detach()
        return QuantizedEmbedding(w.shape[0], w.shape[1], bits=bits,
                                  table=w)

    return hook
