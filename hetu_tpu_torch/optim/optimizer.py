"""Optimizers, the dense path (counterpart of
``hetu_tpu/optim/optimizer.py``).

The reference's functional ``init_state / update`` over parameter pytrees,
over a dict of named tensors here: ``state = {"step": int, "slots":
{slot_name: {param_name: tensor}}}``.  :meth:`Optimizer.update` writes the
new parameters and slots into the existing tensors, in place (the
reference returns new arrays and donates the old ones), leaf by leaf with
the reference's formulas in its order of float32 operations.

Step-dependent scalars (the learning rate of a schedule, Adam's bias
corrections) are computed in float32, as the reference traces them, and
enter the elementwise kernels as Python floats holding those float32
values.  The sparse ``apply_indexed`` path waits for the embedding slice.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

Schedule = Union[float, Callable[[int], float]]


def _lr_at(lr: Schedule, step: int) -> float:
    return float(lr(step)) if callable(lr) else lr


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


class Optimizer:
    """Base optimizer: a stateless object over an explicit state dict."""

    slot_names: tuple = ()

    def __init__(self, learning_rate: Schedule = 0.01, l2reg: float = 0.0):
        self.learning_rate = learning_rate
        self.l2reg = l2reg

    def init_state(self, params: dict) -> dict:
        slots = {name: {k: torch.zeros_like(p.detach())
                        for k, p in params.items()}
                 for name in self.slot_names}
        return {"step": 0, "slots": slots}

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict):
        """Apply one step in place; return ``(params, new_state)``."""
        step = state["step"] + 1
        lr = _lr_at(self.learning_rate, step)
        slots = state["slots"]
        for name, p in params.items():
            g = grads[name]
            s_in = tuple(slots[n][name] for n in self.slot_names)
            if self.l2reg > 0.0:
                g = g + self.l2reg * p
            p_new, s_out = self.apply_dense(p, g, s_in, lr, step)
            p.copy_(p_new)
            for s, s_new in zip(s_in, s_out):
                s.copy_(s_new)
        return params, {"step": step, "slots": slots}

    def apply_dense(self, p, g, slots, lr, step):
        """One leaf: ``(new_p, new_slots)``."""
        raise NotImplementedError


class SGDOptimizer(Optimizer):
    def apply_dense(self, p, g, slots, lr, step):
        return p - lr * g.to(p.dtype), ()


class MomentumOptimizer(Optimizer):
    """Heavy-ball momentum."""

    slot_names = ("velocity",)

    def __init__(self, learning_rate=0.01, momentum: float = 0.9,
                 l2reg: float = 0.0):
        super().__init__(learning_rate, l2reg)
        self.momentum = momentum

    def apply_dense(self, p, g, slots, lr, step):
        (v,) = slots
        v = self.momentum * v - lr * g
        return p + v, (v,)


class NesterovOptimizer(MomentumOptimizer):
    def apply_dense(self, p, g, slots, lr, step):
        (v,) = slots
        v_new = self.momentum * v - lr * g
        return p + self.momentum * v_new - lr * g, (v_new,)


class AdaGradOptimizer(Optimizer):
    slot_names = ("accum",)

    def __init__(self, learning_rate=0.01, initial_accumulator_value=0.0,
                 eps: float = 1e-7, l2reg: float = 0.0):
        super().__init__(learning_rate, l2reg)
        self.initial_accumulator_value = initial_accumulator_value
        self.eps = eps

    def init_state(self, params):
        st = super().init_state(params)
        for a in st["slots"]["accum"].values():
            a.add_(self.initial_accumulator_value)
        return st

    def apply_dense(self, p, g, slots, lr, step):
        (acc,) = slots
        acc = acc + g * g
        return p - lr * g / (torch.sqrt(acc) + self.eps), (acc,)


class AdamOptimizer(Optimizer):
    slot_names = ("m", "v")

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-7, l2reg: float = 0.0):
        super().__init__(learning_rate, l2reg)
        self.beta1, self.beta2, self.eps = beta1, beta2, eps

    def init_state(self, params):
        # float32 slots from step 0, whatever the parameters' type: the
        # update accumulates in float32
        st = super().init_state(params)
        st["slots"] = {n: {k: a.float() for k, a in s.items()}
                       for n, s in st["slots"].items()}
        return st

    def _moments(self, g, m, v, step):
        """The float32 moments and their bias-corrected values."""
        g = g.float()
        m = self.beta1 * m + (1 - self.beta1) * g
        v = self.beta2 * v + (1 - self.beta2) * g * g
        t = _f32(step)
        bc1 = float(1 - _f32(self.beta1) ** t)
        bc2 = float(1 - _f32(self.beta2) ** t)
        return m, v, m / bc1, v / bc2

    def apply_dense(self, p, g, slots, lr, step):
        m, v = slots
        m, v, mhat, vhat = self._moments(g, m, v, step)
        return (p - lr * mhat / (torch.sqrt(vhat) + self.eps)).to(p.dtype), \
            (m, v)


class AMSGradOptimizer(AdamOptimizer):
    slot_names = ("m", "v", "vmax")

    def apply_dense(self, p, g, slots, lr, step):
        m, v, vmax = slots
        m, v, mhat, _ = self._moments(g, m, v, step)
        vmax = torch.maximum(vmax, v)
        vhat = vmax / float(1 - _f32(self.beta2) ** _f32(step))
        return (p - lr * mhat / (torch.sqrt(vhat) + self.eps)).to(p.dtype), \
            (m, v, vmax)


class AdamWOptimizer(AdamOptimizer):
    """Decoupled weight decay: ``weight_decay * p`` joins the update inside
    the learning rate, and ``eps`` sits outside ``sqrt(vhat)`` — not
    ``torch.optim.AdamW``'s defaults."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 eps=1e-7, weight_decay: float = 0.01):
        super().__init__(learning_rate, beta1, beta2, eps, l2reg=0.0)
        self.weight_decay = weight_decay

    def apply_dense(self, p, g, slots, lr, step):
        m, v = slots
        m, v, mhat, vhat = self._moments(g, m, v, step)
        upd = mhat / (torch.sqrt(vhat) + self.eps) + self.weight_decay * p
        return (p - lr * upd).to(p.dtype), (m, v)


class LambOptimizer(AdamOptimizer):
    """Layerwise trust-ratio scaling of the AdamW update."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 eps=1e-6, weight_decay: float = 0.01):
        super().__init__(learning_rate, beta1, beta2, eps, l2reg=0.0)
        self.weight_decay = weight_decay

    def apply_dense(self, p, g, slots, lr, step):
        m, v = slots
        m, v, mhat, vhat = self._moments(g, m, v, step)
        upd = mhat / (torch.sqrt(vhat) + self.eps) + self.weight_decay * p
        w_norm = torch.linalg.vector_norm(p.float())
        u_norm = torch.linalg.vector_norm(upd)
        trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm, 1.0)
        return (p - lr * trust * upd).to(p.dtype), (m, v)
