"""Module base (counterpart of ``hetu_tpu/layers/base.py``).

The reference's modules are pure functions over parameter pytrees
(``init(key)`` / ``apply(variables, x, train=, rng=)``); the port's are
``nn.Module``s that own real parameters, built from an explicit
``torch.Generator`` and called as ``module(x, train=, generator=)``
(where a module needs either).  The reference's non-trainable ``state``
(BatchNorm's running statistics) is the modules' buffers named in their
``state_names``; :func:`state_buffers` collects them.

Parameters are float32 master weights; a layer's ``dtype`` is its COMPUTE
type, applied at each use as in the reference.  Serving does not want that
cast on every step, so :meth:`Module.cast_copy` makes a copy whose
parameters a layer would cast are stored, once, in its compute type.
"""

from __future__ import annotations

import copy
import inspect
from typing import Callable, Optional

import torch
from torch import nn

from hetu_tpu_torch.rng import derive_seed


def child_generator(generator: Optional[torch.Generator],
                    i: int) -> Optional[torch.Generator]:
    """The ``i``-th sub-layer's generator, a fresh one seeded from the
    parent's seed and ``i`` (the reference's ``child_rng``, a
    ``fold_in``).  It depends on the parent's seed, not on how much the
    parent has drawn, so a block recomputed under checkpointing draws the
    same masks again.  ``None`` stays ``None``."""
    if generator is None:
        return None
    return torch.Generator(device=generator.device).manual_seed(
        derive_seed(generator.initial_seed(), i))


def require_own_parameters(own, params: dict,
                           what: str = "parameters") -> None:
    """Raise unless ``params`` holds exactly the tensors of ``own`` (a
    model, whose ``named_parameters()`` are read at the call, or a dict
    such as its :func:`state_buffers`): a loss
    function written over a module reads the module's own tensors, so
    others passed in would be ignored (and a recomputed block would read
    the module's, not the passed ones).  Load other values with
    ``load_state_dict``."""
    if isinstance(own, nn.Module):
        own = dict(own.named_parameters())
    if params.keys() != own.keys() or any(
            params[n] is not p for n, p in own.items()):
        raise ValueError(f"the loss function runs on the model's own "
                         f"{what}; load others with load_state_dict")


def state_buffers(model: nn.Module) -> dict:
    """The model's state (the reference's ``variables["state"]``): name ->
    the model's own buffer, for each buffer a module names in its
    ``state_names``.  A train step writes them in place, as the optimizer
    writes the parameters."""
    return {f"{prefix}.{n}" if prefix else n: getattr(m, n)
            for prefix, m in model.named_modules()
            for n in getattr(m, "state_names", ())}


class Module(nn.Module):
    #: names of the parameters ``forward`` casts to ``self.dtype`` at use
    compute_params: tuple = ()
    #: names of the buffers that are model state (see :func:`state_buffers`)
    state_names: tuple = ()

    def cast_copy(self) -> "Module":
        """A copy without gradients whose (sub)layers' compute parameters
        are stored in their compute type; the other parameters are copied
        as they are.  Bitwise the same results as casting at every use.
        Each parameter is cast straight from this module's tensor, so the
        copy never holds a second float32 set of the weights, and every
        parameter gets storage of its own (also where the compute type is
        the parameter's), so a later update of this module leaves the copy
        as it was."""
        memo = {}
        for m in self.modules():
            cast = getattr(m, "compute_params", ())
            for name, p in m.named_parameters(recurse=False):
                data = p.detach()
                data = data.to(m.dtype, copy=True) if name in cast \
                    else data.clone()
                memo[id(p)] = nn.Parameter(data, requires_grad=False)
        return copy.deepcopy(self, memo)


def _keywords(module: nn.Module) -> tuple:
    """Which of ``train`` and ``generator`` ``module``'s forward takes."""
    params = inspect.signature(module.forward).parameters
    return tuple(k for k in ("train", "generator") if k in params)


class Sequential(Module):
    """A chain of modules, children named ``"0"``, ``"1"``, ... as the
    reference's parameter tree keys them.  Each child is called on the
    previous one's output, with ``train`` if its forward takes it and
    ``generator=child_generator(generator, i)`` if it takes a generator,
    as the reference passes ``train`` and ``child_rng(rng, i)``."""

    def __init__(self, *modules: nn.Module):
        super().__init__()
        if len(modules) == 1 and isinstance(modules[0], (list, tuple)):
            modules = tuple(modules[0])
        for i, m in enumerate(modules):
            self.add_module(str(i), m)
        self._keywords = [_keywords(m) for m in modules]

    def forward(self, x, *, train: bool = False,
                generator: Optional[torch.Generator] = None):
        for i, (m, keys) in enumerate(zip(self.children(), self._keywords)):
            kw = {}
            if "train" in keys:
                kw["train"] = train
            if "generator" in keys:
                kw["generator"] = child_generator(generator, i)
            x = m(x, **kw)
        return x


class Lambda(Module):
    """A stateless function as a module."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)
