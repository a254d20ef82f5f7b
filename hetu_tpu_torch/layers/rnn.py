"""Recurrent layers (counterpart of ``hetu_tpu/layers/rnn.py``).

Each cell holds the reference's fused parameters: ``w [D+H, k·H]``, laid
out ``[in, out]`` as the reference stores it (no transpose), and ``b
[k·H]``, both in the cell's ``dtype`` (drawn Xavier uniform and zero).  A
step multiplies the concatenation ``[x, h]`` by ``w`` once for all ``k``
gates.  These are the reference's cells, not ``torch.nn.LSTM`` /
``GRU``: the LSTM adds 1.0 to the forget gate's pre-activation (gates
split i, f, g, o), and the GRU multiplies ``h`` by the reset gate before
the candidate's product, ``tanh([x, r*h] @ w_n + b_n)``.

:class:`RNN` scans a cell over ``[B, T, D]`` in a Python loop (the
reference's ``lax.scan``).  Its parameters are its cell's; the reference's
tree holds them at the RNN's own level (``{"w", "b"}``), which
:mod:`hetu_tpu_torch.interop` maps to ``cell.w`` and ``cell.b``.
"""

from __future__ import annotations

import torch
from torch import nn

from hetu_tpu_torch import init as initializers
from hetu_tpu_torch.layers.base import Module


class RNNCellBase(Module):
    n_gates = 1

    def __init__(self, input_size: int, hidden_size: int, *,
                 generator: torch.Generator, weight_init=None,
                 dtype=torch.float32):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.dtype = dtype
        k = self.n_gates * hidden_size
        w_init = weight_init or initializers.xavier_uniform()
        self.w = nn.Parameter(w_init(generator, (input_size + hidden_size, k),
                                     dtype))
        self.b = nn.Parameter(initializers.zeros()(generator, (k,), dtype))

    def _gates(self, x, h, cols=slice(None)):
        """``[x, h] @ w[:, cols] + b[cols]`` in the promoted type of the
        inputs and the parameters, as ``jnp`` promotes them."""
        z = torch.cat([x, h], dim=-1)
        dt = torch.promote_types(z.dtype, self.w.dtype)
        return z.to(dt) @ self.w[:, cols].to(dt) + self.b[cols].to(dt)

    def initial_carry(self, batch: int):
        """Zeros ``[batch, H]`` in the cell's ``dtype``."""
        return torch.zeros((batch, self.hidden_size), dtype=self.dtype,
                           device=self.w.device)


class RNNCell(RNNCellBase):
    """``h' = tanh([x, h] @ w + b)``."""

    def step(self, carry, x):
        h2 = torch.tanh(self._gates(x, carry))
        return h2, h2


class LSTMCell(RNNCellBase):
    n_gates = 4  # i, f, g, o

    def step(self, carry, x):
        h, c = carry
        i, f, g, o = self._gates(x, h).chunk(4, dim=-1)
        c2 = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h2 = torch.sigmoid(o) * torch.tanh(c2)
        return (h2, c2), h2

    def initial_carry(self, batch: int):
        z = super().initial_carry(batch)
        return (z, z)


class GRUCell(RNNCellBase):
    n_gates = 3  # r, z, n

    def step(self, carry, x):
        h = carry
        H = self.hidden_size
        r, z = torch.sigmoid(self._gates(x, h, slice(0, 2 * H))).chunk(
            2, dim=-1)
        n = torch.tanh(self._gates(x, r * h, slice(2 * H, None)))
        h2 = (1 - z) * n + z * h
        return h2, h2


_CELLS = {"rnn": RNNCell, "lstm": LSTMCell, "gru": GRUCell}


class RNN(Module):
    """Scan a cell over ``x [B, T, D]``: ``forward`` returns the outputs
    ``[B, T, H]``; :meth:`scan` also the final carry.  ``cell_type`` is
    ``'rnn'``, ``'lstm'`` or ``'gru'``; the other keywords go to the
    cell."""

    def __init__(self, input_size: int, hidden_size: int,
                 cell_type: str = "lstm", **kw):
        super().__init__()
        if cell_type not in _CELLS:
            raise ValueError(f"cell_type {cell_type!r}: one of "
                             f"{sorted(_CELLS)}")
        self.cell = _CELLS[cell_type](input_size, hidden_size, **kw)

    def scan(self, x):
        """``(outputs [B, T, H], final carry)``."""
        carry = self.cell.initial_carry(x.shape[0])
        ys = []
        for t in range(x.shape[1]):
            carry, y = self.cell.step(carry, x[:, t])
            ys.append(y)
        return torch.stack(ys, dim=1), carry

    def forward(self, x):
        return self.scan(x)[0]
