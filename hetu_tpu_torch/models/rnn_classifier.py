"""Recurrent classifier on row-sequence images (counterpart of
``examples/rnn_mnist.py``'s ``RNNClassifier``, the reference's
``examples/cnn/main.py --model rnn|lstm``): a cell scanned over the image's
rows, a linear head on the last step's output."""

from __future__ import annotations

from typing import Optional

import torch

from hetu_tpu_torch import ops
from hetu_tpu_torch.layers.base import Module, require_own_parameters
from hetu_tpu_torch.layers.linear import Linear
from hetu_tpu_torch.layers.rnn import RNN
from hetu_tpu_torch.models.ctr_common import default_generator


class RNNClassifier(Module):
    """``rnn`` (an :class:`~hetu_tpu_torch.layers.RNN` of ``cell``, input
    ``row`` pixels, ``hidden`` wide) and ``head`` (``Linear(hidden,
    classes)``), the reference's tree keys; built from ``generator``
    (default: a CPU generator seeded 0) on ``device``.  An image ``[B,
    rows · row]`` (or any shape with ``B`` first) is read as ``rows`` time
    steps."""

    def __init__(self, cell: str = "lstm", hidden: int = 128,
                 classes: int = 10, *, row: int = 28,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        g = default_generator(generator)
        self.rnn = RNN(row, hidden, cell_type=cell, generator=g)
        self.head = Linear(hidden, classes, generator=g)
        self.to(device)

    def forward(self, x):
        seq = x.reshape(x.shape[0], -1, self.rnn.cell.input_size)
        return self.head(self.rnn(seq)[:, -1])

    def loss_fn(self):
        """The Executor's loss over ``batch = (x, labels)``: the mean
        softmax cross entropy and the accuracy."""
        def fn(params, model_state, batch, generator, train):
            require_own_parameters(self, params)
            x, y = batch
            logits = self(x)
            loss = ops.softmax_cross_entropy_sparse(logits, y).mean()
            acc = (logits.argmax(-1) == y).float().mean()
            return loss, ({"acc": acc.detach()}, model_state)
        return fn
