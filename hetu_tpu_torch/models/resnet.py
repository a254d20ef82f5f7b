"""ResNet for CIFAR-scale inputs (counterpart of
``hetu_tpu/models/resnet.py``).

NCHW inputs; bias-free convolutions each followed by a BatchNorm, whose
running statistics are the model's state (:func:`state_buffers`).  With
``dtype=torch.bfloat16`` the convolutions and the head compute in bf16
(each convolution returns float32, so the batch norms, the residual sums
and the pooling stay float32), as in the reference.

Submodule names are the reference's tree keys: ``conv1``, ``bn1``,
``layer<stage>_<block>`` (each with ``conv1``, ``bn1``, ``conv2``, ``bn2``
and, where the shape changes, ``ds_conv`` and ``ds_bn``), then ``fc``.
"""

from __future__ import annotations

from typing import Optional

import torch

from hetu_tpu_torch import ops
from hetu_tpu_torch.layers.base import (
    Module, require_own_parameters, state_buffers,
)
from hetu_tpu_torch.layers.linear import Conv2d, Linear
from hetu_tpu_torch.layers.norm import BatchNorm
from hetu_tpu_torch.models.ctr_common import default_generator


class BasicBlock(Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1, *,
                 generator: torch.Generator, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, stride=stride, padding=1,
                            bias=False, generator=generator, dtype=dtype)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=1, padding=1,
                            bias=False, generator=generator, dtype=dtype)
        self.bn2 = BatchNorm(planes)
        self.ds_conv = self.ds_bn = None
        if stride != 1 or in_planes != planes * self.expansion:
            self.ds_conv = Conv2d(in_planes, planes * self.expansion, 1,
                                  stride=stride, bias=False,
                                  generator=generator, dtype=dtype)
            self.ds_bn = BatchNorm(planes * self.expansion)

    def forward(self, x, *, train: bool = False):
        out = ops.relu(self.bn1(self.conv1(x), train=train))
        out = self.bn2(self.conv2(out), train=train)
        sc = x if self.ds_conv is None \
            else self.ds_bn(self.ds_conv(x), train=train)
        return ops.relu(out + sc)


class ResNet(Module):
    """Built from ``generator`` (default: a CPU generator seeded 0) and
    moved to ``device``."""

    def __init__(self, block, num_blocks, num_classes: int = 10,
                 dtype=torch.float32, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        g = default_generator(generator)
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 3, stride=1, padding=1, bias=False,
                            generator=g, dtype=dtype)
        self.bn1 = BatchNorm(64)
        in_planes = 64
        self.blocks = []
        for si, (planes, n, stride) in enumerate(
                ((64, num_blocks[0], 1), (128, num_blocks[1], 2),
                 (256, num_blocks[2], 2), (512, num_blocks[3], 2))):
            for bi in range(n):
                b = block(in_planes, planes, stride if bi == 0 else 1,
                          generator=g, dtype=dtype)
                self.add_module(f"layer{si}_{bi}", b)
                self.blocks.append(b)
                in_planes = planes * block.expansion
        self.fc = Linear(512 * block.expansion, num_classes, generator=g,
                         dtype=dtype)
        self.to(device)

    def forward(self, x, *, train: bool = False,
                generator: Optional[torch.Generator] = None):
        h = ops.relu(self.bn1(self.conv1(x.to(self.dtype)), train=train))
        for b in self.blocks:
            h = b(h, train=train)
        h = h.mean(dim=(2, 3))  # global average pool
        return self.fc(h.float())

    def loss_fn(self):
        """The reference's classification loss for the Executor."""
        return classifier_loss_fn(self)


def classifier_loss_fn(model):
    """``fn(params, model_state, batch, generator, train) -> (loss,
    ({"acc"}, model_state))`` for a classifier called as ``model(x,
    train=, generator=)`` with ``batch = (x, labels)``: the mean softmax
    cross entropy in float32 and the accuracy, as the reference's
    ``ResNet.loss_fn`` computes them.  ``params`` and ``model_state`` are
    the model's own parameters and :func:`state_buffers`; a training call
    writes the new running statistics into the latter, which it
    returns."""
    def fn(params, model_state, batch, generator, train):
        require_own_parameters(model, params)
        require_own_parameters(state_buffers(model), model_state,
                               "state buffers")
        x, y = batch
        logits = model(x, train=train, generator=generator)
        loss = ops.softmax_cross_entropy_sparse(logits, y).mean()
        acc = (logits.argmax(-1) == y).float().mean()
        return loss, ({"acc": acc.detach()}, model_state)
    return fn


def ResNet18(num_classes: int = 10, dtype=torch.float32, **kw) -> ResNet:
    return ResNet(BasicBlock, [2, 2, 2, 2], num_classes, dtype, **kw)


def ResNet34(num_classes: int = 10, dtype=torch.float32, **kw) -> ResNet:
    return ResNet(BasicBlock, [3, 4, 6, 3], num_classes, dtype, **kw)
