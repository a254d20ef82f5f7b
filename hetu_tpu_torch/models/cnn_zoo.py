"""LeNet and VGG (counterpart of ``hetu_tpu/models/cnn_zoo.py``).

Each is a :class:`~hetu_tpu_torch.layers.Sequential` whose children are
numbered as the reference's tree keys them; train one with
:func:`~hetu_tpu_torch.models.resnet.classifier_loss_fn`.  Built from
``generator`` (default: a CPU generator seeded 0) and moved to
``device``.
"""

from __future__ import annotations

from typing import Optional

import torch

from hetu_tpu_torch import layers
from hetu_tpu_torch.models.ctr_common import default_generator


def LeNet(num_classes: int = 10, in_channels: int = 1, *,
          generator: Optional[torch.Generator] = None, device="cuda"):
    """LeNet-5 for 32x32 inputs (pad MNIST to 32)."""
    g = default_generator(generator)
    return layers.Sequential(
        layers.Conv2d(in_channels, 6, 5, padding=2, generator=g),
        layers.Relu(), layers.MaxPool2d(2, 2),
        layers.Conv2d(6, 16, 5, generator=g),
        layers.Relu(), layers.MaxPool2d(2, 2),
        layers.Flatten(),
        layers.Linear(16 * 6 * 6, 120, generator=g), layers.Relu(),
        layers.Linear(120, 84, generator=g), layers.Relu(),
        layers.Linear(84, num_classes, generator=g),
    ).to(device)


_VGG_CFGS = {
    11: (1, 1, 2, 2, 2),
    16: (2, 2, 3, 3, 3),
    19: (2, 2, 4, 4, 4),
}


def VGG(depth: int = 16, num_classes: int = 10, in_channels: int = 3, *,
        generator: Optional[torch.Generator] = None, device="cuda"):
    """VGG-11/16/19 with BatchNorm, for 32x32 inputs; ``DropOut(0.5)``
    before the head draws from the step's generator."""
    g = default_generator(generator)
    mods = []
    c_in = in_channels
    for n_convs, c_out in zip(_VGG_CFGS[depth], (64, 128, 256, 512, 512)):
        for _ in range(n_convs):
            mods += [layers.Conv2d(c_in, c_out, 3, padding=1, bias=False,
                                   generator=g),
                     layers.BatchNorm(c_out), layers.Relu()]
            c_in = c_out
        mods.append(layers.MaxPool2d(2, 2))
    mods += [layers.Flatten(),
             layers.Linear(512, 512, generator=g), layers.Relu(),
             layers.DropOut(0.5),
             layers.Linear(512, num_classes, generator=g)]
    return layers.Sequential(*mods).to(device)
