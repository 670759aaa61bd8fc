"""The flagship model's evaluation forward and its example arguments.

Counterpart of the repository's ``__graft_entry__.entry()``: ResNet-50 at
its full width (224x224x3, 1000 classes, ``models/zoo.py`` ``resnet50``)
with random weights from the zoo's seed, and one seeded batch of 8 NHWC
images. The reference's forward takes (params, state, x) so that it can be
jitted; here the network holds its parameters and running statistics, so
the forward takes the images alone and ``forward.net`` is the network.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import DeviceLike
from .models.zoo import resnet50


def entry(device: DeviceLike = "cuda"):
    """(forward, (x,)): ``forward(x)`` is the eval forward of ResNet-50,
    [8, 1000] softmax outputs for ``x`` [8, 224, 224, 3] float32 on
    ``device``."""
    net = resnet50(n_classes=1000, height=224, width=224, channels=3,
                   device=device).init()
    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=(8, 224, 224, 3)).astype(np.float32), device=net.device)

    @torch.inference_mode()
    def forward(x):
        return net.apply_fn([x], train=False)["fc"]

    forward.net = net
    return forward, (x,)
