"""LeNet-5 for MNIST, as in the JAX package's ``models/lenet.py``: two
tanh convs with average pooling and three dense layers (the CPU-smoke
model). The flatten runs in NHWC order so ``Dense_0`` reads the same
features as flax's."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from colearn_federated_learning_tpu_torch.models.layers import Conv, Dense


class LeNet5(nn.Module):
    def __init__(self, num_classes: int = 10, compute_dtype=torch.float32):
        super().__init__()
        cd = compute_dtype
        self.compute_dtype = cd
        self.Conv_0 = Conv(1, 6, 5, padding="SAME", bias=True, compute_dtype=cd)
        self.Conv_1 = Conv(6, 16, 5, padding="VALID", bias=True,
                           compute_dtype=cd)
        self.Dense_0 = Dense(16 * 5 * 5, 120, dtype=cd)
        self.Dense_1 = Dense(120, 84, dtype=cd)
        self.Dense_2 = Dense(84, num_classes, dtype=torch.float32)

    def forward(self, x):
        """x: NHWC images, already scaled to [0, 1]."""
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = F.avg_pool2d(torch.tanh(self.Conv_0(x)), 2)
        x = F.avg_pool2d(torch.tanh(self.Conv_1(x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = torch.tanh(self.Dense_0(x))
        x = torch.tanh(self.Dense_1(x))
        return self.Dense_2(x)
