"""ResNet-18 with GroupNorm and the CIFAR stem, as in the JAX package's
``models/resnet.py``.

GroupNorm in place of BatchNorm (no batch statistics crossing client
boundaries), a 3×3 stride-1 stem with no max-pool for 32×32 inputs, a
spatial-mean pool and an f32 ``Dense`` head. Submodules carry flax's
auto-names (``ResNetBlock_3.Conv_1``), so a parameter's name in the
port is its flax path (models/convert.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from colearn_federated_learning_tpu_torch.models.layers import (
    Conv,
    Dense,
    GroupNorm,
)


class ResNetBlock(nn.Module):
    def __init__(self, cin: int, filters: int, strides: int, compute_dtype):
        super().__init__()
        cd = compute_dtype
        groups = min(32, filters)
        self.Conv_0 = Conv(cin, filters, 3, strides, compute_dtype=cd)
        self.GroupNorm_0 = GroupNorm(filters, groups, compute_dtype=cd)
        self.Conv_1 = Conv(filters, filters, 3, 1, compute_dtype=cd)
        self.GroupNorm_1 = GroupNorm(filters, groups, compute_dtype=cd)
        # flax projects the residual when its shape differs from y's
        self.project = cin != filters or strides != 1
        if self.project:
            self.Conv_2 = Conv(cin, filters, 1, strides, compute_dtype=cd)
            self.GroupNorm_2 = GroupNorm(filters, groups, compute_dtype=cd)

    def forward(self, x):
        y = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = self.GroupNorm_1(self.Conv_1(y))
        residual = x
        if self.project:
            residual = self.GroupNorm_2(self.Conv_2(x))
        return F.relu(y + residual)


class ResNet18(nn.Module):
    def __init__(self, num_classes: int = 10, width: int = 64,
                 stage_sizes=(2, 2, 2, 2), compute_dtype=torch.float32):
        super().__init__()
        cd = compute_dtype
        self.compute_dtype = cd
        self.Conv_0 = Conv(3, width, 3, 1, compute_dtype=cd)
        self.GroupNorm_0 = GroupNorm(width, min(32, width), compute_dtype=cd)
        cin, b = width, 0
        for i, n_blocks in enumerate(stage_sizes):
            filters = width * (2**i)
            for j in range(n_blocks):
                strides = 2 if (i > 0 and j == 0) else 1
                self.add_module(f"ResNetBlock_{b}",
                                ResNetBlock(cin, filters, strides, cd))
                cin, b = filters, b + 1
        self.num_blocks = b
        self.Dense_0 = Dense(cin, num_classes, dtype=torch.float32)

    def forward(self, x):
        """x: NHWC images, already scaled to [0, 1]."""
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        for b in range(self.num_blocks):
            x = getattr(self, f"ResNetBlock_{b}")(x)
        return self.Dense_0(x.mean(dim=(2, 3)))
