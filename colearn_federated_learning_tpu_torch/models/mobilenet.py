"""MobileNetV2 for FEMNIST, as in the JAX package's ``models/mobilenet.py``.

Inverted-residual bottlenecks (1×1 expansion, 3×3 depthwise, 1×1
projection) with ``GroupNorm(min(8, channels))`` after every conv and
ReLU6 after all but the projection. FEMNIST is 28×28 grayscale with 62
classes, so ``small_inputs`` keeps the stem at stride 1 and forces
stride 1 from block group 5 on. The head is a 1×1 conv to
``1280·max(1, width_mult)`` channels, a spatial mean and an f32
``Dense``; everything before the ``Dense`` computes in the compute
dtype, GroupNorm in f32.

Submodules carry flax's auto-names, numbered in call order within each
module: a block with ``expand = 1`` (block 0) has no expansion conv, so
its ``Conv_0`` is the depthwise conv and it holds two convs and two
norms; the others hold ``Conv_0`` (expansion), ``Conv_1`` (depthwise)
and ``Conv_2`` (projection) with ``GroupNorm_0..2``. A parameter's name
in the port is therefore its flax path (models/convert.py).
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

# (expand, filters, repeats, stride) of each block group
_BLOCKS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _gn(ch: int, compute_dtype) -> GroupNorm:
    return GroupNorm(ch, min(8, ch), compute_dtype=compute_dtype)


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int, expand: int,
                 compute_dtype):
        super().__init__()
        cd = compute_dtype
        hidden = cin * expand
        self.residual = stride == 1 and cin == filters
        # (conv, its norm, ReLU6 after it?) in flax's call order
        convs = []
        if expand != 1:
            convs.append((Conv(cin, hidden, 1, compute_dtype=cd), True))
        convs.append((Conv(hidden, hidden, 3, stride, compute_dtype=cd,
                           groups=hidden), True))
        convs.append((Conv(hidden, filters, 1, compute_dtype=cd), False))
        self.relu6 = []
        for i, (conv, relu6) in enumerate(convs):
            self.add_module(f"Conv_{i}", conv)
            self.add_module(f"GroupNorm_{i}",
                            _gn(conv.weight.shape[0], cd))
            self.relu6.append(relu6)

    def forward(self, x):
        y = x
        for i, relu6 in enumerate(self.relu6):
            y = getattr(self, f"GroupNorm_{i}")(getattr(self, f"Conv_{i}")(y))
            if relu6:
                y = F.relu6(y)
        return y + x if self.residual else y


class MobileNetV2(nn.Module):
    def __init__(self, num_classes: int = 62, width_mult: float = 1.0,
                 small_inputs: bool = True, compute_dtype=torch.float32):
        super().__init__()
        cd = compute_dtype
        self.compute_dtype = cd
        ch = _make_divisible(32 * width_mult)
        self.Conv_0 = Conv(1, ch, 3, 1 if small_inputs else 2,
                           compute_dtype=cd)
        self.GroupNorm_0 = _gn(ch, cd)
        b = 0
        for i, (t, c, n, s) in enumerate(_BLOCKS):
            filters = _make_divisible(c * width_mult)
            for j in range(n):
                # no downsampling past group 5 on 28×28 inputs
                stride = 1 if (j > 0 or (small_inputs and i >= 5)) else s
                self.add_module(f"InvertedResidual_{b}",
                                InvertedResidual(ch, filters, stride, t, cd))
                ch, b = filters, b + 1
        self.num_blocks = b
        head = _make_divisible(1280 * max(1.0, width_mult))
        self.Conv_1 = Conv(ch, head, 1, compute_dtype=cd)
        self.GroupNorm_1 = _gn(head, cd)
        self.Dense_0 = Dense(head, num_classes, dtype=torch.float32)

    def forward(self, x):
        """x: NHWC images, already scaled to [0, 1]."""
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = F.relu6(self.GroupNorm_0(self.Conv_0(x)))
        for b in range(self.num_blocks):
            x = getattr(self, f"InvertedResidual_{b}")(x)
        x = F.relu6(self.GroupNorm_1(self.Conv_1(x)))
        return self.Dense_0(x.mean(dim=(2, 3)))
