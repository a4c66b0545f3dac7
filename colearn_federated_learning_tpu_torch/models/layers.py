"""Layers with flax.linen's semantics, in PyTorch.

Each layer takes its parameters in PyTorch's layout and reproduces the
flax layer the JAX package uses:

- :class:`Conv`: ``padding="SAME"`` follows ``lax.padtype_to_pads``,
  which pads a stride-2 3×3 conv on an even input by (0, 1), not (1, 1);
  uneven pads go through ``F.pad`` before the conv. Inputs and weights
  are cast to the layer's compute dtype, as flax's ``dtype=`` does.
  ``groups`` is flax's ``feature_group_count`` (``groups = cin`` is a
  depthwise conv, weight ``[cout, 1, k, k]``).
- :class:`GroupNorm`: ε = 1e-6 (torch's default is 1e-5), statistics
  and the affine transform in f32 whatever the compute dtype, the
  result cast back to it.
- :class:`Dense`: ``Linear`` computing in its own dtype (the heads
  compute in f32 even when the local params are bf16).
- :class:`LayerNorm`: ε = 1e-6; statistics in f32 by flax's fast
  variance, E[x²] − E[x]² clipped at 0; the affine transform in f32;
  the result cast to the compute dtype.
- :class:`Embed`: a table lookup in the table's dtype, and ``attend``,
  the tied head: query and table promoted to a common dtype, then
  ``query @ tableᵀ``.

Modules are built on the ``meta`` device: their parameters only name
the shapes. Real tensors are passed in with
``torch.func.functional_call`` (see client/trainer.py), so one module
serves the server's f32 params and every client's local copy.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of one spatial dim under ``padding="SAME"``:
    the output has ``ceil(size / stride)`` positions and any odd pad
    goes on the high side (``lax.padtype_to_pads``)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: str = "SAME", bias: bool = False,
                 compute_dtype=torch.float32, groups: int = 1):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.compute_dtype, self.groups = compute_dtype, groups
        self.weight = nn.Parameter(
            torch.empty(cout, cin // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        cd = self.compute_dtype
        pad = 0
        if self.padding == "SAME":
            ph = same_pads(x.shape[2], self.kernel, self.stride)
            pw = same_pads(x.shape[3], self.kernel, self.stride)
            if ph[0] == ph[1] == pw[0] == pw[1]:
                pad = ph[0]
            else:
                x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        bias = None if self.bias is None else self.bias.to(cd)
        return F.conv2d(x.to(cd), self.weight.to(cd), bias, self.stride, pad,
                        groups=self.groups)


class GroupNorm(nn.Module):
    def __init__(self, channels: int, num_groups: int, eps: float = 1e-6,
                 compute_dtype=torch.float32):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x):
        y = F.group_norm(x.float(), self.num_groups, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


class Dense(nn.Module):
    def __init__(self, fin: int, fout: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(fout, fin))
        self.bias = nn.Parameter(torch.empty(fout))

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-6,
                 compute_dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(-1, keepdim=True) - mu * mu, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mu) * mul + self.bias.float()
        return y.to(self.compute_dtype)


class Embed(nn.Module):
    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))

    def forward(self, tokens):
        return F.embedding(tokens, self.embedding)

    def attend(self, query):
        dt = torch.promote_types(query.dtype, self.embedding.dtype)
        return torch.matmul(query.to(dt), self.embedding.to(dt).T)


# flax's lecun_normal: truncated normal at ±2σ, σ rescaled so the
# truncated distribution has variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def init_params(model: nn.Module, seed: int) -> dict:
    """Fresh f32 CPU parameters for ``model`` with flax's initializers
    (lecun_normal kernels, zero biases, unit norm scales, normal(0.02)
    embeddings and positions, as models/bert.py sets them), drawn from
    a ``torch.Generator`` seeded with ``seed``.
    The draws are the port's own: the JAX package's threefry stream
    cannot be reproduced, so parity tests start both packages from the
    same arrays instead (models/convert.py)."""
    gen = torch.Generator().manual_seed(int(seed))
    params = {}
    for mod_name, mod in model.named_modules():
        for leaf, p in mod._parameters.items():
            if p is None:
                continue
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            t = torch.empty(p.shape, dtype=torch.float32)
            if leaf == "weight" and isinstance(mod, (Conv, Dense)):
                fan_in = math.prod(p.shape[1:])
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
            elif leaf == "weight" and isinstance(mod, (GroupNorm, LayerNorm)):
                t.fill_(1.0)
            elif leaf in ("embedding", "pos_embedding"):
                t.normal_(0.0, 0.02, generator=gen)
            else:
                t.zero_()
            params[name] = t
    order = [n for n, _ in model.named_parameters()]
    return {n: params[n] for n in order}
