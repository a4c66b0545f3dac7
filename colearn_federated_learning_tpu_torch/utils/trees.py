"""Parameter containers as ``dict[str, Tensor]`` plus a flat layout.

The server keeps every parameter in ONE contiguous f32 buffer and hands
out per-parameter views into it (:class:`ParamLayout`): the server
apply kernel then runs over a single vector with no per-round flatten,
concat or unflatten, and local training casts the whole model to its
dtype with one op.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class ParamLayout:
    """Names, shapes and offsets of the parameters in a flat buffer."""

    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    offsets: Tuple[int, ...]
    numel: int

    @classmethod
    def from_params(cls, params: Params) -> "ParamLayout":
        names, shapes, offsets, off = [], [], [], 0
        for name, t in params.items():
            names.append(name)
            shapes.append(tuple(t.shape))
            offsets.append(off)
            off += t.numel()
        return cls(tuple(names), tuple(shapes), tuple(offsets), off)

    def spans(self) -> Tuple[Tuple[int, int], ...]:
        """``(start, end)`` of each parameter in the flat buffer."""
        ends = self.offsets[1:] + (self.numel,)
        return tuple(zip(self.offsets, ends))

    def views(self, flat: torch.Tensor) -> Params:
        """Per-parameter views into ``flat`` (writes go through)."""
        if flat.shape != (self.numel,):
            raise ValueError(
                f"flat buffer has shape {tuple(flat.shape)}, layout needs "
                f"({self.numel},)"
            )
        out = {}
        for name, shape, off in zip(self.names, self.shapes, self.offsets):
            n = 1
            for s in shape:
                n *= s
            out[name] = flat[off:off + n].view(shape)
        return out

    def flatten(self, params: Params, device=None) -> torch.Tensor:
        """One fresh contiguous f32 buffer holding ``params`` in layout
        order."""
        if list(params) != list(self.names):
            raise ValueError("params do not match the layout's names/order")
        flat = torch.empty(self.numel, dtype=torch.float32, device=device)
        for name, view in self.views(flat).items():
            view.copy_(params[name])
        return flat


def tree_weighted_mean(trees: Sequence[Params],
                       weights: Sequence[float]) -> Params:
    """Σᵢ wᵢ·treeᵢ / Σᵢ wᵢ over a list of parameter dicts (host-side
    reference math)."""
    total = sum(weights)
    acc = {k: torch.zeros_like(v) for k, v in trees[0].items()}
    for t, w in zip(trees, weights):
        acc = {k: w * t[k] + acc[k] for k in acc}
    return {k: v * (1.0 / total) for k, v in acc.items()}

