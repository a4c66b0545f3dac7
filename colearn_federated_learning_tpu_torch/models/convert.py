"""Weights bridge between the JAX package's flax params and the port.

Flax params (a nested dict of arrays, handed over as numpy) map to the
port's ``dict[str, Tensor]`` by flax path, never by order: the port's
modules carry flax's auto-names, so ``ResNetBlock_3/Conv_1/kernel``
becomes ``ResNetBlock_3.Conv_1.weight``. Layouts:

- ``Conv*/kernel`` HWIO → ``weight`` OIHW;
- ``Dense*/kernel`` ``[in, out]`` → ``weight`` ``[out, in]``;
- ``GroupNorm*/scale`` and ``LayerNorm*/scale`` → ``weight``; every
  ``bias`` stays ``bias``;
- ``Embed*/embedding`` stays ``embedding`` (``[vocab, features]`` in
  both), and the top-level leaf ``pos_embedding`` (BERT's positions,
  a param of no submodule) keeps its name.

Both directions are exact (transposes only), so a round trip is bitwise.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_CONV_TO_TORCH = (3, 2, 0, 1)  # HWIO → OIHW
_CONV_TO_FLAX = (2, 3, 1, 0)  # OIHW → HWIO


def _walk(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _walk(dict(value), prefix + (key,))
        else:
            yield prefix + (key,), value


def _kind(mods) -> str:
    """The flax layer kind of the innermost module (``""`` at the top)."""
    return mods[-1].rsplit("_", 1)[0] if mods else ""


_NORMS = ("GroupNorm", "LayerNorm")


def _same_name(kind: str, leaf: str) -> bool:
    """Leaves that keep their name and layout across the bridge."""
    return (leaf == "bias" and kind != ""
            or (kind, leaf) in (("Embed", "embedding"), ("", "pos_embedding")))


def flax_to_torch(params: Dict[str, Any],
                  model: Optional[torch.nn.Module] = None
                  ) -> Dict[str, torch.Tensor]:
    """Flax params (nested dict of numpy arrays) → port params. With
    ``model``, the result follows the model's parameter order and must
    hold exactly its names and shapes."""
    out = {}
    for path, value in _walk(params):
        *mods, leaf = path
        arr = np.asarray(value)
        kind = _kind(mods)
        if leaf == "kernel" and kind == "Conv":
            arr, leaf = arr.transpose(_CONV_TO_TORCH), "weight"
        elif leaf == "kernel" and kind == "Dense":
            arr, leaf = arr.T, "weight"
        elif leaf == "scale" and kind in _NORMS:
            leaf = "weight"
        elif not _same_name(kind, leaf):
            raise ValueError(f"unmapped flax param {'/'.join(path)}")
        out[".".join(mods + [leaf])] = torch.from_numpy(np.array(arr))
    if model is None:
        return out
    want = dict(model.named_parameters())
    if set(want) != set(out):
        raise ValueError(
            f"flax params do not match the model: missing "
            f"{sorted(set(want) - set(out))}, extra "
            f"{sorted(set(out) - set(want))}"
        )
    for name, p in want.items():
        if tuple(out[name].shape) != tuple(p.shape):
            raise ValueError(
                f"{name}: flax shape {tuple(out[name].shape)} != model "
                f"shape {tuple(p.shape)}"
            )
    return {name: out[name] for name in want}


def torch_to_flax(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Port params → flax params (nested dict of numpy arrays)."""
    out: Dict[str, Any] = {}
    for name, t in params.items():
        *mods, leaf = name.split(".")
        arr = t.detach().cpu().numpy()
        kind = _kind(mods)
        if leaf == "weight" and kind == "Conv":
            arr, leaf = arr.transpose(_CONV_TO_FLAX), "kernel"
        elif leaf == "weight" and kind == "Dense":
            arr, leaf = arr.T, "kernel"
        elif leaf == "weight" and kind in _NORMS:
            leaf = "scale"
        elif not _same_name(kind, leaf):
            raise ValueError(f"unmapped port param {name}")
        node = out
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return out
