"""Checkpoints as ``torch.save`` files, one per saved round.

Persisted state: ``{params, server_opt_state, round, sampler}``.
``params`` is the server's flat f32 buffer (on the CPU) with the
layout's names and shapes beside it, so a restore checks that the
checkpoint belongs to the same model. The cohort sampler and the
round-input builder are pure in ``(seed, round)``, so the seed is all
the sampler state there is.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import torch

_NAME = re.compile(r"^round_(\d+)\.pt$")


class CheckpointStore:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(os.path.expanduser(directory))

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"round_{int(step):08d}.pt")

    def steps(self):
        if not os.path.isdir(self.directory):
            return []
        found = (_NAME.match(f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, payload: Dict[str, Any]) -> str:
        """Write atomically: a crash mid-save never leaves a torn file
        under the final name."""
        os.makedirs(self.directory, exist_ok=True)
        path = self._path(step)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        return path

    def restore(self) -> Dict[str, Any]:
        """The latest checkpoint, on the CPU."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)
