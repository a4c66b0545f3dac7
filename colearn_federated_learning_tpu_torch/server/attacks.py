"""Byzantine adversary simulation: the attack half of the robustness
path (the defenses live in server/aggregation.py).

``select_compromised`` draws the run's compromised client ids once,
purely from ``(seed, num_clients, fraction)``; each round
``Experiment`` marks the cohort slots those clients hold (a ``[K]`` 0/1
mask) and the round engine transforms their uploads on the cohort's
``[K, N]`` f32 delta stack before aggregation:

- ``sign_flip`` — ``Δ ← −scale·Δ`` (Blanchard et al. 2017);
- ``scale``     — ``Δ ← scale·Δ`` (model-replacement boosting);
- ``alie``      — every compromised row becomes ``μ − eps·σ`` of the
  honest participants' per-coordinate mean and std (Baruch et al. 2019).

``label_flip`` poisons the compromised clients' training labels
``y → (C−1) − y`` on the host before the corpus is placed; the engine
is not involved. The JAX package's ``gauss`` attack draws its noise
from ``jax.random``, which torch cannot reproduce, and is not ported.

``select_compromised`` and ``flip_labels`` are verbatim copies of the
JAX package's NumPy code; ``apply_upload_attack`` keeps its f32 factor
arithmetic, so sign_flip and scale agree with it bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# attacks applied to the upload (engine-side); label_flip is host-side
UPLOAD_ATTACKS = ("sign_flip", "scale", "alie")


def select_compromised(num_clients: int, fraction: float, seed: int) -> np.ndarray:
    """The run's compromised client ids: a deterministic pure function
    of ``(seed, num_clients, fraction)`` — the same federation attacked
    twice is attacked identically, and the sharded/sequential engines
    (and any resumed run) agree on who the adversary owns.

    ``round(fraction · N)`` clients, floored at 1 (an attack config
    with zero attackers would silently be a benign run), drawn without
    replacement and sorted for stable logging."""
    n_byz = max(1, int(round(fraction * num_clients)))
    n_byz = min(n_byz, num_clients)
    rng = np.random.default_rng((seed, 0xB12A))
    ids = rng.choice(num_clients, size=n_byz, replace=False)
    return np.sort(ids).astype(np.int64)


def flip_labels(train_y: np.ndarray, client_indices, compromised: np.ndarray,
                num_classes: int) -> np.ndarray:
    """Label-flip data poisoning: ``y → (C−1) − y`` on the compromised
    clients' shards only. Client shards are disjoint example-id sets,
    so flipping their rows in a COPY of the corpus poisons exactly the
    attackers' local datasets — honest clients (and the test set) are
    untouched."""
    out = np.array(train_y, copy=True)
    for cid in compromised:
        rows = client_indices[int(cid)]
        out[rows] = (num_classes - 1) - out[rows]
    return out


def apply_upload_attack(stack: torch.Tensor, byz: torch.Tensor, kind: str,
                        scale: float, eps: float,
                        participation: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Transform the compromised rows of the ``[K, N]`` f32 delta stack in
    place and return it. ``byz``: ``[K]`` 0/1 mask of compromised cohort
    slots; ``participation``: ``[K]`` (``n_ex > 0``), which ``alie``
    reads to estimate the honest statistics. Everything stays on the
    stack's device (no host sync)."""
    if kind not in UPLOAD_ATTACKS:
        raise ValueError(f"unknown upload attack {kind!r}")
    b = (byz > 0).to(torch.float32)
    if kind == "sign_flip":
        # Δ·(1 − b·(1 + scale)): Δ honest, −scale·Δ compromised; the
        # factor is rounded in f32 as the JAX package's is
        return stack.mul_((1.0 - b * (1.0 + scale))[:, None])
    if kind == "scale":
        return stack.mul_((1.0 + b * (scale - 1.0))[:, None])
    # alie: the colluders all send the identical message μ − eps·σ
    part = (torch.ones_like(b) if participation is None
            else (participation > 0).to(torch.float32))
    h = (part * (1.0 - b))[:, None]  # honest participants
    n_h = torch.clamp_min(h.sum(), 1.0)
    mu = (h * stack).sum(0) / n_h
    sigma = torch.sqrt((h * (stack - mu[None]) ** 2).sum(0) / n_h)
    poisoned = mu - eps * sigma
    for r in range(stack.shape[0]):
        stack[r].copy_(torch.where(b[r] > 0, poisoned, stack[r]))
    return stack


def stack_weighted_mean(stack: torch.Tensor,
                        n_ex: torch.Tensor) -> torch.Tensor:
    """FedAvg's example-weighted mean over the ``[K, N]`` stack, the
    stacked-path twin of the engine's f32 accumulator, used on attacked
    rounds (the attack transform needs the per-client stack, so the
    weighted mean runs after it). ``1 / Σ nᵢ`` becomes 1 when nobody
    trained."""
    w = n_ex.to(torch.float32)
    w_sum = w.sum()
    denom = torch.where(w_sum > 0, w_sum, torch.ones_like(w_sum))
    return (w @ stack) / denom
