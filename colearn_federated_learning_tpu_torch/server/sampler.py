"""Cohort sampler, ``fixed`` mode: a uniform draw without replacement.

Stateless by construction: the cohort for round ``r`` is a pure
function of ``(seed, r)``, so a run restored from a checkpoint replays
the same schedule with no sampler state to persist. The draw is the JAX
package's ``server/sampler.py`` fixed-mode draw, so the same seed gives
the same cohorts in both packages.
"""

from __future__ import annotations

import numpy as np


class CohortSampler:
    def __init__(self, num_clients: int, cohort_size: int, seed: int):
        if cohort_size > num_clients:
            raise ValueError(f"cohort {cohort_size} > clients {num_clients}")
        self.num_clients = num_clients
        self.cohort_size = cohort_size
        self.seed = seed

    def sample(self, round_idx: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, round_idx))
        return np.sort(
            rng.choice(self.num_clients, size=self.cohort_size, replace=False)
        )
