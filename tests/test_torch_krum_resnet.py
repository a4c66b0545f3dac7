"""One attacked, Krum-defended round of the PyTorch port vs the JAX
package's parity oracle, for the path's model: ResNet-18 at width 8,
Krum (f = 1) under sign_flip, fused, a cohort of 5 with slot 3
compromised, at f32 within atol 1e-4 / rtol 1e-3 (the cases and helpers
of tests/test_torch_krum_round.py)."""

import torch

from tests.test_torch_krum_round import _run_both

torch.set_num_threads(1)


def test_resnet_krum_sign_flip_round_matches_jax():
    """The slice's model (ResNet-18 at width 8), Krum under sign_flip,
    fused, two local steps per client (see test_torch_round.py for why
    ResNet rounds are compared at two steps)."""
    _run_both("resnet18", "krum", "sign_flip", True, cap=16, width=8)
