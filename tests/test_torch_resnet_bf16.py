"""The bf16 bound of tests/test_torch_round_bf16.py for the main path's
model: ResNet-18 at width 8 on the round of tests/test_torch_round.py's
``test_resnet_round_matches_jax`` (a cohort of 2, two local steps of
batch 8, the fused ``mean`` server step)."""

import torch

from tests.test_torch_round_bf16 import check_bf16_bound

torch.set_num_threads(1)


def test_resnet_bf16_round_within_the_references_bf16_distance():
    check_bf16_bound("resnet18", "cifar10", 2, 16, 2, fused=True, width=8)
