"""FedProx in the port's local trainer vs the JAX package's sequential
round oracle (tests/torch_parity.py), from the same numpy params and
round inputs:

- LeNet with ``prox_mu`` and momentum: f32 at atol 1e-4 / rtol 1e-3,
  and bf16 local params within 1.25× of the reference's own bf16
  distance from its f32 round (tests/test_torch_round_bf16.py's rule);
- a padded step stays a bitwise no-op with the pull on;
- ``fit`` of ``femnist_fedprox_500`` at a tiny size on the CPU
  (MobileNetV2 at width 0.25 through the trainer with the pull on and
  the fused server apply) names the algorithm in every round's record.

MobileNetV2 itself is held against JAX in tests/test_torch_mobilenet.py
(its logits, its gradient and one local step), not in an oracle round:
from those params the round is chaotic past one local step, and at one
step p = p₀, so the pull is zero.
"""

import json

import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu_torch import cli
from colearn_federated_learning_tpu_torch.models.convert import flax_to_torch
from tests.test_torch_round_bf16 import bf16_distances
from tests.torch_parity import (
    check_padded_step_is_noop,
    jax_round,
    port_round,
    round_inputs,
)

torch.set_num_threads(1)

_ATOL = 1e-4
_RTOL = 1e-3
_BOUND = 1.25
_CLIENT = dict(prox_mu=0.1, momentum=0.9)
# tests/test_torch_round.py's unfused mean step: its compile is shared
_SERVER = dict(optimizer="mean", server_lr=0.8, server_momentum=0.9,
               fused_apply=False)


def test_lenet_prox_round_matches_jax():
    """cohort 3, cap 40: 5 local steps of batch 8, some padded."""
    assert (round_inputs("mnist", 3, 40)[2].sum(-1) == 0).any()
    args = ("lenet5", "mnist", 3, 40, _SERVER)
    jp, jopt, jloss, jexamples = jax_round(*args, client=_CLIENT)
    flat, layout, topt, tmet = port_round(*args, client=_CLIENT)
    want = flax_to_torch(jp)
    for n, t in layout.views(flat).items():
        np.testing.assert_allclose(t.numpy(), want[n].numpy(), atol=_ATOL,
                                   rtol=_RTOL, err_msg=n)
    np.testing.assert_allclose(float(tmet.train_loss), jloss, atol=_ATOL,
                               rtol=_RTOL)
    assert tmet.examples == jexamples
    assert topt["round"] == int(jopt["round"]) == 1


def test_lenet_prox_bf16_round_within_the_references_distance():
    port, ref = bf16_distances("lenet5", "mnist", 3, 40, _SERVER,
                               client=_CLIENT)
    assert 0.0 < ref and port <= _BOUND * ref, (port, ref)


@pytest.mark.parametrize("local_dtype", [torch.float32, torch.bfloat16])
def test_padded_step_is_exact_noop_with_prox(local_dtype):
    check_padded_step_is_noop(local_dtype, prox_mu=0.1)


def test_femnist_fit_names_fedprox_in_every_record(tmp_path, capsys):
    args = ["fit", "--config", "femnist_fedprox_500", "--out-dir",
            str(tmp_path), "--device", "cpu",
            "--set", "model.kwargs.width_mult=0.25",
            "--set", "data.num_clients=6", "--set", "server.cohort_size=2",
            "--set", "server.num_rounds=2", "--set", "server.eval_every=2",
            "--set", "server.fused_apply=true",
            "--set", "data.max_examples_per_client=16",
            "--set", "client.batch_size=8",
            "--set", "data.synthetic_test_size=16"]
    assert cli.main(args) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    rounds = [r for r in lines if "train_loss" in r]
    assert [r["round"] for r in rounds] == [1, 2]
    assert all(r["algorithm"] == "fedprox" for r in rounds)
    assert all(np.isfinite(r["train_loss"]) for r in rounds)
    assert np.isfinite(rounds[-1]["eval_loss"])
