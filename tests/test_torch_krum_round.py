"""One attacked / robust round of the PyTorch port vs the JAX package's
parity oracle ``make_sequential_round_fn`` (with its ``byz`` mask input)
on the same cohort, idx, mask, params and compromised slot, at f32 with
the atol 1e-4 / rtol 1e-3 of tests/test_torch_round.py. LeNet with a
cohort of 5 and ``krum_byzantine=1`` for each stacked route: the
undefended weighted mean under sign_flip (fused through the reduce-apply
kernel's plain version vs Pallas interpret mode, and unfused), Krum
without and with sign_flip (fused and unfused), median and trimmed_mean
under sign_flip (ResNet-18's case, Krum under sign_flip, is in
tests/test_torch_krum_resnet.py). Plus a small CPU ``Experiment.fit`` of the
``cifar10_krum_byzantine`` preset: every round records the number of
compromised clients in its cohort."""

import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu_torch import config as tcfg
from colearn_federated_learning_tpu_torch.models.convert import flax_to_torch
from colearn_federated_learning_tpu_torch.ops.reduce_apply import (
    fused_reduce_apply,
)
from colearn_federated_learning_tpu_torch.ops.server_apply import (
    fused_delta_apply,
)
from colearn_federated_learning_tpu_torch.server.round_driver import Experiment
from tests.torch_parity import (
    engine_byz,
    jax_round,
    port_round,
    round_inputs,
)

torch.set_num_threads(1)

_ATOL = 1e-4
_RTOL = 1e-3
_BYZ = engine_byz(5)  # slot 3 of the cohort of 5 is compromised
_DATASET = {"lenet5": "mnist", "resnet18": "cifar10"}


_LENET_CASES = [
    ("weighted_mean", "sign_flip", True),
    ("weighted_mean", "sign_flip", False),
    ("krum", "", True),
    ("krum", "sign_flip", True),
    ("krum", "sign_flip", False),
    ("median", "sign_flip", False),
    ("trimmed_mean", "sign_flip", False),
]


def _case(name, aggregator, attack, fused, cap, **kw):
    """``(args, kwargs)`` of the round in tests/torch_parity.py's terms."""
    server = dict(server_lr=0.8, fused_apply=fused)
    engine = dict(aggregator=aggregator, byzantine_f=1, trim_ratio=0.2,
                  attack=attack, attack_scale=10.0)
    return (name, _DATASET[name], len(_BYZ), cap, server, engine), kw


def _run_both(name, aggregator, attack, fused, cap, **kw):
    args, kw = _case(name, aggregator, attack, fused, cap, **kw)
    n_ex = round_inputs(*args[1:4], **kw)[3]
    assert n_ex[_BYZ > 0].min() > 0  # the attacker trains and uploads
    jp, _, jloss, jexamples = jax_round(*args, **kw)
    flat, layout, topt, tmet = port_round(*args, byz=_BYZ, **kw)
    assert topt["round"] == 1
    want = flax_to_torch(jp)
    for pname, t in layout.views(flat).items():
        np.testing.assert_allclose(t.numpy(), want[pname].numpy(),
                                   atol=_ATOL, rtol=_RTOL, err_msg=pname)
    np.testing.assert_allclose(float(tmet.train_loss), jloss,
                               atol=_ATOL, rtol=_RTOL)
    assert tmet.examples == jexamples
    return tmet


@pytest.mark.parametrize("aggregator,attack,fused", _LENET_CASES)
def test_lenet_stacked_round_matches_jax(aggregator, attack, fused):
    before = (fused_reduce_apply.launches, fused_delta_apply.launches)
    tmet = _run_both("lenet5", aggregator, attack, fused, cap=40)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (fused_reduce_apply.launches, fused_delta_apply.launches) == before
    if aggregator == "krum":
        assert _BYZ[int(tmet.krum_winner)] == 0  # the flipped upload lost
    else:
        assert tmet.krum_winner is None


def test_fit_records_byzantine_count(tmp_path):
    cfg = tcfg.resolve_config("cifar10_krum_byzantine", {
        "model.kwargs.width": 8, "data.synthetic_train_size": 512,
        "data.synthetic_test_size": 32, "data.max_examples_per_client": 16,
        "client.batch_size": 16, "server.num_rounds": 2,
        "server.eval_every": 2, "server.fused_apply": True,
        "run.out_dir": str(tmp_path)})
    exp = Experiment(cfg, device="cpu", echo=False)
    exp.fit()
    attack = [r for r in exp.logger.history if r.get("event") == "attack"]
    assert attack[0]["compromised"] == exp.compromised.tolist()
    assert len(exp.compromised) == 12  # round(0.125 · 100)
    rounds = [r for r in exp.logger.history if "train_loss" in r]
    assert [r["round"] for r in rounds] == [1, 2]
    for r in rounds:
        cohort = exp.sampler.sample(r["round"] - 1)
        assert r["byzantine_count"] == int(
            np.isin(cohort, exp.compromised).sum())
        assert r["krum_selected_byzantine"] in (0, 1)
        assert np.isfinite(r["train_loss"])
