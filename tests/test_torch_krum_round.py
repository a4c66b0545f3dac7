"""One attacked / robust round of the PyTorch port vs the JAX package's
parity oracle ``make_sequential_round_fn`` (with its ``byz`` mask input)
on the same cohort, idx, mask, params and compromised slot, at f32 with
the atol 1e-4 / rtol 1e-3 of tests/test_torch_round.py. LeNet with a
cohort of 5 and ``krum_byzantine=1`` for each stacked route: the
undefended weighted mean under sign_flip (fused through the reduce-apply
kernel's plain version vs Pallas interpret mode, and unfused), Krum
without and with sign_flip (fused and unfused), median and trimmed_mean
under sign_flip; ResNet-18 at width 8 with two local steps for Krum
under sign_flip, fused. Plus a small CPU ``Experiment.fit`` of the
``cifar10_krum_byzantine`` preset: every round records the number of
compromised clients in its cohort."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu import config as jcfg
from colearn_federated_learning_tpu.models import build_model as jbuild
from colearn_federated_learning_tpu.parallel.round_engine import (
    make_sequential_round_fn as jround,
)
from colearn_federated_learning_tpu.server.aggregation import (
    make_server_update_fn as jserver,
)
from colearn_federated_learning_tpu_torch import config as tcfg
from colearn_federated_learning_tpu_torch.models import build_model
from colearn_federated_learning_tpu_torch.models.convert import flax_to_torch
from colearn_federated_learning_tpu_torch.ops.reduce_apply import (
    fused_reduce_apply,
)
from colearn_federated_learning_tpu_torch.ops.server_apply import (
    fused_delta_apply,
)
from colearn_federated_learning_tpu_torch.parallel.round_engine import (
    make_sequential_round_fn,
)
from colearn_federated_learning_tpu_torch.server.aggregation import (
    make_server_update_fn,
)
from colearn_federated_learning_tpu_torch.server.round_driver import Experiment
from colearn_federated_learning_tpu_torch.utils.trees import ParamLayout
from tests.test_torch_round import _params, _round_inputs

torch.set_num_threads(1)

_ATOL = 1e-4
_RTOL = 1e-3
_BYZ = np.array([0, 0, 0, 1, 0], np.float32)  # slot 3 is compromised


def _run_both(name, dataset, aggregator, attack, fused, cap, **kw):
    k = len(_BYZ)
    fed, idx, mask, n_ex = _round_inputs(dataset, k, cap)
    assert n_ex[_BYZ > 0].min() > 0  # the attacker trains and uploads
    jm = jbuild(name, 10, **kw)
    fp = _params(jm, name, seed=7)
    knobs = dict(aggregator=aggregator, byzantine_f=1, trim_ratio=0.2,
                 attack=attack, attack_scale=10.0)
    jinit, jupdate = jserver(jcfg.ServerConfig(server_lr=0.8,
                                               fused_apply=fused))
    jcc = jcfg.ClientConfig(local_epochs=1, batch_size=8, lr=0.05)
    round_fn = jround(jm, jcc, jcfg.DPConfig(), "classify", jupdate,
                      fused_apply=fused, **knobs)
    jp, _, jmet = round_fn(fp, jinit(fp), jnp.asarray(fed.train_x),
                           jnp.asarray(fed.train_y), jnp.asarray(idx),
                           jnp.asarray(mask), jnp.asarray(n_ex),
                           jax.random.PRNGKey(0),
                           byz=jnp.asarray(_BYZ) if attack else None)

    model = build_model(name, 10, **kw)
    tp = flax_to_torch(fp, model)
    layout = ParamLayout.from_params(tp)
    flat = layout.flatten(tp)
    tinit, tupdate = make_server_update_fn(
        tcfg.ServerConfig(server_lr=0.8, fused_apply=fused))
    tround = make_sequential_round_fn(
        model, tcfg.ClientConfig(local_epochs=1, batch_size=8, lr=0.05),
        tupdate, layout, **knobs)
    topt, tmet = tround(flat, tinit(flat), torch.from_numpy(fed.train_x),
                        torch.from_numpy(fed.train_y).long(),
                        torch.from_numpy(idx.astype(np.int64)),
                        torch.from_numpy(mask), n_ex, mask.sum(-1), _BYZ)
    assert topt["round"] == 1
    want = flax_to_torch(jax.tree.map(np.asarray, jp))
    for pname, t in layout.views(flat).items():
        np.testing.assert_allclose(t.numpy(), want[pname].numpy(),
                                   atol=_ATOL, rtol=_RTOL, err_msg=pname)
    np.testing.assert_allclose(float(tmet.train_loss), float(jmet.train_loss),
                               atol=_ATOL, rtol=_RTOL)
    assert tmet.examples == float(jmet.examples)
    return tmet


@pytest.mark.parametrize("aggregator,attack,fused", [
    ("weighted_mean", "sign_flip", True),
    ("weighted_mean", "sign_flip", False),
    ("krum", "", True),
    ("krum", "sign_flip", True),
    ("krum", "sign_flip", False),
    ("median", "sign_flip", False),
    ("trimmed_mean", "sign_flip", False),
])
def test_lenet_stacked_round_matches_jax(aggregator, attack, fused):
    before = (fused_reduce_apply.launches, fused_delta_apply.launches)
    tmet = _run_both("lenet5", "mnist", aggregator, attack, fused, cap=40)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (fused_reduce_apply.launches, fused_delta_apply.launches) == before
    if aggregator == "krum":
        assert _BYZ[int(tmet.krum_winner)] == 0  # the flipped upload lost
    else:
        assert tmet.krum_winner is None


def test_resnet_krum_sign_flip_round_matches_jax():
    """The slice's model (ResNet-18 at width 8), Krum under sign_flip,
    fused, two local steps per client (see test_torch_round.py for why
    ResNet rounds are compared at two steps)."""
    _run_both("resnet18", "cifar10", "krum", "sign_flip", True, cap=16,
              width=8)


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
