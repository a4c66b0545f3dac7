"""One FedAvg round of the PyTorch port vs the JAX package's parity
oracle ``make_sequential_round_fn`` on the same cohort, idx, mask and
params, at f32: atol 1e-4 / rtol 1e-3 (the bf16-engine tolerance of
tests/test_fused_apply.py:247, here covering f32 reassociation across
the local SGD steps). Server apply fused (Pallas interpret mode vs the
port's wrapper on CPU tensors) and unfused, for ``mean`` and
``fedavgm``. Plus: a padded local step leaves params and momentum
bitwise unchanged."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu.server.aggregation import (
    weighted_delta_mean as jweighted_delta_mean,
)
from colearn_federated_learning_tpu_torch.models.convert import flax_to_torch
from colearn_federated_learning_tpu_torch.server.aggregation import (
    weighted_delta_mean,
)
from colearn_federated_learning_tpu_torch.utils.trees import ParamLayout
from tests.torch_parity import (
    check_padded_step_is_noop,
    jax_round,
    port_round,
    round_inputs,
)

torch.set_num_threads(1)

_ATOL = 1e-4
_RTOL = 1e-3
_DATASET = {"lenet5": "mnist", "resnet18": "cifar10"}


def _case(name, optimizer, fused, cohort_size, cap, **kw):
    """``(args, kwargs)`` of the round in tests/torch_parity.py's terms."""
    server = dict(optimizer=optimizer, server_lr=0.8, server_momentum=0.9,
                  fused_apply=fused)
    return (name, _DATASET[name], cohort_size, cap, server), kw


_LENET = dict(cohort_size=3, cap=40)
_RESNET = dict(cohort_size=2, cap=16, width=8)


def _run_both(name, optimizer, fused, cohort_size, cap, **kw):
    """The oracle round and the port's from the same numpy params and
    round inputs (tests/torch_parity.py)."""
    args, kw = _case(name, optimizer, fused, cohort_size, cap, **kw)
    jp, jopt2, jloss, jexamples = jax_round(*args, **kw)
    flat, layout, topt2, tmet = port_round(*args, **kw)
    mask = round_inputs(_DATASET[name], cohort_size, cap, **kw)[2]
    return (jp, jopt2, jloss, jexamples), (layout.views(flat), topt2,
                                           tmet), mask


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("optimizer", ["mean", "fedavgm"])
def test_lenet_round_matches_jax(optimizer, fused):
    (jp, jopt, jloss, jexamples), (tp, topt, tmet), mask = _run_both(
        "lenet5", optimizer, fused, **_LENET)
    assert (mask.sum(-1) == 0).any()  # the round ran padded steps
    want = flax_to_torch(jp)
    for name, t in tp.items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                   atol=_ATOL, rtol=_RTOL, err_msg=name)
    np.testing.assert_allclose(float(tmet.train_loss), jloss,
                               atol=_ATOL, rtol=_RTOL)
    assert tmet.examples == jexamples
    assert topt["round"] == int(jopt["round"]) == 1
    if optimizer == "fedavgm":
        want_m = flax_to_torch(jopt["opt"][0].trace)
        got_m = ParamLayout.from_params(tp).views(topt["opt"]["trace"])
        for name, t in got_m.items():
            np.testing.assert_allclose(t.numpy(), want_m[name].numpy(),
                                       atol=_ATOL, rtol=_RTOL, err_msg=name)


def test_resnet_round_matches_jax():
    """The main path's model (ResNet-18 at width 8), fused ``mean``, two
    local steps per client. Longer local runs of this small ResNet are
    ill-conditioned in both frameworks: the JAX trainer against itself,
    from start params perturbed by 1e-7 relative, differs by 2e-4 after
    three steps at lr 0.05 — so past two steps the comparison would
    measure the conditioning, not the port."""
    (jp, _, jloss, _), (tp, _, tmet), mask = _run_both(
        "resnet18", "mean", True, **_RESNET)
    assert mask.shape[1] == 2
    want = flax_to_torch(jp)
    for name, t in tp.items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                   atol=_ATOL, rtol=_RTOL, err_msg=name)
    np.testing.assert_allclose(float(tmet.train_loss), jloss,
                               atol=_ATOL, rtol=_RTOL)


@pytest.mark.parametrize("local_dtype", [torch.float32, torch.bfloat16])
def test_padded_step_is_exact_noop(local_dtype):
    """Appending all-zero-mask steps changes nothing, bit for bit; the
    real steps do move the params."""
    check_padded_step_is_noop(local_dtype)


def test_weighted_delta_mean_matches_jax():
    rng = np.random.default_rng(2)
    deltas = [{"a": rng.normal(size=(3, 4)).astype(np.float32),
               "b": rng.normal(size=(5,)).astype(np.float32)}
              for _ in range(3)]
    weights = [3.0, 0.0, 5.0]
    want = jweighted_delta_mean(
        [jax.tree.map(jnp.asarray, d) for d in deltas], weights)
    got = weighted_delta_mean(
        [{k: torch.from_numpy(v) for k, v in d.items()} for d in deltas],
        weights)
    for k in ("a", "b"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, rtol=1e-6)
