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

from colearn_federated_learning_tpu import config as jcfg
from colearn_federated_learning_tpu.data import core as jcore
from colearn_federated_learning_tpu.data import loader as jloader
from colearn_federated_learning_tpu.models import build_model as jbuild
from colearn_federated_learning_tpu.parallel.round_engine import (
    make_sequential_round_fn as jround,
)
from colearn_federated_learning_tpu.server.aggregation import (
    make_server_update_fn as jserver,
)
from colearn_federated_learning_tpu.server.aggregation import (
    weighted_delta_mean as jweighted_delta_mean,
)
from colearn_federated_learning_tpu_torch import config as tcfg
from colearn_federated_learning_tpu_torch.client.trainer import (
    make_local_train_fn,
)
from colearn_federated_learning_tpu_torch.models import build_model
from colearn_federated_learning_tpu_torch.models.convert import flax_to_torch
from colearn_federated_learning_tpu_torch.parallel.round_engine import (
    make_sequential_round_fn,
)
from colearn_federated_learning_tpu_torch.server.aggregation import (
    make_server_update_fn,
    weighted_delta_mean,
)
from colearn_federated_learning_tpu_torch.utils.trees import ParamLayout

torch.set_num_threads(1)

_ATOL = 1e-4
_RTOL = 1e-3
_INPUT = {"lenet5": (28, 28, 1), "resnet18": (32, 32, 3)}


def _params(jm, name, seed):
    """numpy-made params of the JAX model's tree: fan-in-scaled kernels,
    GroupNorm scales near 1, small biases."""
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0),
                        jnp.zeros((1,) + _INPUT[name])))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = path[-1].key
        z = rng.normal(size=s.shape).astype(np.float32)
        if leaf == "kernel":
            return z / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        return (1.0 + 0.1 * z) if leaf == "scale" else 0.1 * z

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _round_inputs(dataset, cohort_size, cap, seed=3):
    dc = jcfg.DataConfig(name=dataset, num_clients=6, partition="dirichlet",
                         dirichlet_alpha=0.5, synthetic_train_size=192,
                         synthetic_test_size=16, max_examples_per_client=cap,
                         data_dir="/nonexistent")
    cc = jcfg.ClientConfig(local_epochs=1, batch_size=8, lr=0.05)
    fed = jcore.build_federated_data(dc, seed=seed)
    shape = jloader.compute_round_shape(fed, cc, dc)
    cohort = np.arange(cohort_size)
    idx, spec, n_ex = jloader.make_round_spec(
        fed, cohort, shape, np.random.default_rng((seed, 7919, 0)))
    mask = jloader.mask_from_spec(spec, shape)
    return fed, idx, mask, n_ex


def _run_both(name, dataset, optimizer, fused, cohort_size, cap, **kw):
    fed, idx, mask, n_ex = _round_inputs(dataset, cohort_size, cap)
    jm = jbuild(name, 10, **kw)
    fp = _params(jm, name, seed=7)
    jsc = jcfg.ServerConfig(optimizer=optimizer, server_lr=0.8,
                            server_momentum=0.9, fused_apply=fused)
    jinit, jupdate = jserver(jsc)
    jcc = jcfg.ClientConfig(local_epochs=1, batch_size=8, lr=0.05)
    round_fn = jround(jm, jcc, jcfg.DPConfig(), "classify", jupdate,
                      fused_apply=fused)
    jopt = jinit(fp)
    if optimizer == "fedavgm":  # non-zero incoming momentum
        jopt = jax.tree.map(lambda a: a + 0.01 if a.ndim else a, jopt)
    jp, jopt2, jmet = round_fn(fp, jopt, jnp.asarray(fed.train_x),
                               jnp.asarray(fed.train_y), jnp.asarray(idx),
                               jnp.asarray(mask), jnp.asarray(n_ex),
                               jax.random.PRNGKey(0))

    model = build_model(name, 10, **kw)
    tp = flax_to_torch(fp, model)
    layout = ParamLayout.from_params(tp)
    flat = layout.flatten(tp)
    tsc = tcfg.ServerConfig(optimizer=optimizer, server_lr=0.8,
                            server_momentum=0.9, fused_apply=fused)
    tinit, tupdate = make_server_update_fn(tsc)
    topt = tinit(flat)
    if optimizer == "fedavgm":
        topt["opt"]["trace"] += 0.01
    tround = make_sequential_round_fn(
        model, tcfg.ClientConfig(local_epochs=1, batch_size=8, lr=0.05),
        tupdate, layout)
    topt2, tmet = tround(flat, topt, torch.from_numpy(fed.train_x),
                         torch.from_numpy(fed.train_y).long(),
                         torch.from_numpy(idx.astype(np.int64)),
                         torch.from_numpy(mask), n_ex, mask.sum(-1))
    return (jp, jopt2, jmet), (layout.views(flat), topt2, tmet), mask


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("optimizer", ["mean", "fedavgm"])
def test_lenet_round_matches_jax(optimizer, fused):
    (jp, jopt, jmet), (tp, topt, tmet), mask = _run_both(
        "lenet5", "mnist", optimizer, fused, cohort_size=3, cap=40)
    assert (mask.sum(-1) == 0).any()  # the round ran padded steps
    want = flax_to_torch(jax.tree.map(np.asarray, jp))
    for name, t in tp.items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                   atol=_ATOL, rtol=_RTOL, err_msg=name)
    np.testing.assert_allclose(float(tmet.train_loss), float(jmet.train_loss),
                               atol=_ATOL, rtol=_RTOL)
    assert tmet.examples == float(jmet.examples)
    assert topt["round"] == int(jopt["round"]) == 1
    if optimizer == "fedavgm":
        want_m = flax_to_torch(jax.tree.map(np.asarray, jopt["opt"][0].trace))
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
    (jp, _, jmet), (tp, _, tmet), mask = _run_both(
        "resnet18", "cifar10", "mean", True, cohort_size=2, cap=16, width=8)
    assert mask.shape[1] == 2
    want = flax_to_torch(jax.tree.map(np.asarray, jp))
    for name, t in tp.items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                   atol=_ATOL, rtol=_RTOL, err_msg=name)
    np.testing.assert_allclose(float(tmet.train_loss), float(jmet.train_loss),
                               atol=_ATOL, rtol=_RTOL)


@pytest.mark.parametrize("local_dtype", [torch.float32, torch.bfloat16])
def test_padded_step_is_exact_noop(local_dtype):
    """Appending all-zero-mask steps changes nothing, bit for bit; the
    real steps do move the params."""
    model = build_model("lenet5", 10)
    fp = _params(jbuild("lenet5", 10), "lenet5", seed=1)
    tp = flax_to_torch(fp, model)
    layout = ParamLayout.from_params(tp)
    flat = layout.flatten(tp)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (40, 28, 28, 1)).astype(np.uint8))
    y = torch.from_numpy(rng.integers(0, 10, 40)).long()
    idx = torch.from_numpy(rng.integers(0, 40, (4, 8)))
    mask = torch.ones(4, 8)
    mask[1, 5:] = 0.0
    train = make_local_train_fn(model, tcfg.ClientConfig(batch_size=8),
                                local_dtype)
    base, base_m = train(flat, layout, x, y, idx[:2], mask[:2],
                         mask[:2].sum(-1).numpy())
    mask[2:] = 0.0
    padded, pad_m = train(flat, layout, x, y, idx, mask, mask.sum(-1).numpy())
    assert base.dtype == local_dtype
    assert not torch.equal(base.float(), flat)
    assert torch.equal(padded, base)
    assert torch.equal(pad_m.loss, base_m.loss)
    assert pad_m.examples == base_m.examples == 13.0


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
