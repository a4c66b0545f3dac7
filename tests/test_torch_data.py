"""Host data path of the PyTorch port vs the JAX package: partitions,
synthetic corpora, LEAF FEMNIST files, round shapes, index/mask grids,
eval batches and cohort draws must be BITWISE equal for the same config
and seed."""

import json

import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu import config as jcfg
from colearn_federated_learning_tpu.data import core as jcore
from colearn_federated_learning_tpu.data import loader as jloader
from colearn_federated_learning_tpu.data import partition as jpart
from colearn_federated_learning_tpu.server.sampler import (
    CohortSampler as JSampler,
)
from colearn_federated_learning_tpu_torch import config as tcfg
from colearn_federated_learning_tpu_torch.data import core as tcore
from colearn_federated_learning_tpu_torch.data import loader as tloader
from colearn_federated_learning_tpu_torch.data import partition as tpart
from colearn_federated_learning_tpu_torch.server.sampler import (
    CohortSampler as TSampler,
)

torch.set_num_threads(1)


def _same_shards(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 3, 17])
def test_partitions_bitwise(seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, 700)
    _same_shards(tpart.iid_partition(700, 9, seed),
                 jpart.iid_partition(700, 9, seed))
    for alpha in (0.05, 0.5, 10.0):
        ti, ji = {}, {}
        _same_shards(
            tpart.dirichlet_partition(labels, 12, 10, alpha, seed, info=ti),
            jpart.dirichlet_partition(labels, 12, 10, alpha, seed, info=ji))
        assert ti == ji


def _data_cfgs(name, **kw):
    return jcfg.DataConfig(name=name, **kw), tcfg.DataConfig(name=name, **kw)


@pytest.mark.parametrize("name,partition", [("cifar10", "dirichlet"),
                                            ("mnist", "iid")])
def test_federated_data_bitwise(name, partition):
    jd, td = _data_cfgs(name, num_clients=7, partition=partition,
                        synthetic_train_size=300, synthetic_test_size=50,
                        data_dir="/nonexistent")
    jf = jcore.build_federated_data(jd, seed=5)
    tf = tcore.build_federated_data(td, seed=5)
    for a in ("train_x", "train_y", "test_x", "test_y"):
        np.testing.assert_array_equal(getattr(tf, a), getattr(jf, a))
        assert getattr(tf, a).dtype == getattr(jf, a).dtype
    _same_shards(tf.client_indices, jf.client_indices)
    assert tf.num_classes == jf.num_classes
    assert tf.meta["source"] == jf.meta["source"] == "synthetic"


def test_round_grid_and_cohorts_bitwise():
    """Cohort draw → shape → (idx, spec, n_ex) → mask over several rounds,
    including a cap below the largest shard (subsampling) and clients
    with padded steps."""
    jd, td = _data_cfgs("cifar10", num_clients=20, partition="dirichlet",
                        dirichlet_alpha=0.3, synthetic_train_size=640,
                        synthetic_test_size=70, max_examples_per_client=40,
                        data_dir="/nonexistent")
    jc = jcfg.ClientConfig(local_epochs=2, batch_size=8)
    tc = tcfg.ClientConfig(local_epochs=2, batch_size=8)
    jf = jcore.build_federated_data(jd, seed=1)
    tf = tcore.build_federated_data(td, seed=1)
    jshape = jloader.compute_round_shape(jf, jc, jd)
    tshape = tloader.compute_round_shape(tf, tc, td)
    assert (tshape.local_epochs, tshape.steps_per_epoch, tshape.batch_size,
            tshape.cap) == (jshape.local_epochs, jshape.steps_per_epoch,
                            jshape.batch_size, jshape.cap)
    js, ts = JSampler(20, 6, seed=4), TSampler(20, 6, seed=4)
    padded = 0
    for r in range(5):
        cohort = ts.sample(r)
        np.testing.assert_array_equal(cohort, js.sample(r))
        got = tloader.make_round_spec(tf, cohort, tshape,
                                      np.random.default_rng((4, 7919, r)))
        want = jloader.make_round_spec(jf, cohort, jshape,
                                       np.random.default_rng((4, 7919, r)))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        mask = tloader.mask_from_spec(got[1], tshape)
        np.testing.assert_array_equal(mask,
                                      jloader.mask_from_spec(want[1], jshape))
        padded += int((mask.sum(-1) == 0).sum())
        gi = tloader.make_round_indices(tf, cohort, tshape,
                                        np.random.default_rng(r))
        wi = jloader.make_round_indices(jf, cohort, jshape,
                                        np.random.default_rng(r))
        for g, w in zip(gi, wi):
            np.testing.assert_array_equal(g, w)
    assert padded > 0  # the grids exercised padded steps


def test_eval_batches_bitwise():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 255, (37, 4, 4, 3)).astype(np.uint8)
    y = rng.integers(0, 10, 37).astype(np.int32)
    for g, w in zip(tloader.eval_batches(x, y, 8),
                    jloader.eval_batches(x, y, 8)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_femnist_synthetic_and_natural_partition_bitwise():
    """femnist_fedprox_500's data: the synthetic 28×28×1, 62-class
    stand-in (16,000 examples: 32 for each of the 500 clients) and its
    ``natural`` partition, which falls back to Dirichlet(0.3) without
    LEAF writer groups."""
    jd, td = _data_cfgs("femnist", num_clients=500, partition="natural",
                        max_examples_per_client=256, data_dir="/nonexistent")
    jf = jcore.build_federated_data(jd, seed=0)
    tf = tcore.build_federated_data(td, seed=0)
    assert tf.train_x.shape == (16_000, 28, 28, 1) and tf.num_classes == 62
    for a in ("train_x", "train_y", "test_x", "test_y"):
        np.testing.assert_array_equal(getattr(tf, a), getattr(jf, a))
        assert getattr(tf, a).dtype == getattr(jf, a).dtype
    _same_shards(tf.client_indices, jf.client_indices)
    assert tf.meta == jf.meta


def _write_leaf_femnist(root):
    """3 writers over two LEAF json files, a few 28×28 images each."""
    rng = np.random.default_rng(11)
    d = root / "femnist"
    d.mkdir()
    for fname, users in (("b.json", {"w2": 5}), ("a.json", {"w0": 4,
                                                           "w1": 3})):
        blob = {"users": list(users), "num_samples": list(users.values()),
                "user_data": {u: {"x": rng.uniform(size=(n, 784)).round(3)
                                  .tolist(),
                                  "y": rng.integers(0, 62, n).tolist()}
                              for u, n in users.items()}}
        (d / fname).write_text(json.dumps(blob))


def test_leaf_femnist_dir_loads_and_partitions_alike(tmp_path):
    from colearn_federated_learning_tpu.data import leaf as jleaf
    from colearn_federated_learning_tpu_torch.data import leaf as tleaf

    _write_leaf_femnist(tmp_path)
    got, want = tleaf.load_femnist(str(tmp_path)), jleaf.load_femnist(
        str(tmp_path))
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    _same_shards(got[4]["natural_groups"], want[4]["natural_groups"])
    assert len(got[4]["natural_groups"]) == 3
    assert [u for u, _ in tleaf.iter_leaf_clients(
        str(tmp_path / "femnist"))] == ["w0", "w1", "w2"]
    jd, td = _data_cfgs("femnist", num_clients=2, partition="natural",
                        data_dir=str(tmp_path))
    jf = jcore.build_federated_data(jd, seed=2)
    tf = tcore.build_federated_data(td, seed=2)
    assert tf.meta["source"] == jf.meta["source"] == "real"
    _same_shards(tf.meta["natural_groups"], jf.meta["natural_groups"])
    _same_shards(tf.client_indices, jf.client_indices)
    np.testing.assert_array_equal(tf.train_x, jf.train_x)


def test_cifar10_fedavg_1000_partition_and_cohorts_bitwise():
    """cifar10_fedavg_1000's federation without its images: Dirichlet(0.5)
    over a seeded 50,000-label array into 1000 clients, and the fixed-mode
    cohorts of 64 for a few rounds."""
    cfg = tcfg.resolve_config("cifar10_fedavg_1000")
    labels = np.random.default_rng(0).integers(0, 10, 50_000)
    ti, ji = {}, {}
    _same_shards(
        tpart.dirichlet_partition(labels, 1000, 10, 0.5, 0, info=ti),
        jpart.dirichlet_partition(labels, 1000, 10, 0.5, 0, info=ji))
    assert ti == ji
    assert (cfg.data.num_clients, cfg.server.cohort_size) == (1000, 64)
    js, ts = JSampler(1000, 64, seed=0), TSampler(1000, 64, seed=0)
    for r in (0, 1, 2, 999):
        np.testing.assert_array_equal(ts.sample(r), js.sample(r))
