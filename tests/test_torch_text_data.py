"""The port's text path vs the JAX package's, bitwise: the synthetic
Shakespeare corpus (a fixed sparse Markov chain), the ``natural``
partition on it (Dirichlet(0.3) on each window's first token when there
are no natural groups), ``load_shakespeare_text`` on
tests/fixtures/shakespeare/shakespeare.txt with its natural groups, and
the round grid that the ``shakespeare_fedavg`` preset draws from them."""

import os

import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu import config as jcfg
from colearn_federated_learning_tpu.data import core as jcore
from colearn_federated_learning_tpu.data import leaf as jleaf
from colearn_federated_learning_tpu.data import loader as jloader
from colearn_federated_learning_tpu.data import partition as jpart
from colearn_federated_learning_tpu_torch import config as tcfg
from colearn_federated_learning_tpu_torch.data import core as tcore
from colearn_federated_learning_tpu_torch.data import leaf as tleaf
from colearn_federated_learning_tpu_torch.data import loader as tloader
from colearn_federated_learning_tpu_torch.data import partition as tpart

torch.set_num_threads(1)

_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "shakespeare")


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    else:
        assert a == b


def _both(data_dir, num_clients):
    fields = dict(name="shakespeare", num_clients=num_clients,
                  partition="natural", synthetic_test_size=64,
                  data_dir=data_dir)
    model_kw = dict(vocab_size=90, seq_len=20)
    return (jcore.build_federated_data(jcfg.DataConfig(**fields), seed=4,
                                       **model_kw),
            tcore.build_federated_data(tcfg.DataConfig(**fields), seed=4,
                                       **model_kw))


@pytest.mark.parametrize("source", ["synthetic", "real"])
def test_federated_text_bitwise(source):
    real = source == "real"
    # the fixture holds 6 speaker turns of more than 20 characters
    jf, tf = _both(_FIXTURE if real else "/nonexistent", 4 if real else 8)
    assert tf.meta["source"] == source
    assert tf.task == jf.task == "lm"
    assert tf.num_classes == jf.num_classes == 90
    for a in ("train_x", "train_y", "test_x", "test_y", "client_indices"):
        _same(getattr(tf, a), getattr(jf, a))
    _same(tf.meta, jf.meta)
    if not real:
        assert tf.train_x.shape == (2048, 20)  # max(2048, 8 · 32)
        # next-token targets: y is x shifted by one
        np.testing.assert_array_equal(tf.train_x[:, 1:], tf.train_y[:, :-1])


def test_load_shakespeare_text_bitwise():
    path = os.path.join(_FIXTURE, "shakespeare.txt")
    _same(tleaf.load_shakespeare_text(path, 90, 20),
          jleaf.load_shakespeare_text(path, 90, 20))
    text = open(path).read()
    _same(tleaf.build_char_vocab(text, 30), jleaf.build_char_vocab(text, 30))
    vocab = tleaf.build_char_vocab(text, 30)
    _same(tleaf.encode_chars(text, vocab), jleaf.encode_chars(text, vocab))


@pytest.mark.parametrize("seed", [0, 5])
def test_natural_partition_bitwise(seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 30, 23)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    groups = [np.arange(offsets[i], offsets[i + 1]) for i in range(23)]
    _same(tpart.natural_partition(groups, 7, seed),
          jpart.natural_partition(groups, 7, seed))
    labels = rng.integers(0, 9, int(offsets[-1]))
    ti, ji = {}, {}
    _same(tpart.partition("natural", labels, 7, 9, 0.5, seed, info=ti),
          jpart.partition("natural", labels, 7, 9, 0.5, seed, info=ji))
    assert ti == ji
    with pytest.raises(ValueError, match="natural groups"):
        tpart.natural_partition(groups[:3], 7, seed)


def test_preset_round_grid_bitwise():
    """The ``shakespeare_fedavg`` preset's federation: 128 clients over
    the synthetic corpus, cap 256, batch 16; round 0's index grid."""
    jc = jcfg.get_named_config("shakespeare_fedavg")
    tc = tcfg.resolve_config("shakespeare_fedavg")
    jc.data.data_dir = tc.data.data_dir = "/nonexistent"
    jf = jcore.build_federated_data(jc.data, seed=0, **jc.model.kwargs)
    tf = tcore.build_federated_data(tc.data, seed=0, **tc.model.kwargs)
    assert tf.train_x.shape == (4096, 80)  # max(2048, 128 · 32)
    _same(tf.client_indices, jf.client_indices)
    js = jloader.compute_round_shape(jf, jc.client, jc.data)
    ts = tloader.compute_round_shape(tf, tc.client, tc.data)
    assert (ts.steps, ts.batch_size, ts.cap) == (js.steps, js.batch_size,
                                                 js.cap)
    cohort = np.arange(0, 128, 4)
    _same(tloader.make_round_spec(tf, cohort, ts, np.random.default_rng(1)),
          jloader.make_round_spec(jf, cohort, js, np.random.default_rng(1)))
