"""The port's adversary (server/attacks.py) vs the JAX package's, on the
same numpy-made inputs: the compromised set and the label flip bit for
bit; the upload attacks on a ``[K, N]`` stack — sign_flip and scale bit
for bit (the same f32 factor arithmetic), alie within 1e-6 (its mean and
std sum over the cohort in another order); and the stacked weighted
mean of the undefended attacked path within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu.server import attacks as jattacks
from colearn_federated_learning_tpu_torch.ops.reduce_apply import new_stack
from colearn_federated_learning_tpu_torch.server import attacks

torch.set_num_threads(1)

_K = 6


@pytest.mark.parametrize("num_clients,fraction,seed",
                         [(100, 0.125, 0), (16, 0.25, 3), (7, 0.01, 11)])
def test_select_compromised_matches_jax(num_clients, fraction, seed):
    got = attacks.select_compromised(num_clients, fraction, seed)
    want = jattacks.select_compromised(num_clients, fraction, seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert len(got) >= 1


def test_flip_labels_matches_jax():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 10, 200).astype(np.int32)
    shards = np.array_split(rng.permutation(200), 8)
    bad = np.array([1, 6])
    got = attacks.flip_labels(y, shards, bad, 10)
    want = jattacks.flip_labels(y, shards, bad, 10)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[shards[0]], y[shards[0]])
    np.testing.assert_array_equal(got[shards[1]], 9 - y[shards[1]])


def _stack(rng):
    leaves = {"a": rng.normal(size=(_K, 5, 7)).astype(np.float32),
              "b": rng.normal(size=(_K, 13)).astype(np.float32)}
    dense = np.concatenate([np.reshape(x, (_K, -1))
                            for x in jax.tree.leaves(leaves)], axis=1)
    return leaves, dense


@pytest.mark.parametrize("kind,scale,eps", [("sign_flip", 10.0, 1.0),
                                            ("scale", 0.3, 1.0),
                                            ("alie", 10.0, 1.5)])
def test_upload_attack_matches_jax(kind, scale, eps):
    rng = np.random.default_rng(len(kind))
    leaves, dense = _stack(rng)
    byz = np.array([0, 1, 0, 0, 1, 0], np.float32)
    part = np.array([3, 5, 0, 2, 4, 1], np.float32) > 0  # slot 2 dropped
    want = jattacks.apply_upload_attack(
        jax.tree.map(jnp.asarray, leaves), jnp.asarray(byz), None, kind,
        scale, eps, participation=jnp.asarray(part))
    want = np.concatenate([np.reshape(np.asarray(x), (_K, -1))
                           for x in jax.tree.leaves(want)], axis=1)
    stack = new_stack(_K, dense.shape[1], "cpu")
    stack.copy_(torch.from_numpy(dense))
    out = attacks.apply_upload_attack(stack, torch.from_numpy(byz), kind,
                                      scale, eps,
                                      participation=torch.from_numpy(part))
    assert out is stack  # in place
    if kind == "alie":
        np.testing.assert_allclose(stack.numpy(), want, atol=1e-6, rtol=1e-6)
        assert torch.equal(stack[1], stack[4])  # the colluders agree
        np.testing.assert_array_equal(stack[0].numpy(), dense[0])
    else:
        np.testing.assert_array_equal(stack.numpy(), want)


def test_gauss_is_not_an_upload_attack_of_the_port():
    with pytest.raises(ValueError, match="gauss"):
        attacks.apply_upload_attack(torch.zeros(2, 3), torch.ones(2),
                                    "gauss", 1.0, 1.0)


@pytest.mark.parametrize("n_ex", [[3, 0, 5, 1, 2, 7], [0] * _K])
def test_stack_weighted_mean_matches_jax(n_ex):
    rng = np.random.default_rng(9)
    leaves, dense = _stack(rng)
    n_ex = np.asarray(n_ex, np.float32)
    params = jax.tree.map(lambda x: jnp.zeros(x.shape[1:]), leaves)
    want = jattacks.stack_weighted_mean(
        jax.tree.map(jnp.asarray, leaves), jnp.asarray(n_ex), "examples",
        params)
    want = np.concatenate([np.ravel(np.asarray(x))
                           for x in jax.tree.leaves(want)])
    got = attacks.stack_weighted_mean(torch.from_numpy(dense),
                                      torch.from_numpy(n_ex))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
