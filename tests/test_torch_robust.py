"""The port's robust aggregators (server/aggregation.py) vs the JAX
package's on the same numpy-made ``[K, ...]`` stacks: ``robust_reduce``
(median, trimmed_mean, krum) with a dropped client, with one
participant (m = 1) and with none (m = 0), within 1e-6; Krum's winner;
and the config rules of the robust/attacked path.

Krum's winner rule: the port and JAX compute the scores in different
summation orders, so where JAX's two lowest scores differ by less than
1e-5 relative, the winner may differ legitimately. There the test
asserts that the port's winner's JAX score lies within that margin of
the minimum; everywhere else the winners must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu.server import aggregation as jagg
from colearn_federated_learning_tpu_torch import config as tcfg
from colearn_federated_learning_tpu_torch.server import aggregation as tagg
from colearn_federated_learning_tpu_torch.utils.trees import ParamLayout

torch.set_num_threads(1)

_K = 6
_TIE_RTOL = 1e-5
_PART = {"dropout": [1, 1, 0, 1, 1, 1], "m1": [0, 0, 1, 0, 0, 0],
         "m0": [0] * _K}


def _stack(seed, outlier=True):
    """A two-leaf ``[K, ...]`` tree, its dense ``[K, N]`` f32 stack in leaf
    order, and the port's layout of the leaves."""
    rng = np.random.default_rng(seed)
    leaves = {"a": rng.normal(size=(_K, 4, 9)).astype(np.float32),
              "b": rng.normal(size=(_K, 11)).astype(np.float32)}
    if outlier:
        leaves = {k: v * np.float32([1, 1, 1, -10, 1, 1]).reshape(
            (_K,) + (1,) * (v.ndim - 1)) for k, v in leaves.items()}
    names = sorted(leaves)  # jax.tree.leaves order
    dense = np.concatenate([leaves[n].reshape(_K, -1) for n in names], 1)
    layout = ParamLayout.from_params(
        {n: torch.zeros(leaves[n].shape[1:]) for n in names})
    return leaves, torch.from_numpy(dense), layout


@pytest.mark.parametrize("part", sorted(_PART))
@pytest.mark.parametrize("mode", ["median", "trimmed_mean", "krum"])
def test_robust_reduce_matches_jax(mode, part):
    leaves, stack, layout = _stack(seed=len(mode) + len(part))
    p = np.asarray(_PART[part], np.float32)
    want = jagg.robust_reduce(jax.tree.map(jnp.asarray, leaves),
                              jnp.asarray(p), mode, trim_ratio=0.2,
                              byzantine_f=1)
    want = np.concatenate([np.ravel(np.asarray(want[n])) for n in ("a", "b")])
    got = tagg.robust_reduce(stack, torch.from_numpy(p), mode, layout,
                             trim_ratio=0.2, byzantine_f=1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    if part == "m0":
        assert not got.any()  # the zero update
    if mode == "krum" and part != "m0":  # selection: one row, bit for bit
        assert any(torch.equal(got, stack[c]) for c in range(_K))


def _jax_scores(leaves, part, f):
    """The score lines of the JAX package's ``krum_select``, verbatim."""
    part = jnp.asarray(part, jnp.float32)
    k = part.shape[0]
    m = part.sum()
    d2 = jnp.zeros((k, k), jnp.float32)
    for leaf in jax.tree.leaves(jax.tree.map(jnp.asarray, leaves)):
        x = leaf.astype(jnp.float32).reshape(k, -1)
        sq = (x * x).sum(-1)
        d2 = d2 + jnp.maximum(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), 0.0)
    alive = part > 0
    d2 = jnp.where(alive[:, None] & alive[None, :], d2, jnp.inf)
    d2 = d2.at[jnp.arange(k), jnp.arange(k)].set(jnp.inf)
    s = jnp.sort(d2, axis=1)
    n_nb = jnp.maximum(m - f - 2, 1.0)
    keep = (jnp.arange(k)[None, :] < n_nb).astype(jnp.float32)
    scores = (jnp.where(keep > 0, s, 0.0)).sum(1)
    scores = jnp.where(alive & (m > 1), scores, jnp.where(alive, 0.0, jnp.inf))
    return np.asarray(scores)


@pytest.mark.parametrize("case", ["seed0", "seed1", "duplicate_rows"])
def test_krum_winner_matches_jax(case):
    leaves, stack, layout = _stack(seed=int(case[-1]) if "seed" in case
                                   else 2, outlier=False)
    if case == "duplicate_rows":  # an exact tie between slots 1 and 4
        leaves = {k: v.copy() for k, v in leaves.items()}
        for v in leaves.values():
            v[4] = v[1]
        stack = stack.clone()
        stack[4] = stack[1]
    part = np.ones(_K, np.float32)
    j_win, j_m = jagg.krum_select(jax.tree.map(jnp.asarray, leaves),
                                  jnp.asarray(part), 1)
    winner, m = tagg.krum_select(stack, torch.from_numpy(part), 1, layout)
    assert float(m) == float(j_m) == _K
    scores = _jax_scores(leaves, part, 1)
    assert int(np.argmin(scores)) == int(j_win)  # the copy is faithful
    lo, second = np.sort(scores)[:2]
    if second - lo < _TIE_RTOL * abs(lo):
        assert scores[int(winner)] - lo <= _TIE_RTOL * abs(lo)
    else:
        assert int(winner) == int(j_win)


@pytest.mark.parametrize("overrides,field", [
    ({"attack.kind": "gauss"}, "attack.kind='gauss'"),
    ({"server.krum_byzantine": 7}, "server.krum_byzantine=7"),
    ({"server.krum_byzantine": -1}, "server.krum_byzantine"),
    ({"attack.fraction": 1.0}, "attack.fraction"),
    ({"attack.scale": 0.0}, "attack.scale"),
    ({"server.trim_ratio": 0.5}, "server.trim_ratio"),
    ({"server.aggregator": "bulyan"}, "server.aggregator"),
])
def test_validate_names_the_field(overrides, field):
    with pytest.raises(ValueError, match=field):
        tcfg.resolve_config("cifar10_krum_byzantine", overrides)
