"""Fused server apply (ops/server_apply.py): the plain version the
wrapper runs on CPU tensors vs the JAX package's ``fused_delta_apply``
in Pallas interpret mode (its own CPU path), both branches, at the
``_ATOL``/``_RTOL`` = 1e-5 of tests/test_fused_apply.py; and the
wrapper's input checks. The CUDA kernel itself is held against the
plain version on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu.ops.pallas_apply import (
    fused_delta_apply as jax_fused_delta_apply,
)
from colearn_federated_learning_tpu_torch.ops.server_apply import (
    delta_apply_reference,
    fused_delta_apply,
)

torch.set_num_threads(1)

_ATOL = 1e-5
_RTOL = 1e-5


def _tree(rng):
    # 2 full 8192-element Pallas tiles plus a ragged, odd-length tail
    return {"w": rng.normal(size=(129, 128)).astype(np.float32),
            "b": {"k": rng.normal(size=(37,)).astype(np.float32)}}


def _flat(tree):
    return torch.from_numpy(np.concatenate(
        [np.ravel(x) for x in jax.tree.leaves(tree)]))


@pytest.mark.parametrize("lr,beta", [(1.0, 0.0), (0.5, 0.0), (0.7, 0.9)])
def test_plain_matches_pallas_interpret(lr, beta):
    rng = np.random.default_rng(int(lr * 10 + beta * 100))
    p, d = _tree(rng), _tree(rng)
    m = _tree(rng) if beta else None
    want_p, want_m = jax_fused_delta_apply(
        jax.tree.map(jnp.asarray, p),
        None if m is None else jax.tree.map(jnp.asarray, m),
        jax.tree.map(jnp.asarray, d), lr, beta, interpret=True)
    tp, tm = _flat(p), None if m is None else _flat(m)
    before = fused_delta_apply.launches
    got_p, got_m = fused_delta_apply(tp, _flat(d), lr, tm, beta)
    assert got_p is tp and got_m is tm  # in place
    assert fused_delta_apply.launches == before  # CPU: no kernel launch
    np.testing.assert_allclose(tp.numpy(), _flat(want_p).numpy(),
                               atol=_ATOL, rtol=_RTOL)
    if beta:
        np.testing.assert_allclose(tm.numpy(), _flat(want_m).numpy(),
                                   atol=_ATOL, rtol=_RTOL)
    else:
        assert want_m is None and got_m is None


def test_wrapper_rejects_bad_inputs():
    p = torch.zeros(10)
    with pytest.raises(TypeError):
        fused_delta_apply(p, torch.zeros(10, dtype=torch.float64), 1.0)
    with pytest.raises(ValueError):
        fused_delta_apply(p, torch.zeros(11), 1.0)
    with pytest.raises(ValueError):
        fused_delta_apply(p, torch.zeros(20)[::2], 1.0)
    with pytest.raises(ValueError):
        fused_delta_apply(p, torch.zeros(10), 1.0, torch.zeros(2, 5), 0.9)
    with pytest.raises(ValueError):
        fused_delta_apply(torch.zeros(0), torch.zeros(0), 1.0)


def test_reference_is_optax_sgd():
    """mean: p + lr·Δ̄; fedavgm: m′ = β·m − Δ̄, p′ = p − lr·m′."""
    p = torch.tensor([1.0, -2.0, 0.5])
    d = torch.tensor([0.25, 0.5, -1.0])
    m = torch.tensor([1.0, 0.0, -1.0])
    np.testing.assert_array_equal(delta_apply_reference(p, d, 2.0)[0],
                                  [1.5, -1.0, -1.5])
    p2, m2 = delta_apply_reference(p, d, 2.0, m, 0.5)
    np.testing.assert_array_equal(m2, [0.25, -0.5, 0.5])
    np.testing.assert_array_equal(p2, [0.5, -1.0, -0.5])

