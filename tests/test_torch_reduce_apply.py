"""Fused reduce-apply (ops/reduce_apply.py): the plain version the
wrapper runs on CPU tensors vs the JAX package's ``fused_reduce_apply``
in Pallas interpret mode (its own CPU path), both branches, weighted
and one-hot weights, at an N that is not a tile multiple, at the
``_ATOL``/``_RTOL`` = 1e-5 of tests/test_fused_apply.py; the stack's
row alignment; the wrapper's input checks; and the server update's
``fused_reduce`` entry. The CUDA kernel itself is held against the
plain version on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu.ops.pallas_apply import (
    fused_reduce_apply as jax_fused_reduce_apply,
)
from colearn_federated_learning_tpu_torch.config import ServerConfig
from colearn_federated_learning_tpu_torch.ops.reduce_apply import (
    fused_reduce_apply,
    new_stack,
    reduce_apply_reference,
)
from colearn_federated_learning_tpu_torch.server.aggregation import (
    make_server_update_fn,
)

torch.set_num_threads(1)

_ATOL = 1e-5
_RTOL = 1e-5
_K = 5


def _tree(rng, lead=()):
    # 2 full 8192-element Pallas tiles plus a ragged, odd-length tail
    return {"w": rng.normal(size=lead + (129, 128)).astype(np.float32),
            "b": {"k": rng.normal(size=lead + (37,)).astype(np.float32)}}


def _flat(tree, k=None):
    leaves = jax.tree.leaves(tree)
    if k is None:
        return torch.from_numpy(np.concatenate([np.ravel(x) for x in leaves]))
    return torch.from_numpy(np.concatenate(
        [np.reshape(x, (k, -1)) for x in leaves], axis=1))


def _weights(kind, rng):
    if kind == "one_hot":
        return np.eye(_K, dtype=np.float32)[2]
    w = rng.uniform(0.0, 3.0, _K).astype(np.float32)
    w[1] = 0.0  # a dropped client
    return w / w.sum()


@pytest.mark.parametrize("beta", [0.0, 0.9])
@pytest.mark.parametrize("wkind", ["weighted", "one_hot"])
def test_plain_matches_pallas_interpret(wkind, beta):
    rng = np.random.default_rng(17 + int(beta * 10))
    s_tree = _tree(rng, (_K,))
    p, m = _tree(rng), (_tree(rng) if beta else None)
    w = _weights(wkind, rng)
    lr = 0.7
    want_p, want_m, want_d = jax_fused_reduce_apply(
        jax.tree.map(jnp.asarray, s_tree), jnp.asarray(w),
        jax.tree.map(jnp.asarray, p),
        None if m is None else jax.tree.map(jnp.asarray, m),
        lr, beta, interpret=True)

    dense = _flat(s_tree, _K)
    stack = new_stack(_K, dense.shape[1], "cpu")
    stack.copy_(dense)
    assert stack.stride(0) % 4 == 0 and stack.stride(0) > stack.shape[1]
    tp, tm = _flat(p), (None if m is None else _flat(m))
    before = fused_reduce_apply.launches
    got_p, got_m, got_d = fused_reduce_apply(stack, torch.from_numpy(w), tp,
                                             lr, tm, beta)
    assert got_p is tp and got_m is tm  # in place
    assert fused_reduce_apply.launches == before  # CPU: no kernel launch
    for got, want in ((tp, want_p), (got_d, want_d)):
        np.testing.assert_allclose(got.numpy(), _flat(want).numpy(),
                                   atol=_ATOL, rtol=_RTOL)
    if beta:
        np.testing.assert_allclose(tm.numpy(), _flat(want_m).numpy(),
                                   atol=_ATOL, rtol=_RTOL)
    else:
        assert want_m is None and got_m is None
    if wkind == "one_hot":  # selection: the winner's row, bit for bit
        assert torch.equal(got_d, dense[2])


def test_new_stack_rows_are_16_byte_apart():
    for n in (11_173_962, 1_000_003, 8, 1):
        s = new_stack(3, n, "cpu")
        assert s.shape == (3, n) and s.stride() == ((n + 3) // 4 * 4, 1)
        assert (s[1].data_ptr() - s[0].data_ptr()) % 16 == 0


def test_wrapper_rejects_bad_inputs():
    p = torch.zeros(10)
    s = torch.zeros(3, 10)
    w = torch.ones(3) / 3
    with pytest.raises(TypeError):
        fused_reduce_apply(s.double(), w, p, 1.0)
    with pytest.raises(ValueError, match="stack must be"):
        fused_reduce_apply(torch.zeros(3, 11), w, p, 1.0)
    with pytest.raises(ValueError, match="stack must be"):
        fused_reduce_apply(torch.zeros(10, 3).T, w, p, 1.0)
    with pytest.raises(ValueError, match="weights"):
        fused_reduce_apply(s, torch.ones(4), p, 1.0)
    with pytest.raises(ValueError, match="momentum"):
        fused_reduce_apply(s, w, p, 1.0, torch.zeros(2, 5), 0.9)
    with pytest.raises(ValueError, match="rows"):
        fused_reduce_apply(torch.zeros(0, 10), torch.zeros(0), p, 1.0)


def test_reference_sums_rows_in_order():
    """Row by row from zero, each product and sum rounded once in f32 —
    the order the kernel follows, so the two agree bit for bit."""
    rng = np.random.default_rng(3)
    s = torch.from_numpy(rng.normal(size=(4, 257)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(size=4).astype(np.float32))
    p = torch.from_numpy(rng.normal(size=257).astype(np.float32))
    want = torch.zeros(257)
    for k in range(4):
        want = want + w[k] * s[k]
    p2, m2, d = reduce_apply_reference(s, w, p, 0.5)
    assert m2 is None
    assert torch.equal(d, want)
    assert torch.equal(p2, p + 0.5 * want)


@pytest.mark.parametrize("optimizer", ["mean", "fedavgm"])
def test_server_fused_reduce_entry(optimizer):
    """``update.fused_reduce`` exists only under fused_apply, advances the
    round and the momentum, and returns the aggregate it applied."""
    cfg = ServerConfig(optimizer=optimizer, server_lr=0.8, fused_apply=True)
    init, update = make_server_update_fn(cfg)
    rng = np.random.default_rng(5)
    p = torch.from_numpy(rng.normal(size=33).astype(np.float32))
    s = torch.from_numpy(rng.normal(size=(3, 33)).astype(np.float32))
    w = torch.tensor([0.25, 0.0, 0.75])
    state = init(p)
    want_p, want_m, want_d = reduce_apply_reference(
        s, w, p, 0.8, state["opt"].get("trace"), cfg.server_momentum)
    state, d = update.fused_reduce(p, state, s, w)
    assert state["round"] == 1
    assert torch.equal(d, want_d) and torch.equal(p, want_p)
    if optimizer == "fedavgm":
        assert torch.equal(state["opt"]["trace"], want_m)
    unfused = make_server_update_fn(ServerConfig(optimizer=optimizer))[1]
    assert not hasattr(unfused, "fused_reduce")
