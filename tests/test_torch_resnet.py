"""Model parity of the PyTorch port vs flax (``model.apply``) on the
same numpy-made params and inputs.

f32: atol 1e-4 (f32 reassociation across ~20 layers of O(1) values).
bf16 compute: atol 4·2⁻⁸·max(1, |logits|) — bf16 keeps 8 significant
bits, so each rounding moves a value by at most 2⁻⁸ relative; the two
frameworks round at different places (conv accumulation, GroupNorm's
f32 island, the residual adds), and GroupNorm renormalizes every layer
so the errors do not compound past a few such roundings on O(1)
logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from torch.func import functional_call

from colearn_federated_learning_tpu.client.trainer import (
    make_loss_fn as jloss,
)
from colearn_federated_learning_tpu.client.trainer import (
    normalize_input as jnormalize,
)
from colearn_federated_learning_tpu.models import build_model as jbuild
from colearn_federated_learning_tpu_torch.client.trainer import (
    make_loss_fn,
    normalize_input,
)
from colearn_federated_learning_tpu_torch.models import build_model
from colearn_federated_learning_tpu_torch.models.convert import flax_to_torch
from colearn_federated_learning_tpu_torch.models.layers import same_pads
from tests.torch_parity import jax_model, param_shapes

torch.set_num_threads(1)

_F32_ATOL = 1e-4


def _bf16_atol(ref):
    return 4 * 2.0**-8 * max(1.0, float(np.abs(ref).max()))


def _setup(name="resnet18", seed=0, **kw):
    jm = jax_model(name, **kw)
    shapes = param_shapes(name, **kw)
    rng = np.random.default_rng(seed)
    # unit-variance-preserving scale per kernel (fan-in over all but out)
    fp = jax.tree.map(
        lambda s: (rng.normal(size=s.shape)
                   / np.sqrt(max(1, np.prod(s.shape[:-1])))).astype(
                       np.float32) if len(s.shape) > 1
        else (1.0 + 0.1 * rng.normal(size=s.shape)).astype(np.float32),
        shapes)
    return jm, fp, rng


@pytest.mark.parametrize("size", [32, 17])
def test_same_pads_match_lax(size):
    for k, s in ((3, 1), (3, 2), (1, 2), (5, 1), (7, 2)):
        want = lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0]
        assert same_pads(size, k, s) == tuple(want)
    # the case a straight (1, 1) translation gets wrong
    assert same_pads(32, 3, 2) == (0, 1)


@pytest.mark.parametrize("hw", [32, 17])
def test_resnet_logits_f32(hw):
    jm, fp, rng = _setup(width=8)
    x = rng.uniform(size=(3, hw, hw, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x))(fp, x))
    model = build_model("resnet18", 10, width=8)
    got = functional_call(model, flax_to_torch(fp, model),
                          (torch.from_numpy(x),))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, atol=_F32_ATOL,
                               rtol=0)


@pytest.mark.parametrize("local_bf16", [False, True])
def test_resnet_logits_bf16_compute(local_bf16):
    """bf16 compute over f32 params (eval) and over bf16 params (local
    training); the head's logits stay f32 in both frameworks."""
    jm = jbuild("resnet18", 10, width=8, compute_dtype=jnp.bfloat16)
    _, fp, rng = _setup(width=8)
    x = rng.uniform(size=(4, 32, 32, 3)).astype(np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), fp) \
        if local_bf16 else fp
    want = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x))(jp, x))
    model = build_model("resnet18", 10, width=8, compute_dtype=torch.bfloat16)
    tp = flax_to_torch(fp, model)
    if local_bf16:
        tp = {k: v.to(torch.bfloat16) for k, v in tp.items()}
    got = functional_call(model, tp, (torch.from_numpy(x),))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=_bf16_atol(want), rtol=0)


def test_normalize_input_bitwise():
    x = np.arange(256, dtype=np.uint8).reshape(4, 8, 8, 1)
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jnormalize(jnp.asarray(x), jd).astype(jnp.float32))
        got = normalize_input(torch.from_numpy(x), td).float().numpy()
        np.testing.assert_array_equal(got, want)


def test_masked_loss_and_grads_f32():
    """Masked-mean cross-entropy and its gradient through the whole
    ResNet, with a partially padded batch."""
    jm, fp, rng = _setup(width=8, seed=1)
    x = rng.integers(0, 256, (6, 32, 32, 3)).astype(np.uint8)
    y = rng.integers(0, 10, 6).astype(np.int32)
    m = np.array([1, 1, 1, 1, 0, 0], np.float32)
    jl, jg = jax.jit(jax.value_and_grad(jloss(jm, "classify")))(fp, x, y, m)
    model = build_model("resnet18", 10, width=8)
    tp = {k: v.requires_grad_(True) for k, v in
          flax_to_torch(fp, model).items()}
    loss = make_loss_fn(model)(tp, torch.from_numpy(x),
                               torch.from_numpy(y), torch.from_numpy(m))
    grads = torch.autograd.grad(loss, list(tp.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=_F32_ATOL)
    want = flax_to_torch(jax.tree.map(np.asarray, jg))
    for (name, _), g in zip(tp.items(), grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   atol=_F32_ATOL, rtol=1e-3, err_msg=name)


def test_lenet_logits_f32():
    jm, fp, rng = _setup("lenet5")
    x = rng.uniform(size=(5, 28, 28, 1)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x))(fp, x))
    model = build_model("lenet5", 10)
    got = functional_call(model, flax_to_torch(fp, model),
                          (torch.from_numpy(x),))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=_F32_ATOL,
                               rtol=0)
