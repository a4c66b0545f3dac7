"""The port's flash-attention ``autograd.Function`` on bf16 inputs and
its gradients, vs the JAX package (its Pallas ``flash_attention`` in
interpret mode, and JAX's gradient of the plain attention, as
tests/test_pallas_attention.py holds its kernel).

bf16 inputs within 3e-2 of the JAX kernel's bf16 output; gradients (the
reference's ``_flash_bwd`` recompute) within 2e-5 (abs and rel).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu.ops.attention import (
    causal_attention as jcausal,
)
from colearn_federated_learning_tpu.ops.attention import (
    full_attention as jfull,
)
from colearn_federated_learning_tpu.ops.pallas_attention import (
    flash_attention as jflash,
)
from colearn_federated_learning_tpu_torch.ops import flash_attention as fa
from colearn_federated_learning_tpu_torch.ops.attention import (
    causal_attention,
)
from tests.torch_parity import attention_qkv

torch.set_num_threads(1)

_TOL = dict(atol=2e-5, rtol=2e-5)


def test_bfloat16_inputs():
    """bf16 in, bf16 out, within 3e-2 of the JAX kernel's bf16 output."""
    q, k, v = attention_qkv(1, 32, 64, seed=1)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jflash(jq, jk, jv, 2, True, 16, 16), np.float32)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    for got in (fa.flash_attention(tq, tk, tv, 2, True, 16, 16),
                causal_attention(tq, tk, tv, 2)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("t,block,causal", [
    (32, 16, True),   # divisible: the blockwise recompute
    (50, 32, True),   # ragged causal: the zero-padded recompute
    (50, 32, False),  # ragged non-causal: the full-attention recompute
])
def test_gradients_match_jax(t, block, causal):
    b, d, heads = (2 if t == 32 else 1), 64, 2
    q, k, v = attention_qkv(b, t, d, seed=t + 3)
    g = np.random.default_rng(9).normal(size=(b, t, d)).astype(np.float32)
    oracle = jcausal if causal else jfull
    want = jax.jit(jax.grad(
        lambda q, k, v: (oracle(q, k, v, heads) * g).sum(),
        argnums=(0, 1, 2)))(q, k, v)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_attention(*leaves, heads, causal, block, block)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **_TOL)
