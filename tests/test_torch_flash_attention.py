"""The plain version of the port's flash-attention CUDA kernel on
``[B·H, T, hd]`` (``attention_reference``) and its ``autograd.Function``
(``flash_attention``), which on CPU tensors runs that plain version, vs
the JAX package's ``flash_attention`` run in Pallas interpret mode, as
tests/test_pallas_attention.py runs it, on the same numpy-made q/k/v.

The cases and tolerance are that file's: f32 at 2e-5 (abs and rel),
ragged T ∈ {48, 197, 50} causal and non-causal. Each JAX output is
computed once per process (tests/torch_parity.py).
"""

import pytest
import torch

from colearn_federated_learning_tpu_torch.ops import flash_attention as fa
from tests.torch_parity import (
    ATTENTION_CASES,
    attention_case_id,
    attention_qkv,
    check_backend_against_jax_flash,
)

torch.set_num_threads(1)

_TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("backend", ["reference", "flash"])
@pytest.mark.parametrize("case", ATTENTION_CASES, ids=attention_case_id)
def test_backend_matches_jax_flash_interpret(case, backend):
    check_backend_against_jax_flash(case, backend, _TOL)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper counts no launch and equals the plain
    version bit for bit."""
    q, k, v = (torch.from_numpy(x) for x in attention_qkv(3, 40, 16, seed=2))
    before = fa.flash_attention.launches
    got = fa.attention_forward(q, k, v, True)
    assert fa.flash_attention.launches == before
    assert torch.equal(got, fa.attention_reference(q, k, v, True))
