"""The port's attention backends ``full`` and ``blockwise``
(ops/attention.py, ops/ring_attention.py) vs the JAX package's
``flash_attention`` run in Pallas interpret mode, as
tests/test_pallas_attention.py runs it, on the same numpy-made q/k/v.

The cases and tolerance are that file's: f32 at 2e-5 (abs and rel),
ragged T ∈ {48, 197, 50} causal and non-causal. Each JAX output is
computed once per process (tests/torch_parity.py). The plain version of
the CUDA kernel and its ``autograd.Function`` are held against the same
outputs in tests/test_torch_flash_attention.py; bf16 inputs and
gradients are in tests/test_torch_flash_attention_grads.py.
"""

import pytest
import torch

from colearn_federated_learning_tpu_torch.ops.attention import (
    causal_attention,
    full_attention,
)
from colearn_federated_learning_tpu_torch.ops.backends import (
    resolve_attention,
)
from tests.torch_parity import (
    ATTENTION_CASES,
    attention_case_id,
    check_backend_against_jax_flash,
)

torch.set_num_threads(1)

_TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("backend", ["full", "blockwise"])
@pytest.mark.parametrize("case", ATTENTION_CASES, ids=attention_case_id)
def test_backend_matches_jax_flash_interpret(case, backend):
    check_backend_against_jax_flash(case, backend, _TOL)


def test_resolve_attention_names_the_backends():
    assert resolve_attention("full", causal=True) is causal_attention
    assert resolve_attention("full", causal=False) is full_attention
    for name in ("ring", "ulysses"):
        with pytest.raises(ValueError, match="not ported"):
            resolve_attention(name, causal=True)
    with pytest.raises(ValueError, match="unknown attention backend"):
        resolve_attention("bogus", causal=True)
