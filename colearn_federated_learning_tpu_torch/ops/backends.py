"""Attention backends by name, as the JAX package's ``ops/backends.py``
``resolve_attention``: each returns a ``(q, k, v, heads) → out``
callable on packed ``[B, T, D]`` tensors, and all are exact.

- ``full`` — T×T scores (ops/attention.py);
- ``blockwise`` — the online softmax over k/v blocks
  (ops/ring_attention.py);
- ``pallas`` — the name the configs use for the fused kernel; in the
  port it selects the hand-written CUDA kernel (ops/flash_attention.py).

``ring`` and ``ulysses`` need several devices and are not ported yet.
"""

from __future__ import annotations

from functools import partial

from colearn_federated_learning_tpu_torch.ops.attention import (
    causal_attention,
    full_attention,
)

BACKENDS = ("full", "blockwise", "pallas")
NOT_PORTED = ("ring", "ulysses")


def resolve_attention(name: str, *, causal: bool, block_size: int = 128):
    """The ``(q, k, v, heads) → out`` callable of backend ``name``."""
    if name in NOT_PORTED:
        raise ValueError(
            f"attention backend {name!r} is not ported to the PyTorch "
            f"package yet (it needs several devices); ported: "
            f"{list(BACKENDS)}")
    if name not in BACKENDS:
        raise ValueError(f"unknown attention backend {name!r}; supported: "
                         f"{list(BACKENDS)}")
    if name == "full":
        return causal_attention if causal else full_attention
    if name == "blockwise":
        from colearn_federated_learning_tpu_torch.ops.ring_attention import (
            blockwise_attention,
        )

        return partial(blockwise_attention, block_size=block_size,
                       causal=causal)
    from colearn_federated_learning_tpu_torch.ops.flash_attention import (
        flash_attention,
    )

    return partial(flash_attention, causal=causal, block_q=block_size,
                   block_kv=block_size)
