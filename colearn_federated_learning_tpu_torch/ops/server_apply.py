"""Fused server apply: the hand-written CUDA kernel, its plain version
and its build.

``fused_delta_apply(params, delta, lr, momentum, beta)`` applies the
cohort's mean delta to the server's flat f32 parameter buffer in place:

- no momentum (``server.optimizer="mean"``): ``p ← p + lr·Δ̄``;
- momentum (``"fedavgm"``): ``m ← β·m − Δ̄;  p ← p − lr·m``,

which is ``optax.sgd(lr, momentum)`` fed ``−Δ̄`` as the gradient. It
replaces the TPU kernel ``_delta_apply_kernel`` reached through
``fused_delta_apply`` in the JAX package's ``ops/pallas_apply.py``.
On a CUDA tensor the wrapper launches ``csrc/server_apply.cu`` or
raises; only a CPU tensor takes the plain version
(:func:`delta_apply_reference`). The JAX package is functional; the
port updates in place because the whole point of the pass is to move
each parameter byte the fewest times.

The kernel is built at first use with ``nvcc`` for ``sm_90a`` into the
repository's ``build/`` directory and loaded with ``ctypes``
(ops/_build.py).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from colearn_federated_learning_tpu_torch.ops._build import CudaLibrary


def _bind(lib: ctypes.CDLL) -> None:
    lib.colearn_delta_apply.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.colearn_delta_apply.restype = ctypes.c_int


LIBRARY = CudaLibrary("server_apply.cu", _bind)
build = LIBRARY.build
library_path = LIBRARY.path


def delta_apply_reference(params: torch.Tensor, delta: torch.Tensor,
                          lr: float, momentum: Optional[torch.Tensor] = None,
                          beta: float = 0.0
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version: new ``(params′, momentum′)`` from torch ops, each
    rounded once in f32 like the kernel."""
    if momentum is None:
        return params + lr * delta, None
    m_new = beta * momentum - delta
    return params - lr * m_new, m_new


def _check(params, delta, momentum):
    tensors = [("params", params), ("delta", delta)]
    if momentum is not None:
        tensors.append(("momentum", momentum))
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D buffer")
        if t.shape != params.shape:
            raise ValueError(
                f"{name} has {t.numel()} elements, params {params.numel()}")
        if t.device != params.device:
            raise ValueError(
                f"{name} is on {t.device}, params on {params.device}")
    if params.numel() == 0:
        raise ValueError("empty parameter buffer")


def fused_delta_apply(params: torch.Tensor, delta: torch.Tensor, lr: float,
                      momentum: Optional[torch.Tensor] = None,
                      beta: float = 0.0
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Apply the mean delta to ``params`` (and ``momentum``) in place and
    return them. Flat contiguous f32 buffers of one length; on CUDA each
    base pointer must be 16-byte aligned (whole fresh buffers are)."""
    _check(params, delta, momentum)
    if params.device.type == "cpu":
        p_new, m_new = delta_apply_reference(params, delta, lr, momentum, beta)
        params.copy_(p_new)
        if momentum is not None:
            momentum.copy_(m_new)
        return params, momentum
    if params.device.type != "cuda":
        raise ValueError(f"unsupported device {params.device}")
    ptrs = [params.data_ptr(), delta.data_ptr()]
    if momentum is not None:
        ptrs.append(momentum.data_ptr())
    if any(p % 16 for p in ptrs):
        raise ValueError("fused_delta_apply needs 16-byte-aligned buffers")
    lib = LIBRARY.load()
    with torch.cuda.device(params.device):
        stream = torch.cuda.current_stream(params.device).cuda_stream
        rc = lib.colearn_delta_apply(
            params.data_ptr(), delta.data_ptr(),
            None if momentum is None else momentum.data_ptr(),
            params.numel(), float(lr), float(beta), stream,
        )
    LIBRARY.check(rc, "colearn_delta_apply")
    fused_delta_apply.launches += 1
    if momentum is not None:
        fused_delta_apply.momentum_launches += 1
    return params, momentum


# kernel launches, all and those of the momentum branch
fused_delta_apply.launches = 0
fused_delta_apply.momentum_launches = 0
