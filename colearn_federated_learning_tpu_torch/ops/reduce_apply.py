"""Fused reduce + server apply: the hand-written CUDA kernel, its plain
version and the stack it reads.

``fused_reduce_apply(stack, weights, params, lr, momentum, beta)``
contracts the cohort's ``[K, N]`` f32 upload stack with pre-folded
``[K]`` weights into the aggregate ``Δ̄ = Σₖ wₖ·Sₖ`` and applies it to the
server's flat f32 params in the same pass:

- no momentum (``server.optimizer="mean"``): ``p ← p + lr·Δ̄``;
- momentum (``"fedavgm"``): ``m ← β·m − Δ̄;  p ← p − lr·m``.

``Δ̄`` is written out too. The weights carry everything multiplicative:
the FedAvg weight over the weight sum, or Krum's one-hot winner row. It
replaces the TPU kernel ``_reduce_apply_kernel`` reached through
``fused_reduce_apply`` in the JAX package's ``ops/pallas_apply.py``. On
CUDA tensors the wrapper launches ``csrc/reduce_apply.cu`` or raises;
only CPU tensors take the plain version (:func:`reduce_apply_reference`).

The kernel loads each stack row as float4, so every row must start on a
16-byte boundary: :func:`new_stack` allocates the rows ``ld`` floats
apart with ``ld`` rounded up to a multiple of 4 (ResNet-18's
11,173,962 parameters are 2 mod 4, so a dense stack's odd rows would
start 8 bytes off).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from colearn_federated_learning_tpu_torch.ops._build import CudaLibrary
from colearn_federated_learning_tpu_torch.ops.server_apply import (
    delta_apply_reference,
)

MAX_ROWS = 12288  # the kernel keeps the weights in 48 KB of shared memory


def _bind(lib: ctypes.CDLL) -> None:
    lib.colearn_reduce_apply.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.colearn_reduce_apply.restype = ctypes.c_int


LIBRARY = CudaLibrary("reduce_apply.cu", _bind)


def new_stack(k: int, n: int, device) -> torch.Tensor:
    """An uninitialised ``[k, n]`` f32 stack whose rows lie a multiple of
    4 floats apart (a view into a ``[k, ld]`` buffer)."""
    ld = (n + 3) // 4 * 4
    return torch.empty((k, ld), dtype=torch.float32, device=device)[:, :n]


def reduce_apply_reference(stack: torch.Tensor, weights: torch.Tensor,
                           params: torch.Tensor, lr: float,
                           momentum: Optional[torch.Tensor] = None,
                           beta: float = 0.0):
    """The plain version: new ``(params′, momentum′, Δ̄)`` from torch ops,
    the rows summed in the kernel's order and each product and sum
    rounded once in f32, as the kernel does."""
    delta = torch.zeros(stack.shape[1], dtype=torch.float32,
                        device=stack.device)
    for k in range(stack.shape[0]):
        delta = delta + weights[k] * stack[k]
    p_new, m_new = delta_apply_reference(params, delta, lr, momentum, beta)
    return p_new, m_new, delta


def _check(stack, weights, params, momentum, delta):
    flat = [("params", params), ("delta", delta)]
    if momentum is not None:
        flat.append(("momentum", momentum))
    for name, t in flat + [("stack", stack), ("weights", weights)]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != params.device:
            raise ValueError(
                f"{name} is on {t.device}, params on {params.device}")
    for name, t in flat:
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D buffer")
        if t.shape != params.shape:
            raise ValueError(
                f"{name} has {t.numel()} elements, params {params.numel()}")
    if params.numel() == 0:
        raise ValueError("empty parameter buffer")
    if (stack.dim() != 2 or stack.shape[1] != params.numel()
            or stack.stride(1) != 1):
        raise ValueError(
            f"stack must be [K, {params.numel()}] with unit column stride, "
            f"got shape {tuple(stack.shape)} strides {stack.stride()}")
    k = stack.shape[0]
    if not 1 <= k <= MAX_ROWS:
        raise ValueError(f"stack has {k} rows; the kernel takes 1..{MAX_ROWS}")
    if weights.shape != (k,) or not weights.is_contiguous():
        raise ValueError(f"weights must be a contiguous [{k}] vector, got "
                         f"{tuple(weights.shape)}")


def fused_reduce_apply(stack: torch.Tensor, weights: torch.Tensor,
                       params: torch.Tensor, lr: float,
                       momentum: Optional[torch.Tensor] = None,
                       beta: float = 0.0,
                       delta: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                  torch.Tensor]:
    """Reduce ``stack`` with ``weights`` into ``delta`` (allocated when not
    given) and apply it to ``params`` (and ``momentum``) in place; returns
    ``(params, momentum, delta)``. On CUDA the stack's rows and every
    buffer must start on a 16-byte boundary (see :func:`new_stack`)."""
    if delta is None:
        delta = torch.empty_like(params)
    _check(stack, weights, params, momentum, delta)
    if params.device.type == "cpu":
        p_new, m_new, d_new = reduce_apply_reference(
            stack, weights, params, lr, momentum, beta)
        params.copy_(p_new)
        delta.copy_(d_new)
        if momentum is not None:
            momentum.copy_(m_new)
        return params, momentum, delta
    if params.device.type != "cuda":
        raise ValueError(f"unsupported device {params.device}")
    ld = stack.stride(0)
    ptrs = [stack.data_ptr(), params.data_ptr(), delta.data_ptr()]
    if momentum is not None:
        ptrs.append(momentum.data_ptr())
    if ld % 4 or any(p % 16 for p in ptrs):
        raise ValueError(
            "fused_reduce_apply needs 16-byte-aligned buffers and stack "
            f"rows a multiple of 4 floats apart (row stride {ld}); "
            "allocate the stack with new_stack")
    lib = LIBRARY.load()
    with torch.cuda.device(params.device):
        stream = torch.cuda.current_stream(params.device).cuda_stream
        rc = lib.colearn_reduce_apply(
            stack.data_ptr(), ld, stack.shape[0], weights.data_ptr(),
            params.data_ptr(),
            None if momentum is None else momentum.data_ptr(),
            delta.data_ptr(), params.numel(), float(lr), float(beta), stream,
        )
    LIBRARY.check(rc, "colearn_reduce_apply")
    fused_reduce_apply.launches += 1
    if momentum is not None:
        fused_reduce_apply.momentum_launches += 1
    return params, momentum, delta


# kernel launches, all and those of the momentum branch
fused_reduce_apply.launches = 0
fused_reduce_apply.momentum_launches = 0
