"""Flash attention: the hand-written CUDA kernel, its plain version and
its gradient.

``flash_attention(q, k, v, heads, causal, block_q, block_kv)`` takes
packed ``[B, T, D]`` q/k/v like the JAX package's
``ops/pallas_attention.py`` ``flash_attention`` and returns ``[B, T, D]``
in q's dtype. It replaces the TPU kernel ``_attn_kernel`` reached through
``_flash_fwd_impl``: an online softmax over k/v tiles with f32 scores and
accumulators, scores of masked keys at −1e30, and the output
``acc / max(l, 1e−30)`` rounded once to the input dtype.

- **Forward.** The heads are split into ``[B·H, T, hd]``. On a CUDA
  tensor the wrapper launches ``csrc/flash_attention.cu`` (f32 or bf16,
  hd ∈ {16, 32, 64, 128}, any T, causal or not; both on the tensor
  cores, f32 through the 3xTF32 split, reading 16-byte-aligned q, k, v)
  or raises; only a CPU tensor takes the plain version
  (:func:`attention_reference`), which
  runs ``ops/ring_attention.py``'s online-softmax recurrence over the TPU
  kernel's k/v tiles in torch ops.
  ``flash_attention.launches`` counts the kernel's launches, and
  ``flash_attention.f32_launches`` those of its f32 branch.
- **Backward.** The TPU kernel has no backward kernel: the reference
  recomputes the gradient through the XLA blockwise recurrence
  (``_flash_bwd``). The port does the same in plain torch through
  ``ops/ring_attention.py`` ``blockwise_attention``: directly when T is
  a multiple of the block, zero-padded for a ragged causal T (padded
  keys lie past every real query), and through ``full_attention`` for a
  ragged non-causal T. A hand-written backward kernel is later work.

The kernel is built at first use with ``nvcc`` for ``sm_90a`` into the
repository's ``build/`` directory and loaded with ``ctypes``
(ops/_build.py).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from colearn_federated_learning_tpu_torch.ops._build import CudaLibrary
from colearn_federated_learning_tpu_torch.ops.attention import (
    full_attention,
    merge_heads,
    split_heads,
)
from colearn_federated_learning_tpu_torch.ops.ring_attention import (
    blockwise_attention,
    online_softmax_attention,
)

HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    lib.colearn_flash_attention.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.colearn_flash_attention.restype = ctypes.c_int


LIBRARY = CudaLibrary("flash_attention.cu", _bind)


def _tiles(t: int, block_q: int, block_kv: int) -> int:
    """The TPU kernel's k/v tile: ``min(block_kv, T)``, collapsed to the
    smaller block when T divides neither."""
    bq, bkv = min(block_q, t), min(block_kv, t)
    if t % bq or t % bkv:
        bkv = min(bq, bkv)
    return bkv


def attention_reference(q, k, v, causal: bool = True, block_q: int = 128,
                        block_kv: int = 128):
    """The plain version on ``[B·H, T, hd]``: the TPU kernel's online
    softmax over its k/v tiles, for all queries at once. A tile that a
    query may not see contributes exactly nothing (its correction factor
    is 1 and its p is 0), so skipping it, as the kernels do, gives the
    same numbers."""
    return online_softmax_attention(
        q, k, v, _tiles(q.shape[1], block_q, block_kv), causal)


def _check(q, k, v):
    if q.dim() != 3:
        raise ValueError(f"q must be [B·H, T, hd], got shape {tuple(q.shape)}")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"{name} is {tuple(x.shape)} {x.dtype} on {x.device}, q is "
                f"{tuple(q.shape)} {q.dtype} on {q.device}")


def _launch(q, k, v, causal: bool):
    bh, t, hd = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {hd}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")
    if bh == 0 or t == 0:
        raise ValueError(f"empty attention input {tuple(q.shape)}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention kernel needs 16-byte-aligned q, "
                         "k, v")
    out = torch.empty_like(q)
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.colearn_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, t,
            hd, _DTYPE_CODES[q.dtype], int(causal), float(hd**-0.5), stream)
    LIBRARY.check(rc, "colearn_flash_attention")
    flash_attention.launches += 1
    if q.dtype == torch.float32:
        flash_attention.f32_launches += 1
    return out


def attention_forward(q, k, v, causal: bool = True, block_q: int = 128,
                      block_kv: int = 128):
    """Forward attention on ``[B·H, T, hd]``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors (``block_q``/``block_kv``
    set its tiles; the kernel tiles for the card)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal, block_q, block_kv)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k, v, causal)


def _to_rows(x, heads):
    b, t, _ = x.shape
    xh = split_heads(x, heads)
    return xh.reshape(b * heads, t, xh.shape[-1])


def _flash_packed(q, k, v, heads, causal, block_q, block_kv):
    b, t, _ = q.shape
    out = attention_forward(_to_rows(q, heads), _to_rows(k, heads),
                            _to_rows(v, heads), causal, block_q, block_kv)
    return merge_heads(out.reshape(b, heads, t, -1))


def _recompute_grads(q, k, v, g, heads, causal, block):
    """``_flash_bwd`` of the JAX package: the vjp of the plain recurrence
    at the saved q, k, v."""
    t = q.shape[1]
    if t % block == 0:
        ref, args, cot = (lambda a, b, c: blockwise_attention(
            a, b, c, heads, block, causal)), (q, k, v), g
    elif causal:
        pad = ((t + block - 1) // block) * block - t
        args = tuple(F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
        cot = F.pad(g, (0, 0, 0, pad))
        ref = (lambda a, b, c: blockwise_attention(a, b, c, heads, block,
                                                   True))
    else:
        ref, args, cot = (lambda a, b, c: full_attention(a, b, c, heads)), \
            (q, k, v), g
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in args]
        grads = torch.autograd.grad(ref(*leaves), leaves, cot)
    return tuple(x[:, :t] for x in grads)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, heads, causal, block_q, block_kv):
        ctx.save_for_backward(q, k, v)
        ctx.config = (heads, causal, min(block_q, block_kv, q.shape[1]))
        return _flash_packed(q, k, v, heads, causal, block_q, block_kv)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        heads, causal, block = ctx.config
        dq, dk, dv = _recompute_grads(q, k, v, g.contiguous(), heads, causal,
                                      block)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, heads: int, causal: bool = True,
                    block_q: int = 128, block_kv: int = 128):
    """``[B, T, D]`` packed q/k/v → ``[B, T, D]``: the kernel's forward,
    the recomputed backward."""
    return _FlashAttention.apply(q, k, v, heads, causal, block_q, block_kv)


# kernel launches (CUDA tensors only), all and those of the f32 branch
flash_attention.launches = 0
flash_attention.f32_launches = 0
