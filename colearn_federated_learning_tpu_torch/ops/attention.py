"""Attention ops, as the JAX package's ``ops/attention.py``.

``causal_attention`` and ``full_attention`` take packed ``[B, T, D]``
q/k/v and the head count, and return ``[B, T, D]``. They keep the JAX
package's order of rounding: q is scaled in its own dtype before the
product, masked scores get ``finfo(scores.dtype).min``, and the softmax
runs in f32 and is cast back to v's dtype before the second product.
"""

from __future__ import annotations

from typing import Optional

import torch


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """``[B, T, D]`` → ``[B, H, T, D/H]``."""
    b, t, d = x.shape
    return x.reshape(b, t, heads, d // heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, T, hd]`` → ``[B, T, H·hd]``."""
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def multihead_attention(q, k, v, heads: int,
                        mask: Optional[torch.Tensor] = None):
    """``[B, T, D]`` q/k/v → ``[B, T, D]``; ``mask`` broadcasts to
    ``[B, H, T, T]`` (True = keep)."""
    q, k, v = (split_heads(x, heads) for x in (q, k, v))
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q * scale, k.transpose(-1, -2))
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    att = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    return merge_heads(torch.matmul(att, v))


def causal_attention(q, k, v, heads: int):
    t = q.shape[1]
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    return multihead_attention(q, k, v, heads, mask)


def full_attention(q, k, v, heads: int):
    return multihead_attention(q, k, v, heads, None)
