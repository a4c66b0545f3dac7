"""Blockwise (flash-style) attention on one device, as the JAX
package's ``ops/ring_attention.py`` ``blockwise_attention``: the online
softmax over k/v blocks in f32, with O(T·block) live scores. Its
recurrence, :func:`online_softmax_attention`, is also the plain version
of the flash-attention kernel, and ``ops/flash_attention.py``'s backward
recomputes through it. The ring and Ulysses variants need several devices and are
not ported yet.
"""

from __future__ import annotations

import torch

from colearn_federated_learning_tpu_torch.ops.attention import (
    merge_heads,
    split_heads,
)

NEG_BIG = -1e30


def online_softmax_attention(q, k, v, tile: int, causal: bool = True):
    """The online softmax over k/v tiles of ``tile`` keys (the last tile
    may be shorter) on ``[..., T, hd]`` rows: q scaled in f32, f32
    scores and accumulators, masked scores at ``NEG_BIG`` and their p
    re-zeroed, the output ``acc / max(l, 1e-30)`` in q's dtype."""
    t, hd = q.shape[-2:]
    qf = q.float() * hd**-0.5
    q_pos = torch.arange(t, device=q.device)
    acc = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    m = torch.full(qf.shape[:-1] + (1,), NEG_BIG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    for k0 in range(0, t, tile):
        k_blk = k[..., k0:k0 + tile, :].float()
        v_blk = v[..., k0:k0 + tile, :].float()
        s = torch.matmul(qf, k_blk.transpose(-1, -2))
        keep = None
        if causal:
            k_pos = k0 + torch.arange(k_blk.shape[-2], device=q.device)
            keep = q_pos[:, None] >= k_pos[None, :]
            s = torch.where(keep, s, NEG_BIG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        if keep is not None:
            p = torch.where(keep, p, 0.0)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, v_blk)
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)


def blockwise_attention(q, k, v, heads: int, block_size: int,
                        causal: bool = True):
    """``[B, T, D]`` q/k/v → ``[B, T, D]``; T must be a multiple of
    ``block_size``."""
    qh, kh, vh = (split_heads(x, heads) for x in (q, k, v))
    t = qh.shape[2]
    if t % block_size:
        raise ValueError(
            f"blockwise_attention requires the sequence length to be a "
            f"block_size multiple, got t={t}, block_size={block_size}")
    return merge_heads(online_softmax_attention(qh, kh, vh, block_size,
                                                causal))
