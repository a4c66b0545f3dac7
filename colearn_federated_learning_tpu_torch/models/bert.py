"""BERT-tiny as a causal next-token LM, as in the JAX package's
``models/bert.py``: L = 2 pre-LN blocks of hidden 128, 2 heads and FF
512 over a character vocabulary of 90, learned positions, a final
LayerNorm and a head tied to the embedding.

Parity with flax: the qkv projection is one Dense of width 3·hidden
split ``[q | k | v]``; ``nn.gelu`` is the tanh approximation; the
positions are a top-level param sliced to T; the tied head runs in the
table's dtype (bf16 in local training under ``local_param_dtype``, f32
on the server's params at eval) and its logits are cast to f32.
Attention goes through ops/backends.py: ``full`` (the default),
``blockwise`` or ``pallas`` (the hand-written CUDA kernel).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from colearn_federated_learning_tpu_torch.models.layers import (
    Dense,
    Embed,
    LayerNorm,
)
from colearn_federated_learning_tpu_torch.ops.attention import (
    causal_attention,
)
from colearn_federated_learning_tpu_torch.ops.backends import (
    resolve_attention,
)


class TransformerBlock(nn.Module):
    def __init__(self, hidden: int, heads: int, ff: int, compute_dtype,
                 attention_fn: Callable):
        super().__init__()
        cd = compute_dtype
        self.heads, self.attention_fn = heads, attention_fn
        self.LayerNorm_0 = LayerNorm(hidden, compute_dtype=cd)
        self.Dense_0 = Dense(hidden, 3 * hidden, dtype=cd)
        self.Dense_1 = Dense(hidden, hidden, dtype=cd)
        self.LayerNorm_1 = LayerNorm(hidden, compute_dtype=cd)
        self.Dense_2 = Dense(hidden, ff, dtype=cd)
        self.Dense_3 = Dense(ff, hidden, dtype=cd)

    def forward(self, x):
        q, k, v = self.Dense_0(self.LayerNorm_0(x)).chunk(3, dim=-1)
        x = x + self.Dense_1(self.attention_fn(q, k, v, self.heads))
        h = F.gelu(self.Dense_2(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_3(h)


class BertTinyLM(nn.Module):
    def __init__(self, vocab_size: int = 90, seq_len: int = 80,
                 hidden: int = 128, heads: int = 2, layers: int = 2,
                 ff: int = 512, compute_dtype=torch.float32,
                 attention_fn: Callable = causal_attention):
        super().__init__()
        cd = compute_dtype
        self.compute_dtype, self.layers = cd, layers
        self.Embed_0 = Embed(vocab_size, hidden)
        self.pos_embedding = nn.Parameter(torch.empty(seq_len, hidden))
        for i in range(layers):
            self.add_module(f"TransformerBlock_{i}", TransformerBlock(
                hidden, heads, ff, cd, attention_fn))
        self.LayerNorm_0 = LayerNorm(hidden, compute_dtype=cd)

    def forward(self, tokens):
        """tokens: ``[B, T]`` ints → f32 logits ``[B, T, vocab]``."""
        cd = self.compute_dtype
        x = self.Embed_0(tokens).to(cd)
        x = x + self.pos_embedding[:tokens.shape[1]].to(cd)[None]
        for i in range(self.layers):
            x = getattr(self, f"TransformerBlock_{i}")(x)
        x = self.LayerNorm_0(x)
        table = self.Embed_0.embedding
        return self.Embed_0.attend(x.to(table.dtype)).float()


def bert_tiny(num_classes: int = 0, vocab_size: int = 90, seq_len: int = 80,
              hidden: int = 128, heads: int = 2, layers: int = 2,
              ff: int = 512, attention: str = "full", block_size: int = 128,
              compute_dtype=torch.float32) -> BertTinyLM:
    """The JAX builder's kwargs; ``num_classes`` is unused (the output
    width is the vocabulary)."""
    del num_classes
    attn = resolve_attention(attention, causal=True, block_size=block_size)
    return BertTinyLM(vocab_size=vocab_size, seq_len=seq_len, hidden=hidden,
                      heads=heads, layers=layers, ff=ff,
                      compute_dtype=compute_dtype, attention_fn=attn)
