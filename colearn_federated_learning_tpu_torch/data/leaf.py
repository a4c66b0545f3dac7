"""Shakespeare text → next-token windows, copied from the JAX package's
``data/leaf.py`` (its NumPy-only character path), so the same file
gives bitwise-identical windows and natural groups in both packages.
The LEAF JSON loaders (FEMNIST) are not ported yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def build_char_vocab(text: str, vocab_size: int) -> Dict[str, int]:
    """Most-frequent chars get ids [1, vocab); id 0 is <unk>."""
    counts: Dict[str, int] = {}
    for ch in text:
        counts[ch] = counts.get(ch, 0) + 1
    ranked = sorted(counts, key=lambda c: (-counts[c], c))[: vocab_size - 1]
    return {ch: i + 1 for i, ch in enumerate(ranked)}


def encode_chars(text: str, vocab: Dict[str, int]) -> np.ndarray:
    return np.array([vocab.get(ch, 0) for ch in text], np.int32)


def load_shakespeare_text(path: str, vocab_size: int, seq_len: int,
                          test_fraction: float = 0.1):
    """Plain-text Shakespeare → next-token windows.

    Speaker turns (blank-line-separated blocks) act as the natural groups
    when the LEAF per-character json is not available; each block's
    windows stay together, approximating LEAF's per-role split.
    """
    with open(path, encoding="utf-8", errors="replace") as f:
        text = f.read()
    vocab = build_char_vocab(text, vocab_size)
    blocks = [b for b in text.split("\n\n") if len(b) > seq_len + 1]
    xs, ys, groups = [], [], []
    offset = 0
    for block in blocks:
        ids = encode_chars(block, vocab)
        n_win = (len(ids) - 1) // seq_len
        if n_win == 0:
            continue
        ids = ids[: n_win * seq_len + 1]
        x = np.stack([ids[i * seq_len : (i + 1) * seq_len] for i in range(n_win)])
        y = np.stack([ids[i * seq_len + 1 : (i + 1) * seq_len + 1] for i in range(n_win)])
        xs.append(x)
        ys.append(y)
        groups.append(np.arange(offset, offset + n_win, dtype=np.int64))
        offset += n_win
    if not xs:
        raise ValueError(f"{path}: no usable text blocks of length > {seq_len}")
    x, y = np.concatenate(xs), np.concatenate(ys)
    n_test = max(1, int(len(x) * test_fraction))
    # last windows as test (preserves group structure of the train prefix)
    train_x, test_x = x[:-n_test], x[-n_test:]
    train_y, test_y = y[:-n_test], y[-n_test:]
    groups = [g[g < len(train_x)] for g in groups]
    groups = [g for g in groups if len(g)]
    meta = {"source": "real", "input_shape": (seq_len,), "natural_groups": groups}
    return train_x, train_y, test_x, test_y, meta
