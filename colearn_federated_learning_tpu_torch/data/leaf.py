"""LEAF loaders, copied from the JAX package's ``data/leaf.py`` (its
NumPy and json code), so the same files give bitwise-identical arrays
and natural groups in both packages.

LEAF (Caldas et al. 2018) ships naturally-federated datasets as JSON:
``{"users": [...], "num_samples": [...], "user_data": {user: {"x": ...,
"y": ...}}}``. Each user (FEMNIST: a writer) is one natural group; the
``natural`` partitioner merges groups onto clients without ever
splitting a user. Shakespeare's plain text becomes next-token windows
grouped by speaker turn.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np


def iter_leaf_clients(path: str):
    """Stream ``(user, user_data)`` one ``*.json`` file at a time: host
    memory is O(largest file), never O(directory). Files are visited in
    sorted order and users in file order — the exact stream
    :func:`load_leaf_json_dir` merges. A user appearing in MORE than one
    file is rejected: ``load_leaf_json_dir`` silently keeps the last
    occurrence, but a streaming consumer has already used the first."""
    seen: set = set()
    any_file = False
    for fname in sorted(os.listdir(path)):
        if not fname.endswith(".json"):
            continue
        any_file = True
        with open(os.path.join(path, fname)) as f:
            blob = json.load(f)
        for u in blob["users"]:
            if u in seen:
                raise ValueError(
                    f"LEAF user {u!r} appears in multiple json files "
                    f"under {path} — the streaming store conversion "
                    f"cannot merge split users; re-export the data with "
                    f"one file per user set"
                )
            seen.add(u)
            yield u, blob["user_data"][u]
    if not any_file:
        raise FileNotFoundError(f"no LEAF json files under {path}")


def load_leaf_json_dir(path: str) -> Tuple[Dict[str, dict], List[str]]:
    """Read every ``*.json`` in a LEAF data dir and merge user_data."""
    user_data: Dict[str, dict] = {}
    users: List[str] = []
    for fname in sorted(os.listdir(path)):
        if not fname.endswith(".json"):
            continue
        with open(os.path.join(path, fname)) as f:
            blob = json.load(f)
        for u in blob["users"]:
            if u not in user_data:
                users.append(u)
            user_data[u] = blob["user_data"][u]
    if not users:
        raise FileNotFoundError(f"no LEAF json files under {path}")
    return user_data, users


def load_femnist(data_dir: str, test_fraction: float = 0.1, seed: int = 0):
    """LEAF FEMNIST: 28×28 grayscale flattened to 784 floats, 62 classes.

    Returns (train_x [N,28,28,1], train_y, test_x, test_y, meta) where
    ``meta["natural_groups"]`` holds one index array per writer.
    """
    user_data, users = load_leaf_json_dir(os.path.join(data_dir, "femnist"))
    rng = np.random.default_rng(seed)
    xs, ys, groups = [], [], []
    test_xs, test_ys = [], []
    offset = 0
    for u in users:
        x = np.asarray(user_data[u]["x"], np.float32).reshape(-1, 28, 28, 1)
        y = np.asarray(user_data[u]["y"], np.int32)
        n_test = max(1, int(len(x) * test_fraction)) if len(x) > 1 else 0
        perm = rng.permutation(len(x))
        test_ix, train_ix = perm[:n_test], perm[n_test:]
        xs.append(x[train_ix])
        ys.append(y[train_ix])
        test_xs.append(x[test_ix])
        test_ys.append(y[test_ix])
        groups.append(np.arange(offset, offset + len(train_ix), dtype=np.int64))
        offset += len(train_ix)
    meta = {"source": "real", "input_shape": (28, 28, 1), "natural_groups": groups}
    return (
        np.concatenate(xs), np.concatenate(ys),
        np.concatenate(test_xs), np.concatenate(test_ys), meta,
    )


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
