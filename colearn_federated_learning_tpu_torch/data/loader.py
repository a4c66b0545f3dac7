"""Round-batch construction: every client-round is padded to the same
``[steps, batch]`` grid of example indices, with the true example counts
riding along for the FedAvg weighted sum.

The NumPy code is copied from the JAX package's ``data/loader.py`` so
that the same cohort, shape and RNG give bitwise-identical idx/mask
arrays in both packages (its ``run.host_pipeline="numpy"`` path). The
index tensors are tiny; the driver gathers the examples on the device
against the device-resident corpus.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

from colearn_federated_learning_tpu_torch.config import ClientConfig, DataConfig
from colearn_federated_learning_tpu_torch.data.core import FederatedData


@dataclass(frozen=True)
class RoundShape:
    """Static shape of one client-round."""

    local_epochs: int
    steps_per_epoch: int
    batch_size: int
    cap: int  # max examples a client contributes per epoch

    @property
    def steps(self) -> int:
        return self.local_epochs * self.steps_per_epoch


def compute_round_shape(
    fed: FederatedData, client_cfg: ClientConfig, data_cfg: DataConfig
) -> RoundShape:
    sizes = fed.client_sizes()
    cap = data_cfg.max_examples_per_client or int(sizes.max())
    cap = min(cap, int(sizes.max()))
    steps_per_epoch = max(1, math.ceil(cap / client_cfg.batch_size))
    return RoundShape(
        local_epochs=client_cfg.local_epochs,
        steps_per_epoch=steps_per_epoch,
        batch_size=client_cfg.batch_size,
        cap=cap,
    )


def _round_draws(rng: np.random.Generator, k: int, max_len: int,
                 cap_eff: int, local_epochs: int):
    """The round's host randomness, drawn as two dense blocks: ``sel`` keys order each client's shard (cap
    subsampling = the first ``cap`` of that order), ``perm`` keys order
    each epoch's selected subset."""
    sel = rng.random((k, max_len))
    perm = rng.random((k, local_epochs, cap_eff))
    return sel, perm


def make_round_spec(
    fed: FederatedData,
    cohort_ids: Sequence[int],
    shape: RoundShape,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build (idx, spec, n_examples) for one round's cohort.

    idx:        [K, steps, batch] int32 — gather indices into train_x/
                train_y; padding positions point at index 0. Real
                indices pack CONTIGUOUSLY at the head of each epoch
                block — the invariant that makes the mask derivable.
    spec:       [K, 2] int32 — (examples per epoch, valid steps). The
                full float32 validity mask is ``mask_from_spec(spec,
                shape)``.
    n_examples: [K] float32 — real examples processed this round (the
                FedAvg weight; proportional to |D_i| at equal epochs).

    Fully vectorized over (clients × epochs). The random draws depend
    only on the cohort's shard lengths and the cap, never on the grid
    shape.
    """
    k = len(cohort_ids)
    steps, batch = shape.steps, shape.batch_size
    epochs, per_epoch = shape.local_epochs, shape.steps_per_epoch * batch
    if k == 0:
        return (
            np.zeros((0, steps, batch), np.int32),
            np.zeros((0, 2), np.int32),
            np.zeros((0,), np.float32),
        )
    shards = [np.asarray(fed.client_indices[c]) for c in cohort_ids]
    lens = np.array([len(s) for s in shards], np.int64)
    max_len = int(lens.max()) if k else 0
    take = np.minimum(lens, shape.cap)
    cap_eff = int(take.max())
    if cap_eff > per_epoch:
        raise ValueError(
            f"round grid holds {per_epoch} examples/epoch but the cohort "
            f"max is {cap_eff} — steps_per_epoch={shape.steps_per_epoch} "
            f"is too small for this cohort"
        )
    sel_keys, perm_keys = _round_draws(rng, k, max_len, cap_eff, epochs)

    # padded [K, max_len] shard matrix; rows shorter than max_len carry
    # +inf selection keys so their tail never sorts into the head
    row_pos = np.arange(max_len)[None, :]
    in_shard = row_pos < lens[:, None]
    padded = np.zeros((k, max_len), np.int64)
    if max_len:
        padded[in_shard] = np.concatenate(shards)
        sel_keys = np.where(in_shard, sel_keys, np.inf)
    order = np.argsort(sel_keys, axis=1, kind="stable")
    # chosen[i, :take[i]] is a uniform random subset (and order) of the
    # shard — cap subsampling and full-shard selection in one expression
    chosen = np.take_along_axis(padded, order, axis=1)[:, :cap_eff]

    # per-epoch permutation of each client's selected subset
    sel_pos = np.arange(cap_eff)[None, None, :]
    keyed = np.where(sel_pos < take[:, None, None], perm_keys, np.inf)
    ep_order = np.argsort(keyed, axis=2, kind="stable")
    perm = np.take_along_axis(
        np.broadcast_to(chosen[:, None, :], (k, epochs, cap_eff)),
        ep_order, axis=2,
    )

    # pack: epoch block e of row i holds perm[i, e, :take[i]] first,
    # zeros after (contiguous padding — the mask-spec invariant)
    idx = np.zeros((k, epochs, per_epoch), np.int32)
    valid = np.broadcast_to(sel_pos < take[:, None, None], perm.shape)
    idx[:, :, :cap_eff][valid] = perm[valid].astype(np.int32)
    spec = np.stack(
        [take.astype(np.int64), np.full(k, steps, np.int64)], axis=1
    ).astype(np.int32)
    n_examples = (take * epochs).astype(np.float32)
    return idx.reshape(k, steps, batch), spec, n_examples


def mask_from_spec(spec: np.ndarray, shape: RoundShape) -> np.ndarray:
    """Expand a ``[K, 2]`` spec into the full ``[K, steps, batch]``
    float32 validity mask (0.0/1.0 exactly)."""
    return expand_mask_spec(
        np.asarray(spec), shape.steps, shape.batch_size, shape.local_epochs
    )


def expand_mask_spec(spec: np.ndarray, steps: int, batch: int,
                     local_epochs: int) -> np.ndarray:
    """Shape-parameter form of :func:`mask_from_spec`. A position is valid iff its flat
    offset within its epoch block is below the client's per-epoch
    example count AND its step is below the client's valid-step bound."""
    if steps % local_epochs:
        raise ValueError(
            f"steps={steps} not a multiple of local_epochs={local_epochs}"
        )
    spe = steps // local_epochs
    s = np.arange(steps)[None, :, None]
    b = np.arange(batch)[None, None, :]
    pos = (s % spe) * batch + b
    n_ep = spec[:, 0][:, None, None]
    vsteps = spec[:, 1][:, None, None]
    return ((pos < n_ep) & (s < vsteps)).astype(np.float32)


def make_round_indices(
    fed: FederatedData,
    cohort_ids: Sequence[int],
    shape: RoundShape,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build (idx, mask, n_examples) for one round's cohort.

    ``mask`` is the [K, steps, batch] float32 validity mask, expanded
    host-side from the compact spec.
    """
    idx, spec, n_examples = make_round_spec(fed, cohort_ids, shape, rng)
    return idx, mask_from_spec(spec, shape), n_examples


def eval_batches(x: np.ndarray, y: np.ndarray, batch_size: int):
    """Pad the test set to a whole number of fixed-size batches.

    Returns (x_batches [B, batch, ...], y_batches, mask [B, batch])  so the
    eval loop sees one static batch shape.
    """
    n = len(x)
    if n == 0:
        # padding repeats x[:1]; an empty split has no row to repeat
        raise ValueError(
            "eval_batches requires at least one example; got an empty "
            "array (empty client shard or empty test split)"
        )
    n_batches = max(1, math.ceil(n / batch_size))
    total = n_batches * batch_size
    pad = total - n
    xp = np.concatenate([x, np.repeat(x[:1], pad, axis=0)]) if pad else x
    yp = np.concatenate([y, np.repeat(y[:1], pad, axis=0)]) if pad else y
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    return (
        xp.reshape((n_batches, batch_size) + x.shape[1:]),
        yp.reshape((n_batches, batch_size) + y.shape[1:]),
        mask.reshape(n_batches, batch_size),
    )
