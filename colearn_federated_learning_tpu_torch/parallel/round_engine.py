"""One-device round engine: the main-path subset of the JAX package's
``make_sequential_round_fn`` (its parity oracle).

The cohort's clients train in turn from the same global params; each
delta ``wᵢ − w`` is accumulated in f32 with its example weight ``nᵢ``;
the sum is scaled by ``1 / Σ nᵢ`` (1 when nobody trained) and handed to
the server update. Only the f32 accumulator and one client's local
buffers are live at a time.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from colearn_federated_learning_tpu_torch.client.trainer import (
    make_local_train_fn,
)
from colearn_federated_learning_tpu_torch.utils.trees import ParamLayout


class RoundMetrics(NamedTuple):
    train_loss: torch.Tensor  # example-weighted mean of the client losses
    examples: float  # real examples trained on this round


def make_sequential_round_fn(model, client_cfg, server_update,
                             layout: ParamLayout, local_dtype=None):
    local_train = make_local_train_fn(model, client_cfg, local_dtype)

    def round_fn(params: torch.Tensor, server_opt_state: Dict[str, Any],
                 train_x: torch.Tensor, train_y: torch.Tensor,
                 idx: torch.Tensor, mask: torch.Tensor, n_ex: np.ndarray,
                 step_counts: np.ndarray):
        """One FedAvg round. ``idx``/``mask``: ``[K, steps, batch]`` on
        the device; ``n_ex`` ``[K]`` and ``step_counts`` ``[K, steps]``
        on the host. Updates ``params`` in place and returns
        ``(server_opt_state′, RoundMetrics)``."""
        k = idx.shape[0]
        weights = np.asarray(n_ex, np.float32)
        acc = torch.zeros_like(params, dtype=torch.float32)
        weighted_loss = torch.zeros((), dtype=torch.float32,
                                    device=params.device)
        for c in range(k):
            local, metrics = local_train(params, layout, train_x, train_y,
                                         idx[c], mask[c], step_counts[c])
            w = float(weights[c])
            acc.add_(local.float() - params, alpha=w)
            weighted_loss += w * metrics.loss
            del local
        w_sum = np.float32(weights.sum())
        denom = w_sum if w_sum > 0 else np.float32(1.0)
        mean_delta = acc.mul_(float(np.float32(1.0) / denom))
        new_state = server_update(params, server_opt_state, mean_delta)
        metrics = RoundMetrics(train_loss=weighted_loss / float(denom),
                               examples=float(weights.sum()))
        return new_state, metrics

    return round_fn
