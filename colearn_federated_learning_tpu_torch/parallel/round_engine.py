"""One-device round engine: the port's subset of the JAX package's
``make_sequential_round_fn`` (its parity oracle).

The cohort's clients train in turn from the same global params. On the
plain FedAvg path each delta ``wᵢ − w`` is accumulated in f32 with its
example weight ``nᵢ``; the sum is scaled by ``1 / Σ nᵢ`` (1 when nobody
trained) and handed to the server update. Only the f32 accumulator and
one client's local buffers are live at a time.

A robust aggregator or an upload attack needs the per-client uploads
(the stacked path): each client's f32 delta is written into row ``c`` of
one preallocated ``[K, N]`` stack (ops/reduce_apply.py ``new_stack``),
the attack transforms the compromised rows in place, and then:

- with ``server.fused_apply`` and ``weighted_mean`` or ``krum``, the
  stack goes through the reduce-apply kernel with pre-folded weights
  (the example weights over their sum, or Krum's one-hot winner row),
  which writes the aggregate and applies it in one pass;
- otherwise ``robust_reduce`` or ``stack_weighted_mean`` forms the
  aggregate and the server update applies it.

Krum's winner stays on the device, so no route syncs the host.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from colearn_federated_learning_tpu_torch.client.trainer import (
    make_local_train_fn,
)
from colearn_federated_learning_tpu_torch.config import AGGREGATORS
from colearn_federated_learning_tpu_torch.ops.reduce_apply import new_stack
from colearn_federated_learning_tpu_torch.server.aggregation import (
    example_weights,
    krum_select,
    krum_take,
    krum_weights,
    robust_reduce,
)
from colearn_federated_learning_tpu_torch.server.attacks import (
    UPLOAD_ATTACKS,
    apply_upload_attack,
    stack_weighted_mean,
)
from colearn_federated_learning_tpu_torch.utils.trees import ParamLayout


class RoundMetrics(NamedTuple):
    train_loss: torch.Tensor  # example-weighted mean of the client losses
    examples: float  # real examples trained on this round
    # Krum's selected cohort slot (0-dim, on the device); None otherwise
    krum_winner: Optional[torch.Tensor] = None


def make_sequential_round_fn(model, client_cfg, server_update,
                             layout: ParamLayout, local_dtype=None,
                             aggregator: str = "weighted_mean",
                             trim_ratio: float = 0.1, byzantine_f: int = 0,
                             attack: str = "", attack_scale: float = 10.0,
                             attack_eps: float = 1.0, task: str = "classify"):
    """``round_fn`` for one cohort; ``attack`` is an upload attack or ""
    (label_flip acts on the host data and needs nothing here); ``task``
    is ``classify`` or ``lm``.
    ``round_fn.upload_stack`` builds one round's attacked stack alone."""
    if aggregator not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {aggregator!r}")
    if attack and attack not in UPLOAD_ATTACKS:
        raise ValueError(f"unknown upload attack {attack!r}")
    local_train = make_local_train_fn(model, client_cfg, local_dtype, task)
    stacked = aggregator != "weighted_mean" or bool(attack)
    fused_reduce = getattr(server_update, "fused_reduce", None)

    def train_cohort(params, train_x, train_y, idx, mask, weights,
                     step_counts, sink):
        """Train each client in turn and hand its local params to
        ``sink(c, local)``; returns the example-weighted loss sum."""
        weighted_loss = torch.zeros((), dtype=torch.float32,
                                    device=params.device)
        for c in range(idx.shape[0]):
            local, metrics = local_train(params, layout, train_x, train_y,
                                         idx[c], mask[c], step_counts[c])
            sink(c, local)
            weighted_loss += float(weights[c]) * metrics.loss
        return weighted_loss

    def upload_stack(params, train_x, train_y, idx, mask, n_ex, step_counts,
                     byz=None):
        """``([K, N] f32 stack of the cohort's deltas, attack applied,
        example-weighted loss sum)``."""
        stack = new_stack(idx.shape[0], params.numel(), params.device)

        def write_row(c, local):
            stack[c].copy_(local).sub_(params)

        weighted_loss = train_cohort(params, train_x, train_y, idx, mask,
                                     n_ex, step_counts, write_row)
        if attack:
            dev = params.device
            apply_upload_attack(
                stack, torch.as_tensor(byz, dtype=torch.float32, device=dev),
                attack, attack_scale, attack_eps,
                participation=torch.as_tensor(n_ex, device=dev) > 0)
        return stack, weighted_loss

    def aggregate_stack(params, opt_state, stack, n_ex):
        """Route the stack to the server step; returns
        ``(state′, Δ̄, Krum's winner or None)``."""
        n_ex_d = torch.as_tensor(np.asarray(n_ex, np.float32),
                                 device=params.device)
        part = n_ex_d > 0
        winner = None
        if aggregator == "krum":
            winner, m = krum_select(stack, part, byzantine_f, layout)
        if fused_reduce is not None and aggregator in ("weighted_mean",
                                                       "krum"):
            w = (krum_weights(winner, m, stack.shape[0]) if winner is not None
                 else example_weights(n_ex_d))
            new_state, mean_delta = fused_reduce(params, opt_state, stack, w)
            return new_state, mean_delta, winner
        if winner is not None:
            mean_delta = krum_take(stack, winner, m)
        elif aggregator != "weighted_mean":
            mean_delta = robust_reduce(stack, part, aggregator, layout,
                                       trim_ratio, byzantine_f)
        else:
            mean_delta = stack_weighted_mean(stack, n_ex_d)
        return server_update(params, opt_state, mean_delta), mean_delta, winner

    def round_fn(params: torch.Tensor, server_opt_state: Dict[str, Any],
                 train_x: torch.Tensor, train_y: torch.Tensor,
                 idx: torch.Tensor, mask: torch.Tensor, n_ex: np.ndarray,
                 step_counts: np.ndarray, byz: Optional[np.ndarray] = None):
        """One round. ``idx``/``mask``: ``[K, steps, batch]`` on the
        device; ``n_ex`` ``[K]``, ``step_counts`` ``[K, steps]`` and, under
        an upload attack, the ``[K]`` 0/1 byzantine mask ``byz`` on the
        host. Updates ``params`` in place and returns
        ``(server_opt_state′, RoundMetrics)``."""
        if attack and byz is None:
            raise TypeError(f"attack={attack!r} requires the byz mask input")
        weights = np.asarray(n_ex, np.float32)
        w_sum = np.float32(weights.sum())
        denom = w_sum if w_sum > 0 else np.float32(1.0)
        winner = None
        if stacked:
            stack, weighted_loss = upload_stack(
                params, train_x, train_y, idx, mask, weights, step_counts,
                byz)
            new_state, _, winner = aggregate_stack(
                params, server_opt_state, stack, weights)
            del stack
        else:
            acc = torch.zeros_like(params, dtype=torch.float32)

            def accumulate(c, local):
                acc.add_(local.float() - params, alpha=float(weights[c]))

            weighted_loss = train_cohort(params, train_x, train_y, idx, mask,
                                         weights, step_counts, accumulate)
            mean_delta = acc.mul_(float(np.float32(1.0) / denom))
            new_state = server_update(params, server_opt_state, mean_delta)
        metrics = RoundMetrics(train_loss=weighted_loss / float(denom),
                               examples=float(weights.sum()),
                               krum_winner=winner)
        return new_state, metrics

    round_fn.upload_stack = upload_stack
    return round_fn
