"""Aggregation and the server optimizer.

The cohort's example-weighted mean delta ``Δ̄ = Σᵢ nᵢ·Δᵢ / Σᵢ nᵢ`` is fed
to the server optimizer as the pseudo-gradient ``−Δ̄`` (FedAvg is
``mean`` at ``server_lr=1``; FedAvgM adds server momentum). Parameters
and momentum are flat f32 buffers updated in place.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from colearn_federated_learning_tpu_torch.config import ServerConfig
from colearn_federated_learning_tpu_torch.ops.server_apply import (
    fused_delta_apply,
)
from colearn_federated_learning_tpu_torch.utils import trees


def weighted_delta_mean(deltas: Sequence[trees.Params],
                        weights: Sequence[float]) -> trees.Params:
    """Host-side reference weighted mean over a list of delta dicts."""
    return trees.tree_weighted_mean(deltas, weights)


def make_server_update_fn(cfg: ServerConfig):
    """``(init, update)``: ``init(params) → state`` and
    ``update(params, state, mean_delta) → state′`` with ``params`` (and
    the momentum inside ``state``) updated in place.

    The state keeps the JAX package's ``{"round", "opt"}`` shape: a
    round counter beside the optimizer state, here ``{"trace": m}``
    under ``fedavgm`` and ``{}`` under ``mean``. ``cfg.fused_apply``
    routes the update to the CUDA kernel (ops/server_apply.py);
    otherwise it runs ``optax.sgd(server_lr, momentum)``'s chain in
    plain torch ops. The two agree in f32: the kernel's
    ``β·m − Δ̄`` is optax's ``g + β·m`` with ``g = −Δ̄``.
    """
    if cfg.optimizer not in ("mean", "fedavgm"):
        raise ValueError(
            f"the port's server optimizer is mean or fedavgm, not "
            f"{cfg.optimizer!r}")
    has_mom = cfg.optimizer == "fedavgm"
    beta = cfg.server_momentum if has_mom else 0.0
    lr = cfg.server_lr

    def init(params: torch.Tensor) -> Dict[str, Any]:
        opt = {"trace": torch.zeros_like(params)} if has_mom else {}
        return {"round": 0, "opt": opt}

    def update(params: torch.Tensor, opt_state: Dict[str, Any],
               mean_delta: torch.Tensor) -> Dict[str, Any]:
        trace = opt_state["opt"].get("trace")
        if cfg.fused_apply:
            fused_delta_apply(params, mean_delta, lr, trace, beta)
        else:
            grad = -mean_delta
            if trace is not None:
                trace.copy_(grad + beta * trace)
                grad = trace
            params.add_(-lr * grad)
        return {"round": opt_state["round"] + 1, "opt": opt_state["opt"]}

    return init, update

