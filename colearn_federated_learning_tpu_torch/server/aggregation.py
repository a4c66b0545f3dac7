"""Aggregation and the server optimizer.

The cohort's example-weighted mean delta ``Δ̄ = Σᵢ nᵢ·Δᵢ / Σᵢ nᵢ`` — or,
on the stacked path, a Byzantine-robust aggregate of the ``[K, N]``
delta stack (:func:`robust_reduce`) — is fed to the server optimizer as
the pseudo-gradient ``−Δ̄`` (FedAvg is ``mean`` at ``server_lr=1``;
FedAvgM adds server momentum). Parameters and momentum are flat f32
buffers updated in place.

The robust statistics are ports of the JAX package's
``server/aggregation.py``: unweighted by design, in f32, with
non-participants excluded exactly and every quantity that depends on
the participant count kept on the device, so no route syncs the host.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from colearn_federated_learning_tpu_torch.config import ServerConfig
from colearn_federated_learning_tpu_torch.ops.reduce_apply import (
    fused_reduce_apply,
)
from colearn_federated_learning_tpu_torch.ops.server_apply import (
    fused_delta_apply,
)
from colearn_federated_learning_tpu_torch.utils import trees
from colearn_federated_learning_tpu_torch.utils.trees import ParamLayout


def weighted_delta_mean(deltas: Sequence[trees.Params],
                        weights: Sequence[float]) -> trees.Params:
    """Host-side reference weighted mean over a list of delta dicts."""
    return trees.tree_weighted_mean(deltas, weights)


def robust_reduce(stack: torch.Tensor, participation: torch.Tensor,
                  mode: str, layout: ParamLayout, trim_ratio: float = 0.1,
                  byzantine_f: int = 0) -> torch.Tensor:
    """Byzantine-robust aggregate ``[N]`` of the ``[K, N]`` f32 stack.

    ``participation``: ``[K]`` 0/1 — non-participants are excluded
    exactly: their rows become +inf before a per-coordinate sort, so
    they land past every participant, and the order statistics index
    only the first ``m = Σ participation`` rows. Modes:

    - ``"median"`` — coordinate-wise median over participants;
    - ``"trimmed_mean"`` — drop ``⌊trim_ratio·m⌋`` smallest and largest
      values per coordinate, average the rest;
    - ``"krum"`` — the ONE participant row whose summed squared distance
      to its ``m − byzantine_f − 2`` nearest participants (≥ 1) is
      smallest (:func:`krum_select`).

    ``m == 0`` gives the zero update. Each parameter view of ``layout``
    is reduced in turn, as the JAX package reduces leaf by leaf, which
    bounds the sort's scratch memory."""
    if mode == "krum":
        winner, m = krum_select(stack, participation, byzantine_f, layout)
        return krum_take(stack, winner, m)
    if mode not in ("median", "trimmed_mean"):
        raise ValueError(f"unknown robust aggregator {mode!r}")
    part = participation.to(torch.float32)
    k = part.shape[0]
    m = part.sum().to(torch.int64)
    pb = (part > 0)[:, None]
    iota = torch.arange(k, device=stack.device)[:, None]
    if mode == "median":
        lo = torch.clamp((m - 1) // 2, 0, k - 1).view(1)
        hi = torch.clamp(m // 2, 0, k - 1).view(1)
    else:
        t = torch.floor(trim_ratio * m.to(torch.float32)).to(torch.int64)
        keep = (iota >= t) & (iota < m - t)
        cnt = torch.clamp_min((m - 2 * t).to(torch.float32), 1.0)
    out = torch.empty(stack.shape[1], dtype=torch.float32,
                      device=stack.device)
    for start, end in layout.spans():
        s = torch.sort(torch.where(pb, stack[:, start:end], torch.inf),
                       dim=0).values
        if mode == "median":
            med = 0.5 * (s.index_select(0, lo)[0] + s.index_select(0, hi)[0])
            out[start:end] = torch.where(m > 0, med, 0.0)
        else:
            # zero the dropped rows BEFORE summing: 0·inf would be NaN
            out[start:end] = torch.where(keep, s, 0.0).sum(0) / cnt
    return out


def krum_select(stack: torch.Tensor, participation: torch.Tensor,
                byzantine_f: int, layout: ParamLayout
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selection half of Krum: ``(winner index, participant count)``,
    both 0-dim tensors on the stack's device.

    The pairwise squared distances are summed over the parameter views,
    one ``[K, K]`` Gram per view with the per-view ``max(·, 0)`` clamp,
    as the JAX package sums them over the leaves. ``sq_i + sq_j − 2·xᵢ·xⱼ``
    cancels, so the Gram must run in full f32: this path never enables
    TF32 (``allow_tf32`` / ``set_float32_matmul_precision("high")``),
    and ``Experiment`` turns TF32 off on the card."""
    part = participation.to(torch.float32)
    k = part.shape[0]
    m = part.sum()
    d2 = torch.zeros((k, k), dtype=torch.float32, device=stack.device)
    for start, end in layout.spans():
        x = stack[:, start:end]
        sq = (x * x).sum(-1)
        d2 += torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T),
                              0.0)
    alive = part > 0
    pair_ok = alive[:, None] & alive[None, :]
    d2 = torch.where(pair_ok, d2, torch.inf)
    d2.fill_diagonal_(torch.inf)  # exclude self
    s = torch.sort(d2, dim=1).values  # each row: finite neighbours first
    n_nb = torch.clamp_min(m - byzantine_f - 2, 1.0)
    keep = torch.arange(k, device=stack.device)[None, :] < n_nb
    scores = torch.where(keep, s, 0.0).sum(1)
    # m == 1: the lone participant has no neighbours (score inf) — give
    # it score 0 so argmin still selects a participant
    scores = torch.where(alive & (m > 1), scores,
                         torch.where(alive, 0.0, torch.inf))
    return torch.argmin(scores), m


def krum_take(stack: torch.Tensor, winner: torch.Tensor,
              m: torch.Tensor) -> torch.Tensor:
    """The winner's row, or the zero update when nobody participated
    (every score is inf and argmin would pick a non-participant)."""
    row = stack.index_select(0, winner.view(1))[0]
    return torch.where(m > 0, row, 0.0)


def krum_weights(winner: torch.Tensor, m: torch.Tensor,
                 k: int) -> torch.Tensor:
    """Krum as a weighted sum for the fused kernel: the winner's one-hot
    ``[K]`` row, zeroed when nobody participated."""
    w = torch.zeros(k, dtype=torch.float32, device=winner.device)
    w.scatter_(0, winner.view(1), 1.0)
    return w * (m > 0)


def example_weights(n_ex: torch.Tensor) -> torch.Tensor:
    """FedAvg's ``[K]`` example weights over their sum (1 when nobody
    trained): the fused kernel's contraction is then the finished
    weighted mean."""
    w = n_ex.to(torch.float32)
    w_sum = w.sum()
    return w / torch.where(w_sum > 0, w_sum, torch.ones_like(w_sum))


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

    Under ``cfg.fused_apply`` the returned ``update`` also carries
    ``fused_reduce(params, state, stack, weights) → (state′, Δ̄)``, the
    stacked path's entry: the ``[K, N]`` stack contracted with the
    pre-folded ``[K]`` weights (:func:`example_weights` or
    :func:`krum_weights`) and applied in one pass of the reduce-apply
    kernel (ops/reduce_apply.py).
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

    def fused_reduce(params: torch.Tensor, opt_state: Dict[str, Any],
                     stack: torch.Tensor, weights: torch.Tensor):
        trace = opt_state["opt"].get("trace")
        _, _, mean_delta = fused_reduce_apply(stack, weights, params, lr,
                                              trace, beta)
        return ({"round": opt_state["round"] + 1, "opt": opt_state["opt"]},
                mean_delta)

    if cfg.fused_apply:
        update.fused_reduce = fused_reduce
    return init, update

