"""Per-client local trainer: E epochs of masked minibatch SGD.

``local_train`` takes the server's flat f32 params and the loader's
``[steps, batch]`` index/mask grid, casts the params ONCE to the local
dtype (``run.local_param_dtype``: bf16 on the headline config, so the
whole local phase runs in bf16 while the server trajectory stays f32),
and returns the client's trained flat buffer. Batches are gathered on
the device from the device-resident corpus.

Semantics follow the JAX package's fused scalar-gated SGD step
(``client/trainer.py`` ``_make_step``), in its order:

1. FedProx's pull ``g ← g + μ·(p − p₀)`` (``client.prox_mu``), with p₀
   the round's params cast to the local dtype — a copy kept beside the
   buffer that trains;
2. momentum ``m ← β·m + g``;
3. ``p ← p − lr·m``, with ``lr`` rounded to the parameter dtype first,
   as its ``lr_eff.astype(p.dtype)`` does; μ and β are rounded to it as
   well.

A padded step (all-zero mask, v = 0) is an exact no-op there
(``lr_eff = β_eff − 1 = 0``); here the host knows the mask, so the step
is not run at all, which leaves params and momentum bitwise unchanged in
the same way.

Tasks: ``classify`` (``y`` ``[B]``) and ``lm`` (``y`` ``[B, T]`` next
tokens: per-token cross-entropy and accuracy, each a mean over T, then
the masked mean over the batch).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from colearn_federated_learning_tpu_torch.config import ClientConfig
from colearn_federated_learning_tpu_torch.utils.trees import ParamLayout


class LocalMetrics(NamedTuple):
    loss: torch.Tensor  # mask-weighted mean train loss over the round
    examples: float  # real examples processed


def normalize_input(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 images are stored raw; scale to [0, 1] in ``dtype`` as
    ``x.astype(dtype) * dtype(1/255)`` (uint8 values are exact in bf16,
    so the only rounding is the product's). Other inputs, such as an LM's
    integer tokens, pass through."""
    if x.dtype == torch.uint8:
        return x.to(dtype) * torch.tensor(1.0 / 255.0, dtype=dtype,
                                          device=x.device)
    return x


def _cross_entropy(logits, y, task: str):
    """Per-example softmax cross-entropy of f32 logits; ``lm`` takes the
    mean over the tokens of each example."""
    ce = F.cross_entropy(logits.flatten(0, -2), y.flatten().long(),
                         reduction="none")
    return ce if task == "classify" else ce.view(y.shape).mean(-1)


def make_loss_fn(model, task: str = "classify"):
    """Masked mean softmax cross-entropy on ``model``'s f32 logits;
    inputs are scaled straight into the model's compute dtype."""
    in_dtype = getattr(model, "compute_dtype", torch.float32)

    def loss_fn(params, x, y, m):
        logits = functional_call(model, params, (normalize_input(x, in_dtype),))
        ce = _cross_entropy(logits.float(), y, task)
        return (ce * m).sum() / torch.clamp_min(m.sum(), 1.0)

    return loss_fn


def round_to_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` as the nearest number representable in ``dtype``."""
    return torch.tensor(value, dtype=dtype).item()


def make_local_train_fn(model, client_cfg: ClientConfig,
                        local_dtype: Optional[torch.dtype] = None,
                        task: str = "classify"):
    grad_loss = make_loss_fn(model, task)
    beta = client_cfg.momentum
    mu = client_cfg.prox_mu

    def local_train(global_flat: torch.Tensor, layout: ParamLayout,
                    train_x: torch.Tensor, train_y: torch.Tensor,
                    idx: torch.Tensor, mask: torch.Tensor,
                    step_counts: np.ndarray):
        """idx/mask: ``[steps, batch]`` on the device; ``step_counts``:
        the host's ``mask.sum(-1)``. Returns ``(local flat params,
        LocalMetrics)``; ``global_flat`` is not modified."""
        dtype = local_dtype or global_flat.dtype
        flat = global_flat.to(dtype=dtype, copy=True)
        params = layout.views(flat)
        leaves = list(params.values())
        # p₀: the round's params in the local dtype, beside the buffer
        # that trains
        anchor = (list(layout.views(flat.clone()).values()) if mu > 0.0
                  else None)
        for t in leaves:
            t.requires_grad_(True)
        moms = None
        if beta:
            moms = list(layout.views(torch.zeros_like(flat)).values())
        lr_c = round_to_dtype(client_cfg.lr, dtype)
        beta_c = round_to_dtype(beta, dtype)
        mu_c = round_to_dtype(mu, dtype)
        loss_sum = torch.zeros((), dtype=torch.float32, device=flat.device)
        for s in range(idx.shape[0]):
            n = float(step_counts[s])
            if n == 0.0:
                continue  # padded step: an exact no-op (see module doc)
            ids = idx[s]
            loss = grad_loss(params, train_x[ids], train_y[ids], mask[s])
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                if anchor is not None:  # ∇ of μ/2‖p − p₀‖²
                    pull = torch._foreach_sub(leaves, anchor)
                    torch._foreach_mul_(pull, mu_c)
                    grads = torch._foreach_add(grads, pull)
                direction = grads
                if moms is not None:
                    torch._foreach_mul_(moms, beta_c)
                    torch._foreach_add_(moms, grads)
                    direction = moms
                torch._foreach_sub_(leaves, torch._foreach_mul(direction, lr_c))
                loss_sum += loss.detach() * n
        for t in leaves:
            t.requires_grad_(False)
        n_total = float(np.sum(step_counts))
        return flat, LocalMetrics(loss=loss_sum / max(n_total, 1.0),
                                  examples=n_total)

    return local_train


def make_eval_fn(model, task: str = "classify"):
    """Masked eval of one batch → ``(sum_loss, sum_correct, n)`` tensors.
    Inputs are scaled in f32; the model casts them to its compute dtype."""

    @torch.no_grad()
    def eval_batch(params, x, y, m):
        logits = functional_call(model, params, (normalize_input(x),)).float()
        ce = _cross_entropy(logits, y, task)
        correct = (logits.argmax(-1) == y).float()
        if task != "classify":
            correct = correct.mean(-1)
        return (ce * m).sum(), (correct * m).sum(), m.sum()

    return eval_batch
