"""The port's round at the main path's dtype: bf16 local params.

An element-wise pin is impossible at bf16, since the two frameworks
round at different places. What must hold is that the port's bf16 round
lands as close to the f32 result as the reference's own bf16 round
does:

    ‖Δ_port,bf16 − Δ_jax,f32‖ ≤ 1.25 · ‖Δ_jax,bf16 − Δ_jax,f32‖,

with Δ the round's parameter delta over the whole model, every round
from the same numpy params and inputs (tests/torch_parity.py), f32
compute, and ``local_dtype`` bf16 on both sides. LeNet runs 5 local
steps here; ResNet-18 at width 8 two steps in
tests/test_torch_resnet_bf16.py; BERT-tiny's case is in
tests/test_torch_bert_round.py.
"""

import numpy as np
import torch

from colearn_federated_learning_tpu_torch.models.convert import flax_to_torch
from tests.torch_parity import (
    LR,
    flat_delta,
    jax_round,
    model_params,
    port_round,
    round_inputs,
)

torch.set_num_threads(1)

_BOUND = 1.25


def bf16_distances(name, dataset, cohort_size, cap, server, lr=LR,
                   client=None, **kw):
    """(‖Δ_port,bf16 − Δ_jax,f32‖, ‖Δ_jax,bf16 − Δ_jax,f32‖), relative to
    ‖Δ_jax,f32‖. ``client``: extra ClientConfig fields, as
    tests/torch_parity.py takes them; ``kw``: model kwargs."""
    start = flax_to_torch(model_params(name, 7, **kw))
    args = (name, dataset, cohort_size, cap, server)
    kw = dict(kw, lr=lr, client=client)
    want = flat_delta(flax_to_torch(jax_round(*args, **kw)[0]), start)
    ref = flat_delta(flax_to_torch(jax_round(
        *args, local_dtype="bfloat16", **kw)[0]), start)
    flat, layout, _, _ = port_round(*args, local_dtype=torch.bfloat16, **kw)
    got = flat_delta(layout.views(flat), start)
    scale = np.linalg.norm(want)
    return (np.linalg.norm(got - want) / scale,
            np.linalg.norm(ref - want) / scale)


def check_bf16_bound(name, dataset, cohort_size, cap, steps, fused, **kw):
    """The bound on the round of tests/test_torch_round.py's ``mean``
    case with the same cohort, cap, server step and ``fused``, so the
    f32 oracle round is that test's own (cached by tests/torch_parity.py)."""
    mask = round_inputs(dataset, cohort_size, cap, **kw)[2]
    assert mask.shape[1] == steps
    server = dict(optimizer="mean", server_lr=0.8, server_momentum=0.9,
                  fused_apply=fused)
    port, ref = bf16_distances(name, dataset, cohort_size, cap, server,
                               **kw)
    assert 0.0 < ref and port <= _BOUND * ref, (port, ref)


def test_lenet_bf16_round_within_the_references_bf16_distance():
    """The round of tests/test_torch_round.py's [mean-False] case: cohort
    3, cap 40, 5 steps of batch 8."""
    check_bf16_bound("lenet5", "mnist", 3, 40, 5, fused=False)
