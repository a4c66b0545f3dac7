"""One ``lm`` FedAvg round of BERT-tiny through the PyTorch port vs the
JAX sequential oracle (``make_sequential_round_fn(..., "lm", ...)``), at
the small geometry of tests/test_torch_bert.py: atol 1e-4 / rtol 1e-3
at f32 under ``full`` and ``pallas`` (the JAX side of ``pallas`` runs
the Pallas kernel in interpret mode), and the bf16 bound of
tests/test_torch_round_bf16.py under ``pallas``."""

import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu_torch.models.convert import flax_to_torch
from colearn_federated_learning_tpu_torch.ops import flash_attention as fa
from tests.test_torch_bert import _ATOL, _KW, _RTOL
from tests.test_torch_round_bf16 import bf16_distances
from tests.torch_parity import jax_round, port_round

torch.set_num_threads(1)

# one round: 2 clients of the natural split, 2 local steps of batch 8,
# the preset's lr
_ROUND = dict(cohort_size=2, cap=16, server=dict(optimizer="mean",
                                                 server_lr=1.0), lr=0.5)


@pytest.mark.parametrize("attention", ["full", "pallas"])
def test_lm_round_matches_jax(attention):
    kw = dict(_KW, attention=attention)
    before = fa.flash_attention.launches
    jp, _, jloss, jexamples = jax_round("bert_tiny", "shakespeare", **_ROUND,
                                        **kw)
    flat, layout, topt, tmet = port_round("bert_tiny", "shakespeare",
                                          **_ROUND, **kw)
    assert fa.flash_attention.launches == before  # CPU: the plain version
    assert topt["round"] == 1 and tmet.examples == jexamples
    want = flax_to_torch(jp)
    for name, t in layout.views(flat).items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                   atol=_ATOL, rtol=_RTOL, err_msg=name)
    np.testing.assert_allclose(float(tmet.train_loss), jloss, atol=_ATOL,
                               rtol=_RTOL)


def test_lm_bf16_round_within_the_references_bf16_distance():
    """The bound of tests/test_torch_round_bf16.py, BERT-tiny under the
    path's ``pallas`` backend."""
    rnd = dict(_ROUND)
    port, ref = bf16_distances("bert_tiny", "shakespeare",
                               rnd.pop("cohort_size"), rnd.pop("cap"),
                               rnd.pop("server"), attention="pallas", **rnd,
                               **_KW)
    assert 0.0 < ref and port <= 1.25 * ref, (port, ref)
