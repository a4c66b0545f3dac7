"""BERT-tiny LM parity of the PyTorch port vs the JAX package, at a small
geometry (hidden 32, 2 heads, 2 layers, FF 64, T = 16) with
``block_size=8`` so that the ``pallas`` backend runs several tiles.

- Logits at f32 within 1e-4 of ``model.apply`` on numpy-made params
  carried across by ``flax_to_torch``, for ``full``, ``blockwise`` and
  ``pallas`` (the JAX side of ``pallas`` runs the Pallas kernel in
  interpret mode; the port's runs the plain version of its CUDA kernel).
- The ``lm`` loss and eval sums against the JAX trainer's.
- A flax → torch → flax round trip of the params is bitwise.

One ``lm`` round against the JAX oracle is in
tests/test_torch_bert_round.py.
"""

import jax
import numpy as np
import pytest
import torch
from torch.func import functional_call

from colearn_federated_learning_tpu.client.trainer import (
    make_eval_fn as jeval_fn,
)
from colearn_federated_learning_tpu.client.trainer import (
    make_loss_fn as jloss_fn,
)
from colearn_federated_learning_tpu_torch.client.trainer import (
    make_eval_fn,
    make_loss_fn,
)
from colearn_federated_learning_tpu_torch.models import build_model
from colearn_federated_learning_tpu_torch.models.convert import (
    flax_to_torch,
    torch_to_flax,
)
from tests.torch_parity import jax_model, model_params

torch.set_num_threads(1)

_KW = dict(vocab_size=90, seq_len=16, hidden=32, heads=2, layers=2, ff=64,
           block_size=8)
_ATOL = 1e-4
_RTOL = 1e-3


def _tokens(seed, n=3):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, _KW["vocab_size"], (n, _KW["seq_len"]))
    y = rng.integers(0, _KW["vocab_size"], (n, _KW["seq_len"]))
    return x.astype(np.int32), y.astype(np.int32)


@pytest.mark.parametrize("attention", ["full", "blockwise", "pallas"])
def test_bert_logits_match_jax(attention):
    jm = jax_model("bert_tiny", attention=attention, **_KW)
    fp = model_params("bert_tiny", 7, **_KW)
    x, _ = _tokens(0)
    want = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x))(fp, x))
    model = build_model("bert_tiny", 0, attention=attention, **_KW)
    got = functional_call(model, flax_to_torch(fp, model),
                          (torch.from_numpy(x),))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=_ATOL,
                               rtol=0)


def test_lm_loss_and_eval_match_jax():
    """Per-token CE, mean over T, masked mean; eval sums of loss and
    per-token accuracy (mean over T)."""
    jm = jax_model("bert_tiny", attention="full", **_KW)
    fp = model_params("bert_tiny", 7, **_KW)
    x, y = _tokens(1, n=4)
    m = np.array([1.0, 1.0, 0.0, 1.0], np.float32)
    want_loss = float(jax.jit(jloss_fn(jm, "lm"))(fp, x, y, m))
    want_eval = [float(v) for v in jax.jit(jeval_fn(jm, "lm"))(fp, x, y, m)]
    model = build_model("bert_tiny", 0, **_KW)
    tp = flax_to_torch(fp, model)
    args = (torch.from_numpy(x), torch.from_numpy(y).long(),
            torch.from_numpy(m))
    got_loss = float(make_loss_fn(model, "lm")(tp, *args))
    got_eval = [float(v) for v in make_eval_fn(model, "lm")(tp, *args)]
    np.testing.assert_allclose(got_loss, want_loss, atol=_ATOL, rtol=_RTOL)
    np.testing.assert_allclose(got_eval, want_eval, atol=_ATOL, rtol=_RTOL)


def test_params_round_trip_bitwise():
    fp = model_params("bert_tiny", 7, **_KW)
    model = build_model("bert_tiny", 0, **_KW)
    tp = flax_to_torch(fp, model)
    assert list(tp) == [n for n, _ in model.named_parameters()]
    assert "pos_embedding" in tp and "Embed_0.embedding" in tp
    back = torch_to_flax(tp)
    assert jax.tree.structure(back) == jax.tree.structure(fp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(fp)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_builder_rejects_what_the_port_lacks():
    with pytest.raises(ValueError, match="not ported"):
        build_model("bert_tiny", 0, attention="ring")
    with pytest.raises(ValueError, match="unknown model.kwargs"):
        build_model("bert_tiny", 0, depth=3)
    model = build_model("bert_tiny", 0, compute_dtype=torch.bfloat16)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes["Embed_0.embedding"] == (90, 128)
    assert shapes["pos_embedding"] == (80, 128)
    assert shapes["TransformerBlock_1.Dense_0.weight"] == (384, 128)
    assert shapes["TransformerBlock_1.Dense_2.weight"] == (512, 128)
