"""Weights bridge flax ↔ port (models/convert.py): names by flax path,
layouts transposed, a round trip bitwise; the port's model has exactly
the JAX model's parameters; the flat f32 server buffer serves views."""

import jax
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu_torch.models import build_model, init_params
from colearn_federated_learning_tpu_torch.models.convert import (
    flax_to_torch,
    torch_to_flax,
)
from colearn_federated_learning_tpu_torch.utils.trees import ParamLayout
from tests.torch_parity import param_shapes

torch.set_num_threads(1)

def _flax_params(name, seed=0, **kw):
    """Random flax params of the JAX model's exact tree (shapes from
    eval_shape — no compile), drawn with numpy."""
    shapes = param_shapes(name, **kw)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("name,kw", [("resnet18", {"width": 8}),
                                     ("resnet18", {}), ("lenet5", {})])
def test_round_trip_bitwise_and_names_match(name, kw):
    fp = _flax_params(name, **kw)
    model = build_model(name, 10, **kw)
    tp = flax_to_torch(fp, model)
    assert list(tp) == [n for n, _ in model.named_parameters()]
    back = torch_to_flax(tp)
    assert jax.tree.structure(back) == jax.tree.structure(fp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(fp)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # the port's own init has the same parameter set and shapes
    own = init_params(model, seed=0)
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in tp.items()}


def test_full_width_resnet18_size():
    fp = _flax_params("resnet18")
    assert len(jax.tree.leaves(fp)) == 62
    assert sum(x.size for x in jax.tree.leaves(fp)) == 11_173_962
    assert ParamLayout.from_params(flax_to_torch(fp)).numel == 11_173_962


def test_layouts():
    fp = _flax_params("resnet18", width=8)
    tp = flax_to_torch(fp)
    k = fp["ResNetBlock_3"]["Conv_1"]["kernel"]  # HWIO
    np.testing.assert_array_equal(
        tp["ResNetBlock_3.Conv_1.weight"].numpy(), k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(tp["Dense_0.weight"].numpy(),
                                  fp["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(tp["GroupNorm_0.weight"].numpy(),
                                  fp["GroupNorm_0"]["scale"])


def test_mismatched_tree_is_rejected():
    fp = _flax_params("lenet5")
    del fp["Dense_1"]
    with pytest.raises(ValueError, match="missing"):
        flax_to_torch(fp, build_model("lenet5", 10))


def test_flat_buffer_views():
    tp = flax_to_torch(_flax_params("lenet5"), build_model("lenet5", 10))
    layout = ParamLayout.from_params(tp)
    flat = layout.flatten(tp)
    assert flat.dtype == torch.float32 and flat.is_contiguous()
    views = layout.views(flat)
    for name in tp:
        assert torch.equal(views[name], tp[name])
    flat.add_(1.0)  # writes through the buffer show in every view
    assert torch.equal(views["Dense_2.bias"], tp["Dense_2.bias"] + 1.0)
