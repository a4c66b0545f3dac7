"""Model zoo of the port: ``resnet18``, ``lenet5``, ``mobilenetv2``
(28×28×1 inputs) and ``bert_tiny``.

:func:`build_model` returns a module on the ``meta`` device (shapes
only); parameters live outside it as ``dict[str, Tensor]`` keyed by
flax path (see models/layers.py and models/convert.py).
"""

from __future__ import annotations

import inspect
import torch
from torch import nn

from colearn_federated_learning_tpu_torch.models.bert import bert_tiny
from colearn_federated_learning_tpu_torch.models.layers import init_params  # noqa: F401
from colearn_federated_learning_tpu_torch.models.lenet import LeNet5
from colearn_federated_learning_tpu_torch.models.mobilenet import MobileNetV2
from colearn_federated_learning_tpu_torch.models.resnet import ResNet18
from colearn_federated_learning_tpu_torch.utils.registry import Registry

model_registry = Registry("model")
model_registry.register("resnet18")(ResNet18)
model_registry.register("lenet5")(LeNet5)
model_registry.register("mobilenetv2")(MobileNetV2)
model_registry.register("bert_tiny")(bert_tiny)


def build_model(name: str, num_classes: int,
                compute_dtype=torch.float32, **kwargs) -> nn.Module:
    """Instantiate a zoo model (on the meta device). Unknown ``name``
    and unknown ``kwargs`` raise a ValueError naming the allowed set."""
    try:
        cls = model_registry.get(name)
    except KeyError:
        raise ValueError(
            f"unknown model.name {name!r}; known models: "
            f"{', '.join(model_registry.names())}"
        ) from None
    allowed = set(inspect.signature(cls).parameters) - {
        "num_classes", "compute_dtype", "stage_sizes"}
    unknown = set(kwargs) - allowed
    if unknown:
        raise ValueError(
            f"unknown model.kwargs for {name!r}: {', '.join(sorted(unknown))}"
            f"; allowed kwargs: {', '.join(sorted(allowed)) or '(none)'}"
        )
    with torch.device("meta"):
        return cls(num_classes=num_classes, compute_dtype=compute_dtype,
                   **kwargs)
