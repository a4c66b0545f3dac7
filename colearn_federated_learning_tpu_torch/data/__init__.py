"""Data layer: dataset loaders, federated partitioners and the
static-shape round-batch index builder (NumPy, host-side)."""

from colearn_federated_learning_tpu_torch.data.core import (  # noqa: F401
    FederatedData,
    build_federated_data,
    dataset_registry,
)
