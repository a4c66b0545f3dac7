"""PyTorch/CUDA port of colearn-tpu's federated-learning simulator.

A second package beside ``colearn_federated_learning_tpu`` (the JAX
reference it is held against), mirroring its layout: ``config``,
``data/``, ``models/``, ``client/trainer``, ``server/aggregation``,
``parallel/round_engine``, ``server/round_driver``, ``ops/`` and
``cli``. It imports nothing of the JAX package and no JAX. The server
apply is a hand-written CUDA kernel (``ops/csrc/server_apply.cu``).
Entry point: ``python -m colearn_federated_learning_tpu_torch``.
"""
