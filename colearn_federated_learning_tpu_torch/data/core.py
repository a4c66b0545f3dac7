"""Dataset registry and loaders (MNIST, CIFAR-10, FEMNIST, Shakespeare).

Each loader first looks for real data files under ``data_dir``
(keras-style ``mnist.npz``, the CIFAR-10 python pickles, LEAF's FEMNIST
json under ``femnist/``, whose writers become the ``natural``
partition's groups). When they are
absent and ``synthetic_fallback`` is on, a deterministic, learnable
synthetic stand-in of the same shapes, dtypes and class structure is
generated instead; ``meta["source"]`` records which. The NumPy code is
copied from the JAX package's ``data/core.py`` so that the same config
and seed give bitwise-identical corpora in both packages.

Shakespeare is a next-token task (``task="lm"``): ``[N, T]`` int32
windows of characters and their ``[N, T]`` next characters, from
``shakespeare.txt`` under ``data_dir`` (data/leaf.py) or, without it, a
fixed sparse Markov chain over the vocabulary.

Images stay raw uint8 NHWC on the host; the driver moves the corpus to
the device once per run and scales it there (client/trainer.py
``normalize_input``).
"""

from __future__ import annotations

import logging
import os
import pickle
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np

from colearn_federated_learning_tpu_torch.config import DataConfig
from colearn_federated_learning_tpu_torch.data import partition as partition_lib
from colearn_federated_learning_tpu_torch.data.leaf import (
    load_femnist,
    load_shakespeare_text,
)
from colearn_federated_learning_tpu_torch.utils.registry import Registry

dataset_registry = Registry("dataset")


@dataclass
class FederatedData:
    """A dataset plus its federated structure: flat example arrays and
    one int array of example ids per client."""

    train_x: np.ndarray
    train_y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray
    client_indices: List[np.ndarray]
    num_classes: int
    task: str = "classify"
    meta: Dict[str, Any] = field(default_factory=dict)

    @property
    def num_clients(self) -> int:
        return len(self.client_indices)

    def client_sizes(self) -> np.ndarray:
        return np.array([len(ix) for ix in self.client_indices], np.int64)


def _synthetic_images(rng: np.random.Generator, n: int, templates: np.ndarray,
                      template_weight: float = 0.7):
    """Class-template images + noise: x = w·template[y] + (1−w)·noise.
    The same templates generate train and test, so the task is
    learnable in a handful of rounds. Stored as raw uint8."""
    num_classes, shape = templates.shape[0], templates.shape[1:]
    w = float(template_weight)
    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    noise = rng.uniform(0.0, 1.0, size=(n,) + tuple(shape)).astype(np.float32)
    x = w * templates[y] + (1.0 - w) * noise
    return np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8), y


def _synthetic_text(rng: np.random.Generator, n: int, seq_len: int, vocab: int,
                    successors: np.ndarray):
    """Sequences from a fixed sparse Markov chain: each symbol has 4
    plausible successors, so next-token prediction is learnable well
    above chance. The caller draws ``successors`` once and shares it
    between the train and the test split."""
    seqs = np.empty((n, seq_len + 1), np.int32)
    state = rng.integers(0, vocab, size=n)
    seqs[:, 0] = state
    for t in range(1, seq_len + 1):
        choice = rng.integers(0, 4, size=n)
        state = successors[seqs[:, t - 1], choice]
        seqs[:, t] = state
    return seqs[:, :-1].copy(), seqs[:, 1:].copy()


def _stable_seed(name: str) -> int:
    # abs(hash()) is salted per-process; datasets must be reproducible
    return int.from_bytes(name.encode(), "little") % (2**31)


def _scaled_train_size(cfg: DataConfig) -> int:
    """Synthetic corpora must be big enough to partition: ≥32 examples
    per client on average."""
    return max(cfg.synthetic_train_size, cfg.num_clients * 32)


def _image_loader(name: str, shape, num_classes: int, real_fn):
    def load(cfg: DataConfig, **_model_kwargs):
        shp = tuple(shape)
        data_dir = os.path.expanduser(cfg.data_dir)
        real = real_fn(data_dir)
        extra_meta = {}
        if real is not None:
            # extra_meta: the loader's own (e.g. LEAF's natural_groups)
            tx, ty, ex, ey, extra_meta = real
            source = "real"
            shp = tuple(tx.shape[1:])
        elif cfg.synthetic_fallback:
            rng = np.random.default_rng(_stable_seed(name))
            n_train = _scaled_train_size(cfg)
            templates = rng.uniform(
                0.0, 1.0, size=(num_classes,) + shp
            ).astype(np.float32)
            w = cfg.synthetic_template_weight
            tx, ty = _synthetic_images(rng, n_train, templates, w)
            ex, ey = _synthetic_images(
                rng, cfg.synthetic_test_size, templates, w
            )
            source = "synthetic"
        else:
            raise FileNotFoundError(
                f"{name}: no data under {data_dir} and synthetic_fallback=False"
            )
        meta = {"source": source, "input_shape": shp, **extra_meta}
        return tx, ty, ex, ey, meta, num_classes, "classify"

    return load


def _try_mnist_real(data_dir: str):
    path = os.path.join(data_dir, "mnist.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as d:
        tx = d["x_train"].astype(np.uint8)[..., None]
        ex = d["x_test"].astype(np.uint8)[..., None]
        return (tx, d["y_train"].astype(np.int32), ex,
                d["y_test"].astype(np.int32), {})


def _try_cifar10_real(data_dir: str):
    base = os.path.join(data_dir, "cifar-10-batches-py")
    if not os.path.isdir(base):
        return None

    def read(fname):
        with open(os.path.join(base, fname), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return np.ascontiguousarray(x), np.array(d[b"labels"], np.int32)

    xs, ys = zip(*[read(f"data_batch_{i}") for i in range(1, 6)])
    tx, ty = np.concatenate(xs), np.concatenate(ys)
    ex, ey = read("test_batch")
    return tx, ty, ex, ey, {}


def _try_femnist_real(data_dir: str):
    if not os.path.isdir(os.path.join(data_dir, "femnist")):
        return None
    return load_femnist(data_dir)


dataset_registry.register("mnist")(
    _image_loader("mnist", (28, 28, 1), 10, _try_mnist_real))
dataset_registry.register("cifar10")(
    _image_loader("cifar10", (32, 32, 3), 10, _try_cifar10_real))
dataset_registry.register("femnist")(
    _image_loader("femnist", (28, 28, 1), 62, _try_femnist_real))


@dataset_registry.register("shakespeare")
def _load_shakespeare(cfg: DataConfig, vocab_size: int = 90, seq_len: int = 80,
                      **_model_kwargs):
    data_dir = os.path.expanduser(cfg.data_dir)
    txt = os.path.join(data_dir, "shakespeare.txt")
    if os.path.exists(txt):
        tx, ty, ex, ey, meta = load_shakespeare_text(txt, vocab_size, seq_len)
        return tx, ty, ex, ey, meta, vocab_size, "lm"
    if not cfg.synthetic_fallback:
        raise FileNotFoundError(f"shakespeare: no data under {data_dir}")
    rng = np.random.default_rng(1207)
    successors = rng.integers(0, vocab_size, size=(vocab_size, 4))
    tx, ty = _synthetic_text(rng, _scaled_train_size(cfg), seq_len,
                             vocab_size, successors)
    ex, ey = _synthetic_text(rng, cfg.synthetic_test_size, seq_len,
                             vocab_size, successors)
    meta = {"source": "synthetic", "input_shape": (seq_len,)}
    return tx, ty, ex, ey, meta, vocab_size, "lm"


def build_federated_data(cfg: DataConfig, seed: int = 0,
                         **model_kwargs) -> FederatedData:
    """Load a dataset and partition it into ``cfg.num_clients`` shards.
    ``model_kwargs`` reach the loader (Shakespeare reads ``vocab_size``
    and ``seq_len``). An LM task partitions on each window's first
    token."""
    loader = dataset_registry.get(cfg.name)
    tx, ty, ex, ey, meta, num_classes, task = loader(cfg, **model_kwargs)
    labels = ty if task == "classify" else ty[:, 0]
    part_info: dict = {}
    client_indices = partition_lib.partition(
        cfg.partition,
        labels=labels,
        num_clients=cfg.num_clients,
        num_classes=(num_classes if task == "classify"
                     else int(labels.max()) + 1),
        alpha=cfg.dirichlet_alpha,
        seed=seed,
        natural_groups=meta.get("natural_groups"),
        info=part_info,
    )
    meta = dict(meta, partition=cfg.partition, **part_info)
    if part_info.get("repair_used"):
        logging.getLogger(__name__).warning(
            "%s partition (dirichlet alpha=%s) needed deterministic repair: "
            "%d example(s) moved from the largest shards to starved ones",
            cfg.partition, part_info.get("repair_alpha"),
            part_info.get("repair_moved", 0),
        )
    return FederatedData(
        train_x=tx, train_y=ty, test_x=ex, test_y=ey,
        client_indices=client_indices, num_classes=num_classes, task=task,
        meta=meta,
    )
