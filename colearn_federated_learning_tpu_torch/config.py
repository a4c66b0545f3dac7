"""Experiment configuration for the PyTorch port.

Typed dataclasses holding the fields the port's main path reads, with
the same names and defaults as the JAX package's ``config.py``, so a
``--set a.b=v`` override means the same thing in both. Unknown keys
raise, as they do there. Named presets: ``mnist_fedavg_2`` (the CPU
smoke), ``cifar10_fedavg_100`` (the headline workload),
``cifar10_fedavg_1000`` (the same workload over 1000 clients, cohort
64), ``cifar10_krum_byzantine`` (the headline federation under a
sign-flipping adversary, defended by Krum), ``femnist_fedprox_500``
(FedProx of MobileNetV2 over 500 FEMNIST clients) and
``shakespeare_fedavg`` (BERT-tiny as a next-token LM over 128 natural
clients).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

DTYPE_NAMES = ("float32", "bfloat16")
PARTITIONS = ("iid", "dirichlet", "natural")
AGGREGATORS = ("weighted_mean", "median", "trimmed_mean", "krum")
# gauss draws its noise from jax.random's threefry, which torch's
# generators cannot reproduce; the port leaves it out (see validate)
ATTACK_KINDS = ("sign_flip", "scale", "alie", "label_flip")
# the stateless algorithms; scaffold, feddyn, fedbuff and gossip are not
# ported
ALGORITHMS = ("fedavg", "fedprox")


@dataclass
class ModelConfig:
    name: str = "lenet5"
    num_classes: int = 10
    # model-family extras (e.g. resnet18's ``width``)
    kwargs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class DataConfig:
    name: str = "mnist"
    num_clients: int = 2
    # iid | dirichlet | natural (LEAF groups; Dirichlet(0.3) without them)
    partition: str = "iid"
    dirichlet_alpha: float = 0.5
    data_dir: str = "~/.cache/colearn_data"
    # real dataset files absent → deterministic synthetic stand-in of
    # the same shapes and cardinality
    synthetic_fallback: bool = True
    synthetic_train_size: int = 2048
    synthetic_test_size: int = 512
    # x = w·class_template + (1−w)·noise
    synthetic_template_weight: float = 0.7
    # cap on examples a client contributes per round (0 = largest shard)
    max_examples_per_client: int = 0


@dataclass
class ClientConfig:
    """Local SGD with (β = ``momentum``) heavy-ball momentum and
    FedProx's proximal pull. The JAX package's ``lr_decay`` and
    ``weight_decay`` are not ported: no preset sets them."""

    local_epochs: int = 1
    batch_size: int = 32
    lr: float = 0.1
    momentum: float = 0.9
    # FedProx proximal coefficient μ (0.0 == plain FedAvg local training)
    prox_mu: float = 0.0


@dataclass
class ServerConfig:
    num_rounds: int = 10
    cohort_size: int = 2
    eval_every: int = 1
    checkpoint_every: int = 0  # 0 = only at end
    # mean (plain FedAvg) | fedavgm (server momentum)
    optimizer: str = "mean"
    server_lr: float = 1.0
    server_momentum: float = 0.9
    # route the server apply through the hand-written CUDA kernels
    # (ops/server_apply.py; on the stacked path ops/reduce_apply.py)
    # instead of the plain optax-sgd chain
    fused_apply: bool = False
    # Cohort delta aggregation:
    #   weighted_mean — FedAvg's example-weighted mean
    #   median | trimmed_mean — coordinate-wise Byzantine-robust
    #   statistics over the per-client deltas (unweighted by design)
    #   krum — whole-update selection (Blanchard et al. 2017): keep the
    #   one delta closest to its m−f−2 nearest neighbours
    aggregator: str = "weighted_mean"
    # fraction trimmed from EACH side per coordinate (trimmed_mean only)
    trim_ratio: float = 0.1
    # krum only: assumed number of Byzantine clients f (neighbour count
    # = participants − f − 2, clamped ≥ 1)
    krum_byzantine: int = 0


@dataclass
class AttackConfig:
    """Byzantine adversary simulation (server/attacks.py). ``kind``:
    "" (off) | sign_flip (upload −scale·Δ) | scale (upload scale·Δ) |
    alie (upload μ − eps·σ of the honest cohort) | label_flip (train
    on labels flipped y → (C−1)−y)."""

    kind: str = ""
    # fraction of the FEDERATION compromised: round(fraction·num_clients)
    # clients (≥ 1), drawn once from run.seed
    fraction: float = 0.25
    # sign_flip/scale boost factor
    scale: float = 10.0
    # alie: the z of μ − z·σ
    eps: float = 1.0


@dataclass
class RunConfig:
    seed: int = 0
    out_dir: str = "runs"
    # rounds between metric fetches (each fetch synchronizes the device)
    metrics_flush_every: int = 10
    compute_dtype: str = "float32"
    # cast the f32 server params to this dtype once per client at local
    # training entry ("" = train in f32)
    local_param_dtype: str = ""


@dataclass
class ExperimentConfig:
    """A FedAvg or FedProx experiment (uniform cohort sampling, client
    SGD, f32 server params — the only sampler, client optimizer and
    server dtype the port has so far), optionally under attack."""

    name: str = "mnist_fedavg_2"
    # fedavg | fedprox (FedAvg with the proximal term; client.prox_mu > 0)
    algorithm: str = "fedavg"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    client: ClientConfig = field(default_factory=ClientConfig)
    server: ServerConfig = field(default_factory=ServerConfig)
    attack: AttackConfig = field(default_factory=AttackConfig)
    run: RunConfig = field(default_factory=RunConfig)

    def validate(self) -> "ExperimentConfig":
        """Reject what the port does not implement, naming the field."""
        if self.algorithm == "fedprox" and self.client.prox_mu <= 0:
            raise ValueError("algorithm='fedprox' requires client.prox_mu "
                             f"> 0, got {self.client.prox_mu}")
        checks = (
            (self.algorithm in ALGORITHMS, "algorithm", ALGORITHMS),
            (self.data.partition in PARTITIONS, "data.partition",
             PARTITIONS),
            (self.server.optimizer in ("mean", "fedavgm"),
             "server.optimizer", ("mean", "fedavgm")),
            (self.server.aggregator in AGGREGATORS, "server.aggregator",
             AGGREGATORS),
            (self.attack.kind in ("",) + ATTACK_KINDS, "attack.kind",
             ("",) + ATTACK_KINDS),
            (self.run.compute_dtype in DTYPE_NAMES, "run.compute_dtype",
             DTYPE_NAMES),
            (self.run.local_param_dtype in ("",) + DTYPE_NAMES,
             "run.local_param_dtype", ("",) + DTYPE_NAMES),
        )
        for ok, path, allowed in checks:
            if not ok:
                value = eval_path(self, path)
                if path == "attack.kind" and value == "gauss":
                    raise ValueError(
                        "attack.kind='gauss' is not supported by the port: "
                        "its noise comes from jax.random's threefry "
                        "streams, which torch cannot reproduce")
                raise ValueError(
                    f"{path}={value!r} is not supported by the port; "
                    f"allowed: {', '.join(map(repr, allowed))}"
                )
        if self.server.cohort_size > self.data.num_clients:
            raise ValueError(
                f"cohort_size {self.server.cohort_size} > num_clients "
                f"{self.data.num_clients}"
            )
        if self.server.num_rounds < 1:
            raise ValueError("server.num_rounds must be >= 1")
        self._validate_robust()
        return self

    def _validate_robust(self) -> None:
        """The JAX package's rules for the robust aggregators and the
        attack knobs."""
        srv, atk = self.server, self.attack
        if srv.krum_byzantine < 0:
            raise ValueError(f"server.krum_byzantine must be >= 0, "
                             f"got {srv.krum_byzantine}")
        if (srv.aggregator == "krum"
                and 2 * srv.krum_byzantine + 2 >= srv.cohort_size):
            # Blanchard et al.'s resilience condition 2f + 2 < n
            raise ValueError(
                f"server.krum_byzantine={srv.krum_byzantine}: krum requires "
                f"2*krum_byzantine + 2 < cohort_size ({srv.cohort_size})")
        if not 0.0 <= srv.trim_ratio < 0.5:
            raise ValueError(f"server.trim_ratio must be in [0, 0.5), "
                             f"got {srv.trim_ratio}")
        if not atk.kind:
            return
        if not 0.0 < atk.fraction < 1.0:
            raise ValueError(f"attack.fraction must be in (0, 1), "
                             f"got {atk.fraction}")
        if atk.scale <= 0.0:
            raise ValueError(f"attack.scale must be > 0, got {atk.scale}")
        if atk.eps < 0.0:
            raise ValueError(f"attack.eps must be >= 0, got {atk.eps}")
        if atk.kind == "label_flip" and self.model.num_classes < 2:
            raise ValueError(
                "attack.kind='label_flip' requires a classification label "
                "space (model.num_classes >= 2)")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def apply_overrides(self, overrides: Dict[str, Any]) -> "ExperimentConfig":
        """Apply dotted-path overrides like ``{'server.num_rounds': 5}``.
        Paths may descend into dict-typed fields (``model.kwargs.width``);
        an unknown section or leaf raises ``KeyError``."""
        for dotted, value in overrides.items():
            obj = self
            *head, last = dotted.split(".")
            for part in head:
                if isinstance(obj, dict):
                    obj = obj[part]
                elif hasattr(obj, part):
                    obj = getattr(obj, part)
                else:
                    raise KeyError(f"unknown config path {dotted!r}")
            if isinstance(obj, dict):
                obj[last] = value
                continue
            if not hasattr(obj, last):
                raise KeyError(f"unknown config path {dotted!r}")
            current = getattr(obj, last)
            if current is not None and not isinstance(current, dict):
                value = (type(current)(value)
                         if not isinstance(value, type(current)) else value)
            setattr(obj, last, value)
        return self


def eval_path(cfg: ExperimentConfig, dotted: str) -> Any:
    obj: Any = cfg
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def _mnist_fedavg_2() -> ExperimentConfig:
    """FedAvg, 2 clients, LeNet-5 on MNIST (the CPU smoke)."""
    return ExperimentConfig(
        name="mnist_fedavg_2",
        model=ModelConfig(name="lenet5", num_classes=10),
        data=DataConfig(name="mnist", num_clients=2, partition="iid"),
        client=ClientConfig(local_epochs=1, batch_size=32, lr=0.1),
        server=ServerConfig(num_rounds=20, cohort_size=2),
    )


def _cifar10_fedavg_100() -> ExperimentConfig:
    """FedAvg, 100 Dirichlet(0.5) clients, ResNet-18 (GroupNorm, CIFAR
    stem) on CIFAR-10, cohort 16, bf16 compute and bf16 local params
    over f32 server params — the headline workload."""
    return ExperimentConfig(
        name="cifar10_fedavg_100",
        model=ModelConfig(name="resnet18", num_classes=10),
        data=DataConfig(
            name="cifar10",
            num_clients=100,
            partition="dirichlet",
            dirichlet_alpha=0.5,
            max_examples_per_client=512,
        ),
        client=ClientConfig(local_epochs=1, batch_size=64, lr=0.05),
        server=ServerConfig(num_rounds=500, cohort_size=16, eval_every=10),
        run=RunConfig(compute_dtype="bfloat16", local_param_dtype="bfloat16"),
    )


def _cifar10_krum_byzantine() -> ExperimentConfig:
    """The headline CIFAR-10 federation under a live sign-flipping
    adversary, defended by Krum: fraction 0.125 of 100 clients (≈ 12)
    compromised, so ≈ 2 of the 16 cohort slots are Byzantine in steady
    state, matching ``krum_byzantine=2`` within 2f + 2 < 16. The JAX
    preset's ``run.cohort_layout="megabatch"`` is not a port option;
    the sequential engine gives the same result."""
    cfg = _cifar10_fedavg_100()
    cfg.name = "cifar10_krum_byzantine"
    cfg.server.aggregator = "krum"
    cfg.server.krum_byzantine = 2
    cfg.attack = AttackConfig(kind="sign_flip", fraction=0.125, scale=10.0)
    return cfg


def _shakespeare_fedavg() -> ExperimentConfig:
    """FedAvg of BERT-tiny as a causal next-token LM on Shakespeare:
    128 natural clients (LEAF roles from ``shakespeare.txt``, or a
    Dirichlet(0.3) split of the synthetic Markov-chain corpus), cohort
    32, batch 16, lr 0.5, bf16 compute and bf16 local params. The JAX
    preset's ``run.cohort_layout="megabatch"`` and ``run.fuse_rounds=10``
    are not port options; the sequential engine gives the same result,
    one round per call. Attention is ``full`` unless
    ``model.kwargs.attention`` says otherwise (``pallas`` selects the
    CUDA kernel)."""
    return ExperimentConfig(
        name="shakespeare_fedavg",
        model=ModelConfig(name="bert_tiny", num_classes=0,
                          kwargs={"vocab_size": 90, "seq_len": 80}),
        data=DataConfig(name="shakespeare", num_clients=128,
                        partition="natural", max_examples_per_client=256),
        client=ClientConfig(local_epochs=1, batch_size=16, lr=0.5),
        server=ServerConfig(num_rounds=200, cohort_size=32, eval_every=10),
        run=RunConfig(compute_dtype="bfloat16", local_param_dtype="bfloat16"),
    )


def _cifar10_fedavg_1000() -> ExperimentConfig:
    """The north-star scale config: the headline's per-client workload
    (ResNet-18, batch 64, lr 0.05, bf16 local training) over 1000
    Dirichlet(0.5) clients of the full 50,000-example CIFAR-10 corpus
    (2,000 test examples), cohort 64; ``max_examples_per_client=128``
    bounds the pad of the small, skewed shards. The JAX preset's
    ``run.cohort_layout="megabatch"`` is not a port option, and neither
    are ``run.fuse_rounds`` and ``run.shape_buckets``: the sequential
    engine gives the same result one round per call, and the port skips
    a client's padded steps on the host (client/trainer.py)."""
    return ExperimentConfig(
        name="cifar10_fedavg_1000",
        algorithm="fedavg",
        model=ModelConfig(name="resnet18", num_classes=10),
        data=DataConfig(
            name="cifar10",
            num_clients=1000,
            partition="dirichlet",
            dirichlet_alpha=0.5,
            synthetic_train_size=50_000,
            synthetic_test_size=2_000,
            max_examples_per_client=128,
        ),
        client=ClientConfig(local_epochs=1, batch_size=64, lr=0.05),
        server=ServerConfig(num_rounds=1000, cohort_size=64, eval_every=20),
        run=RunConfig(compute_dtype="bfloat16", local_param_dtype="bfloat16"),
    )


def _femnist_fedprox_500() -> ExperimentConfig:
    """FedProx (μ = 0.01), 500 clients, MobileNetV2 (width 1.0, 62
    classes, the small-input stem) on FEMNIST: LEAF writers merged onto
    clients by the ``natural`` partition, or a Dirichlet(0.3) split of
    the synthetic stand-in; cohort 32, batch 32, lr 0.03, bf16 compute
    and bf16 local params. The JAX preset's
    ``run.cohort_layout="megabatch"`` is not a port option, and neither
    are ``run.fuse_rounds`` and ``run.shape_buckets``: the port skips a
    client's padded steps on the host (client/trainer.py), which is what
    shape buckets buy on the TPU."""
    return ExperimentConfig(
        name="femnist_fedprox_500",
        algorithm="fedprox",
        model=ModelConfig(name="mobilenetv2", num_classes=62,
                          kwargs={"width_mult": 1.0}),
        data=DataConfig(
            name="femnist",
            num_clients=500,
            partition="natural",
            max_examples_per_client=256,
        ),
        client=ClientConfig(local_epochs=1, batch_size=32, lr=0.03,
                            prox_mu=0.01),
        server=ServerConfig(num_rounds=500, cohort_size=32, eval_every=10),
        run=RunConfig(compute_dtype="bfloat16", local_param_dtype="bfloat16"),
    )


_NAMED = {
    "mnist_fedavg_2": _mnist_fedavg_2,
    "cifar10_fedavg_100": _cifar10_fedavg_100,
    "cifar10_fedavg_1000": _cifar10_fedavg_1000,
    "cifar10_krum_byzantine": _cifar10_krum_byzantine,
    "femnist_fedprox_500": _femnist_fedprox_500,
    "shakespeare_fedavg": _shakespeare_fedavg,
}


def list_named_configs():
    return sorted(_NAMED)


def resolve_config(name: str,
                   overrides: Optional[Dict[str, Any]] = None
                   ) -> ExperimentConfig:
    """A named preset with dotted overrides applied, validated."""
    if name not in _NAMED:
        raise KeyError(
            f"unknown config {name!r}; known named configs: {sorted(_NAMED)}"
        )
    cfg = _NAMED[name]()
    if overrides:
        cfg.apply_overrides(overrides)
    return cfg.validate()
