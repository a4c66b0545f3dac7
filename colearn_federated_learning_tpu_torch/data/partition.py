"""Federated partitioners: IID, Dirichlet(α) label skew and LEAF's
natural split.

Pure NumPy on index arrays, copied from the JAX package's
``data/partition.py`` so that the same seed gives bitwise-identical
client shards in both packages.

Invariants: the client shards partition the example index set
(disjoint, complete); same seed ⇒ identical shards.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def iid_partition(n: int, num_clients: int, seed: int) -> List[np.ndarray]:
    if num_clients > n:
        # array_split would silently hand back empty shards that only
        # surface rounds later as an opaque eval/np.repeat error — name
        # both numbers at partition time instead
        raise ValueError(
            f"iid_partition: {num_clients} clients over {n} examples "
            f"would leave {num_clients - n} client shard(s) empty — "
            f"reduce data.num_clients or provide more examples"
        )
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return [np.sort(s) for s in np.array_split(perm, num_clients)]


def dirichlet_partition(
    labels: np.ndarray, num_clients: int, num_classes: int, alpha: float, seed: int,
    min_size: int = 1, info: Optional[dict] = None,
) -> List[np.ndarray]:
    """Label-skew non-IID: for each class, split its examples across clients
    by proportions drawn from Dirichlet(α)·𝟙. Standard FL recipe (Hsu et al.).

    Re-draws until every client has ≥ ``min_size`` examples, which mirrors
    the usual implementation and keeps downstream static shapes sane. At
    extreme α (near-label-pure splits) redraws can keep failing — e.g.
    α≈0.05, 2 classes, 10 clients leaves most clients empty on every
    draw — so after the retry budget a deterministic REPAIR bulk-moves
    examples from the largest shards to the starved ones instead of
    raising; the result is still a partition and still extremely
    label-skewed, and stays deterministic in ``seed``. The repair
    changes the effective label-skew distribution, so it is SURFACED:
    when ``info`` is passed, ``info["repair_used"]`` /
    ``info["repair_moved"]`` record whether and how many examples were
    relocated (threaded into ``FederatedData.meta`` and the run log by
    data/core.py)."""
    rng = np.random.default_rng(seed)
    n = len(labels)
    if n < num_clients * min_size:
        raise ValueError(
            f"dirichlet_partition: {n} examples cannot give {num_clients} "
            f"clients ≥ {min_size} each"
        )
    shards: List[List[int]] = []
    for _attempt in range(100):
        shards = [[] for _ in range(num_clients)]
        for c in range(num_classes):
            idx_c = np.flatnonzero(labels == c)
            rng.shuffle(idx_c)
            props = rng.dirichlet(np.full(num_clients, alpha))
            # cumulative split points over this class's examples
            cuts = (np.cumsum(props)[:-1] * len(idx_c)).astype(int)
            for shard, part in zip(shards, np.split(idx_c, cuts)):
                shard.extend(part.tolist())
        sizes = [len(s) for s in shards]
        if min(sizes) >= min_size:
            if info is not None:
                info["repair_used"] = False
                info["repair_moved"] = 0
            return [np.sort(np.array(s, np.int64)) for s in shards]
    # Repair the final draw: feed starved shards from the largest ones.
    # Each starved shard's deficit is computed once and filled with bulk
    # slices from the current largest donors (donors never drop below
    # min_size, so repairs can't cascade) — O(num_clients·log) instead of
    # one argmin/argmax pass per moved example, which matters at extreme
    # α on large datasets where the total deficit can be tens of
    # thousands of examples.
    sizes = np.array([len(s) for s in shards])
    moved = 0
    for needy in np.flatnonzero(sizes < min_size):
        deficit = min_size - int(sizes[needy])
        while deficit > 0:
            donor = int(sizes.argmax())
            take = min(deficit, int(sizes[donor]) - min_size)
            shards[needy].extend(shards[donor][-take:])
            del shards[donor][-take:]
            sizes[donor] -= take
            sizes[needy] += take
            deficit -= take
            moved += take
    if info is not None:
        info["repair_used"] = True
        info["repair_moved"] = moved
        # the α actually drawn from — the 'natural' fallback calls this
        # with a hardcoded α, not the config field
        info["repair_alpha"] = alpha
    return [np.sort(np.array(s, np.int64)) for s in shards]


def natural_partition(
    groups: Sequence[np.ndarray], num_clients: int, seed: int
) -> List[np.ndarray]:
    """LEAF-style natural split: each group is one writer/character's
    examples. If there are more groups than clients, groups are merged
    round-robin by size (largest first) to balance; fewer groups than
    clients is an error (natural splits can't be subdivided)."""
    if len(groups) < num_clients:
        raise ValueError(
            f"natural_partition: {len(groups)} natural groups < {num_clients} clients"
        )
    order = np.argsort([-len(g) for g in groups])
    assign = [[] for _ in range(num_clients)]
    sizes = np.zeros(num_clients, np.int64)
    for gi in order:
        # place largest remaining group on the currently smallest client
        tgt = int(np.argmin(sizes))
        assign[tgt].append(gi)
        sizes[tgt] += len(groups[gi])
    return [
        np.sort(np.concatenate([np.asarray(groups[gi], np.int64) for gi in gis]))
        for gis in assign
    ]


def partition(
    kind: str,
    labels: np.ndarray,
    num_clients: int,
    num_classes: int,
    alpha: float,
    seed: int,
    natural_groups: Optional[Sequence[np.ndarray]] = None,
    info: Optional[dict] = None,
) -> List[np.ndarray]:
    n = len(labels)
    if kind == "iid":
        return iid_partition(n, num_clients, seed)
    if kind == "dirichlet":
        return dirichlet_partition(labels, num_clients, num_classes, alpha, seed,
                                   info=info)
    if kind == "natural":
        if natural_groups is None:
            # synthetic stand-in for a LEAF natural split: heavy label
            # skew and heterogeneous sizes
            return dirichlet_partition(labels, num_clients, num_classes,
                                       alpha=0.3, seed=seed, info=info)
        return natural_partition(natural_groups, num_clients, seed)
    raise ValueError(f"unknown partition kind {kind!r}")
