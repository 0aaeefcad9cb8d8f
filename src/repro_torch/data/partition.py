"""FL data partitioning (paper Sec. IV-A1).

IID: random equal split. Non-IID: the McMahan et al. [9] pathological
split the paper uses — sort by label, cut into ``2 * num_users`` shards,
deal each user 2 shards, so each user sees ~2 classes.

Part of the numpy bit-reproducible reference path — reprolint:
reference-path (no jax imports; partitions decide every user's data
and hence the pinned reference sequences).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def partition_iid(x, y, num_users: int, seed: int = 0) -> List[Tuple]:
    rng = np.random.default_rng(seed)  # reprolint: disable=RL101 # copy of a whitelisted site
    idx = rng.permutation(len(y))
    splits = np.array_split(idx, num_users)
    return [(x[s], y[s]) for s in splits]


def partition_noniid_shards(x, y, num_users: int, shards_per_user: int = 2,
                            seed: int = 0) -> List[Tuple]:
    """Label-sorted shard split; paper: 200 shards of 300 for 60k samples,
    scaled as len(y) // (num_users * shards_per_user) per shard."""
    rng = np.random.default_rng(seed)  # reprolint: disable=RL101 # copy of a whitelisted site
    n_shards = num_users * shards_per_user
    shard_size = len(y) // n_shards
    order = np.argsort(y, kind="stable")
    shards = [order[i * shard_size:(i + 1) * shard_size]
              for i in range(n_shards)]
    assignment = rng.permutation(n_shards).reshape(num_users,
                                                   shards_per_user)
    out = []
    for u in range(num_users):
        idx = np.concatenate([shards[s] for s in assignment[u]])
        out.append((x[idx], y[idx]))
    return out


def user_label_histogram(user_data, num_classes: int = 10) -> np.ndarray:
    """(num_users, num_classes) counts — used by fairness analyses."""
    return np.stack([np.bincount(y, minlength=num_classes)
                     for _, y in user_data])
