"""The run's random streams, re-derived from the seed: a frozen copy of
the spawn-tree rule (numpy ``SeedSequence`` children at fixed paths).

    (0,)        engine stream: Eq. 3's R ~ U(0, 1) backoff draws
    (1,)        strategy stream: the CSMA simulator's collision redraws
                (NumPy contention), or the entropy of the counter-based
                redraws (device contention)
    (2, u)      user u's batch stream: one permutation of its examples
                a local epoch
"""
from __future__ import annotations

import numpy as np

ENGINE, STRATEGY, CLIENT = 0, 1, 2


def child(seed: int, *path: int) -> np.random.SeedSequence:
    return np.random.SeedSequence(entropy=int(seed), spawn_key=tuple(path))


def engine_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(child(seed, ENGINE))


def strategy_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(child(seed, STRATEGY))


def strategy_entropy(seed: int) -> int:
    """64 bits distilled from the strategy stream's seed material."""
    lo, hi = child(seed, STRATEGY).generate_state(2, np.uint32)
    return int(hi) << 32 | int(lo)


def client_rng(seed: int, uid: int) -> np.random.Generator:
    return np.random.default_rng(child(seed, CLIENT, int(uid)))
